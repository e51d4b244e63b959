"""Flagship-scale BER/SER parity vs an independent NumPy float64 oracle.

Closes SURVEY.md section 4 test-plan item (d) at the north-star scale
(L=1024, M=512, R=1.0): the JAX framework's measured section- and
bit-error rates across the AMP threshold region must agree, within
Monte-Carlo confidence, with an INDEPENDENT implementation running the
reference's own engine family — a seeded subsampled-DCT design
(re-derived from the construction described at
sparc_public/sparc.py:649-701: rows/columns subsampled from the scaled
orthonormal DCT matrix, excluding the constant row/column) driven by a
scalar-tau AMP re-derived from the AMP equations
(sparc_public/sparc.py:883-999), in float64 NumPy end to end.

The two engines share NOTHING: different language/runtime (NumPy/scipy
vs JAX/XLA), different design ensemble (subsampled DCT vs SRHT
Hadamard), different dtype (f64 vs f32), different RNG streams. Agreement
is therefore an ensemble-level statistical claim, gated per operating
point with a frame-level 4-sigma confidence bound (sections within a
frame are correlated, so the unit of replication is the frame).

Writes docs/artifacts/oracle_parity.json (gated by
tests/test_oracle_parity.py).

Usage: python benchmarks/oracle_parity.py [--np-trials 160]
           [--jax-trials 1024] [--platform cpu] [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
from scipy.fft import dct, idct

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "artifacts")


# --------------------------------------------------------------------------
# Independent NumPy float64 oracle (subsampled-DCT design + scalar-tau AMP)
# --------------------------------------------------------------------------

def make_dct_design(n: int, LM: int, P: float, L: int, rng):
    """Seeded subsampled-DCT SPARC design (the reference's fast-transform
    ensemble, sparc_public/sparc.py:649-701): A = sqrt(P/L) * sqrt(w) *
    C[rows][:, cols] where C is the w-point orthonormal DCT-II matrix and
    rows/cols are drawn without replacement from [1, w) (index 0 — the
    constant row/column — is excluded).  sqrt(w)*C entries are
    sqrt(2)*cos(.), zero mean and unit variance on average, so columns of
    A have squared norm ~ n*P/L and E||A beta||^2/n = P for a unit-amplitude
    message vector."""
    w = 1 << int(np.ceil(np.log2(max(n + 1, LM + 1))))
    rows = rng.permutation(np.arange(1, w, dtype=np.int64))[:n]
    cols = rng.permutation(np.arange(1, w, dtype=np.int64))[:LM]
    scale = np.sqrt(P / L) * np.sqrt(w)

    def Ab(beta):
        x_ext = np.zeros(w)
        x_ext[cols] = beta
        return scale * dct(x_ext, norm="ortho", workers=-1)[rows]

    def Az(z):
        y_ext = np.zeros(w)
        y_ext[rows] = z
        return scale * idct(y_ext, norm="ortho", workers=-1)[cols]

    return Ab, Az


def numpy_dct_amp_trial(L: int, M: int, P: float, R: float, awgn_var: float,
                        t_max: int, rng, rtol: float = 1e-6):
    """One end-to-end float64 trial: random message -> subsampled-DCT
    codeword -> AWGN -> scalar-tau AMP -> MAP hard decision.

    AMP recursion (scalar base entry W = P; phi_est_method=1), re-derived
    from sparc_public/sparc.py:883-999:
        gamma = P * psi                      (residual var minus noise var)
        z     = y - A beta + (gamma/phi_prev) z          (Onsager term)
        phi   = awgn_var + gamma
        tau   = L * phi / (n * P)            (effective noise variance)
        s     = beta + (tau/phi) A^T z
        beta  = softmax_section(s / tau)     (MMSE posterior mean, amp 1)
        psi   = 1 - ||beta||^2 / L
    with the reference's early stop allclose(psi, psi_prev, rtol, atol)
    after t_max-1 iterations and argmax-on-s hard decision.

    Returns (sec_errs, bit_errs, t_final)."""
    logM = M.bit_length() - 1
    n = int(L * logM / R)
    LM = L * M

    Ab, Az = make_dct_design(n, LM, P, L, rng)
    idx0 = rng.integers(0, M, L)
    beta0 = np.zeros(LM)
    beta0[np.arange(L) * M + idx0] = 1.0
    y = Ab(beta0) + rng.normal(0.0, np.sqrt(awgn_var), n)

    atol = 2 * np.finfo(np.float64).resolution
    beta = np.zeros(LM)
    z = y
    psi = 1.0
    phi = None
    s = None
    t_final = t_max - 1
    for t in range(t_max - 1):
        if t > 0:
            gamma = P * psi
            z = y - Ab(beta) + (gamma / phi) * z
        else:
            gamma = P  # psi = 1 at init
        phi = awgn_var + gamma
        tau = L * phi / (n * P)
        s = beta + (tau / phi) * Az(z)
        x = (s / tau).reshape(L, M)
        x -= x.max(axis=1, keepdims=True)
        e = np.exp(x)
        beta = (e / e.sum(axis=1, keepdims=True)).reshape(LM)
        psi_prev = psi
        psi = 1.0 - (beta ** 2).sum() / L
        if t > 0 and np.isclose(psi, psi_prev, rtol, atol):
            t_final = t + 1
            break

    idx_hat = s.reshape(L, M).argmax(axis=1)
    sec_errs = int(np.count_nonzero(idx_hat != idx0))
    # bit errors under the canonical index<->bits bijection: popcount of
    # the XOR of true and decoded section indices
    xor = (idx_hat ^ idx0).astype(np.int64)
    bit_errs = 0
    for b in range(logM):
        bit_errs += int(np.count_nonzero((xor >> b) & 1))
    return sec_errs, bit_errs, t_final


def run_numpy_point(L, M, P, R, awgn_var, t_max, trials, seed):
    """Per-frame section/bit error counts from the NumPy oracle."""
    rng = np.random.default_rng(seed)
    sec = np.zeros(trials, np.int64)
    bits = np.zeros(trials, np.int64)
    iters = np.zeros(trials, np.int64)
    for i in range(trials):
        sec[i], bits[i], iters[i] = numpy_dct_amp_trial(
            L, M, P, R, awgn_var, t_max, rng)
    return sec, bits, iters


# --------------------------------------------------------------------------
# Spatially-coupled oracle: per-block subsampled-DCT design + 2-D-W AMP
# --------------------------------------------------------------------------

def sc_base_matrix(P, omega, Lambda):
    """(omega, Lambda) base matrix, re-derived from the construction at
    sparc_public/sparc.py:534-567: column c spreads power P*Lr/omega over
    rows c..c+omega-1; the matrix mean equals P."""
    Lr = Lambda + omega - 1
    W = np.zeros((Lr, Lambda))
    for c in range(Lambda):
        W[c:c + omega, c] = P * Lr / omega
    return W


def make_block_dct_design(W, L, M, n, rng):
    """Blockwise subsampled-DCT SPARC design for a 2-D base matrix
    (the reference's W.ndim==2 engine, sparc_public/sparc.py:832-877,
    re-derived): one independent seeded sub-DCT per nonzero (r, c) block,
    scaled sqrt(W[r,c]/L)."""
    Lr, Lc = W.shape
    LM = L * M
    Mr, Mc = n // Lr, LM // Lc
    w = 1 << int(np.ceil(np.log2(max(Mr + 1, Mc + 1))))
    blocks = []
    for r in range(Lr):
        for c in range(Lc):
            if W[r, c] != 0:
                rows = rng.permutation(np.arange(1, w, dtype=np.int64))[:Mr]
                cols = rng.permutation(np.arange(1, w, dtype=np.int64))[:Mc]
                blocks.append((r, c, rows, cols,
                               np.sqrt(W[r, c] / L) * np.sqrt(w)))

    def Ab(beta):
        out = np.zeros(n)
        for r, c, rows, cols, sc in blocks:
            x_ext = np.zeros(w)
            x_ext[cols] = beta[c * Mc:(c + 1) * Mc]
            out[r * Mr:(r + 1) * Mr] += \
                sc * dct(x_ext, norm="ortho", workers=-1)[rows]
        return out

    def Az(z):
        out = np.zeros(LM)
        for r, c, rows, cols, sc in blocks:
            y_ext = np.zeros(w)
            y_ext[rows] = z[r * Mr:(r + 1) * Mr]
            out[c * Mc:(c + 1) * Mc] += \
                sc * idct(y_ext, norm="ortho", workers=-1)[cols]
        return out

    return Ab, Az


def numpy_sc_amp_trial(L, M, P, R, omega, Lambda, awgn_var, t_max, rng,
                       rtol=1e-6):
    """One float64 spatially-coupled trial: 2-D-W AMP re-derived from the
    unified block equations (sparc_public/sparc.py:883-999, W.ndim==2
    branches): per-row-block phi, per-column-block tau, Onsager coefficient
    repeated over row blocks."""
    logM = M.bit_length() - 1
    W = sc_base_matrix(P, omega, Lambda)
    Lr, Lc = W.shape
    LM = L * M
    n0 = int(round(L * logM / R))
    Mr = int(round(n0 / Lr))
    n = Mr * Lr                      # row-block rounding (sparc.py:40-43)
    Mc = LM // Lc
    sec_per_col = L // Lc

    Ab, Az = make_block_dct_design(W, L, M, n, rng)
    idx0 = rng.integers(0, M, L)
    beta0 = np.zeros(LM)
    beta0[np.arange(L) * M + idx0] = 1.0
    y = Ab(beta0) + rng.normal(0.0, np.sqrt(awgn_var), n)

    atol = 2 * np.finfo(np.float64).resolution
    beta = np.zeros(LM)
    z = y
    psi = np.ones(Lc)
    phi = None
    s = None
    t_final = t_max - 1
    for t in range(t_max - 1):
        gamma = W @ psi / Lc                     # (Lr,)
        if t > 0:
            z = y - Ab(beta) + np.repeat(gamma / phi, Mr) * z
        phi = awgn_var + gamma
        tau = (L / Mr) / (W.T @ (1.0 / phi))     # (Lc,)
        s = beta + np.repeat(tau, Mc) * Az(z / np.repeat(phi, Mr))
        tau_sec = np.repeat(tau, sec_per_col)    # (L,)
        x = s.reshape(L, M) / tau_sec[:, None]
        x -= x.max(axis=1, keepdims=True)
        e = np.exp(x)
        beta = (e / e.sum(axis=1, keepdims=True)).reshape(LM)
        psi_prev = psi
        psi = 1.0 - (beta ** 2).reshape(Lc, -1).sum(axis=1) / sec_per_col
        if t > 0 and np.allclose(psi, psi_prev, rtol, atol):
            t_final = t + 1
            break

    idx_hat = s.reshape(L, M).argmax(axis=1)
    sec_errs = int(np.count_nonzero(idx_hat != idx0))
    xor = (idx_hat ^ idx0).astype(np.int64)
    bit_errs = sum(int(np.count_nonzero((xor >> b) & 1))
                   for b in range(logM))
    return sec_errs, bit_errs, t_final


def run_numpy_sc_point(L, M, P, R, omega, Lambda, awgn_var, t_max, trials,
                       seed):
    rng = np.random.default_rng(seed)
    sec = np.zeros(trials, np.int64)
    bits = np.zeros(trials, np.int64)
    iters = np.zeros(trials, np.int64)
    for i in range(trials):
        sec[i], bits[i], iters[i] = numpy_sc_amp_trial(
            L, M, P, R, omega, Lambda, awgn_var, t_max, rng)
    return sec, bits, iters


# --------------------------------------------------------------------------
# Power-allocated oracle: W.ndim==1 engine (B column blocks, full rows)
# --------------------------------------------------------------------------

def pa_power_allocation(P, sigma_sqr, B, R_PA):
    """Iterative power allocation (the published recurrence of
    sparc_public/sparc.py:516-533). Shared BY SPECIFICATION with
    config.pa_iterative — the allocation is a deterministic function of
    (P, sigma^2, B, R) that both engines must compute identically, like
    the IEEE protograph tables; it carries no randomness or decoding
    logic."""
    Q = np.zeros(B)
    for b in range(B):
        phi = sigma_sqr + P - Q.mean()
        P_block = 2.0 * np.log(2.0) * R_PA * phi
        P_spread = (B * P - Q.sum()) / (B - b)
        if P_block > P_spread:
            Q[b] = P_block
        else:
            Q[b:] = P_spread
            break
    return Q / (Q.mean() / P)


def make_pa_dct_design(Wv, L, M, n, rng):
    """Blockwise design for a base VECTOR (the reference's W.ndim==1
    engine, sparc_public/sparc.py:800-830): B full-height column blocks,
    block b a seeded sub-DCT scaled sqrt(W[b]/L)."""
    B = len(Wv)
    LM = L * M
    Mc = LM // B
    w = 1 << int(np.ceil(np.log2(max(n + 1, Mc + 1))))
    blocks = []
    for b in range(B):
        rows = rng.permutation(np.arange(1, w, dtype=np.int64))[:n]
        cols = rng.permutation(np.arange(1, w, dtype=np.int64))[:Mc]
        blocks.append((rows, cols, np.sqrt(Wv[b] / L) * np.sqrt(w)))

    def Ab(beta):
        out = np.zeros(n)
        for b, (rows, cols, sc) in enumerate(blocks):
            x_ext = np.zeros(w)
            x_ext[cols] = beta[b * Mc:(b + 1) * Mc]
            out += sc * dct(x_ext, norm="ortho", workers=-1)[rows]
        return out

    def Az(z):
        out = np.zeros(LM)
        y_base = np.zeros(w)
        for b, (rows, cols, sc) in enumerate(blocks):
            y_ext = y_base.copy()
            y_ext[rows] = z
            out[b * Mc:(b + 1) * Mc] = \
                sc * idct(y_ext, norm="ortho", workers=-1)[cols]
        return out

    return Ab, Az


def numpy_pa_amp_trial(L, M, P, R, B, R_PA_ratio, awgn_var, t_max, rng,
                       rtol=1e-6):
    """One float64 power-allocated trial (W.ndim==1 AMP branches of
    sparc_public/sparc.py:883-999, re-derived): scalar phi, per-column-
    block tau = L*phi/(n*W[b])."""
    logM = M.bit_length() - 1
    n = int(round(L * logM / R))
    LM = L * M
    Mc = LM // B
    sec_per_blk = L // B
    Wv = pa_power_allocation(P, awgn_var, B, R * R_PA_ratio)

    Ab, Az = make_pa_dct_design(Wv, L, M, n, rng)
    idx0 = rng.integers(0, M, L)
    beta0 = np.zeros(LM)
    beta0[np.arange(L) * M + idx0] = 1.0
    y = Ab(beta0) + rng.normal(0.0, np.sqrt(awgn_var), n)

    atol = 2 * np.finfo(np.float64).resolution
    beta = np.zeros(LM)
    z = y
    psi = np.ones(B)
    phi = None
    s = None
    t_final = t_max - 1
    for t in range(t_max - 1):
        gamma = float(Wv @ psi) / B              # scalar
        if t > 0:
            z = y - Ab(beta) + (gamma / phi) * z
        phi = awgn_var + gamma
        tau = (L * phi / n) / Wv                 # (B,)
        s = beta + np.repeat(tau, Mc) * Az(z / phi)
        tau_sec = np.repeat(tau, sec_per_blk)
        x = s.reshape(L, M) / tau_sec[:, None]
        x -= x.max(axis=1, keepdims=True)
        e = np.exp(x)
        beta = (e / e.sum(axis=1, keepdims=True)).reshape(LM)
        psi_prev = psi
        psi = 1.0 - (beta ** 2).reshape(B, -1).sum(axis=1) / sec_per_blk
        if t > 0 and np.allclose(psi, psi_prev, rtol, atol):
            t_final = t + 1
            break

    idx_hat = s.reshape(L, M).argmax(axis=1)
    sec_errs = int(np.count_nonzero(idx_hat != idx0))
    xor = (idx_hat ^ idx0).astype(np.int64)
    bit_errs = sum(int(np.count_nonzero((xor >> b) & 1))
                   for b in range(logM))
    return sec_errs, bit_errs, t_final


def run_numpy_pa_point(L, M, P, R, B, R_PA_ratio, awgn_var, t_max, trials,
                       seed):
    rng = np.random.default_rng(seed)
    sec = np.zeros(trials, np.int64)
    bits = np.zeros(trials, np.int64)
    iters = np.zeros(trials, np.int64)
    for i in range(trials):
        sec[i], bits[i], iters[i] = numpy_pa_amp_trial(
            L, M, P, R, B, R_PA_ratio, awgn_var, t_max, rng)
    return sec, bits, iters


# --------------------------------------------------------------------------
# Modulated-complex oracle: subsampled-FFT design + K-PSK AMP
# --------------------------------------------------------------------------

def make_fft_design(n, LM, P, L, rng):
    """Seeded subsampled-FFT design (the reference's complex engine,
    sparc_public/sparc.py:593-646, re-derived): rows/columns drawn without
    replacement from [0, w) \\ {0, w/2} of the UNNORMALIZED w-point DFT
    matrix (unit-modulus entries), scaled sqrt(P/L)."""
    w = 1 << int(np.ceil(np.log2(max(n + 2, LM + 2))))
    allowed = np.delete(np.arange(w, dtype=np.int64), [0, w // 2])
    rows = rng.permutation(allowed)[:n]
    cols = rng.permutation(allowed)[:LM]
    scale = np.sqrt(P / L)

    def Ab(beta):
        x_ext = np.zeros(w, dtype=complex)
        x_ext[cols] = beta
        return scale * np.fft.fft(x_ext)[rows]

    def Az(z):
        y_ext = np.zeros(w, dtype=complex)
        y_ext[rows] = z
        # adjoint A^H: conj(F)^T = conj(fft(conj(.)))
        return scale * np.conj(np.fft.fft(np.conj(y_ext)))[cols]

    return Ab, Az


def numpy_mod_amp_trial(L, M, P, R, K, awgn_var, t_max, rng, rtol=1e-6):
    """One float64 complex K-PSK modulated trial (scalar-W complex AMP,
    sparc_public/sparc.py:883-999 + the K=4 MMSE/MAP estimators at
    :402-513, re-derived): circular AWGN of total variance awgn_var,
    per-dimension effective noise tau/2, Gray-coded value bits.

    Returns (sec_errs, loc_errs, val_errs, bit_errs, t_final)."""
    assert K == 4, "oracle implements the reference's K=4 demo family"
    logM = M.bit_length() - 1
    logK = 2
    n = int(round(L * (logM + logK) / R))
    LM = L * M

    Ab, Az = make_fft_design(n, LM, P, L, rng)
    idx0 = rng.integers(0, M, L)
    vbits0 = rng.integers(0, K, L)           # Gray-coded value bits
    k0 = vbits0 ^ (vbits0 >> 1)              # gray2bin -> constellation idx
    constel = np.array([1 + 0j, 0 + 1j, -1 + 0j, 0 - 1j])
    beta0 = np.zeros(LM, dtype=complex)
    beta0[np.arange(L) * M + idx0] = constel[k0]
    noise = (rng.normal(size=n) + 1j * rng.normal(size=n)) \
        * np.sqrt(awgn_var / 2)
    y = Ab(beta0) + noise

    atol = 2 * np.finfo(np.float64).resolution
    beta = np.zeros(LM, dtype=complex)
    z = y
    psi = 1.0
    phi = None
    s = None
    t_final = t_max - 1
    for t in range(t_max - 1):
        gamma = P * psi
        if t > 0:
            z = y - Ab(beta) + (gamma / phi) * z
        phi = awgn_var + gamma
        tau = L * phi / (n * P)
        s = beta + (tau / phi) * Az(z)
        tau2 = tau / 2.0                      # per-dimension variance
        xr = (np.real(s) / tau2).reshape(L, M)
        xi = (np.imag(s) / tau2).reshape(L, M)
        m = np.maximum(np.abs(xr), np.abs(xi)).max(axis=1, keepdims=True)
        er, emr = np.exp(xr - m), np.exp(-xr - m)
        ei, emi = np.exp(xi - m), np.exp(-xi - m)
        num = (er - emr) + 1j * (ei - emi)    # 2(sinh xr + i sinh xi) e^-m
        den = (er + emr + ei + emi).sum(axis=1, keepdims=True)
        beta = (num / den).reshape(LM)
        psi_prev = psi
        psi = 1.0 - float((np.abs(beta) ** 2).sum()) / L
        if t > 0 and np.isclose(psi, psi_prev, rtol, atol):
            t_final = t + 1
            break

    # MAP on s: per section maximize Re(s_j conj(c_k))
    sr = np.real(s).reshape(L, M)
    si = np.imag(s).reshape(L, M)
    best = np.maximum(np.abs(sr), np.abs(si))
    j_hat = best.argmax(axis=1)
    r = sr[np.arange(L), j_hat]
    q = si[np.arange(L), j_hat]
    k_hat = np.where(np.abs(r) >= np.abs(q),
                     np.where(r > 0, 0, 2), np.where(q > 0, 1, 3))
    loc_e = j_hat != idx0
    val_e = k_hat != k0
    sec_errs = int(np.count_nonzero(loc_e | val_e))
    loc_errs = int(np.count_nonzero(loc_e))
    val_errs = int(np.count_nonzero(val_e))
    vbits_hat = k_hat ^ (k_hat >> 1)          # bin2gray
    xor_loc = (j_hat ^ idx0).astype(np.int64)
    xor_val = (vbits_hat ^ vbits0).astype(np.int64)
    bit_errs = sum(int(np.count_nonzero((xor_loc >> b) & 1))
                   for b in range(logM))
    bit_errs += sum(int(np.count_nonzero((xor_val >> b) & 1))
                    for b in range(logK))
    return sec_errs, loc_errs, val_errs, bit_errs, t_final


def run_numpy_mod_point(L, M, P, R, K, awgn_var, t_max, trials, seed):
    rng = np.random.default_rng(seed)
    sec = np.zeros(trials, np.int64)
    bits = np.zeros(trials, np.int64)
    iters = np.zeros(trials, np.int64)
    for i in range(trials):
        sec[i], _, _, bits[i], iters[i] = numpy_mod_amp_trial(
            L, M, P, R, K, awgn_var, t_max, rng)
    return sec, bits, iters


# --------------------------------------------------------------------------
# JAX side: per-frame counts through the framework's own decoder
# --------------------------------------------------------------------------

def run_jax_point(params, decode, awgn_var, trials, seed0, chunk=128,
                  engine="srht"):
    """Per-frame counts from the framework (default: SRHT engine, f32;
    engine='dft' selects the reference-exact complex DFT ensemble), one
    fresh design per chunk so design randomness is averaged too."""
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.models.sparc import design_for_params
    from ldpc_sparc_tpu.models.sparc import amp_decode, awgn_channel
    from ldpc_sparc_tpu.utils import bits as bitops
    from ldpc_sparc_tpu.utils import rng as rngmod

    M, K, L = params.M, params.K, params.L

    @jax.jit
    def chunk_counts(design, keys):
        def one(key):
            kb = rngmod.derive(key, rngmod.BITS)
            kc = rngmod.derive(key, rngmod.CHANNEL)
            b = bitops.random_bits(kb, params.bit_len)
            beta0 = bitops.bits_to_msg_vector(b, M, K)
            y = awgn_channel(design.ab(beta0), awgn_var, kc)
            res = amp_decode(y, design, params, decode, awgn_var)
            b_out = bitops.msg_vector_to_bits(res.beta, M, K)
            sec = jnp.sum(jnp.any((res.beta != beta0).reshape(L, M), axis=1))
            return sec, jnp.sum(b != b_out), res.t_final
        return jax.vmap(one)(keys)

    import jax.random as jrand
    n_chunks = (trials + chunk - 1) // chunk
    sec_all, bit_all, it_all = [], [], []
    for c in range(n_chunks):
        design = design_for_params(params, awgn_var, (seed0, c), engine)
        root = rngmod.root_key((seed0, 1000 + c))
        keys = jax.vmap(lambda i: jrand.fold_in(root, i))(jnp.arange(chunk))
        sec, bit, it = chunk_counts(design, keys)
        sec_all.append(np.asarray(sec))
        bit_all.append(np.asarray(bit))
        it_all.append(np.asarray(it))
    sec = np.concatenate(sec_all)[:trials]
    bit = np.concatenate(bit_all)[:trials]
    it = np.concatenate(it_all)[:trials]
    return sec, bit, it


def summarize(sec, bits, iters, L, bits_per_sec):
    """bits_per_sec: message bits PER SECTION (logM, plus logK for
    modulated codes — both engines count errors over ALL of them)."""
    frames = len(sec)
    fser = sec / L
    fber = bits / (L * bits_per_sec)
    return {
        "trials": int(frames),
        "sec_errs": int(sec.sum()), "sections": int(frames * L),
        "bit_errs": int(bits.sum()), "bits": int(frames * L * bits_per_sec),
        "ser": float(sec.sum() / (frames * L)),
        "ber": float(bits.sum() / (frames * L * bits_per_sec)),
        "fer": float(np.mean(sec > 0)),
        "frame_ser_std": float(fser.std(ddof=1)),
        "frame_ber_std": float(fber.std(ddof=1)),
        "avg_iters": float(iters.mean()),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--family",
                    choices=("plain", "sc", "pa", "modulated",
                             "modulated_dft"),
                    default="plain")
    ap.add_argument("--np-trials", type=int, default=None)
    ap.add_argument("--jax-trials", type=int, default=1024)
    ap.add_argument("--t-max", type=int, default=None)
    ap.add_argument("--quick", action="store_true",
                    help="2 points, few trials (smoke only; do not commit)")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from ldpc_sparc_tpu import SparcParams, DecodeParams
    from ldpc_sparc_tpu.utils.device import device_record

    engine = "srht"
    if args.family == "plain":
        # north-star config; threshold region of docs/artifacts/
        # flagship_sweep.json (SE threshold snr ~3.88)
        params = SparcParams(P=15.0, R=1.0, L=1024, M=512)
        snrs = [3.25, 3.5625, 3.875, 4.1875]
        t_max = args.t_max or 30
        np_trials = args.np_trials or 160
        artifact = "oracle_parity.json"
    elif args.family == "sc":
        # the demo notebook's SC config (sparc_demo.ipynb cell 10). The
        # asymptotic SE threshold sits at snr ~7.8, but at L=1024/Lambda=8
        # (128 sections per column block) the finite-length wave decodes
        # from snr ~10.5 and needs ~2x the demo's t_max to traverse the
        # coupling chain (measured: snr 10.5 SER 0.18 at t_max=25 vs
        # 2e-4 at 60) — points span fail/transition/near-clean/clean
        params = SparcParams(P=15.0, R=1.4, L=1024, M=32,
                             spatially_coupled=True, omega=2, Lambda=8)
        snrs = [8.5, 9.5, 10.5, 12.0]
        t_max = args.t_max or 60
        np_trials = args.np_trials or 200
        artifact = "oracle_parity_sc.json"
    elif args.family == "pa":
        # demo cell 6 config; points from docs/artifacts/pa_sweep.json
        # (gradual finite-length waterfall: SER 0.21 -> 5e-4)
        params = SparcParams(P=15.0, R=1.4, L=1024, M=32,
                             power_allocated=True, B=32, R_PA_ratio=0.9)
        snrs = [8.0, 9.0, 10.0, 12.0]
        t_max = args.t_max or 25
        np_trials = args.np_trials or 200
        artifact = "oracle_parity_pa.json"
    elif args.family in ("modulated", "modulated_dft"):
        # demo cell 14 config (K=4 complex). NOTE a deliberate design
        # divergence in this family: the reference's complex engine is a
        # subsampled DFT (sub_fft); this framework standardizes on the
        # real SRHT design applied to complex message vectors (matmul
        # transforms).
        # The two STRUCTURED ensembles agree in the error-floor region
        # but sit ~0.2-0.3 linear snr units apart on the waterfall cliff
        # (SRHT earlier; a dense iid-complex-Gaussian referee is worse
        # than both — see the gate's threshold-offset bound). Points
        # therefore span the cliff AND the floor.
        params = SparcParams(P=15.0, R=2.6, L=2048, M=8, modulated=True,
                             K=4, is_complex=True)
        snrs = [6.0, 6.5, 7.0, 7.5, 8.0, 9.0, 10.0]
        t_max = args.t_max or 25
        np_trials = args.np_trials or 96
        artifact = "oracle_parity_mod.json"
        if args.family == "modulated_dft":
            # SAME-ENSEMBLE closing loop: the JAX side uses DftDesign —
            # the reference's exact subsampled-DFT ensemble — so parity
            # with the NumPy FFT oracle must be TIGHT at every point,
            # including the cliff where the SRHT ensemble diverges.
            engine = "dft"
            artifact = "oracle_parity_mod_dft.json"
    decode = DecodeParams(t_max=t_max)
    bits_per_sec = params.sec_size  # logM + logK

    jax_trials = args.jax_trials
    if args.quick:
        snrs = snrs[:1] + snrs[-1:]
        np_trials, jax_trials = 8, 64

    points = []
    t0 = time.perf_counter()
    for i, snr in enumerate(snrs):
        var = float(params.P / snr)
        tj0 = time.perf_counter()
        js, jb, ji = run_jax_point(params, decode, var, jax_trials,
                                   seed0=400 + i, engine=engine)
        tj = time.perf_counter() - tj0
        tn0 = time.perf_counter()
        if args.family == "plain":
            ns, nb, ni = run_numpy_point(
                params.L, params.M, params.P, params.R, var, t_max,
                np_trials, seed=8000 + i)
        elif args.family == "sc":
            ns, nb, ni = run_numpy_sc_point(
                params.L, params.M, params.P, params.R, params.omega,
                params.Lambda, var, t_max, np_trials, seed=8000 + i)
        elif args.family == "pa":
            ns, nb, ni = run_numpy_pa_point(
                params.L, params.M, params.P, params.R, params.B,
                params.R_PA_ratio, var, t_max, np_trials, seed=8000 + i)
        else:
            ns, nb, ni = run_numpy_mod_point(
                params.L, params.M, params.P, params.R, params.K, var,
                t_max, np_trials, seed=8000 + i)
        tn = time.perf_counter() - tn0
        jrow = summarize(js, jb, ji, params.L, bits_per_sec)
        nrow = summarize(ns, nb, ni, params.L, bits_per_sec)
        # frame-level Welch sigma of the SER difference
        sig = float(np.sqrt(jrow["frame_ser_std"] ** 2 / jrow["trials"] +
                            nrow["frame_ser_std"] ** 2 / nrow["trials"]))
        points.append({"snr": snr, "awgn_var": var,
                       "jax": jrow, "numpy": nrow,
                       "ser_diff": abs(jrow["ser"] - nrow["ser"]),
                       "ser_sigma": sig,
                       "jax_wall_s": round(tj, 1),
                       "numpy_wall_s": round(tn, 1)})
        print(json.dumps({"snr": snr, "jax_ser": jrow["ser"],
                          "np_ser": nrow["ser"], "sigma": sig}), flush=True)

    cfg = {"P": params.P, "R": params.R, "L": params.L,
           "M": params.M, "t_max": t_max}
    if params.spatially_coupled:
        cfg.update(spatially_coupled=True, omega=params.omega,
                   Lambda=params.Lambda)
    if params.power_allocated:
        cfg.update(power_allocated=True, B=params.B,
                   R_PA_ratio=params.R_PA_ratio)
    if params.modulated:
        cfg.update(modulated=True, K=params.K, is_complex=True)
    cfg["jax_engine"] = engine
    out = {"device": device_record(),
           "config": cfg,
           "oracle": "independent NumPy float64 subsampled-DCT AMP "
                     "(benchmarks/oracle_parity.py)",
           "wall_s": round(time.perf_counter() - t0, 1),
           "quick": bool(args.quick),
           "points": points}
    path = os.path.join(ART, artifact)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"artifact": path, "wall_s": out["wall_s"]}))


if __name__ == "__main__":
    main()
