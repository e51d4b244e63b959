"""Pure-SPARC codec: encoder, AWGN channel, and the AMP decoder.

Redesign of sparc_public/sparc.py:17-74 (encode/decode wrappers)
and sparc_public/sparc.py:883-999 (`sparc_amp`):

  * One unified code path for all base-matrix shapes. The reference branches
    on W.ndim in {0,1,2} throughout its AMP loop; here W is always (Lr, Lc)
    (plain SPARC = (1,1)) and the scalar/PA formulas fall out as the Lr=1
    special case of the spatially-coupled ones.
  * The iteration loop is a `lax.scan` with masked early stopping (the
    reference's data-dependent `break` at sparc.py:984-986 does not jit);
    converged state is frozen and carried to the end.
  * The denoiser is the float32-safe log-domain softmax (ops/denoiser.py).
  * Everything vmaps over a leading batch of codewords for Monte-Carlo.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SparcParams, DecodeParams, create_base_matrix
from ..ops.transforms import SparcDesign, DftDesign
from ..ops.denoiser import mmse_denoise, map_estimate
from ..utils import bits as bitops
from ..utils import rng as rngmod


def design_for_params(params, awgn_var, seed, engine: str = "srht"):
    """Design-engine selector. 'srht' (default): the real SRHT operator
    for every family. 'dft': the reference's exact complex
    subsampled-DFT ensemble (ops/transforms.DftDesign) — opt-in for
    complex codes where ensemble-exact reference behavior matters
    (the two differ ~0.25 snr units on the K=4 cliff,
    docs/artifacts/oracle_parity_mod.json). Both engines share the
    np.random.default_rng(seed) host-randomness convention (int or
    nested tuple of non-negative ints)."""
    assert engine in ("srht", "dft"), engine
    cls = DftDesign if engine == "dft" else SparcDesign
    return cls.for_params(params, awgn_var, seed)


# --------------------------------------------------------------------------
# Encoder / channel
# --------------------------------------------------------------------------

def sparc_encode(params: SparcParams, awgn_var: float, seed,
                 key: Optional[jax.Array] = None, engine: str = "srht"):
    """Encode a random message to a SPARC codeword.

    Mirrors `sparc_encode` (sparc_public/sparc.py:17-53): random bits ->
    message vector -> x = A @ beta0 through the seeded design
    (`engine`: 'srht' default, 'dft' for the reference's complex
    ensemble — see design_for_params).

    Returns (bits, beta0, x, design).
    """
    if key is None:
        key = rngmod.root_key(seed)
    bits = bitops.random_bits(rngmod.derive(key, rngmod.BITS), params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, params.M, params.K)
    design = design_for_params(params, awgn_var, seed, engine)
    x = design.ab(beta0)
    return bits, beta0, x, design


def awgn_channel(x: jnp.ndarray, awgn_var: float, key: jax.Array) -> jnp.ndarray:
    """AWGN channel; complex inputs get circular noise of total variance
    awgn_var (sparc_public/sparc_sim.py:179-204)."""
    if jnp.iscomplexobj(x):
        kr, ki = jax.random.split(key)
        noise = (jax.random.normal(kr, x.shape) +
                 1j * jax.random.normal(ki, x.shape)) * jnp.sqrt(awgn_var / 2)
    else:
        noise = jax.random.normal(key, x.shape) * jnp.sqrt(awgn_var)
    return x + noise


# --------------------------------------------------------------------------
# AMP decoder
# --------------------------------------------------------------------------

class AmpState(NamedTuple):
    beta: jnp.ndarray      # (LM,) current posterior-mean estimate
    z: jnp.ndarray         # (n,)  modified residual
    s: jnp.ndarray         # (LM,) effective observation
    phi: jnp.ndarray       # (Lr,) residual variance per row block
    psi: jnp.ndarray       # (Lc,) estimated NMSE per column block
    stopped: jnp.ndarray   # ()    convergence flag
    t_final: jnp.ndarray   # ()    iterations actually run


class AmpResult(NamedTuple):
    beta: jnp.ndarray        # hard-decision (MAP on s) message vector, unit amp
    beta_mmse: jnp.ndarray   # final posterior-mean estimate
    s: jnp.ndarray           # final effective observation
    t_final: jnp.ndarray     # number of AMP iterations performed
    nmse: jnp.ndarray        # (t_max, Lc) NMSE trajectory (vs beta0 if given)
    psi: jnp.ndarray         # (Lc,) final estimated NMSE


def amp_decode(y: jnp.ndarray, design: SparcDesign, params: SparcParams,
               decode: DecodeParams, awgn_var: float,
               beta0: Optional[jnp.ndarray] = None,
               W: Optional[jnp.ndarray] = None) -> AmpResult:
    """AMP decoding of a SPARC codeword (sparc_public/sparc.py:883-999).

    Per iteration (unified 2-D base-matrix form, Lr x Lc blocks):
        gamma = W @ psi / Lc                       residual var minus noise var
        z     = y - A beta + repeat(gamma/phi_prev, Mr) * z     (Onsager)
        phi   = awgn_var + gamma            (phi_est_method=1)
              | per-row-block mean |z|^2    (phi_est_method=2)
        tau_c = (L/Mr) / (W^T (1/phi))_c           effective noise variance
        s     = beta + repeat(tau, Mc) * A^T (z / repeat(phi, Mr))
        beta  = MMSE eta(s, tau)
        psi_c = 1 - sum|beta_c|^2 / (L/Lc)
    with masked early stopping on allclose(psi, psi_prev, rtol) and a final
    MAP hard decision on s (the reference's rationale at sparc.py:990-996).
    """
    if W is None:
        # building W host-side needs a concrete awgn_var (power allocation
        # runs a numpy fixed point); jitted callers pass W explicitly
        W = create_base_matrix(params, float(awgn_var))
    W = jnp.asarray(W, dtype=jnp.float32)
    Lr, Lc = W.shape
    L, M, K = params.L, params.M, params.K
    n, LM = design.n, design.LM
    Mr, Mc = n // Lr, LM // Lc
    t_max = decode.t_max
    sec_per_col = L // Lc
    atol = 2 * float(np.finfo(np.float32).resolution)

    cdtype = y.dtype if jnp.iscomplexobj(y) else jnp.float32
    beta_init = jnp.zeros(LM, dtype=cdtype)

    def rep_r(v):  # (Lr,) -> (n,): broadcast each row-block stat over Mr
        return jnp.broadcast_to(v[:, None], (Lr, Mr)).reshape(n)

    def rep_c(v):  # (Lc,) -> (LM,): broadcast each col-block stat over Mc
        return jnp.broadcast_to(v[:, None], (Lc, Mc)).reshape(LM)

    def col_energy(b):
        """sum |b|^2 per column block / (L/Lc)."""
        e = jnp.sum(jnp.abs(b).reshape(Lc, Mc) ** 2, axis=1)
        return e / sec_per_col

    # W matvecs at HIGHEST: no TF32 rounding of the float32 statistics
    hi = jax.lax.Precision.HIGHEST

    def iteration(state: AmpState, t) -> Tuple[AmpState, jnp.ndarray]:
        beta, z, s_prev, phi_prev, psi_prev = (state.beta, state.z, state.s,
                                               state.phi, state.psi)
        first = t == 0
        # (Lr,) ; psi=1 at t=0 reproduces init
        gamma = jnp.matmul(W, psi_prev, precision=hi) / Lc

        # Onsager-corrected residual (skipped at t=0 where z = y)
        b_coef = jnp.where(first, 0.0, gamma / jnp.where(first, 1.0, phi_prev))
        z_new = jnp.where(first, y, y - design.ab(beta) + rep_r(b_coef) * z)

        if decode.phi_est_method == 1:
            phi = awgn_var + gamma
        else:
            phi = jnp.mean(jnp.abs(z_new).reshape(Lr, Mr) ** 2, axis=1)

        tau = (L / Mr) / jnp.matmul(W.T, 1.0 / phi, precision=hi)  # (Lc,)
        azo = design.az(z_new / rep_r(phi).astype(z_new.dtype))
        s = beta + rep_c(tau) * azo
        beta_new = mmse_denoise(s, rep_c(1.0 / tau), M, K)
        psi = 1.0 - col_energy(beta_new)

        converged = jnp.logical_and(
            t > 0,
            jnp.all(jnp.abs(psi - psi_prev) <= atol + decode.rtol * jnp.abs(psi_prev)))

        # Freeze once stopped: keep previous state verbatim.
        stopped_before = state.stopped
        keep = lambda old, new: jnp.where(stopped_before, old, new)
        new_state = AmpState(
            beta=keep(beta, beta_new), z=keep(z, z_new), s=keep(s_prev, s),
            phi=keep(phi_prev, phi), psi=keep(psi_prev, psi),
            stopped=jnp.logical_or(stopped_before, converged),
            t_final=jnp.where(stopped_before, state.t_final, t + 1))

        if beta0 is not None:
            nmse_t = jnp.sum(jnp.abs(new_state.beta - beta0).reshape(Lc, Mc) ** 2,
                             axis=1) / sec_per_col
        else:
            nmse_t = new_state.psi
        return new_state, nmse_t

    init = AmpState(beta=beta_init, z=jnp.zeros_like(y), s=beta_init,
                    phi=jnp.ones(Lr, jnp.float32), psi=jnp.ones(Lc, jnp.float32),
                    stopped=jnp.asarray(False), t_final=jnp.asarray(0))
    # The reference runs t_max - 1 MMSE iterations then one MAP step
    # (sparc.py:931,997).
    final, nmse_traj = jax.lax.scan(iteration, init, jnp.arange(t_max - 1))
    nmse = jnp.concatenate([jnp.ones((1, Lc), nmse_traj.dtype), nmse_traj])

    beta_map = map_estimate(final.s, M, K)
    return AmpResult(beta=beta_map, beta_mmse=final.beta, s=final.s,
                     t_final=final.t_final, nmse=nmse, psi=final.psi)


def sparc_decode(y: jnp.ndarray, design: SparcDesign, params: SparcParams,
                 decode: DecodeParams, awgn_var: float,
                 beta0: Optional[jnp.ndarray] = None):
    """Decode wrapper (sparc_public/sparc.py:55-74): AMP + hard decision +
    bits conversion + frame-error detection flag."""
    res = amp_decode(y, design, params, decode, awgn_var, beta0)
    expect_err = jnp.mean(res.psi) >= 0.001  # sparc.py:66-68
    bits_out = bitops.msg_vector_to_bits(res.beta, params.M, params.K)
    return bits_out, res, expect_err


# --------------------------------------------------------------------------
# End-to-end simulation
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params", "decode"))
def _sim_core(key: jax.Array, design: SparcDesign, W: jnp.ndarray,
              params: SparcParams, decode: DecodeParams, awgn_var) -> dict:
    """Jitted end-to-end trial: bits -> beta0 -> x -> AWGN -> AMP -> metrics.

    One fused device program per (params, decode) pair.
    """
    from ..utils.metrics import (bit_error_rate, section_errors,
                                 location_value_errors)

    bits_in = bitops.random_bits(rngmod.derive(key, rngmod.BITS),
                                 params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits_in, params.M, params.K)
    x = design.ab(beta0)
    y = awgn_channel(x, awgn_var, rngmod.derive(key, rngmod.CHANNEL))
    res = amp_decode(y, design, params, decode, awgn_var, beta0, W)
    expect_err = jnp.mean(res.psi) >= 0.001  # sparc.py:66-68
    bits_out = bitops.msg_vector_to_bits(res.beta, params.M, params.K)

    ber = bit_error_rate(bits_in, bits_out)
    cer = (ber > 0).astype(jnp.float32)
    detect = (~jnp.logical_xor(ber > 0, expect_err)).astype(jnp.float32)
    results = {"ber": ber, "cer": cer, "t_final": res.t_final,
               "nmse": res.nmse, "detect": detect}
    if not params.modulated:
        err, ser = section_errors(beta0, res.beta, params.L)
        results.update({"ser": ser, "num_of_sec_errs": jnp.sum(err),
                        "_sec_err_ind": err})
    else:
        (ler, ver, ser), (loc_e, val_e, sec_e) = \
            location_value_errors(beta0, res.beta, params.L)
        results.update({"ser": ser, "ler": ler, "ver": ver,
                        "num_of_sec_errs": jnp.sum(sec_e),
                        "num_of_loc_errs": jnp.sum(loc_e),
                        "num_of_val_errs": jnp.sum(val_e),
                        "_sec_err_ind": sec_e, "_loc_err_ind": loc_e,
                        "_val_err_ind": val_e})
    return results


def sparc_sim(params: SparcParams, decode: DecodeParams, awgn_var: float,
              seed, engine: str = "srht") -> dict:
    """End-to-end single-trial simulation (sparc_public/sparc_sim.py:8-58).

    Returns the reference's metric dict: ber, cer, t_final, nmse, detect,
    section-error metrics, plus the error-location diagnostics
    (loc_of_sec_errs and, for modulated codes, loc_of_loc_errs /
    loc_of_val_errs — sparc_sim.py:30-51): index arrays of the sections
    that decoded wrong, used to study where PA/SC codes fail along the
    section axis. Inside jit these are fixed-size indicator arrays; here
    they are converted to the reference's index-array surface.
    """
    key = rngmod.root_key(seed)
    design = design_for_params(params, awgn_var, seed, engine)
    W = jnp.asarray(create_base_matrix(params, awgn_var), jnp.float32)
    results = dict(_sim_core(key, design, W, params, decode,
                             jnp.float32(awgn_var)))
    for ind, loc in (("_sec_err_ind", "loc_of_sec_errs"),
                     ("_loc_err_ind", "loc_of_loc_errs"),
                     ("_val_err_ind", "loc_of_val_errs")):
        if ind in results:
            results[loc] = np.flatnonzero(np.asarray(results.pop(ind)))
    return results
