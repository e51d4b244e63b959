"""State evolution (SE): deterministic AMP performance predictor.

Port of sparc_public/sparc_se.py:82-183, vectorized: the Monte-Carlo
expectation `sparc_se_E` is computed fully vectorized over
(mc_samples, M) Gaussian samples drawn once and reused across iterations
(as the reference does, sparc_se.py:154-157), and across column blocks in
one batched evaluation instead of the reference's per-block Python loop
(sparc_se.py:179-180).

The fixed-point iteration itself is a host-side Python loop (t_max is tiny
and each step launches one fused device computation); early stopping on
allclose(tau, tau_prev) matches sparc_se.py:169-174.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SparcParams, create_base_matrix
from ..utils.bits import psk_constel


def se_expectation(tau: jnp.ndarray, K: int, u: jnp.ndarray) -> jnp.ndarray:
    """E[<beta, eta(beta + sqrt(tau) Z)>] via Monte Carlo, batched over tau.

    tau : (T,) effective noise variances (one per column block)
    u   : (mc, M) standard normal samples (complex for K > 2)

    Returns (T,) expectations. Specializations match sparc_se_E
    (sparc_public/sparc_se.py:82-115); all K branches are max-shifted so the
    f32 exponentials never overflow (the reference ran f64, where 1/tau up
    to ~709 is safe; f32 overflows at ~89, reachable at high-SNR / low-tau
    modulated operating points).
    """
    tau = jnp.atleast_1d(tau)[:, None]          # (T, 1)
    itau = 1.0 / tau
    rtau = jnp.sqrt(itau)

    if K == 1:
        u0 = u[:, 0][None, :]                   # (1, mc)
        # exps ratio computed stably: divide top and bottom by exp(max)
        a = itau + rtau * u0                    # (T, mc)
        cT = (rtau[..., None] * u[None, :, 1:])  # (T, mc, M-1)
        m = jnp.maximum(a, cT.max(axis=-1))
        top = jnp.exp(a - m)
        bot = top + jnp.sum(jnp.exp(cT - m[..., None]), axis=-1)
        E = top / bot
    elif K == 2:
        u0 = u[:, 0][None, :]
        a = itau + rtau * u0
        cT = rtau[..., None] * u[None, :, 1:]
        m = jnp.maximum(jnp.abs(a), jnp.abs(cT).max(axis=-1))
        top = jnp.exp(a - m) - jnp.exp(-a - m)              # 2 sinh(a) e^-m
        both = jnp.exp(cT - m[..., None]) + jnp.exp(-cT - m[..., None])
        bot = jnp.exp(a - m) + jnp.exp(-a - m) + jnp.sum(both, axis=-1)
        E = top / bot
    elif K == 4:
        # max-shifted like the K<=2 branches: sinh/cosh overflow f32 at
        # argument ~89 (itau at low-tau / high-SNR operating points easily
        # exceeds that; the reference ran f64 where the limit is ~709).
        # Multiply top and bottom by e^{-m}: cosh(x)e^{-m} =
        # (e^{x-m}+e^{-x-m})/2 and the /2 cancels in the ratio.
        u0r, u0i = jnp.real(u[:, 0])[None, :], jnp.imag(u[:, 0])[None, :]
        a = itau + rtau * u0r                   # (T, mc)
        b0 = rtau * u0i                         # (T, mc)
        cr = rtau[..., None] * jnp.real(u[None, :, 1:])  # (T, mc, M-1)
        ci = rtau[..., None] * jnp.imag(u[None, :, 1:])
        m = jnp.maximum(jnp.maximum(jnp.abs(a), jnp.abs(b0)),
                        jnp.maximum(jnp.abs(cr).max(axis=-1),
                                    jnp.abs(ci).max(axis=-1)))
        top = jnp.exp(a - m) - jnp.exp(-a - m)              # 2 sinh(a) e^-m
        bot = (jnp.exp(a - m) + jnp.exp(-a - m) +
               jnp.exp(b0 - m) + jnp.exp(-b0 - m) +
               jnp.sum(jnp.exp(cr - m[..., None]) + jnp.exp(-cr - m[..., None]) +
                       jnp.exp(ci - m[..., None]) + jnp.exp(-ci - m[..., None]),
                       axis=-1))
        E = top / bot
    else:
        c = jnp.asarray(psk_constel(K))         # (K,)
        u0 = u[:, 0][None, :, None]             # (1, mc, 1)
        arg0 = jnp.real((itau[..., None] + rtau[..., None] * u0) *
                        jnp.conj(c))            # (T, mc, K)
        argC = jnp.real((rtau[..., None, None] * u[None, :, 1:, None]) *
                        jnp.conj(c))            # (T, mc, M-1, K)
        # shared max shift over both exponent families (cancels in the
        # ratio); without it e^{itau} overflows f32 at itau ~ 89
        m = jnp.maximum(arg0.max(axis=-1), argC.max(axis=(-1, -2)))
        tmpB = jnp.exp(arg0 - m[..., None])
        tmpA = jnp.real(c) * tmpB
        tmpC = jnp.exp(argC - m[..., None, None]).mean(axis=-1)
        expsA = tmpA.mean(axis=-1)
        expsB = tmpB.mean(axis=-1)
        E = expsA / (expsB + jnp.sum(tmpC, axis=-1))
    return E.mean(axis=-1)


def sparc_se(awgn_var: float, params: SparcParams, t_max: int,
             mc_samples: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """State evolution for SPARCs (sparc_public/sparc_se.py:117-183).

    Returns (psi, tau): psi is (t_max, Lc) NMSE trajectory, tau the final
    effective noise variances (usable for SER estimation).
    """
    W = np.asarray(create_base_matrix(params, awgn_var))
    Lr, Lc = W.shape
    P, R, M, K = params.P, params.R, params.M, params.K
    if params.is_complex:
        R = R / 2  # rate per dimension (sparc_se.py:142-143)

    key = jax.random.key(seed)
    if K > 2:
        # complex samples with unit-variance real and imaginary parts
        kr, ki = jax.random.split(key)
        u = jax.lax.complex(jax.random.normal(kr, (mc_samples, M)),
                            jax.random.normal(ki, (mc_samples, M)))
    else:
        u = jax.random.normal(key, (mc_samples, M))

    Wj = jnp.asarray(W, jnp.float32)
    logKM = np.log(K * M)
    psi = np.ones((t_max, Lc))
    tau = None
    expect = jax.jit(lambda t: se_expectation(t, K, u))
    # W matvecs at HIGHEST: no TF32 rounding of the float32 statistics
    hi = jax.lax.Precision.HIGHEST
    for t in range(t_max - 1):
        tau_prev = tau
        phi = awgn_var + jnp.matmul(
            Wj, jnp.asarray(psi[t], jnp.float32), precision=hi) / Lc
        tau = (np.log(2) * R * Lr / logKM) / jnp.matmul(
            Wj.T, 1.0 / phi, precision=hi)
        tau = np.asarray(tau)
        if tau_prev is not None and np.allclose(tau, tau_prev, rtol=1e-6, atol=0):
            psi[t:] = psi[t]
            break
        psi[t + 1] = 1.0 - np.asarray(expect(jnp.asarray(tau, jnp.float32)))
    if tau is None:
        # t_max == 1: no iteration ran; still return the tau implied by the
        # initial psi so SER estimation downstream never sees None
        phi = awgn_var + jnp.matmul(
            Wj, jnp.asarray(psi[0], jnp.float32), precision=hi) / Lc
        tau = np.asarray((np.log(2) * R * Lr / logKM) / jnp.matmul(
            Wj.T, 1.0 / phi, precision=hi))
    return psi, tau
