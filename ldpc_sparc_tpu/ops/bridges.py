"""AMP <-> BP probability bridges.

Closed-form vectorized redesign of the reference's per-(section, entry, bit)
Python loops (sparc_sophie/sparc_new.py:1118-1160, 1260-1279) and of the
integrated decoder's quadruple-loop Onsager derivative
(`differentiated_eta_calc` + `sub_term`, sparc_new.py:824-883 — the
documented L3 hot spot).

Everything reduces to matmuls with one fixed 0/1 mask:

    BIT0[q, k] = 1  iff bit k (MSB-first) of section index q is 0

which is exactly the S_k index-set family of `S_k_mapping`
(sparc_new.py:1140-1160): S_k = { q : BIT0[q, k] = 1 }.

  * section posteriors -> per-bit P(bit=0):      p0 = probs @ BIT0
  * per-bit P(bit=0)  -> section posteriors:     log-domain matmul with
    BIT0 / (1-BIT0) masks (stable where the reference multiplied raw
    probabilities in a loop)
  * the Onsager derivative of the BP-composed denoiser collapses to two
    (L,logM)x(logM,M) matmuls (derivation in `integrated_onsager_term`).

Every product here runs at `lax.Precision.HIGHEST`: the operands are
probabilities and log-probabilities that feed BP and the integrated
decoder's Onsager term, and TF32 (the GPU's default for float32 matmuls)
would round them to about 1e-3 relative.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def bit0_mask_np(M: int) -> np.ndarray:
    """(M, logM) mask: entry [q, k] is 1 iff bit k (MSB-first) of q is 0."""
    logM = M.bit_length() - 1
    q = np.arange(M)[:, None]
    k = np.arange(logM)[None, :]
    return ((q >> (logM - 1 - k)) & 1 == 0).astype(np.float32)


def s_k_mapping(M: int) -> list:
    """The reference's S_k index sets (sparc_new.py:1140-1160): for each bit
    position k, the section indices whose bit k is 0. Provided for API parity
    and tests; internally everything uses `bit0_mask_np`."""
    mask = bit0_mask_np(M)
    return [list(np.flatnonzero(mask[:, k])) for k in range(mask.shape[1])]


def section_probs_to_bit_probs(probs: jnp.ndarray, M: int) -> jnp.ndarray:
    """Section posterior probabilities -> per-bit P(bit = 0).

    probs: (..., L*M) posterior mass per section entry (rows sum to ~1).
    Returns (..., L*logM). Vectorizes `beta_estimate_to_bp_probs`
    (sparc_new.py:1118-1138): p0[l,k] = sum_{q in S_k} probs[l,q].
    """
    logM = M.bit_length() - 1
    L = probs.shape[-1] // M
    mask = jnp.asarray(bit0_mask_np(M))
    sec = probs.reshape(probs.shape[:-1] + (L, M))
    p0 = jnp.matmul(sec, mask, precision=_HI)
    return p0.reshape(probs.shape[:-1] + (L * logM,))


def bit_probs_to_section_probs(p0: jnp.ndarray, M: int,
                               eps: float = 1e-7) -> jnp.ndarray:
    """Per-bit P(bit=0) -> section posterior (product over bits).

    p0: (..., L*logM). Returns (..., L*M) with
    probs[l,q] = prod_k (BIT0[q,k] ? p0[l,k] : 1 - p0[l,k]),
    computed in log space (vectorizes `bp_output_to_beta_estimate`,
    sparc_new.py:1260-1279, whose raw-probability product underflows).

    eps is float32-safe (the reference's 1e-15 is below f32 resolution:
    1 - 1e-15 rounds to 1.0, producing log(0)).
    """
    logM = M.bit_length() - 1
    L = p0.shape[-1] // logM
    mask = jnp.asarray(bit0_mask_np(M))          # (M, logM)
    pb = jnp.clip(p0.reshape(p0.shape[:-1] + (L, logM)), eps, 1.0 - eps)
    log_p = jnp.log(pb)
    log_q = jnp.log1p(-pb)
    # log probs[l, q] = sum_k mask[q,k] log_p[l,k] + (1-mask[q,k]) log_q[l,k]
    logits = (jnp.matmul(log_p, mask.T, precision=_HI) +
              jnp.matmul(log_q, 1.0 - mask.T, precision=_HI))
    out = jnp.exp(logits)
    return out.reshape(p0.shape[:-1] + (L * M,))


def combine_posteriors(alpha: jnp.ndarray, gamma: jnp.ndarray,
                       M: int) -> jnp.ndarray:
    """Posterior *combination* (product + renormalize per section) instead of
    replacement (`update_using_bp_probs`, sparc_new.py:1030-1038).

    alpha, gamma: (..., L*M) section posteriors. Returns normalized product.
    """
    L = alpha.shape[-1] // M
    top = (alpha * gamma).reshape(alpha.shape[:-1] + (L, M))
    bot = jnp.sum(top, axis=-1, keepdims=True)
    out = top / jnp.maximum(bot, 1e-30)
    return out.reshape(alpha.shape)


def integrated_onsager_derivative(alpha: jnp.ndarray, vk: jnp.ndarray,
                                  vk0: jnp.ndarray, beta_probs: jnp.ndarray,
                                  tau_sqr: jnp.ndarray, M: int,
                                  c_amp: jnp.ndarray) -> jnp.ndarray:
    """Per-entry derivative sum d(eta)/ds for the integrated decoder's
    generalized Onsager term.

    Closed form of `differentiated_eta_calc` (sparc_new.py:824-841) with
    `sub_term` (sparc_new.py:871-883). With B = BIT0[q,k],
    A_k[l] = sum_{q in S_k} alpha[l,q] and D[l,k] = clip(vk0)(1-clip(vk0)):

      sub_term(l,k,q)  = (c/tau^2) * alpha[l,q] * (B[q,k] - A_k[l]) / D[l,k]
      weight(l,k,q)    = B[q,k] - vk[l,k]            (+(1-vk) if bit 0,
                                                      -vk     if bit 1)
      main[l,q]        = sum_k weight * sub_term
      d(eta)/ds[l,q]   = beta_probs[l,q] * main[l,q] * c
                         (beta in the reference carries amplitude c;
                          beta_probs here is the unit-amplitude posterior)

    The k-sum expands (B - vk)(B - A) = B(1 - vk - A) + vk*A  (B^2 = B since
    B is 0/1), so main = [(1-vk-A)/D] @ B^T + rowsum(vk*A/D) — two matmuls.

    alpha      : (..., L*M) unit-amplitude MMSE posterior (the reference's
                 weighted_alpha / sqrt(nP_l), sparc_new.py:714-715)
    vk         : (..., L*logM) BP output bit probabilities
    vk0        : (..., L*logM) BP input bit probabilities
    beta_probs : (..., L*M) unit-amplitude post-BP section estimate
    c_amp      : scalar sqrt(n*P/L)

    Returns (..., L*M): beta * main (the reference's return value divided by
    its amplitude convention — caller multiplies by c_amp to match).
    """
    logM = M.bit_length() - 1
    L = alpha.shape[-1] // M
    lead = alpha.shape[:-1]
    B = jnp.asarray(bit0_mask_np(M))                     # (M, logM)
    a = alpha.reshape(lead + (L, M))
    v = vk.reshape(lead + (L, logM))
    # f32-safe clip (the reference's 1e-10 bound, sparc_new.py:881,
    # rounds 1-eps to 1.0 in f32 making D exactly zero)
    v0 = jnp.clip(vk0.reshape(lead + (L, logM)), 1e-6, 1.0 - 1e-6)
    D = v0 * (1.0 - v0)
    A = jnp.matmul(a, B, precision=_HI)                  # (..., L, logM)
    term_b = jnp.matmul((1.0 - v - A) / D, B.T,
                        precision=_HI)                   # (..., L, M)
    term_c = jnp.sum(v * A / D, axis=-1, keepdims=True)  # (..., L, 1)
    main = (c_amp / tau_sqr) * a * (term_b + term_c)
    bp = beta_probs.reshape(lead + (L, M))
    return (bp * main).reshape(alpha.shape)
