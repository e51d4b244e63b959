"""Fast Walsh-Hadamard transform as a Kronecker chain of small matmuls.

The SPARC design matrix is a seeded row/column-subsampled Hadamard operator
(the design documented at sparc_public/sparc.py:703-728; the reference's
actual implementation substitutes scipy DCT/FFT, sparc_public/sparc.py:593-701
— statistically equivalent ensembles for AMP).

Instead of the O(w log w) butterfly, the transform uses the Kronecker
factorization

    H_w = H_a  (x)  H_b  (x)  ...   =>   FWHT = a chain of dense matmuls

so a w=2^19 transform is a short chain of (w/f, f) @ (f, f) matmuls. XLA
fuses the surrounding scatter/gather/scale elementwise ops into their
neighbours.

Precision: every stage asks for `lax.Precision.HIGHEST`. On the GPU a
float32 matmul at the default precision may run in TF32, which keeps about
10 mantissa bits of the activations; HIGHEST keeps float32. The +-1
factors are exact either way.

Tuning knobs:

  * max_log_factor — the largest Kronecker factor is 2^max_log_factor
    ("auto"/None picks 5 or 8 by transform width). Smaller factors mean
    fewer FLOPs (total = 2 * w * sum(factors)) but more passes over the
    array (memory traffic = passes * 2 * w * itemsize); larger factors
    trade FLOPs for fewer passes.
  * matmul_dtype — 'bfloat16' feeds bf16 inputs with float32 accumulation
    (preferred_element_type). Hadamard entries are +-1 (exact in bf16); only
    the activations are rounded (~2^-9 relative per pass).

All Hadamard factor matrices are Sylvester-ordered, symmetric, entries +-1.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp

# Defaults; override with set_fwht_options() or the environment variables
# LDPC_SPARC_WHT_MAX_LOG_FACTOR / LDPC_SPARC_WHT_DTYPE /
# LDPC_SPARC_WHT_STAGE_DTYPE (read at import).
# "auto" (None internally): pick the factorization by transform width
# (_auto_max_log_factor).
_MAX_LOG_FACTOR = os.environ.get("LDPC_SPARC_WHT_MAX_LOG_FACTOR", "auto")
_MAX_LOG_FACTOR = (None if _MAX_LOG_FACTOR == "auto"
                   else int(_MAX_LOG_FACTOR))
_MATMUL_DTYPE = os.environ.get("LDPC_SPARC_WHT_DTYPE", "float32")
_STAGE_DTYPE = os.environ.get("LDPC_SPARC_WHT_STAGE_DTYPE", "float32")


def set_fwht_options(max_log_factor: int | str | None = None,
                     matmul_dtype: str | None = None,
                     stage_dtype: str | None = None) -> None:
    """Set the FWHT tuning knobs process-wide.

    Call before tracing; already-jitted callers keep the factorization they
    were traced with (the knobs are trace-time constants).

    stage_dtype: dtype the INTER-STAGE intermediates are stored in (memory
    traffic), independent of matmul_dtype (the matmul input rounding).
    'bfloat16' halves the memory traffic of the Kronecker chain at ~2^-9
    relative rounding per stage.
    The final stage always accumulates/returns in the caller's dtype.
    """
    global _MAX_LOG_FACTOR, _MATMUL_DTYPE, _STAGE_DTYPE
    if max_log_factor is not None:
        if max_log_factor == "auto":
            _MAX_LOG_FACTOR = None
        else:
            assert 1 <= max_log_factor <= 13
            _MAX_LOG_FACTOR = int(max_log_factor)
    if matmul_dtype is not None:
        assert matmul_dtype in ("float32", "bfloat16")
        _MATMUL_DTYPE = matmul_dtype
    if stage_dtype is not None:
        assert stage_dtype in ("float32", "bfloat16")
        _STAGE_DTYPE = stage_dtype


def get_fwht_options() -> tuple[int | None, str, str]:
    """Current (max_log_factor, matmul_dtype, stage_dtype); the first
    slot is None while the width-aware auto default is active."""
    return _MAX_LOG_FACTOR, _MATMUL_DTYPE, _STAGE_DTYPE


@functools.lru_cache(maxsize=None)
def _hadamard_np(n: int) -> np.ndarray:
    """Sylvester-ordered n x n Hadamard matrix (n a power of two)."""
    assert n > 0 and (n & (n - 1)) == 0
    H = np.array([[1.0]], dtype=np.float32)
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return H


def hadamard_factor(n: int, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.asarray(_hadamard_np(n), dtype=dtype)


def _auto_max_log_factor(log_w: int) -> int:
    """Width-dependent default: small transforms prefer more 2^5 passes
    (better fusion with the scatter/gather around them), very large
    transforms prefer fewer, wider 2^8 passes (each pass re-streams the
    full w-state through device memory). The crossover between w=2^20 and
    w=2^21 is an inherited value, not yet measured on the GPU."""
    return 5 if log_w <= 20 else 8


def _factorize(log_w: int, max_log_factor: int | None) -> list[int]:
    """Split log2(w) into near-equal chunks of at most max_log_factor
    (None = the measured width-dependent auto default)."""
    if max_log_factor is None:
        max_log_factor = _auto_max_log_factor(log_w)
    if log_w == 0:
        return [1]
    k = -(-log_w // max_log_factor)  # ceil
    base, rem = divmod(log_w, k)
    logs = [base + (1 if i < rem else 0) for i in range(k)]
    return [1 << g for g in logs]


def fwht(x: jnp.ndarray) -> jnp.ndarray:
    """Walsh-Hadamard transform along the last axis (unnormalized, H H = w I).

    x: (..., w) with w a power of two. Complex inputs are handled by
    transforming real and imaginary parts (H is real), keeping the matmuls
    real.
    """
    w = x.shape[-1]
    assert w > 0 and (w & (w - 1)) == 0, "FWHT length must be a power of two"
    if jnp.iscomplexobj(x):
        return jax.lax.complex(fwht(jnp.real(x)), fwht(jnp.imag(x)))

    log_w = w.bit_length() - 1
    factors = _factorize(log_w, _MAX_LOG_FACTOR)
    out_dtype = x.dtype
    mm_dtype = jnp.bfloat16 if _MATMUL_DTYPE == "bfloat16" else out_dtype
    # inter-stage storage dtype: bf16 halves the chain's memory traffic
    # (each stage materializes the full w-state); the LAST stage always
    # lands in out_dtype so callers see full-precision accumulation
    st_dtype = jnp.bfloat16 if _STAGE_DTYPE == "bfloat16" else out_dtype
    batch = x.shape[:-1]
    y = x.reshape(batch + tuple(factors))
    nb = len(batch)
    for i, f in enumerate(factors):
        H = hadamard_factor(f, mm_dtype)
        axis = nb + i
        last = i == len(factors) - 1
        # contract factor axis with H (symmetric), put result back in place;
        # accumulation dtype = stage storage dtype (except the final stage);
        # HIGHEST: no TF32 rounding of float32 activations (module docstring)
        y = jnp.moveaxis(
            jnp.tensordot(y.astype(mm_dtype), H, axes=[[axis], [0]],
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=out_dtype if last
                          else st_dtype),
            -1, axis)
    return y.reshape(batch + (w,)).astype(out_dtype)


def fwht_matrix_row(w: int, r: int) -> np.ndarray:
    """Row r of the Sylvester Hadamard H_w without materializing H_w.

    H_w[r, c] = (-1)^{popcount(r & c)} — used by tests and by dense-oracle
    checks of the subsampled design operator.
    """
    c = np.arange(w, dtype=np.uint64)
    bits = np.bitwise_count(np.bitwise_and(np.uint64(r), c)) \
        if hasattr(np, "bitwise_count") else None
    if bits is None:
        v = np.bitwise_and(np.uint64(r), c)
        bits = np.zeros(w, dtype=np.int64)
        vv = v.astype(np.uint64)
        while np.any(vv):
            bits += (vv & 1).astype(np.int64)
            vv >>= np.uint64(1)
    return np.where(bits % 2 == 0, 1.0, -1.0)
