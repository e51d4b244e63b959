"""Profiling / tracing utilities.

Counterpart of the reference's profiling harness (SURVEY.md
section 5): the cProfile driver (ldpc_jossy/py/profile_ldpc.py), kernprof
decorators (sparc_sophie/testing/timing_*.py) and the notebooks'
per-trial `time.perf_counter` prints. Here:

  * `timed(fn)` — wall-clock with device sync (block_until_ready), the
    per-trial metric the baselines are quoted in (BASELINE.md)
  * `trace(path)` — context manager around jax.profiler for full XLA traces
    viewable in TensorBoard/Perfetto
  * `flops_estimate` — speed-of-light reference numbers for the two hot
    kernels (Hadamard products and BP iterations)
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Tuple

import jax


def timed(fn: Callable, *args, reps: int = 1, warmup: int = 1, **kw):
    """Run fn reps times with device sync; returns (last_result, sec/rep)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / reps


@contextlib.contextmanager
def trace(path: str = "/tmp/jax-trace"):
    """XLA profiler trace: `with trace('/tmp/t'): run()` then inspect in
    TensorBoard (`tensorboard --logdir /tmp/t`) or Perfetto."""
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


def fwht_width(L: int, M: int, n: int,
               base_shape: Tuple[int, int] = (1, 1)) -> int:
    """Transform width w the design engine picks — mirrors
    SparcDesign.build (ops/transforms.py) for any base-matrix shape
    (Lr, Lc), incl. PA (1, B) and SC (Lambda+omega-1, Lambda) designs:
    per-block sides are Mr = n/Lr, Mc = L*M/Lc; the full window [0, w)
    when the larger side is already a power of two, else next_pow2(large+1)
    with the skip-row-0 offset-1 window."""
    Lr, Lc = base_shape
    large = max(n // Lr, (L * M) // Lc)
    if large & (large - 1) == 0:
        return large
    return 1 << large.bit_length()


def amp_iteration_flops(L: int, M: int, n: int,
                        max_log_factor: int | None = None,
                        base_shape: Tuple[int, int] = (1, 1),
                        n_blocks: int | None = None) -> int:
    """FLOPs of one AMP iteration through the factored Hadamard design:
    per nonzero base-matrix block, two FWHTs of width w, each a Kronecker
    chain of dense factor matmuls costing sum_i (w * f_i) MACs =
    2 * w * sum(factors) FLOPs, plus the O(L*M) denoiser (exp/sum/div
    ~= 10 ops per entry).

    base_shape: the base-matrix (Lr, Lc); n_blocks: number of NONZERO
    blocks (for band-diagonal SC matrices pass the design's actual count,
    len(design.rows); defaults to Lr*Lc, exact for plain/PA/dense W)."""
    from ..ops.wht import _factorize, get_fwht_options
    w = fwht_width(L, M, n, base_shape)
    if n_blocks is None:
        n_blocks = base_shape[0] * base_shape[1]
    if max_log_factor is None:
        max_log_factor = get_fwht_options()[0]
    factors = _factorize(w.bit_length() - 1, max_log_factor)
    fwht = 2 * w * sum(factors)  # MACs * 2
    return 2 * n_blocks * fwht + 10 * L * M


def amp_iteration_hbm_bytes(L: int, M: int, n: int,
                            max_log_factor: int | None = None,
                            itemsize: int = 4,
                            base_shape: Tuple[int, int] = (1, 1),
                            n_blocks: int | None = None) -> int:
    """Minimum device-memory traffic of one AMP iteration, assuming each
    Kronecker matmul stage reads + writes the full w-state once per nonzero
    block (XLA fuses the scatter/gather/scale elementwise chain into the
    neighboring matmuls) plus one read/write of the L*M state for the
    denoiser: the denominator of a memory-roofline estimate.
    base_shape/n_blocks as in amp_iteration_flops."""
    from ..ops.wht import _factorize, get_fwht_options
    w = fwht_width(L, M, n, base_shape)
    if n_blocks is None:
        n_blocks = base_shape[0] * base_shape[1]
    if max_log_factor is None:
        max_log_factor = get_fwht_options()[0]
    stages = len(_factorize(w.bit_length() - 1, max_log_factor))
    per_transform = 2 * stages * w * itemsize     # read + write per stage
    return 2 * n_blocks * per_transform + 2 * L * M * itemsize


def bp_iteration_flops(E: int, z: int, dc_max: int, Mp: int) -> int:
    """Elementwise-op count of one BP iteration in the z-structured layout
    (variable sums + 3*(dc-2) Lxor evaluations per check row)."""
    var_ops = 4 * E * z
    lxor_ops = 12  # min/sign/two log1p-exp per Lxor
    chk_ops = Mp * z * 3 * dc_max * lxor_ops
    return var_ops + chk_ops
