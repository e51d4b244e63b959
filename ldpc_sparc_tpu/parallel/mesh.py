"""Device-mesh helpers.

The framework's two parallel axes (SURVEY.md section 2, parallelism table):

  dp  : independent Monte-Carlo trials (codewords) — the reference's
        grid-engine job fan-out (ldpc_jossy/py/ldpc_awgn.py:125-131)
  sec : SPARC section blocks — the spatially-coupled base matrix's column
        blocks, the natural tensor-parallel decomposition of the design
        matrix (sparc_public/sparc.py:831-875)

Multi-host: call `jax.distributed.initialize()` before building the mesh;
`jax.devices()` then spans all hosts. The mesh follows the algorithm alone:
`jax.make_mesh` over the visible devices, with no topology shaping (GPUs of
one host reach each other all to all over NVLink).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax


def make_mesh(dp: Optional[int] = None, sec: int = 1) -> jax.sharding.Mesh:
    """Build a ('dp', 'sec') mesh over all visible devices.

    dp defaults to n_devices // sec. sec must divide the device count.
    """
    n = len(jax.devices())
    if dp is None:
        assert n % sec == 0, f"sec={sec} must divide device count {n}"
        dp = n // sec
    assert dp * sec <= n, f"mesh {dp}x{sec} exceeds {n} devices"
    return jax.make_mesh((dp, sec), ("dp", "sec"),
                         devices=jax.devices()[:dp * sec])


def maybe_distributed_init():
    """Initialize multi-host JAX if launched under a multi-process runner
    (no-op for single-process)."""
    import os
    if "JAX_COORDINATOR_ADDRESS" in os.environ or \
            "COORDINATOR_ADDRESS" in os.environ:
        jax.distributed.initialize()
