"""Deterministic segment sums over a membership fixed when a program is built.

`jax.ops.segment_sum` lowers to a scatter-add. XLA's GPU scatter-add
accumulates with atomics, so the order in which float terms meet, and with
it the last bits of every sum, changes from run to run (on an H100 the same
BP batch decoded three times gave different APP bits, and a packed concat
decode differed from vmap(decode) in 107 bits). Every segment sum
in this package has a membership known before tracing (the Tanner graph's
edges, the design's nonzero blocks), so it is written instead as a gather of
each segment's members, padded to the largest segment and added in a fixed
order: ascending member index, the order in which a sequential scatter-add
adds them, so results on the CPU do not change.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def segment_table(segment_ids, num_segments: int) -> np.ndarray:
    """(num_segments, depth) int32 table of the indices i with
    segment_ids[i] == s, ascending along each row, padded with -1."""
    ids = np.asarray(segment_ids)
    members = [np.flatnonzero(ids == s) for s in range(num_segments)]
    depth = max(1, max(len(m) for m in members))
    table = np.full((num_segments, depth), -1, np.int32)
    for s, m in enumerate(members):
        table[s, :len(m)] = m
    return table


def table_sum(data: jnp.ndarray, table) -> jnp.ndarray:
    """out[s] = sum_k data[table[s, k]] over entries >= 0, added in k order.

    data: (E, ...). table: (S, D) integer table, a NumPy array or a traced
    one (a per-shard table under shard_map). Returns (S, ...)."""
    out = None
    for k in range(table.shape[1]):
        ids = table[:, k]
        if isinstance(ids, np.ndarray) and (ids >= 0).all():
            term = data[ids]
        else:
            valid = (ids >= 0).reshape((-1,) + (1,) * (data.ndim - 1))
            term = jnp.where(valid, data[jnp.maximum(ids, 0)],
                             jnp.zeros((), data.dtype))
        out = term if out is None else out + term
    return out
