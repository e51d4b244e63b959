"""Fixed-order segment sums (ops/segments.py) against jax.ops.segment_sum."""

import numpy as np
import jax
import jax.numpy as jnp

from ldpc_sparc_tpu.ops.segments import segment_table, table_sum


def test_table_sum_equals_sequential_segment_sum():
    """Same sums, bit for bit, as the sequential scatter-add on the CPU,
    including an empty segment and uneven segment sizes."""
    rng = np.random.default_rng(0)
    ids = np.array([3, 0, 3, 1, 3, 0, 4, 1, 3])
    data = jnp.asarray(rng.standard_normal((ids.size, 5, 2)), jnp.float32)
    table = segment_table(ids, 6)
    assert table.shape == (6, 4)
    assert table[2].tolist() == [-1, -1, -1, -1]
    assert table[3].tolist() == [0, 2, 4, 8]
    np.testing.assert_array_equal(
        np.asarray(table_sum(data, table)),
        np.asarray(jax.ops.segment_sum(data, jnp.asarray(ids),
                                       num_segments=6)))


def test_table_sum_with_traced_table():
    """A traced table (one per shard under shard_map) gives the same sums
    as the NumPy one."""
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 4, 12)
    data = jnp.asarray(rng.standard_normal((12, 3)), jnp.float32)
    table = segment_table(ids, 4)
    traced = jax.jit(table_sum)(data, jnp.asarray(table))
    np.testing.assert_array_equal(np.asarray(traced),
                                  np.asarray(table_sum(data, table)))
