"""Design-operator tests: adjointness, power normalization, block structure."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ldpc_sparc_tpu.config import SparcParams, create_base_matrix
from ldpc_sparc_tpu.ops.transforms import SparcDesign
from ldpc_sparc_tpu.utils import bits as bitops


def _adjoint_check(design, rng):
    x = jnp.asarray(rng.standard_normal(design.LM).astype(np.float32))
    y = jnp.asarray(rng.standard_normal(design.n).astype(np.float32))
    lhs = float(jnp.vdot(design.ab(x), y))
    rhs = float(jnp.vdot(x, design.az(y)))
    np.testing.assert_allclose(lhs, rhs, rtol=2e-3)


@pytest.mark.parametrize("shape", ["plain", "pa", "sc"])
def test_adjoint(shape):
    rng = np.random.default_rng(0)
    if shape == "plain":
        W = np.array([[3.0]])
        L, M, n = 64, 16, 512
    elif shape == "pa":
        W = np.linspace(4.0, 1.0, 4)[None, :]
        L, M, n = 64, 16, 512
    else:
        p = SparcParams(P=2.0, R=1.0, L=64, M=16,
                        spatially_coupled=True, omega=2, Lambda=4)
        W = create_base_matrix(p, 1.0)
        L, M, n = 64, 16, 500  # 500 = 5 row blocks * 100
    d = SparcDesign.build(W, L, M, n, seed=3)
    _adjoint_check(d, rng)


def test_dense_matches_ops():
    """The materialized dense A agrees with ab/az and has the blockwise
    +-sqrt(W[r,c]/L) entry structure (sparc_public/sparc.py:703-728)."""
    W = np.array([[2.0, 0.0], [1.0, 3.0]])
    L, M, n = 8, 4, 8
    d = SparcDesign.build(W, L, M, n, seed=7)
    A = d.dense()
    rng = np.random.default_rng(1)
    x = rng.standard_normal(L * M).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(np.asarray(d.ab(jnp.asarray(x))), A @ x,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(d.az(jnp.asarray(y))), A.T @ y,
                               rtol=1e-4, atol=1e-4)
    # block (0,1) is zero in W -> its sub-block of A is zero
    Mr, Mc = n // 2, L * M // 2
    assert np.abs(A[:Mr, Mc:]).max() == 0
    # entries of nonzero blocks are +-sqrt(W[r,c]/L)
    blk = A[:Mr, :Mc]
    np.testing.assert_allclose(np.abs(blk), np.sqrt(W[0, 0] / L), rtol=1e-5)


def test_codeword_power():
    """E|x_i|^2 == P for a valid message vector (power constraint)."""
    p = SparcParams(P=15.0, R=1.5, L=256, M=32)
    d = SparcDesign.for_params(p, 1.0, seed=11)
    bits = bitops.random_bits(jax.random.key(0), p.bit_len)
    beta = bitops.bits_to_msg_vector(bits, p.M)
    x = np.asarray(d.ab(beta))
    power = np.mean(x ** 2)
    assert abs(power - p.P) / p.P < 0.15  # statistical, n = 2560/1.5


def test_batched_ab():
    W = np.array([[5.0]])
    d = SparcDesign.build(W, 16, 8, 64, seed=0)
    rng = np.random.default_rng(2)
    xs = jnp.asarray(rng.standard_normal((3, d.LM)).astype(np.float32))
    batched = np.asarray(d.ab(xs))
    single = np.stack([np.asarray(d.ab(xs[i])) for i in range(3)])
    np.testing.assert_allclose(batched, single, rtol=1e-5, atol=1e-5)


def test_dft_design_adjoint_and_ensemble():
    """DftDesign (the reference's exact complex sub_fft ensemble): adjoint
    exactness <A x, y> == <x, A^H y>, unit-modulus scaled entries, and
    index sets excluding the two real DFT rows (0 and w/2)."""
    import numpy as np
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams
    from ldpc_sparc_tpu.ops.transforms import DftDesign

    p = SparcParams(P=15.0, R=2.6, L=32, M=8, modulated=True, K=4,
                    is_complex=True)
    d = DftDesign.for_params(p, 1.0, seed=3)
    rng = np.random.default_rng(0)
    x = rng.normal(size=d.LM) + 1j * rng.normal(size=d.LM)
    y = rng.normal(size=d.n) + 1j * rng.normal(size=d.n)
    lhs = np.vdot(np.asarray(d.ab(jnp.asarray(x, jnp.complex64))), y)
    rhs = np.vdot(x, np.asarray(d.az(jnp.asarray(y, jnp.complex64)))).conj()
    assert abs(lhs - rhs.conj()) / abs(lhs) < 1e-5
    A = d.dense()
    # entries are unit-modulus scaled by sqrt(P/L)
    np.testing.assert_allclose(np.abs(A), np.sqrt(p.P / p.L), rtol=1e-4)
    rows = np.asarray(d.rows)
    assert 0 not in rows and d.w // 2 not in rows
    assert rows.size == d.n and np.asarray(d.cols).size == d.LM


def test_dft_design_decodes_through_amp():
    """The DFT engine plugs into the unchanged AMP decoder: exact decode
    at high SNR for the K=4 modulated family."""
    from ldpc_sparc_tpu.config import SparcParams, DecodeParams
    from ldpc_sparc_tpu.models.sparc import sparc_sim

    p = SparcParams(P=15.0, R=2.6, L=128, M=8, modulated=True, K=4,
                    is_complex=True)
    r = sparc_sim(p, DecodeParams(t_max=12), awgn_var=1.0, seed=1,
                  engine="dft")
    assert float(r["ber"]) == 0.0 and float(r["ser"]) == 0.0


def test_dft_design_with_leaves_roundtrip():
    """with_leaves mirrors SparcDesign's contract: replaced array leaves,
    carried static metadata — the external stack/select surface."""
    import numpy as np
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams
    from ldpc_sparc_tpu.ops.transforms import DftDesign

    p = SparcParams(P=15.0, R=2.6, L=32, M=8, modulated=True, K=4,
                    is_complex=True)
    a = DftDesign.for_params(p, 1.0, seed=1)
    b = DftDesign.for_params(p, 1.0, seed=2)
    c = a.with_leaves(b.rows, b.cols)
    assert (c.w, c.n, c.LM, c.scale) == (a.w, a.n, a.LM, a.scale)
    np.testing.assert_array_equal(np.asarray(c.rows), np.asarray(b.rows))
    x = jnp.ones(a.LM, jnp.complex64)
    np.testing.assert_allclose(np.asarray(jnp.real(c.ab(x))),
                               np.asarray(jnp.real(b.ab(x))), rtol=1e-6)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("idx_side_is_input", [False, True])
def test_srht_apply_matches_dense_operator(offset, idx_side_is_input):
    """srht_apply in both directions against the dense block built row by
    row from H_w[r, c] = (-1)^popcount(r & c): the gather-out product is
    scale * H[idx, offset:offset+large] * signs, the scatter-in product its
    transpose."""
    from ldpc_sparc_tpu.ops.transforms import (generate_block_randomness,
                                               srht_apply)
    from ldpc_sparc_tpu.ops.wht import fwht_matrix_row
    small = 24
    large, w = (256, 256) if offset == 0 else (200, 256)
    _, _, idx, signs = generate_block_randomness(
        np.array([[1.0, 0.0], [2.0, 1.0]]), small, large, w, seed=4,
        offset=offset)
    scale = np.array([0.5, 1.5, 2.0], np.float32)
    E = idx.shape[0]
    dense = np.stack([
        scale[e] * np.stack([fwht_matrix_row(w, int(r))[offset:offset + large]
                             for r in idx[e]]) * signs[e] for e in range(E)])
    rng = np.random.default_rng(offset)
    in_dim, out_dim = (small, large) if idx_side_is_input else (large, small)
    vals = rng.standard_normal((E, in_dim)).astype(np.float32)
    got = srht_apply(jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(signs),
                     w, in_dim, out_dim, idx_side_is_input, offset,
                     jnp.asarray(scale))
    op = np.swapaxes(dense, 1, 2) if idx_side_is_input else dense
    np.testing.assert_allclose(np.asarray(got),
                               np.einsum("eoi,ei->eo", op, vals),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("offset", [0, 1])
def test_block_indices_sorted_and_unique(offset):
    """srht_apply tells XLA its scatter/gather indices are sorted and
    unique; generate_block_randomness must keep that promise."""
    from ldpc_sparc_tpu.ops.transforms import generate_block_randomness
    W = np.ones((3, 4))
    for small, large, w in ((40, 256, 256), (255, 256, 256), (96, 300, 512)):
        if offset == 0 and large != w:
            continue
        _, _, idx, _ = generate_block_randomness(W, small, large, w, seed=1,
                                                 offset=offset)
        assert idx.shape == (12, small)
        assert np.all(np.diff(idx, axis=1) > 0)
        assert idx.min() >= (0 if offset == 0 else 1) and idx.max() < w
