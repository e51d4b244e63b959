"""FWHT kernel tests: exactness vs the dense Sylvester Hadamard matrix and
the algebraic properties the design operator relies on."""

import numpy as np
import jax.numpy as jnp
import pytest

from ldpc_sparc_tpu.ops.wht import fwht, _hadamard_np, _factorize


@pytest.mark.parametrize("w", [2, 8, 64, 256, 2048])
def test_fwht_matches_dense(w):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, w)).astype(np.float32)
    got = np.asarray(fwht(jnp.asarray(x)))
    want = x @ _hadamard_np(w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_fwht_involution():
    # H H = w I  =>  fwht(fwht(x)) == w * x
    w = 512
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, w)).astype(np.float32)
    y = np.asarray(fwht(fwht(jnp.asarray(x))))
    np.testing.assert_allclose(y, w * x, rtol=1e-4, atol=1e-2)


def test_fwht_complex():
    w = 128
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, w)) + 1j * rng.standard_normal((3, w))).astype(np.complex64)
    got = np.asarray(fwht(jnp.asarray(x)))
    want = x @ _hadamard_np(w)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_factorize():
    for mlf in (5, 7, 10):
        assert _factorize(0, mlf) == [1]
        for lw in (1, 3, 10, 11, 20, 21):
            fs = _factorize(lw, mlf)
            assert int(np.prod(fs)) == 1 << lw
            assert all(f <= 1 << mlf for f in fs)


@pytest.fixture
def max_log_factor():
    """Set the FWHT factorization for one test, restoring the default."""
    from ldpc_sparc_tpu.ops import wht
    prev = wht.get_fwht_options()[0]
    yield lambda mlf: wht.set_fwht_options(max_log_factor=mlf)
    wht.set_fwht_options(max_log_factor=prev if prev is not None else "auto")


def test_f64_butterfly_reference_matches_dense():
    """The float64 butterfly the GPU smoke compares against is the
    Sylvester Hadamard transform."""
    from chip_smoke import fwht_f64
    x = np.random.default_rng(3).standard_normal((2, 256))
    np.testing.assert_allclose(fwht_f64(x), x @ _hadamard_np(256),
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("log_w,mlf", [(10, 3), (10, 5), (13, 4), (13, 8),
                                       (16, 5), (16, 8)])
def test_fwht_pinned_precision_matches_f64(log_w, mlf, max_log_factor):
    """Every factorization of the Kronecker chain agrees with a float64
    butterfly to float32 accuracy (relative L2 error 1e-6)."""
    from chip_smoke import fwht_f64, relerr
    max_log_factor(mlf)
    x = np.random.default_rng(log_w).standard_normal(
        (3, 1 << log_w)).astype(np.float32)
    assert relerr(fwht(jnp.asarray(x)), fwht_f64(x)) <= 1e-6


def test_fwht_lowers_every_dot_at_highest_precision():
    """Each Kronecker stage asks for HIGHEST, so the GPU cannot run the
    float32 transform in TF32."""
    import jax
    hlo = jax.jit(fwht).lower(jnp.zeros((2, 1 << 12), jnp.float32)).as_text()
    dots = hlo.count("stablehlo.dot_general")
    assert dots == len(_factorize(12, None)) > 1
    assert hlo.count("precision = [HIGHEST, HIGHEST]") == dots
