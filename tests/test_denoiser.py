"""The section-wise MMSE denoiser against a float64 NumPy softmax."""

import numpy as np
import jax.numpy as jnp
import pytest

from ldpc_sparc_tpu.ops.denoiser import mmse_denoise


@pytest.mark.parametrize("L,M", [(8, 128), (4, 256)])
def test_mmse_denoise_matches_f64_softmax(L, M):
    """Per-section posterior means agree with a float64 softmax to 1e-6
    (absolute, on probabilities); so do the per-section energies
    sum_m p_m^2 and the AMP psi statistic of one column block,
    psi = 1 - (sum of the energies) / L (models/sparc.py:col_energy)."""
    from chip_smoke import softmax_ref
    rng = np.random.default_rng(L * M)
    tau = 0.3
    beta0 = np.zeros((2, L, M), np.float32)
    beta0[:, np.arange(L), rng.integers(0, M, L)] = 1.0
    s = (beta0.reshape(2, L * M) +
         np.sqrt(tau) * rng.standard_normal((2, L * M))).astype(np.float32)
    got = np.asarray(mmse_denoise(jnp.asarray(s), jnp.float32(1.0 / tau), M))
    want = softmax_ref(s, 1.0 / tau, M)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    energy = np.sum(got.reshape(2, L, M) ** 2, axis=-1)
    energy_ref = np.sum(want.reshape(2, L, M) ** 2, axis=-1)
    np.testing.assert_allclose(energy, energy_ref, rtol=1e-5, atol=1e-7)
    psi = 1.0 - np.sum(energy, axis=-1, dtype=np.float32) / L
    np.testing.assert_allclose(psi, 1.0 - energy_ref.sum(axis=-1) / L,
                               rtol=0, atol=1e-6)
    assert np.all(psi > 1e-3)        # a noisy point: psi is not trivially 0
