"""The GPU smoke script's device gate, its last line, and the float64
references its phases compare against (chip_smoke.py)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(jax.devices())
    assert exc.value.code not in (0, None)


def test_last_line_schema():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.last_line(dev)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


@pytest.mark.parametrize("shape", ["plain", "concat"])
def test_srht_reference_matches_design(shape):
    """srht_ref (float64) reproduces SparcDesign.ab/az for one-block
    designs with the full window (offset 0) and the skip-row-0 window."""
    from ldpc_sparc_tpu.ops.transforms import SparcDesign
    L, M, n = (16, 32, 96) if shape == "plain" else (24, 2, 24)
    d = SparcDesign.build(np.array([[4.0]]), L, M, n, seed=2)
    assert d.offset == (0 if shape == "plain" else 1)
    rng = np.random.default_rng(0)
    beta = rng.standard_normal((2, d.LM)).astype(np.float32)
    z = rng.standard_normal((2, d.n)).astype(np.float32)
    np.testing.assert_allclose(chip_smoke.srht_ref(d, beta, adjoint=False),
                               np.asarray(d.ab(jnp.asarray(beta))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(chip_smoke.srht_ref(d, z, adjoint=True),
                               np.asarray(d.az(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-5)


def test_dft_reference_matches_design():
    from ldpc_sparc_tpu.config import SparcParams
    from ldpc_sparc_tpu.ops.transforms import DftDesign
    p = SparcParams(P=15.0, R=2.6, L=64, M=8, modulated=True, K=4,
                    is_complex=True)
    d = DftDesign.for_params(p, 1.0, seed=1)
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((2, d.LM)) +
         1j * rng.standard_normal((2, d.LM))).astype(np.complex64)
    z = (rng.standard_normal((2, d.n)) +
         1j * rng.standard_normal((2, d.n))).astype(np.complex64)
    assert chip_smoke.relerr(d.ab(jnp.asarray(v)),
                             chip_smoke.dft_ref(d, v, adjoint=False)) < 1e-5
    assert chip_smoke.relerr(d.az(jnp.asarray(z)),
                             chip_smoke.dft_ref(d, z, adjoint=True)) < 1e-5


def test_compare_with_oracle_splits_limit_words():
    """Converged words are held to decisions and iterations; words the
    oracle runs to the limit are listed apart, whatever the decode did."""
    app_ref = np.array([[1.0, -2.0], [3.0, 4.0], [-1.0, 1.0], [2.0, 2.0]])
    it_ref = np.array([3, 100, 100, 0])
    app = np.array([[0.5, -1.0], [3.0, 4.0], [1.0, 1.0], [2.0, -0.1]])
    it = np.array([3, 100, 40, 1])
    got = chip_smoke.compare_with_oracle(app, it, app_ref, it_ref, 100)
    assert got == {"oracle_converged_words": 2,
                   "decision_mismatch_words": 1,
                   "iteration_mismatch_words": 1,
                   "max_iteration_diff": 1,
                   "oracle_limit_words": [1, 2],
                   "limit_words_also_at_limit": 1,
                   "limit_words_decided_differently": [2]}


def test_bp_case_matches_the_xla_decode_and_oracle_on_converged_words():
    """The smoke's BP comparison at a small code on the CPU: every word the
    oracle converges on gets its decisions and iteration count."""
    from ldpc_sparc_tpu.models.ldpc import get_code
    code = get_code("802.16", "1/2", 24)
    xs, llr = chip_smoke.bp_case(code, 24, 1.5, n=24)
    assert xs.shape == llr.shape == (24, code.N)
    res = code.decode(jnp.asarray(llr, jnp.float32), 50, "sumprod2")
    app_ref, it_ref = chip_smoke.oracle_decode(code, llr, 50, "sumprod2")
    got = chip_smoke.compare_with_oracle(
        np.asarray(res.app), np.asarray(res.iterations), app_ref, it_ref, 50)
    assert got["oracle_converged_words"] > 12
    assert got["decision_mismatch_words"] == 0
    assert got["iteration_mismatch_words"] == 0
