"""Independent-oracle parity: artifact gates + oracle unit tests.

SURVEY.md section 4 test-plan item (d), at full scale for ALL FOUR SPARC
code families: the committed artifacts docs/artifacts/oracle_parity*.json
record matched operating points measured by (a) the JAX framework on the
GPU (SRHT Hadamard design, f32) and (b) an independent NumPy float64 AMP over
the reference's own fast-transform engine family — seeded subsampled
DCT/FFT designs and the scalar / vector / 2-D base-matrix AMP branches,
re-derived from sparc_public/sparc.py:593-701, 800-877, 883-999 (not
ported). The gate checks frame-level 4-sigma agreement of SER and BER at
every point plus coverage conditions.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ART = Path(__file__).resolve().parent.parent / "docs" / "artifacts"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))


# --------------------------------------------------------------------------
# the oracles themselves must be working decoders — otherwise agreement
# with them proves nothing
# --------------------------------------------------------------------------

def test_numpy_oracle_is_a_working_decoder():
    from oracle_parity import numpy_dct_amp_trial
    rng = np.random.default_rng(3)
    sec, bits, t_final = numpy_dct_amp_trial(256, 32, 15.0, 1.3, 1.0, 25, rng)
    assert sec == 0 and bits == 0
    assert t_final < 24  # early stopping engaged
    # far above threshold (R > C): decoding must fail badly
    sec, _, _ = numpy_dct_amp_trial(256, 32, 15.0, 2.5, 4.0, 15, rng)
    assert sec > 0.3 * 256


def test_numpy_sc_oracle_is_a_working_decoder():
    from oracle_parity import numpy_sc_amp_trial
    rng = np.random.default_rng(1)
    sec, bits, _ = numpy_sc_amp_trial(256, 32, 15.0, 1.4, 2, 8, 1.0, 30, rng)
    assert sec == 0 and bits == 0
    sec, _, _ = numpy_sc_amp_trial(256, 32, 15.0, 1.4, 2, 8, 15.0 / 6.0,
                                   30, rng)
    assert sec > 0.2 * 256  # below the finite-length threshold: wave stalls


def test_numpy_pa_oracle_is_a_working_decoder():
    from oracle_parity import numpy_pa_amp_trial
    rng = np.random.default_rng(2)
    sec, bits, _ = numpy_pa_amp_trial(512, 32, 15.0, 1.4, 16, 0.9, 1.0,
                                      25, rng)
    assert sec == 0 and bits == 0
    sec, _, _ = numpy_pa_amp_trial(512, 32, 15.0, 1.4, 16, 0.9, 15.0 / 6.5,
                                   25, rng)
    assert sec > 0.1 * 512


def test_numpy_mod_oracle_is_a_working_decoder():
    from oracle_parity import numpy_mod_amp_trial
    rng = np.random.default_rng(4)
    sec, loc, val, bits, _ = numpy_mod_amp_trial(512, 8, 15.0, 2.6, 4,
                                                 1.0, 25, rng)
    assert sec == loc == val == bits == 0
    sec, loc, val, _, _ = numpy_mod_amp_trial(512, 8, 15.0, 2.6, 4,
                                              15.0 / 6.0, 25, rng)
    assert sec > 0.1 * 512
    assert max(loc, val) <= sec <= loc + val


# --------------------------------------------------------------------------
# artifact gates, one per family
# --------------------------------------------------------------------------

def _assert_jax_side_on_gpu(doc):
    """The JAX side ran on a GPU named by nvidia-smi (the NumPy side runs
    on the host whatever the device)."""
    dev = doc["device"]
    assert dev["platform"] == "gpu" and dev["nvidia_smi"], dev


FAMILIES = {
    "oracle_parity.json": dict(
        check=lambda c: (c["L"], c["M"], c["R"]) == (1024, 512, 1.0),
        jax_min=500, np_min=100),
    "oracle_parity_sc.json": dict(
        check=lambda c: c.get("spatially_coupled")
        and (c["L"], c["M"], c["omega"], c["Lambda"]) == (1024, 32, 2, 8),
        jax_min=500, np_min=100),
    "oracle_parity_pa.json": dict(
        check=lambda c: c.get("power_allocated")
        and (c["L"], c["M"], c["B"]) == (1024, 32, 32)
        and abs(c["R_PA_ratio"] - 0.9) < 1e-9,
        jax_min=500, np_min=100),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_oracle_parity_artifact(name):
    """Frame-level 4-sigma SER and BER agreement at every point, real
    errors exercised on both engines, and a sub-1% operating point."""
    path = ART / name
    if not path.exists():
        pytest.skip(f"{name} not present")
    fam = FAMILIES[name]
    doc = json.loads(path.read_text())
    _assert_jax_side_on_gpu(doc)
    assert fam["check"](doc["config"]), doc["config"]
    assert not doc.get("quick", False)
    points = doc["points"]
    assert len(points) >= 3
    nonzero_both = 0
    for p in points:
        j, n = p["jax"], p["numpy"]
        assert j["trials"] >= fam["jax_min"]
        assert n["trials"] >= fam["np_min"], "oracle side must be CI-bearing"
        sig_ser = np.sqrt(j["frame_ser_std"] ** 2 / j["trials"] +
                          n["frame_ser_std"] ** 2 / n["trials"])
        assert abs(j["ser"] - n["ser"]) <= max(4 * sig_ser, 2e-3), p
        sig_ber = np.sqrt(j["frame_ber_std"] ** 2 / j["trials"] +
                          n["frame_ber_std"] ** 2 / n["trials"])
        assert abs(j["ber"] - n["ber"]) <= max(4 * sig_ber, 2e-3), p
        if j["ser"] > 0 and n["ser"] > 0:
            nonzero_both += 1
    # real errors on both engines (not vacuous 0-vs-0 agreement) AND a
    # deep sub-1% operating point
    assert nonzero_both >= 2
    assert min(p["jax"]["ser"] for p in points) < 0.01
    assert max(p["jax"]["ser"] for p in points) > 0.05


MOD_PARITY = ART / "oracle_parity_mod.json"


def _ser_crossing(points, side, level=0.05):
    """Log-linear interpolated snr where an engine's SER crosses `level`."""
    pts = sorted((p["snr"], max(p[side]["ser"], 1e-9)) for p in points)
    for (s0, e0), (s1, e1) in zip(pts, pts[1:]):
        if e0 >= level >= e1:
            f = (np.log10(e0) - np.log10(level)) / \
                (np.log10(e0) - np.log10(e1))
            return s0 + f * (s1 - s0)
    return None


@pytest.mark.skipif(not MOD_PARITY.exists(),
                    reason="modulated parity artifact not present")
def test_mod_oracle_parity_artifact():
    """The modulated family carries a DELIBERATE design divergence: the
    reference's complex engine is a subsampled DFT, ours the real SRHT
    applied to complex message vectors. The two structured
    ensembles genuinely differ on the waterfall cliff at L=2048 (a dense
    iid-complex-Gaussian referee is worse than both), so this gate pins
    (a) 4-sigma SER/BER agreement in the error-FLOOR region (snr >= 8),
    (b) both engines' SER=5% waterfall crossings within 0.5 linear snr
    units (~0.3 dB), and (c) full-coverage conditions."""
    doc = json.loads(MOD_PARITY.read_text())
    _assert_jax_side_on_gpu(doc)
    cfg = doc["config"]
    assert cfg.get("modulated") and \
        (cfg["L"], cfg["M"], cfg["K"], cfg["R"]) == (2048, 8, 4, 2.6)
    assert not doc.get("quick", False)
    points = doc["points"]
    assert len(points) >= 6
    floor = [p for p in points if p["snr"] >= 8.0]
    assert len(floor) >= 3
    for p in floor:
        j, n = p["jax"], p["numpy"]
        assert j["trials"] >= 500 and n["trials"] >= 90
        sig = np.sqrt(j["frame_ser_std"] ** 2 / j["trials"] +
                      n["frame_ser_std"] ** 2 / n["trials"])
        assert abs(j["ser"] - n["ser"]) <= max(4 * sig, 2e-3), p
        sigb = np.sqrt(j["frame_ber_std"] ** 2 / j["trials"] +
                       n["frame_ber_std"] ** 2 / n["trials"])
        assert abs(j["ber"] - n["ber"]) <= max(4 * sigb, 2e-3), p
    cj = _ser_crossing(points, "jax")
    cn = _ser_crossing(points, "numpy")
    assert cj is not None and cn is not None
    assert abs(cj - cn) <= 0.5, (cj, cn)
    assert max(p["jax"]["ser"] for p in points) > 0.05
    assert min(p["jax"]["ser"] for p in points) < 0.01


MOD_DFT_PARITY = ART / "oracle_parity_mod_dft.json"


@pytest.mark.skipif(not MOD_DFT_PARITY.exists(),
                    reason="DFT-ensemble parity artifact not present")
def test_mod_dft_same_ensemble_parity_is_tight():
    """The SAME-ENSEMBLE closing loop for the modulated family: with the
    JAX side on DftDesign (the reference's exact subsampled-DFT complex
    ensemble, ops/transforms.py) the NumPy FFT oracle must agree within
    4 frame-level sigma at EVERY point — including the waterfall cliff
    where the default SRHT ensemble shows its documented ~0.25-snr-unit
    offset. Together with test_mod_oracle_parity_artifact this pins that
    the cliff offset is an ENSEMBLE property, not a decoder defect."""
    doc = json.loads(MOD_DFT_PARITY.read_text())
    _assert_jax_side_on_gpu(doc)
    cfg = doc["config"]
    assert cfg.get("jax_engine") == "dft"
    assert (cfg["L"], cfg["M"], cfg["K"], cfg["R"]) == (2048, 8, 4, 2.6)
    assert not doc.get("quick", False)
    points = doc["points"]
    assert len(points) >= 6
    nonzero_both = 0
    for p in points:
        j, n = p["jax"], p["numpy"]
        assert j["trials"] >= 500 and n["trials"] >= 90
        sig = np.sqrt(j["frame_ser_std"] ** 2 / j["trials"] +
                      n["frame_ser_std"] ** 2 / n["trials"])
        assert abs(j["ser"] - n["ser"]) <= max(4 * sig, 2e-3), p
        sigb = np.sqrt(j["frame_ber_std"] ** 2 / j["trials"] +
                       n["frame_ber_std"] ** 2 / n["trials"])
        assert abs(j["ber"] - n["ber"]) <= max(4 * sigb, 2e-3), p
        if j["ser"] > 0 and n["ser"] > 0:
            nonzero_both += 1
    assert nonzero_both >= 3  # incl. cliff points
    assert max(p["jax"]["ser"] for p in points) > 0.05
    assert min(p["jax"]["ser"] for p in points) < 0.01
