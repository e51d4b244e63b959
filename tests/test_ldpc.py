"""LDPC code-library acceptance tests.

Ports the reference's 36-config pytest suite (ldpc_jossy/py/test_ldpc.py:5-73)
as the acceptance gate: structural invariants of the prepared graph, encoder
zero-syndrome over random info words, and the noiseless-channel decode fixed
point (0 iterations, exact recovery) — for the JAX kernel, the C++ oracle,
and (unlike the reference, where it was broken upstream) minsum too.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from ldpc_sparc_tpu.config import LdpcParams
from ldpc_sparc_tpu.models.ldpc import LdpcCode, get_code

ALL_CONFIGS = [
    ("802.16", "1/2", 3, "A"), ("802.16", "2/3", 3, "A"),
    ("802.16", "2/3", 3, "B"), ("802.16", "3/4", 3, "A"),
    ("802.16", "3/4", 3, "B"), ("802.16", "5/6", 3, "A"),
    ("802.16", "1/2", 27, "A"), ("802.16", "2/3", 27, "A"),
    ("802.16", "2/3", 27, "B"), ("802.16", "3/4", 27, "A"),
    ("802.16", "3/4", 27, "B"), ("802.16", "5/6", 27, "A"),
    ("802.16", "1/2", 54, "A"), ("802.16", "2/3", 54, "A"),
    ("802.16", "2/3", 54, "B"), ("802.16", "3/4", 54, "A"),
    ("802.16", "3/4", 54, "B"), ("802.16", "5/6", 54, "A"),
    ("802.16", "1/2", 81, "A"), ("802.16", "2/3", 81, "A"),
    ("802.16", "2/3", 81, "B"), ("802.16", "3/4", 81, "A"),
    ("802.16", "3/4", 81, "B"), ("802.16", "5/6", 81, "A"),
    ("802.11n", "1/2", 27, "A"), ("802.11n", "2/3", 27, "A"),
    ("802.11n", "3/4", 27, "A"), ("802.11n", "5/6", 27, "A"),
    ("802.11n", "1/2", 54, "A"), ("802.11n", "2/3", 54, "A"),
    ("802.11n", "3/4", 54, "A"), ("802.11n", "5/6", 54, "A"),
    ("802.11n", "1/2", 81, "A"), ("802.11n", "2/3", 81, "A"),
    ("802.11n", "3/4", 81, "A"), ("802.11n", "5/6", 81, "A"),
]


@pytest.mark.parametrize("standard,rate,z,ptype", ALL_CONFIGS)
def test_structure_encode_noiseless_decode(standard, rate, z, ptype):
    code = get_code(standard, rate, z, ptype)
    assert code.proto.shape[1] == 24
    H = code.pcmat()
    assert np.sum(code.vdeg) == np.sum(code.cdeg) == np.sum(H) == len(code.intrlv)
    # interleaver is a permutation
    assert np.array_equal(np.sort(code.intrlv), np.arange(code.Nmsg))

    rng = np.random.default_rng(hash((standard, rate, z, ptype)) % 2**32)
    # the reference's depth: 100 random codewords per config
    # (ldpc_jossy/py/test_ldpc.py:56-69); encode is vmapped and the
    # noiseless decode is one batched call, so this is nearly free
    n_words = 100
    us = rng.integers(0, 2, (n_words, code.K))
    xs = np.asarray(code.encode(jnp.asarray(us)))
    # zero syndrome for every codeword
    assert np.count_nonzero((xs @ H.T) % 2) == 0
    # noiseless-channel decode fixed point: 0 iterations, exact recovery —
    # for sumprod2 AND minsum (the reference comments minsum out because its
    # C kernel is broken upstream, test_ldpc.py:70-73; ours is fixed)
    ys = 10.0 * (0.5 - xs)
    for method in ("sumprod2", "minsum"):
        res = code.decode(jnp.asarray(ys, jnp.float32), 200, method)
        assert np.all(np.asarray(res.iterations) == 0), method
        assert np.array_equal(np.asarray(res.app) < 0, xs.astype(bool)), method
    # oracle agrees on one codeword
    app_ref, it_ref = code.decode_ref(ys[0], 200, "sumprod")
    assert it_ref == 0
    assert np.array_equal(app_ref < 0, xs[0].astype(bool))


@pytest.mark.parametrize("standard,rate,z,ptype", [
    ("802.11n", "1/2", 27, "A"), ("802.16", "5/6", 54, "A"),
    ("802.16", "2/3", 81, "B"), ("802.16", "1/2", 150, "A"),
])
def test_encode_matmul_matches_parity_chain(standard, rate, z, ptype):
    """The generator-matmul encoder is bit-identical to the reference's
    dual-diagonal super-symbol chain (ldpc.py:400-460) — incl. the z=150
    concat-production code."""
    code = get_code(standard, rate, z, ptype)
    rng = np.random.default_rng(7)
    us = rng.integers(0, 2, (32, code.K))
    xs = np.asarray(code.encode(jnp.asarray(us)))
    assert np.array_equal(xs[:, :code.K], us)
    assert np.array_equal(xs[:, code.K:], code.parity_chain(us))
    # 1-D input keeps the unbatched API
    x1 = np.asarray(code.encode(jnp.asarray(us[0])))
    assert np.array_equal(x1, xs[0])


@pytest.mark.parametrize("dectype", ["sumprod", "sumprod2", "minsum"])
def test_jax_matches_oracle_noisy(dectype):
    """On noisy AWGN inputs the JAX kernel reproduces the oracle's decisions
    and iteration counts (float32 vs float64 — decisions must agree)."""
    code = get_code("802.11n", "1/2", 27)
    rng = np.random.default_rng(0)
    sigma2 = 1.0 / 10 ** (2.0 / 10)  # 2 dB
    for trial in range(5):
        u = rng.integers(0, 2, code.K)
        x = np.asarray(code.encode(jnp.asarray(u)))
        y = (1.0 - 2.0 * x) + rng.normal(0, np.sqrt(sigma2), code.N)
        llr = 2.0 / sigma2 * y
        app_ref, it_ref = code.decode_ref(llr, 60, dectype)
        method = "minsum" if dectype == "minsum" else "sumprod"
        res = code.decode(jnp.asarray(llr, jnp.float32), 60, method)
        assert int(res.iterations) == it_ref
        agree = np.mean((np.asarray(res.app) < 0) == (app_ref < 0))
        assert agree == 1.0, f"trial {trial}: {agree}"


def test_lxor_lxfb_vs_oracle():
    from ldpc_sparc_tpu.native import oracle
    from ldpc_sparc_tpu.ops.bp import lxor, lxfb
    rng = np.random.default_rng(1)
    for correct in (0, 1):
        a, b = rng.normal(0, 4, 2)
        got = float(lxor(jnp.float32(a), jnp.float32(b), bool(correct)))
        want = oracle.lxor(a, b, correct)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        L = rng.normal(0, 4, 7)
        total_ref, ext_ref = oracle.lxfb(L, correct)
        ext, total = lxfb(jnp.asarray(L)[:, None], bool(correct))
        np.testing.assert_allclose(np.asarray(ext)[:, 0], ext_ref,
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(float(total[0]), total_ref,
                                   rtol=1e-5, atol=1e-7)


def test_bp_decode_trace_matches_decode():
    """The fixed-length traced decoder's final APP equals the while_loop
    decoder's (same iteration math, same parity-freeze semantics), and the
    per-iteration trajectory is monotone in recovered bits on easy inputs."""
    from ldpc_sparc_tpu.ops.bp import bp_decode, bp_decode_trace
    code = get_code("802.11n", "1/2", 27)
    rng = np.random.default_rng(5)
    sigma2 = 1.0 / 10 ** (2.5 / 10)
    B = 8
    us = rng.integers(0, 2, (B, code.K))
    xs = np.asarray(code.encode(jnp.asarray(us)))
    ys = (1.0 - 2.0 * xs) + rng.normal(0, np.sqrt(sigma2), xs.shape)
    llr = jnp.asarray(2.0 / sigma2 * ys, jnp.float32)
    n_it = 60
    res = bp_decode(llr, code.graph, max_iters=n_it, method="sumprod")
    traj, it = bp_decode_trace(llr, code.graph, n_it, method="sumprod")
    assert traj.shape == (n_it, B, code.N)
    np.testing.assert_array_equal(np.asarray(it), np.asarray(res.iterations))
    np.testing.assert_allclose(np.asarray(traj[-1]), np.asarray(res.app),
                               rtol=1e-5, atol=1e-5)
    # trajectory converges: last-iteration errors <= first-iteration errors
    errs = [np.sum((np.asarray(traj[j]) < 0) != xs.astype(bool))
            for j in (0, n_it - 1)]
    assert errs[1] <= errs[0]
    assert errs[1] == 0


def test_waterfall_sanity():
    """BER decreases with SNR and beats uncoded at moderate SNR
    (statistical-validation strategy of ldpc_jossy/README.md:133-137)."""
    code = get_code("802.11n", "1/2", 27)
    rng = np.random.default_rng(2)
    bers = []
    n_words = 24
    for snr_db in (1.0, 3.0):
        sigma2 = 1.0 / 10 ** (snr_db / 10)
        us = rng.integers(0, 2, (n_words, code.K))
        xs = np.asarray(code.encode(jnp.asarray(us)))
        ys = (1.0 - 2.0 * xs) + rng.normal(0, np.sqrt(sigma2), xs.shape)
        llrs = 2.0 / sigma2 * ys
        res = code.decode(jnp.asarray(llrs, jnp.float32), 60, "sumprod")
        bers.append(np.mean((np.asarray(res.app) < 0) != xs.astype(bool)))
    assert bers[1] < bers[0]
    assert bers[1] < 1e-3


def test_native_bp_selftest():
    """The standalone C++ kernel self-test (no Python in the loop once
    built): baked 802.16 z=81 codeword over a BSC, every check rule must
    fully correct — the reference's __DEBUG__ main (c_ldpc.c:404-449)."""
    from ldpc_sparc_tpu.native.tools import run_bp_selftest
    out = run_bp_selftest()
    assert "PASS" in out
    assert "FAIL" not in out


@pytest.mark.parametrize("standard,rate,z,dectype", [
    ("802.16", "1/2", 6, "sumprod2"),
    ("802.16", "5/6", 6, "minsum"),
])
def test_small_code_matches_oracle(standard, rate, z, dectype):
    """A small-z batch at 2.5 dB: decisions and iteration counts equal the
    C++ float64 oracle's for every codeword."""
    code = get_code(standard, rate, z)
    rng = np.random.default_rng(z)
    sigma2 = 1.0 / 10 ** (2.5 / 10)
    xs = np.asarray(code.encode(jnp.asarray(rng.integers(0, 2, (6, code.K)))))
    llr = 2.0 / sigma2 * ((1.0 - 2.0 * xs) +
                          rng.normal(0, np.sqrt(sigma2), xs.shape))
    res = code.decode(jnp.asarray(llr, jnp.float32), 15, dectype)
    for i in range(len(llr)):
        app_ref, it_ref = code.decode_ref(llr[i], 15, dectype)
        assert int(res.iterations[i]) == it_ref, i
        assert np.array_equal(np.asarray(res.app[i]) < 0, app_ref < 0), i


def test_noiseless_multidim_batch():
    """bp_decode keeps a (A, B, Nv) batch shape and decodes noiseless
    codewords in 0 iterations."""
    from ldpc_sparc_tpu.ops.bp import bp_decode
    code = get_code("802.16", "1/2", 6)
    us = np.random.default_rng(7).integers(0, 2, (6, code.K))
    xs = np.asarray(code.encode(jnp.asarray(us))).reshape(2, 3, code.N)
    r = bp_decode(jnp.asarray(10.0 * (0.5 - xs), jnp.float32), code.graph, 20)
    assert r.app.shape == (2, 3, code.N)
    assert r.iterations.shape == (2, 3)
    assert np.all(np.asarray(r.iterations) == 0)
    assert np.array_equal(np.asarray(r.app) < 0, xs.astype(bool))
