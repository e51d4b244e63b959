"""Smoke test of the main simulation paths on the GPU.

Each phase drives the package's normal entry points at a published width
(BASELINE.md) and compares what comes out with a plain float64 reference.
It prints one JSON line with its name, its result, the tolerance it held
and its seconds (smoke timings, not benchmark numbers). The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

and appears only when every phase passed. Without a GPU the script exits
non-zero before any phase. Everything runs in this one process: a second
JAX process on the card would fail for want of device memory.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: only the ('dp','sec')
                                        # mesh paths, each against one card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TOL_TRANSFORM = 1e-5    # relative L2 error of the float32 transforms
TOL_DENOISER = 1e-5     # absolute error of the posterior probabilities

# Published widths (BASELINE.md); module constants so that a rehearsal on
# the CPU can shrink them.
FLAGSHIP = dict(P=15.0, R=1.0, L=1024, M=512)
SC_WAVE = dict(P=15.0, R=1.5, L=2048, M=512, spatially_coupled=True,
               omega=6, Lambda=32)
MODULATED = dict(P=15.0, R=2.6, L=2048, M=8, modulated=True, K=4,
                 is_complex=True)
FLAGSHIP_TRIALS = 256
CONCAT_Z = 150
# (standard, rate, z, snr_db): near each code's waterfall, where a few of
# the BP_WORDS codewords run to the iteration limit
BP_CASES = (("802.11n", "1/2", 27, 2.5), ("802.11n", "5/6", 81, 5.5))
BP_WORDS = 128
BP_MAX_ITERS = 100
CAMPAIGN_CODE = ("802.16", "1/2", "27", "A")
CAMPAIGN_BATCH = 512


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def require_gpu(devices) -> dict:
    """The device record for the last line; SystemExit when JAX's first
    device is not a GPU (there is no CPU fallback)."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU; JAX found {d.platform!r} "
                         f"devices")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def relerr(got, want) -> float:
    got = np.asarray(got, np.complex128 if np.iscomplexobj(got)
                     else np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------------------------
# plain float64 references
# --------------------------------------------------------------------------

def fwht_f64(x: np.ndarray) -> np.ndarray:
    """Butterfly Walsh-Hadamard transform (Sylvester order) along the last
    axis, in float64."""
    x = np.array(x, np.float64)
    w = x.shape[-1]
    lead = x.shape[:-1]
    h = 1
    while h < w:
        y = x.reshape(lead + (w // (2 * h), 2, h))
        a, b = y[..., 0, :], y[..., 1, :]
        x = np.stack([a + b, a - b], axis=-2).reshape(lead + (w,))
        h *= 2
    return x


def srht_ref(design, beta: np.ndarray, adjoint: bool) -> np.ndarray:
    """A @ beta (or A.T @ z) of a one-block SRHT design (plain W), float64."""
    check(design.E == 1 and not design.tall,
          "the reference covers one wide block")
    idx = np.asarray(design.idx[0])
    signs = np.asarray(design.signs[0], np.float64)
    scale = float(design.scale[0])
    w, off = design.w, design.offset
    X = np.zeros((beta.shape[0], w))
    if adjoint:          # scatter on the index side, window out
        X[:, idx] = beta * scale
        return fwht_f64(X)[:, off:off + design.Mc] * signs
    X[:, off:off + design.Mc] = beta * signs
    return fwht_f64(X)[:, idx] * scale


def dft_ref(design, v: np.ndarray, adjoint: bool) -> np.ndarray:
    """A @ beta (or A^H @ z) of a subsampled-DFT design, complex128."""
    rows, cols = np.asarray(design.rows), np.asarray(design.cols)
    X = np.zeros((v.shape[0], design.w), np.complex128)
    if adjoint:
        X[:, rows] = v
        return design.scale * np.conj(np.fft.fft(np.conj(X)))[:, cols]
    X[:, cols] = v
    return design.scale * np.fft.fft(X)[:, rows]


def softmax_ref(s: np.ndarray, inv_tau: float, M: int) -> np.ndarray:
    logits = np.asarray(s, np.float64).reshape(s.shape[0], -1, M) * inv_tau
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).reshape(s.shape)


# --------------------------------------------------------------------------
# one-card phases
# --------------------------------------------------------------------------

def concat_config():
    """The bench's z=150 integrated config (802.16 1/2 z=150, mults=4,
    logM=1, R=1; the reference's performance_plots_general.py:26-47)."""
    from ldpc_sparc_tpu.config import (SparcParams, LdpcParams,
                                       DecodeParams, param_calc)
    from ldpc_sparc_tpu.models.ldpc import get_code
    cl = LdpcParams(standard="802.16", rate="1/2", z=CONCAT_Z, ptype="A")
    code = get_code("802.16", "1/2", CONCAT_Z)
    _, _, L_ldpc, lengths = param_calc(4, 1, cl, cl.rate_float, 1.0, code.K)
    csp = SparcParams(P=19.44, R=1.0, L=L_ldpc, M=2)
    return csp, cl, lengths, DecodeParams(t_max=25)


def phase_transforms():
    """FWHT, both SRHT directions and the subsampled DFT against float64
    NumPy at real widths; every float32 matmul runs at HIGHEST."""
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams
    from ldpc_sparc_tpu.models.concat import ConcatCodec
    from ldpc_sparc_tpu.ops.transforms import SparcDesign, DftDesign
    from ldpc_sparc_tpu.ops.wht import fwht

    rng = np.random.default_rng(0)
    out = {"precision": "HIGHEST", "tolerance_relerr": TOL_TRANSFORM}
    flagship = SparcDesign.for_params(SparcParams(**FLAGSHIP), 1.0, seed=0)
    x = rng.standard_normal((4, flagship.w)).astype(np.float32)
    out[f"fwht_w{flagship.w}"] = relerr(fwht(jnp.asarray(x)), fwht_f64(x))

    csp, cl, lengths, _ = concat_config()
    concat = ConcatCodec(csp, cl, lengths, True).build_design(0)
    for name, d in (("flagship", flagship), ("concat", concat)):
        beta = rng.standard_normal((4, d.LM)).astype(np.float32)
        z = rng.standard_normal((4, d.n)).astype(np.float32)
        out[f"ab_{name}_w{d.w}_off{d.offset}"] = relerr(
            d.ab(jnp.asarray(beta)), srht_ref(d, beta, adjoint=False))
        out[f"az_{name}_w{d.w}_off{d.offset}"] = relerr(
            d.az(jnp.asarray(z)), srht_ref(d, z, adjoint=True))

    dft = DftDesign.for_params(SparcParams(**MODULATED), 1.0, seed=0)
    v = (rng.standard_normal((4, dft.LM)) +
         1j * rng.standard_normal((4, dft.LM))).astype(np.complex64)
    zc = (rng.standard_normal((4, dft.n)) +
          1j * rng.standard_normal((4, dft.n))).astype(np.complex64)
    out["dft_ab_modulated"] = relerr(dft.ab(jnp.asarray(v)),
                                     dft_ref(dft, v, adjoint=False))
    out["dft_az_modulated"] = relerr(dft.az(jnp.asarray(zc)),
                                     dft_ref(dft, zc, adjoint=True))
    for k, e in out.items():
        if k not in ("precision", "tolerance_relerr"):
            check(e <= TOL_TRANSFORM, f"{k}: relative error {e}")
    return out


def phase_denoiser():
    """mmse_denoise (per-section softmax) at L=1024, M=512 against a float64
    NumPy softmax, and map_estimate against argmax."""
    import jax.numpy as jnp
    from ldpc_sparc_tpu.ops.denoiser import mmse_denoise, map_estimate
    L, M, tau = FLAGSHIP["L"], FLAGSHIP["M"], 0.5
    rng = np.random.default_rng(1)
    beta0 = np.zeros((4, L, M), np.float32)
    beta0[:, np.arange(L), rng.integers(0, M, L)] = 1.0
    s = (beta0.reshape(4, L * M) +
         np.sqrt(tau) * rng.standard_normal((4, L * M))).astype(np.float32)
    got = np.asarray(mmse_denoise(jnp.asarray(s), jnp.float32(1.0 / tau), M))
    err = float(np.max(np.abs(got - softmax_ref(s, 1.0 / tau, M))))
    check(err <= TOL_DENOISER, f"mmse_denoise: max abs error {err}")
    hard = np.asarray(map_estimate(jnp.asarray(s), M)).reshape(4, L, M)
    want = np.argmax(s.reshape(4, L, M), axis=-1)
    map_mismatch = int(np.sum(np.argmax(hard, axis=-1) != want))
    check(map_mismatch == 0, f"map_estimate: {map_mismatch} sections")
    return {"L": L, "M": M, "mmse_max_abs_err": err,
            "tolerance_abs": TOL_DENOISER, "map_mismatched_sections": 0}


def phase_ldpc_encode():
    """Generator-matmul encoder against a NumPy mod-2 product with the
    reference's parity chain, and zero syndromes; exact equality."""
    import jax.numpy as jnp
    from ldpc_sparc_tpu.models.ldpc import get_code
    out = {}
    rng = np.random.default_rng(2)
    for std, rate, z in (("802.11n", "1/2", 27), ("802.16", "1/2", CONCAT_Z)):
        code = get_code(std, rate, z)
        us = rng.integers(0, 2, (256, code.K))
        xs = np.asarray(code.encode(jnp.asarray(us)))
        gp = code.parity_chain(np.eye(code.K, dtype=np.int64))
        want = np.concatenate([us, (us @ gp) % 2], axis=1)
        bad = int(np.sum(xs != want))
        syn = int(np.count_nonzero((xs @ code.pcmat().T) % 2))
        check(bad == 0 and syn == 0,
              f"{std} {rate} z={z}: {bad} wrong bits, {syn} parity checks")
        out[f"{std}_{rate}_z{z}"] = {"words": 256, "wrong_bits": bad,
                                     "nonzero_syndromes": syn}
    return out


def bp_case(code, z: int, snr_db: float, n: int = BP_WORDS):
    """(codewords, float64 channel LLRs) of one BP_CASES entry: n random
    codewords, BPSK over AWGN at snr_db, drawn from a generator seeded by
    z."""
    import jax.numpy as jnp
    rng = np.random.default_rng(z)
    sigma2 = 1.0 / 10 ** (snr_db / 10)
    xs = np.asarray(code.encode(jnp.asarray(
        rng.integers(0, 2, (n, code.K)))))
    llr = 2.0 / sigma2 * ((1.0 - 2.0 * xs) +
                          rng.normal(0, np.sqrt(sigma2), xs.shape))
    return xs, llr


def oracle_decode(code, llr: np.ndarray, max_iters: int, dectype: str):
    """The C++ float64 oracle on every row of llr: (app, iterations)."""
    with ThreadPoolExecutor(min(16, os.cpu_count() or 1)) as ex:
        refs = list(ex.map(
            lambda l: code.decode_ref(l, max_iters, dectype), llr))
    return (np.stack([r[0] for r in refs]),
            np.array([r[1] for r in refs]))


def compare_with_oracle(app, it, app_ref, it_ref, max_iters: int) -> dict:
    """Word-by-word agreement of a BP decode with the oracle's.

    Words the oracle converges on (iterations < max_iters) are held to
    identical decisions and iteration counts. The words that run to the
    limit are counted apart: the oracle satisfies no parity there, and its
    last iterate is not a codeword."""
    conv = it_ref < max_iters
    dec = np.any((app < 0) != (app_ref < 0), axis=1)
    d_it = np.abs(np.asarray(it) - it_ref)
    return {"oracle_converged_words": int(conv.sum()),
            "decision_mismatch_words": int(np.sum(dec & conv)),
            "iteration_mismatch_words": int(np.sum((d_it > 0) & conv)),
            "max_iteration_diff": int(d_it[conv].max(initial=0)),
            "oracle_limit_words": np.flatnonzero(~conv).tolist(),
            "limit_words_also_at_limit": int(np.sum(
                ~conv & (np.asarray(it) >= max_iters))),
            "limit_words_decided_differently": np.flatnonzero(
                dec & ~conv).tolist()}


def phase_bp_oracle():
    """bp_decode against the C++ float64 oracle on 128 codewords per case,
    near each code's waterfall. On every word the oracle converges on, the
    decisions must be identical, and the iteration counts may differ by
    one on at most 1% of those words: the float32 decode and the float64
    oracle can meet the all-checks-satisfied test one iteration apart when
    a message sits at the edge of its sign. The words that run to the
    iteration limit are reported apart (PERF.md, open questions)."""
    import jax.numpy as jnp
    from ldpc_sparc_tpu.models.ldpc import get_code
    out = {}
    for std, rate, z, snr_db in BP_CASES:
        code = get_code(std, rate, z)
        xs, llr = bp_case(code, z, snr_db)
        for dectype in ("sumprod2", "minsum"):
            res = code.decode(jnp.asarray(llr, jnp.float32), BP_MAX_ITERS,
                              dectype)
            app_ref, it_ref = oracle_decode(code, llr, BP_MAX_ITERS, dectype)
            key = f"{std}_{rate}_z{z}_{dectype}"
            out[key] = cmp = {"snr_db": snr_db, "words": BP_WORDS,
                              "mean_oracle_iterations": float(it_ref.mean()),
                              **compare_with_oracle(
                                  np.asarray(res.app),
                                  np.asarray(res.iterations), app_ref,
                                  it_ref, BP_MAX_ITERS)}
            conv = cmp["oracle_converged_words"]
            check(conv >= 64, f"{key}: the oracle converged on only {conv} "
                  f"codewords; this point is below the waterfall")
            check(cmp["decision_mismatch_words"] == 0,
                  f"{key}: converged codewords decided differently {cmp}")
            check(cmp["max_iteration_diff"] <= 1 and
                  cmp["iteration_mismatch_words"] <= 0.01 * conv,
                  f"{key}: iteration mismatches {cmp}")
    return out


def phase_repeatability():
    """The fixed-order segment sums (ops/segments.py) give the same bits
    run after run: a BP batch (the campaign code, 512 words at 1.5 dB)
    decoded three times, and the SC decode-wave design's forward and
    adjoint products (several blocks per row and column) three times.
    With jax.ops.segment_sum (a scatter-add) the BP runs differ on the
    GPU."""
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.ops.transforms import SparcDesign
    std, rate, z, ptype = CAMPAIGN_CODE
    code = get_code(std, rate, int(z), ptype)
    _, llr = bp_case(code, int(z), 1.5, CAMPAIGN_BATCH)
    llr = jnp.asarray(llr, jnp.float32)
    runs = [code.decode(llr, 200, "sumprod2") for _ in range(3)]
    bp_same = all(np.array_equal(np.asarray(r.app), np.asarray(runs[0].app))
                  and np.array_equal(np.asarray(r.iterations),
                                     np.asarray(runs[0].iterations))
                  for r in runs[1:])
    d = SparcDesign.for_params(SparcParams(**SC_WAVE), 1.0, seed=0)
    rng = np.random.default_rng(4)
    beta = jnp.asarray(rng.standard_normal((4, d.LM)), jnp.float32)
    zz = jnp.asarray(rng.standard_normal((4, d.n)), jnp.float32)
    ab, az = jax.jit(d.ab), jax.jit(d.az)
    outs = [(np.asarray(ab(beta)), np.asarray(az(zz))) for _ in range(3)]
    sc_same = all(np.array_equal(o[0], outs[0][0]) and
                  np.array_equal(o[1], outs[0][1]) for o in outs[1:])
    check(bp_same, "BP decodes of one batch differ between runs")
    check(sc_same, "SC design products differ between runs")
    return {"bp_batch_runs_identical": bp_same,
            "bp_mean_iterations": float(np.mean(
                np.asarray(runs[0].iterations))),
            "sc_design_blocks": int(d.E),
            "sc_products_runs_identical": sc_same}


def phase_sparc():
    """sparc_mc_counts on the flagship (BER must be 0), the SC decode wave
    (BASELINE.md row 5: SER 0 in the reference) and the modulated complex
    code through the DFT engine (cuFFT)."""
    from ldpc_sparc_tpu.config import SparcParams, DecodeParams
    from ldpc_sparc_tpu.parallel.montecarlo import sparc_mc_counts
    out = {}
    c = sparc_mc_counts(SparcParams(**FLAGSHIP), DecodeParams(t_max=25),
                        1.0, seed=0, n_trials=FLAGSHIP_TRIALS)
    check(c["frames"] == FLAGSHIP_TRIALS and c["bit_errs"] == 0,
          f"flagship: {c['bit_errs']} bit errors in {c['frames']} frames")
    out["flagship"] = c
    c = sparc_mc_counts(SparcParams(**SC_WAVE), DecodeParams(t_max=40),
                        1.0, seed=1, n_trials=8)
    check(c["sec_errs"] <= 1e-3 * c["sections"],
          f"SC decode wave: {c['sec_errs']} section errors")
    out["sc_decode_wave"] = c
    c = sparc_mc_counts(SparcParams(**MODULATED), DecodeParams(t_max=25),
                        1.0, seed=2, n_trials=64, engine="dft")
    check(c["sec_errs"] <= 1e-3 * c["sections"],
          f"modulated DFT: {c['sec_errs']} section errors")
    out["modulated_dft"] = c
    return out


def phase_campaign():
    """The CLI's ldpc-campaign in this process (802.16 1/2 z=27 A, batch
    512), twice into fresh directories: results.txt and results.csv must
    be written, and the two runs' records must be identical (the
    determinism that resuming relies on)."""
    from ldpc_sparc_tpu import cli
    texts = []
    with tempfile.TemporaryDirectory() as tmp:
        for run in ("a", "b"):
            out = os.path.join(tmp, run)
            std, rate, z, ptype = CAMPAIGN_CODE
            recs = cli.main(["ldpc-campaign", "--standard", std,
                             "--rate", rate, "--z", z, "--ptype", ptype,
                             "--batch", str(CAMPAIGN_BATCH), "--points", "4",
                             "--out", out])
            for f in ("results.txt", "results.csv"):
                check(os.path.getsize(os.path.join(out, f)) > 0,
                      f"{f} not written")
            with open(os.path.join(out, "results.txt")) as f:
                texts.append(f.read())
    check(len(recs) == 4, f"{len(recs)} points")
    check(texts[0] == texts[1], "two runs gave different records")
    return {"points": len(recs), "identical_records": True,
            "records": [list(r) for r in recs]}


def phase_concat():
    """concat_mc_trial_errors at the z=150 integrated config (20 trials),
    and ConcatCodec.decode_batch (packed BP) against vmap(decode) per
    trial, bit for bit, for sequential, naive and integrated."""
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.models.concat import ConcatCodec
    from ldpc_sparc_tpu.models.sparc import awgn_channel
    from ldpc_sparc_tpu.parallel.montecarlo import concat_mc_trial_errors
    from ldpc_sparc_tpu.utils import rng as rngmod
    csp, cl, lengths, dp = concat_config()
    codec = ConcatCodec(csp, cl, lengths, True)
    errs = concat_mc_trial_errors(csp, cl, lengths, True, dp, csp.P / 3.8,
                                  (3, 0), 20, "integrated")
    check(errs.shape == (20,) and np.all(errs >= 0) and
          np.all(errs <= codec.user_bits_len), f"trial errors {errs}")
    out = {"integrated_snr3.8_trial_bit_errs": errs.tolist()}

    B, awgn_var = 8, csp.P / 3.3
    designs = [codec.build_design((5, d)) for d in range(B)]
    designs = designs[0].with_leaves(jnp.stack([d.idx for d in designs]),
                                     jnp.stack([d.signs for d in designs]))
    root = rngmod.root_key(5)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(jnp.arange(B))

    @jax.jit
    def transmit(keys, idx, signs):
        def tx(key, i, s):
            user_bits, _, beta0 = codec.encode_message(key)
            x = designs.with_leaves(i, s).ab(beta0 / codec.c_amp)
            return user_bits, awgn_channel(
                x, awgn_var, rngmod.derive(key, rngmod.CHANNEL))
        return jax.vmap(tx)(keys, idx, signs)

    user_bits, ys = transmit(keys, designs.idx, designs.signs)
    for decoder in ("sequential", "naive", "integrated"):
        packed = jax.jit(lambda ys, i, s: codec.decode_batch(
            ys, designs.with_leaves(i, s), dp, decoder))
        per_trial = jax.jit(lambda ys, i, s: jax.vmap(
            lambda y, ii, ss: codec.decode(
                y, designs.with_leaves(ii, ss), dp, decoder))(ys, i, s))
        got = np.asarray(packed(ys, designs.idx, designs.signs))
        ref = np.asarray(per_trial(ys, designs.idx, designs.signs))
        per = np.sum(got != np.asarray(user_bits), axis=1)
        check(np.array_equal(got, ref),
              f"{decoder}: packed decode differs from vmap(decode) in "
              f"{int(np.sum(got != ref))} bits")
        out[f"packed_eq_vmap_{decoder}_snr3.3"] = {
            "identical": True, "trial_bit_errs": per.tolist()}
    return out


# --------------------------------------------------------------------------
# four-card phases: each mesh path against its one-card result
# --------------------------------------------------------------------------

def phase_mesh_campaign(one, four_dp):
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.parallel.montecarlo import _ldpc_block_counts
    from ldpc_sparc_tpu.utils import rng as rngmod
    std, rate, z, ptype = CAMPAIGN_CODE
    code = get_code(std, rate, int(z), ptype)
    root = rngmod.root_key(11)
    args = (code, 1.5, root, 0, CAMPAIGN_BATCH, 200, "sumprod2")
    single = _ldpc_block_counts(*args, None)
    meshed = _ldpc_block_counts(*args, four_dp)
    check(single == meshed, f"(4,1) mesh {meshed} vs one card {single}")
    return {"snr_db": 1.5, "batch": CAMPAIGN_BATCH,
            "bit_errs_block_errs_iters": list(meshed), "equal": True}


def phase_mesh_sharded_sc(one, meshes):
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams, DecodeParams
    from ldpc_sparc_tpu.parallel.sharded import make_sharded_sim_step
    params, dec = SparcParams(**SC_WAVE), DecodeParams(t_max=40)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(3), i))(
        jnp.arange(4))
    ref, _ = make_sharded_sim_step(params, dec, 1.0, one, seed=0)
    want = ref(keys)
    out = {"one_card": want}
    for shape, mesh in meshes.items():
        step, _ = make_sharded_sim_step(params, dec, 1.0, mesh, seed=0)
        got = step(keys)
        out[shape] = got
        for k in ("bit_errs", "sec_errs", "frame_errs"):
            check(got[k] == want[k], f"{shape} {k}: {got} vs {want}")
    return out


def phase_mesh_dp(one, four_dp):
    """Operating points with errors in play: the concat integrated decoder
    at snr 3.3 and the flagship at its SE threshold (snr 3.875)."""
    from ldpc_sparc_tpu.config import SparcParams, DecodeParams
    from ldpc_sparc_tpu.parallel.montecarlo import (concat_mc_trial_errors,
                                                    sparc_mc_counts)
    csp, cl, lengths, dp = concat_config()
    meshes = (("one", one), ("dp4", four_dp))
    errs = {name: concat_mc_trial_errors(
        csp, cl, lengths, True, dp, csp.P / 3.3, (3, 0), 20, "integrated",
        mesh=mesh) for name, mesh in meshes}
    check(np.array_equal(errs["one"], errs["dp4"]),
          f"concat per-trial errors differ: {errs}")
    params = SparcParams(**FLAGSHIP)
    counts = {name: sparc_mc_counts(
        params, DecodeParams(t_max=25), params.P / 3.875, seed=0,
        n_trials=FLAGSHIP_TRIALS, mesh=mesh) for name, mesh in meshes}
    check(counts["one"] == counts["dp4"],
          f"flagship counts differ: {counts}")
    return {"concat_integrated_snr3.3_trial_bit_errs": errs["dp4"].tolist(),
            "flagship_snr3.875_counts": counts["dp4"], "equal": True}


# --------------------------------------------------------------------------

def run_phase(name, fn, *args) -> bool:
    t0 = time.perf_counter()
    try:
        result = fn(*args)
    except Exception as e:  # reported, then the run fails at the end
        traceback.print_exc()
        emit(phase=name, ok=False, seconds=round(time.perf_counter() - t0, 3),
             error=repr(e))
        return False
    emit(phase=name, ok=True, seconds=round(time.perf_counter() - t0, 3),
         result=result)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths on four GPUs")
    args = ap.parse_args(argv)

    import jax
    device = require_gpu(jax.devices())
    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    from ldpc_sparc_tpu.utils.device import nvidia_smi_name_power
    cache = enable_persistent_cache()
    smi = nvidia_smi_name_power()
    check(smi, "nvidia-smi not found")
    print(smi, flush=True)
    emit(phase="header", nvidia_smi=smi, jax=jax.__version__,
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache,
         device=device)

    if args.four_cards:
        check(device["count"] == 4, f"{device['count']} GPUs, need 4")
        from ldpc_sparc_tpu.parallel.mesh import make_mesh
        one = make_mesh(dp=1, sec=1)
        phases = [
            ("mesh_campaign_batch_4x1", phase_mesh_campaign, one,
             make_mesh(dp=4, sec=1)),
            ("mesh_sharded_sc_amp", phase_mesh_sharded_sc, one,
             {"1x4": make_mesh(dp=1, sec=4), "2x2": make_mesh(dp=2, sec=2)}),
            ("mesh_dp4_concat_and_sparc", phase_mesh_dp, one,
             make_mesh(dp=4, sec=1)),
        ]
    else:
        phases = [
            ("transforms", phase_transforms),
            ("denoiser", phase_denoiser),
            ("ldpc_encode", phase_ldpc_encode),
            ("bp_vs_oracle", phase_bp_oracle),
            ("repeatability", phase_repeatability),
            ("sparc", phase_sparc),
            ("ldpc_campaign_cli", phase_campaign),
            ("concat", phase_concat),
        ]
    ok = [run_phase(name, fn, *a) for name, fn, *a in phases]
    if not all(ok):
        return 1
    print(last_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
