"""Where float32 BP and the C++ float64 oracle part, word by word.

Case: the BP phase of chip_smoke.py for 802.11n rate 5/6 z=81 at 5.5 dB
(128 codewords, at most 100 iterations, sumprod2 and minsum), where a few
codewords run to the iteration limit. Each decode is run as

  * f32 and f64 on the default device (the GPU on a GPU machine),
  * f32 and f64 on the host CPU backend,
  * f32 on the CPU with every channel LLR moved one float32 ulp up, and
    one ulp down,

and compared with the oracle (float64, `native/bp_ref.cpp`): decisions and
iteration counts of every word. For the words the oracle runs to the limit,
the APP LLRs are followed iteration by iteration (the oracle rerun with
max_iters = 1..100) and the script reports the first iteration at which
each build's hard decisions leave the oracle's, and, between the two float32
builds, the first iteration at which their APPs differ at all. It also
measures the error of the sum-product correction log1p(exp(-x)) in float32
ulps on each backend against float64.

Writes <out> (JSON) and prints a one-line summary.
Usage: python benchmarks/bp_oracle_witness.py
           [--out results/bp_witness.json]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CASE = ("802.11n", "5/6", 81, 5.5)
MAX_ITERS = 100


def first_departure(traj, ref_traj):
    """First iteration (1-based) at which the hard decisions of traj leave
    those of ref_traj, or None. Both (T, N)."""
    diff = np.any((traj < 0) != (ref_traj < 0), axis=1)
    return int(np.argmax(diff)) + 1 if diff.any() else None


def first_difference(a, b):
    """First iteration (1-based) at which two (T, N) trajectories differ in
    any bit, or None."""
    diff = np.any(a != b, axis=1)
    return int(np.argmax(diff)) + 1 if diff.any() else None


def correction_ulps(device):
    """Max and mean |error| in float32 ulps of log1p(exp(-x)), x in
    [0, 40], computed in float32 on device, against float64."""
    import jax
    import jax.numpy as jnp
    x = np.linspace(0.0, 40.0, 400001).astype(np.float32)
    f = jax.jit(lambda v: jnp.log1p(jnp.exp(-v)))
    got = np.asarray(f(jax.device_put(x, device))).astype(np.float64)
    want = np.log1p(np.exp(-x.astype(np.float64)))
    ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
    err = np.abs(got - want) / ulp
    return {"max_ulps": float(err.max()), "mean_ulps": float(err.mean())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/bp_witness.json")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from chip_smoke import bp_case, oracle_decode, compare_with_oracle
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.ops.bp import bp_decode, bp_decode_trace
    from ldpc_sparc_tpu.utils.device import device_record

    std, rate, z, snr_db = CASE
    code = get_code(std, rate, z)
    _, llr = bp_case(code, z, snr_db)
    default, cpu = jax.devices()[0], jax.devices("cpu")[0]
    f32 = llr.astype(np.float32)
    builds = {f"{default.platform}_f32": (default, f32),
              f"{default.platform}_f64": (default, llr)}
    builds.update({"cpu_f32": (cpu, f32), "cpu_f64": (cpu, llr),
                   "cpu_f32_llr_up_1ulp": (
                       cpu, np.nextafter(f32, np.float32(np.inf))),
                   "cpu_f32_llr_down_1ulp": (
                       cpu, np.nextafter(f32, np.float32(-np.inf)))})
    out = {"device": device_record(),
           "case": {"code": f"{std} {rate} z={z}", "snr_db": snr_db,
                    "words": int(len(llr)), "max_iters": MAX_ITERS},
           "correction_ulps": {default.platform: correction_ulps(default),
                               "cpu": correction_ulps(cpu)}}
    for dectype in ("sumprod2", "minsum"):
        method = "minsum" if dectype == "minsum" else "sumprod"
        app_ref, it_ref = oracle_decode(code, llr, MAX_ITERS, dectype)
        limit = np.flatnonzero(it_ref >= MAX_ITERS)
        # the oracle's own trajectory on the limit words
        ref_traj = np.stack([np.stack([
            code.decode_ref(llr[w], t, dectype)[0]
            for t in range(1, MAX_ITERS + 1)]) for w in limit]) \
            if limit.size else None                      # (W, T, N)
        res, trajs = {}, {}
        for name, (dev, ch) in builds.items():
            r = bp_decode(jax.device_put(ch, dev), code.graph, MAX_ITERS,
                          method)
            cmp = compare_with_oracle(np.asarray(r.app),
                                      np.asarray(r.iterations),
                                      app_ref, it_ref, MAX_ITERS)
            if limit.size:
                tr, _ = bp_decode_trace(jax.device_put(ch[limit], dev),
                                        code.graph, MAX_ITERS, method)
                trajs[name] = np.moveaxis(np.asarray(tr), 0, 1)  # (W, T, N)
                cmp["first_departure_from_oracle"] = {
                    int(w): first_departure(trajs[name][i], ref_traj[i])
                    for i, w in enumerate(limit)}
                cmp["limit_words_bits_off_oracle_at_end"] = {
                    int(w): int(np.sum((trajs[name][i, -1] < 0) !=
                                       (ref_traj[i, -1] < 0)))
                    for i, w in enumerate(limit)}
            res[name] = cmp
        a, b = f"{default.platform}_f32", "cpu_f32"
        if limit.size and a != b:
            res["first_iteration_f32_builds_differ"] = {
                int(w): first_difference(trajs[a][i], trajs[b][i])
                for i, w in enumerate(limit)}
        out[dectype] = res
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({d: {k: (v["limit_words_decided_differently"]
                              if isinstance(v, dict) and
                              "limit_words_decided_differently" in v else v)
                          for k, v in out[d].items()}
                      for d in ("sumprod2", "minsum")}))


if __name__ == "__main__":
    main()
