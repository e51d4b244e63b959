"""Beyond-reference scale probe: SPARC decoding at 2x-8x the flagship LM.

The reference's largest exercised config is L=2048/M=512 (the SC decode
wave notebook, 17-25 s per decode on its CPU). This probe runs plain-SPARC
configs UP TO 8x the flagship design size (L*M = 2^22, a 4-million-column
seeded design, w = 2^23 SRHT) end to end on one chip — encode, AWGN, AMP
decode, counts — at near-threshold operating points, recording error
rates and throughput. The point is capability headroom: configs of this
size were simply out of reach for the reference's NumPy stack (a dense
representation of the largest design would be 1.3 TB; even its fast
transforms ran one codeword at a time).

Writes docs/artifacts/scale_probe.json (gated by
tests/test_sweep_artifacts.py::test_scale_probe_artifact).

Usage: python benchmarks/scale_probe.py [--platform cpu] [--trials 64]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "artifacts")

# (L, M, snr): operating points just below each config's threshold
# (capacity snr = 2^(2R)-1 = 3 at R=1; larger M pushes the AMP threshold
# slightly down but the finite-length floor region starts ~4.2-4.5)
CONFIGS = [
    (2048, 512, 4.3),   # 2x flagship LM
    (2048, 1024, 4.3),  # 4x
    (4096, 1024, 4.3),  # 8x (LM = 2^22)
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--trials", type=int, default=64)
    ap.add_argument("--t-max", type=int, default=25)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from ldpc_sparc_tpu import SparcParams, DecodeParams
    from ldpc_sparc_tpu.parallel.montecarlo import sparc_mc_counts
    from ldpc_sparc_tpu.utils.device import device_record

    dec = DecodeParams(t_max=args.t_max)
    rows = []
    for L, M, snr in CONFIGS:
        p = SparcParams(P=15.0, R=1.0, L=L, M=M)
        var = p.P / snr
        sparc_mc_counts(p, dec, var, seed=(2, 0), n_trials=args.trials)
        t0 = time.perf_counter()
        c = sparc_mc_counts(p, dec, var, seed=(2, 1), n_trials=args.trials)
        dt = time.perf_counter() - t0
        rows.append({
            "L": L, "M": M, "LM": L * M, "n": p.n, "snr": snr,
            "trials": args.trials,
            "ber": c["bit_errs"] / c["bits"],
            "ser": c["sec_errs"] / c["sections"],
            "fer": c["frame_errs"] / c["frames"],
            "wall_s": round(dt, 2),
            "trials_per_s": round(args.trials / dt, 2),
            "info_bits_per_s": round(args.trials * p.bit_len / dt, 0)})
        print(json.dumps(rows[-1]), flush=True)

    out = {"device": device_record(),
           "t_max": args.t_max, "rows": rows}
    with open(os.path.join(ART, "scale_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"artifact": "scale_probe.json"}))


if __name__ == "__main__":
    main()
