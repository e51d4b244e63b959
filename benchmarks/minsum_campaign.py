"""Minsum waterfall artifact: the repaired kernel at measurement depth.

The reference ships a BROKEN min-sum: `ldpc_jossy/py/ldpc.py:487` drops the
correction-factor argument when dispatching to the C kernel and the README
says so (`ldpc_jossy/README.md:89` "MINSUM DOES NOT WORK"). This framework
fixed the ABI (ops/bp.py `corr_factor`, native/bp_ref.cpp) and gates
oracle exactness in tests/test_ldpc.py — but exactness vs the repaired
oracle does not show the kernel *performs*. This artifact does: it runs
the reference's full adaptive waterfall campaign protocol
(ldpc_jossy/py/ldpc_awgn.py:60-123) with dectype=minsum (normalized
min-sum, corr_factor 0.7) at several configs and measures the SNR penalty
at BER 1e-4 against a sumprod2 campaign of the same configs, protocol and
seed, run in the same process. Normalized min-sum's textbook penalty is
~0.1-0.3 dB; a broken kernel would show either a multi-dB gap or no
waterfall at all.

Writes docs/artifacts/minsum_campaign.{json,png} (gated by
tests/test_sweep_artifacts.py).

Usage: python benchmarks/minsum_campaign.py [--platform cpu] [--quick]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "artifacts")

CONFIGS = [
    ("802.16", "1/2", 27, "A"),
    ("802.11n", "1/2", 27, "A"),
    ("802.16", "3/4", 27, "A"),
]


def snr_at_ber(points, target=1e-4):
    """Log-linear interpolated SNR (dB) where the waterfall crosses
    `target` BER; None if the sweep never reaches it. Measured-zero
    points are floored at a tenth of one error in their bit budget so a
    [5e-4, 0, 0] tail still brackets the crossing, and the LAST
    (highest-SNR) bracketing pair wins so a mid-sweep statistical zero
    cannot fabricate a spurious early crossing."""
    pts = sorted((p["snr"],
                  max(p["ber"], 0.1 / max(p.get("nbits", 1), 1)))
                 for p in points)
    best = None
    for (s0, b0), (s1, b1) in zip(pts, pts[1:]):
        if b0 >= target >= b1:
            if b0 == b1:
                best = float(s0)
                continue
            f = (np.log10(b0) - np.log10(target)) / \
                (np.log10(b0) - np.log10(b1))
            best = float(s0 + f * (s1 - s0))
    if best is not None:
        return best
    if pts and pts[-1][1] <= target:
        return float(pts[-1][0])
    return None


def plot(doc, path):
    """minsum vs sumprod2 waterfalls from a minsum_campaign.json document."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    results = doc["configs"]
    fig, axes = plt.subplots(1, len(results), figsize=(5 * len(results), 4),
                             squeeze=False)
    for ax, row in zip(axes[0], results):
        key = (row["standard"], row["rate"], row["z"], row["ptype"])
        sp = row["sumprod2_points"]
        ax.semilogy([p["snr"] for p in sp],
                    [max(p["ber"], 1e-8) for p in sp], "o-",
                    label="sumprod2")
        ms = row["minsum_points"]
        ax.semilogy([p["snr"] for p in ms],
                    [max(p["ber"], 1e-8) for p in ms], "s-",
                    label="minsum corr=0.7 (repaired)")
        pen = row["penalty_db"]
        ax.set_title(f"{key[0]} {key[1]} z={key[2]}{key[3]}"
                     + (f"  penalty {pen:+.2f} dB" if pen is not None else ""))
        ax.set_xlabel("SNR (dB)")
        ax.set_ylabel("BER")
        ax.grid(True, which="both", alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    # 30 points: deep enough that both waterfalls of every config cross
    # BER 1e-4 (at 22, the sumprod2 802.16 1/2 z=27 waterfall stopped at
    # 1.2e-4 for this seed)
    ap.add_argument("--points", type=int, default=30)
    ap.add_argument("--min-errors", type=int, default=100)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from ldpc_sparc_tpu.config import LdpcParams
    from ldpc_sparc_tpu.parallel.montecarlo import ldpc_waterfall_campaign
    from ldpc_sparc_tpu.io.results import plot_if_available
    from ldpc_sparc_tpu.utils.device import device_record

    configs = CONFIGS[:1] if args.quick else CONFIGS
    points = 6 if args.quick else args.points
    results = []
    t0 = time.perf_counter()
    for std, rate, z, pt in configs:
        params = LdpcParams(standard=std, rate=rate, z=z, ptype=pt)

        def waterfall(dectype):
            recs = ldpc_waterfall_campaign(
                params, seed=11, n_measurements=points,
                min_errors=args.min_errors, batch=args.batch,
                dectype=dectype, max_iters=200)
            return [{"snr": r[4], "nblocks": r[5], "nblkerr": r[6],
                     "nbits": r[7], "nbiterr": r[8],
                     "ber": r[8] / r[7] if r[7] else 0.0} for r in recs]

        ms_points, sp_points = waterfall("minsum"), waterfall("sumprod2")
        s_ms = snr_at_ber(ms_points)
        s_sp = snr_at_ber(sp_points)
        penalty = (s_ms - s_sp) if (s_ms is not None and s_sp is not None) \
            else None
        row = {"standard": std, "rate": rate, "z": z, "ptype": pt,
               "minsum_points": ms_points, "sumprod2_points": sp_points,
               "snr_at_1e-4_minsum": s_ms, "snr_at_1e-4_sumprod2": s_sp,
               "penalty_db": penalty}
        results.append(row)
        print(json.dumps({"config": f"{std} {rate} z={z}{pt}",
                          "snr@1e-4 minsum": s_ms, "sumprod2": s_sp,
                          "penalty_db": penalty}), flush=True)

    out = {"device": device_record(),
           "protocol": {"points": points, "min_errors": args.min_errors,
                        "batch": args.batch, "dectype": "minsum",
                        "corr_factor": 0.7, "max_iters": 200,
                        "reference_dectype": "sumprod2"},
           "wall_s": round(time.perf_counter() - t0, 1),
           "quick": bool(args.quick),
           "configs": results}
    with open(os.path.join(ART, "minsum_campaign.json"), "w") as f:
        json.dump(out, f, indent=1)

    plot_if_available(plot, os.path.join(ART, "minsum_campaign.png"), out)
    print(json.dumps({"wall_s": out["wall_s"],
                      "penalties": [r["penalty_db"] for r in results]}))


if __name__ == "__main__":
    main()
