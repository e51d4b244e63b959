"""Flagship-config waterfall vs state-evolution prediction.

The north-star benchmark config (plain SPARC, L=1024, M=512, R=1.0;
BASELINE.json config 1) is gated at a single operating point by bench.py
(BER 0). This artifact documents the whole waterfall: measured BER/SER
across the threshold region on the GPU, overlaid with the
state-evolution prediction (models/state_evolution.py; the reference's
validation medium, sparc_public/sparc_demo.ipynb) — the SE fixed point
psi_final flips from ~1 to ~0 at the predicted threshold, and the
measured waterfall must sit at the same SNR.

Writes docs/artifacts/flagship_sweep.{json,png}.

Usage: python benchmarks/flagship_sweep.py [--trials 32] [--platform cpu]
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


def plot(doc, path):
    """Waterfall vs state evolution from a flagship_sweep.json document."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    cfg, rows, deep_rows = doc["config"], doc["rows"], doc["deep_rows"]
    thr = doc["se_threshold_snr"]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    floor = 1.0 / (cfg["trials_per_point"] * cfg["L"])  # one section error
    ax.semilogy([r["snr"] for r in rows],
                [max(r["ser"], floor * 0.1) for r in rows], "o-",
                label="measured SER")
    ax.semilogy([r["snr"] for r in rows],
                [max(r["ber"], floor * 0.1) for r in rows], "s-",
                label="measured BER")
    if deep_rows:
        # zero-error deep points would be silently masked by semilogy;
        # floor them at a tenth of one error in the deep bit budget
        dfloor = 0.1 / deep_rows[0]["bits"]
        ax.semilogy([r["snr"] for r in deep_rows],
                    [max(r["ser"], dfloor) for r in deep_rows], "o--",
                    mfc="none",
                    label=f"deep SER ({deep_rows[0]['trials']} trials)")
        ax.errorbar([r["snr"] for r in deep_rows],
                    [max(r["ber"], dfloor) for r in deep_rows],
                    yerr=[r["ber_ci95"] for r in deep_rows], fmt="s--",
                    mfc="none", capsize=3,
                    label="deep BER (95% CI)")
    ax2 = ax.twinx()
    ax2.plot([r["snr"] for r in rows], [r["se_psi_final"] for r in rows],
             "^--", color="gray", label="SE psi_final")
    ax2.set_ylabel("SE fixed-point NMSE psi")
    if thr is not None:
        ax.axvline(thr, ls=":", color="k", lw=1,
                   label=f"SE threshold ({thr:.2f})")
    ax.set_xlabel("snr = P / awgn_var (linear)")
    ax.set_ylabel("error rate")
    ax.set_title("Flagship config L=1024 M=512 R=1.0: measured waterfall "
                 "vs state evolution")
    ax.grid(True, which="both", alpha=0.3)
    lines, labels = ax.get_legend_handles_labels()
    l2, lb2 = ax2.get_legend_handles_labels()
    ax.legend(lines + l2, labels + lb2, fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default=None)
    ap.add_argument("--trials", type=int, default=32)
    ap.add_argument("--t-max", type=int, default=30)
    ap.add_argument("--deep-trials", type=int, default=2048,
                    help="trials for the below-threshold deep points "
                         "(0 disables)")
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    from ldpc_sparc_tpu import SparcParams, DecodeParams, sparc_se
    from ldpc_sparc_tpu.parallel.montecarlo import sparc_mc_counts
    from ldpc_sparc_tpu.io.results import plot_if_available
    from ldpc_sparc_tpu.utils.device import device_record

    params = SparcParams(P=15.0, R=1.0, L=1024, M=512)
    dec = DecodeParams(t_max=args.t_max)
    # snr = P / awgn_var across the threshold region (capacity C = R at
    # snr = 2^(2R) - 1 = 3; the AMP threshold for iid designs sits below)
    snrs = np.linspace(2.0, 4.5, 9)

    rows = []
    t0 = time.perf_counter()
    for i, snr in enumerate(snrs):
        var = float(params.P / snr)
        c = sparc_mc_counts(params, dec, var, seed=(17, i),
                            n_trials=args.trials)
        psi, _ = sparc_se(var, params, args.t_max, 4000, seed=0)
        rows.append({
            "snr": float(snr), "awgn_var": var,
            "ber": c["bit_errs"] / c["bits"],
            "ser": c["sec_errs"] / c["sections"],
            "fer": c["frame_errs"] / c["frames"],
            "avg_iters": c["iters"] / c["frames"],
            "se_psi_final": float(np.asarray(psi)[-1].mean()),
        })
        print(json.dumps(rows[-1]), flush=True)
    wall = time.perf_counter() - t0

    # deep below-threshold points: enough trials to pin BER with a
    # binomial CI at the 1e-4 level and to demonstrate FER < 1 at
    # flagship scale (round-4 verdict: 32-trial points cannot)
    deep_rows = []
    if args.deep_trials:
        for j, snr in enumerate([4.5, 5.25, 6.0]):
            var = float(params.P / snr)
            td = time.perf_counter()
            # chunked: one 2048-trial program would carry ~3 LM-sized
            # arrays per trial (~13 GB HBM at L=1024/M=512); 256-trial
            # chunks with independent seeds keep it resident
            chunk = 256
            c = None
            for k in range(0, args.deep_trials, chunk):
                ck = sparc_mc_counts(params, dec, var, seed=(71, j, k),
                                     n_trials=min(chunk,
                                                  args.deep_trials - k))
                c = ck if c is None else \
                    {key: c[key] + ck[key] for key in c}
            # 95% Clopper-like normal-approx CI half-width on BER
            ber = c["bit_errs"] / c["bits"]
            ci = 1.96 * np.sqrt(max(ber, 1.0 / c["bits"]) *
                                (1 - ber) / c["bits"])
            deep_rows.append({
                "snr": float(snr), "awgn_var": var,
                "trials": args.deep_trials,
                "ber": ber, "ber_ci95": float(ci),
                "ser": c["sec_errs"] / c["sections"],
                "fer": c["frame_errs"] / c["frames"],
                "bit_errs": int(c["bit_errs"]), "bits": int(c["bits"]),
                "wall_s": round(time.perf_counter() - td, 1)})
            print(json.dumps(deep_rows[-1]), flush=True)
        wall = time.perf_counter() - t0

    # SE-predicted threshold: first snr whose fixed point decodes
    thr = next((r["snr"] for r in rows if r["se_psi_final"] < 0.01), None)
    out = {"device": device_record(),
           "config": {"P": params.P, "R": params.R, "L": params.L,
                      "M": params.M, "t_max": args.t_max,
                      "trials_per_point": args.trials},
           "wall_s": round(wall, 1),
           "se_threshold_snr": thr, "rows": rows,
           "deep_rows": deep_rows}
    with open(os.path.join(ART, "flagship_sweep.json"), "w") as f:
        json.dump(out, f, indent=1)

    plot_if_available(plot, os.path.join(ART, "flagship_sweep.png"), out)
    print(json.dumps({"wall_s": out["wall_s"],
                      "se_threshold_snr": thr}))


if __name__ == "__main__":
    main()
