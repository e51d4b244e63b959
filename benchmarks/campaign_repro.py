"""On-chip reproduction of the reference's 2018 LDPC waterfall campaign.

Runs the EXACT measurement protocol of ldpc_jossy/py/ldpc_awgn.py:60-123
(min_errors=100 block errors or max_blocks=400000 per point, adaptive
SNR stepping SNR += sqrt(100/nblocks), sumprod2, 200 BP iterations) for a
set of the 36 grid-engine configs (ldpc_awgn.py:6-43) on one device,
and overlays the measured waterfalls on the reference's own 2018 data
(ldpc_jossy/data/results.csv) — the campaign the upstream README says
"could take months on a single computer" (ldpc_jossy/README.md:158-161).

Writes docs/artifacts/campaign.json (per-config wall-clock, blocks/s,
every measured point, the matched reference points and the device they
were measured on) and docs/artifacts/campaign.png (ours vs 2018 overlay).

Usage: python benchmarks/campaign_repro.py [--sim-ids 5,20,...]
       [--points 24] [--max-blocks 400000] [--batch 512]
"""

import argparse
import csv
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_CSV = "/root/reference/ldpc_jossy/data/results.csv"


def load_reference_points(standard, rate_float, ptype_int, z):
    if not os.path.exists(REF_CSV):
        return []
    pts = []
    with open(REF_CSV) as f:
        for row in csv.reader(f):
            std, rate, pt, zz, snr, nblocks, nblkerr, nbits, nbiterr, nit = \
                [x.strip() for x in row]
            if (std == standard and abs(float(rate) - rate_float) < 1e-3
                    and int(pt) == ptype_int and int(zz) == z):
                pts.append({"snr": float(snr), "nblocks": int(nblocks),
                            "ber": int(nbiterr) / int(nbits),
                            "bler": int(nblkerr) / int(nblocks)})
    return sorted(pts, key=lambda p: p["snr"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sim-ids", default="5,13,20,25,31,36",
                    help="comma-separated rows of the reference's 36-entry "
                         "grid table (cli.SIM_PARAM_TABLE); the default six "
                         "span both standards, rates 1/2..5/6, z 27..81, "
                         "and a type-B protograph")
    ap.add_argument("--points", type=int, default=24)
    ap.add_argument("--min-errors", type=int, default=100)
    ap.add_argument("--max-blocks", type=int, default=400000)
    ap.add_argument("--batch", type=int, default=512)
    args = ap.parse_args()

    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    from ldpc_sparc_tpu.utils.device import device_record
    enable_persistent_cache()
    from ldpc_sparc_tpu.cli import SIM_PARAM_TABLE
    from ldpc_sparc_tpu.config import LdpcParams
    from ldpc_sparc_tpu.parallel.montecarlo import ldpc_waterfall_campaign

    protocol = {
        "points": args.points, "min_errors": args.min_errors,
        "max_blocks": args.max_blocks, "batch": args.batch,
        "dectype": "sumprod2", "max_iters": 200}
    out = {"device": device_record(), "protocol": protocol,
           "configs": []}
    art_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "artifacts")
    art_path = os.path.join(art_dir, "campaign.json")
    total_blocks = total_wall = 0
    for sim_id in [int(s) for s in args.sim_ids.split(",")]:
        std, rate, z, pt = SIM_PARAM_TABLE[sim_id - 1]
        params = LdpcParams(standard=std, rate=rate, z=z, ptype=pt)
        t0 = time.perf_counter()
        recs = ldpc_waterfall_campaign(
            params, seed=sim_id, n_measurements=args.points,
            min_errors=args.min_errors, max_blocks=args.max_blocks,
            batch=args.batch, dectype="sumprod2", max_iters=200)
        wall = time.perf_counter() - t0
        blocks = sum(r[5] for r in recs)
        ref_pts = load_reference_points(
            "16" if std == "802.16" else "11", params.rate_float,
            0 if pt == "A" else 1, z)
        cfg = {"sim_id": sim_id, "standard": std, "rate": rate, "z": z,
               "ptype": pt, "protocol": dict(protocol),
               "wall_s": round(wall, 1), "blocks": blocks,
               "blocks_per_s": round(blocks / wall, 1),
               "iters": sum(r[9] for r in recs),
               "points": [{"snr": r[4], "nblocks": r[5], "nblkerr": r[6],
                           "nbits": r[7], "nbiterr": r[8], "niters": r[9],
                           "ber": r[8] / r[7], "bler": r[6] / r[5]}
                          for r in recs],
               "reference_points": ref_pts}
        out["configs"].append(cfg)
        total_blocks += blocks
        total_wall += wall
        print(json.dumps({k: cfg[k] for k in
                          ("sim_id", "standard", "rate", "z", "ptype",
                           "wall_s", "blocks", "blocks_per_s")}), flush=True)
        # checkpoint after every config: a long multi-config run that dies
        # keeps everything measured so far (the merge accumulates)
        _write_artifact(out, art_path, plot=False)

    merged = _write_artifact(out, art_path, plot=True)
    print(json.dumps(merged["summary"]))


REF_NOTE = ("grid engine, Sept 2018; 'could take months on a single "
            "computer' (ldpc_jossy/README.md:158-161)")


def _summary(configs):
    total_wall = sum(c["wall_s"] for c in configs)
    total_blocks = sum(c["blocks"] for c in configs)
    per_cfg = total_wall / max(len(configs), 1)
    return {
        "total_wall_s": round(total_wall, 1),
        "total_blocks": total_blocks,
        "configs_measured": len(configs),
        "mean_wall_per_config_s": round(per_cfg, 1),
        "full_36_config_campaign_estimate_min": round(36 * per_cfg / 60, 1),
        "reference_note": REF_NOTE,
    }


def _write_artifact(out, art_path, plot):
    """Merge this run's configs with any previously measured ones (keyed
    by sim_id; the artifact accumulates coverage of the 36-entry grid
    across runs) and write the JSON (+ optionally the overlay plot).
    Called after EVERY measured config so a killed multi-config run keeps
    everything measured so far."""
    merged = list(out["configs"])
    if os.path.exists(art_path):
        prev = json.load(open(art_path))
        have = {c["sim_id"] for c in merged}
        # each config carries the protocol it was measured under (older
        # artifacts stored one top-level protocol block: backfill from it)
        prev_proto = prev.get("protocol", {})
        for c in prev.get("configs", []):
            if c["sim_id"] not in have:
                c.setdefault("protocol", dict(prev_proto))
                merged.append(c)
    merged.sort(key=lambda c: c["sim_id"])
    doc = dict(out, configs=merged, summary=_summary(merged))
    with open(art_path, "w") as f:
        json.dump(doc, f, indent=1)
    if plot:
        from ldpc_sparc_tpu.io.results import plot_if_available
        plot_if_available(_plot, os.path.join(os.path.dirname(art_path),
                                              "campaign.png"), doc)
    return doc


def _plot(doc, png_path):
    # overlay plot: ours (lines+markers) vs 2018 measured (hollow markers)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5.5))
    colors = plt.cm.tab10.colors
    for i, cfg in enumerate(doc["configs"]):
        c = colors[i % 10]
        lbl = f'{cfg["standard"]} {cfg["rate"]} z={cfg["z"]}{cfg["ptype"]}'
        snrs = [p["snr"] for p in cfg["points"]]
        bers = [max(p["ber"], 1e-8) for p in cfg["points"]]
        ax.semilogy(snrs, bers, "-o", color=c, ms=3, lw=1, label=lbl)
        if cfg["reference_points"]:
            ax.semilogy([p["snr"] for p in cfg["reference_points"]],
                        [max(p["ber"], 1e-8)
                         for p in cfg["reference_points"]],
                        "s", mfc="none", mec=c, ms=4, lw=0)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("BER")
    ax.set_title("LDPC waterfalls: this framework (filled) "
                 "vs 2018 measured campaign (hollow)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(png_path, dpi=130)


if __name__ == "__main__":
    main()
