"""Command-line entry points.

Replaces the reference's edit-the-script experiment configuration
(ldpc_sparc/performance_plots_general.py:19-66 module constants and the
positional-integer job selector of ldpc_jossy/py/ldpc_awgn.py:125-131) with
argparse subcommands:

  python -m ldpc_sparc_tpu.cli sparc-sweep   --L 1024 --M 512 --R 1.0 ...
  python -m ldpc_sparc_tpu.cli ldpc-campaign --standard 802.11n --rate 1/2 ...
  python -m ldpc_sparc_tpu.cli concat-sweep  --decoders sequential,naive ...
  python -m ldpc_sparc_tpu.cli results2csv   results.txt results.csv

Campaigns write to a resumable JSONL store and export reference-format
results.txt/.csv plus waterfall plots (when matplotlib is installed).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _add_common(p):
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="results")
    p.add_argument("--platform", type=str, default=None,
                   help="force jax platform (cpu|gpu)")


def _init_jax(args):
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from .utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    return jax


def _config_key(**fields) -> str:
    """Short stable hash of the full sweep configuration, used in resume
    keys so that re-running a *different* config into the same --out dir
    measures fresh points instead of silently returning stale rows."""
    import hashlib
    blob = json.dumps({k: repr(v) for k, v in sorted(fields.items())},
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def cmd_sparc_sweep(args):
    _init_jax(args)
    from .config import SparcParams, DecodeParams
    from .parallel.montecarlo import sparc_ber_sweep
    from .io.results import ResultsStore

    kwargs = dict(P=args.P, R=args.R, L=args.L, M=args.M)
    if args.spatially_coupled:
        kwargs.update(spatially_coupled=True, omega=args.omega,
                      Lambda=args.Lambda)
    if args.power_allocated:
        kwargs.update(power_allocated=True, B=args.B,
                      R_PA_ratio=args.R_PA_ratio)
    if args.modulated:
        # K-PSK modulated SPARCs (sparc_public/sparc_demo.ipynb cell 14);
        # K > 2 requires the complex design (config.SparcParams invariant)
        kwargs.update(modulated=True, K=args.K,
                      is_complex=args.complex or args.K > 2)
    elif args.complex:
        # unmodulated complex SPARC (complex channel, K=1 real-part
        # denoiser — sparc_public/sparc.py:429-432)
        kwargs.update(is_complex=True)
    params = SparcParams(**kwargs)
    decode = DecodeParams(t_max=args.t_max)
    snrs = np.linspace(args.snr_start, args.snr_stop, args.num_snrs)
    store = ResultsStore(Path(args.out) / "sparc_sweep.jsonl")
    # resume key carries the FULL config (params + decode + trial count):
    # a changed config in the same --out dir must measure fresh points
    # the engine joins the resume key only when non-default, so stores
    # written before the engine existed keep their keys (the concat
    # store_version bump is the precedent for DELIBERATE invalidation)
    extra = {} if args.design_engine == "srht"         else {"engine": args.design_engine}
    cfg_key = _config_key(params=params, t_max=args.t_max,
                          trials=args.trials, **extra)
    rows = []
    for snr in snrs:
        key = f"sparc:{cfg_key}:snr{snr:.3f}:s{args.seed}"
        if store.has(key):
            rows.append(store.get(key))
            continue
        [row] = sparc_ber_sweep(params, decode, [params.P / snr],
                                args.seed, args.trials,
                                engine=args.design_engine)
        row["snr_db"] = 10 * np.log10(snr)
        row["snr"] = float(snr)
        store.append(key, row)
        rows.append({"key": key, **row})
        line = {"snr": float(snr), "ber": row["ber"], "ser": row["ser"]}
        if "ler" in row:
            line.update(ler=row["ler"], ver=row["ver"])
        print(json.dumps(line))
    return rows


# The reference's 36-entry grid-engine parameter table
# (ldpc_jossy/py/ldpc_awgn.py:6-43), selectable with --sim-id 1..36.
SIM_PARAM_TABLE = [
    (std, rate, z, pt)
    for std, zs in [("802.16", [3, 27, 54, 81]), ("802.11n", [27, 54, 81])]
    for z in zs
    for rate, pts in [("1/2", ["A"]),
                      ("2/3", ["A", "B"] if std == "802.16" else ["A"]),
                      ("3/4", ["A", "B"] if std == "802.16" else ["A"]),
                      ("5/6", ["A"])]
    for pt in pts
]


def cmd_ldpc_campaign(args):
    _init_jax(args)
    from .config import LdpcParams
    if args.sim_id is not None:
        assert 1 <= args.sim_id <= len(SIM_PARAM_TABLE)
        args.standard, args.rate, args.z, args.ptype = \
            SIM_PARAM_TABLE[args.sim_id - 1]
    from .parallel.montecarlo import ldpc_waterfall_campaign
    from .io.results import (ResultsStore, record_to_tuple_line,
                             records_to_csv, plot_waterfalls,
                             plot_if_available)

    params = LdpcParams(standard=args.standard, rate=args.rate, z=args.z,
                        ptype=args.ptype)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    txt = out / "results.txt"

    # Resumable per (config, SNR-point index) cell (SURVEY.md section 5):
    # each measured point is stored with the campaign state needed to
    # continue EXACTLY (next adaptive SNR + running key counter), so a
    # killed campaign rerun produces the identical record set with no
    # duplicated points — strictly better than the reference's append-only
    # log which loses the in-flight point (ldpc_awgn.py:109-114).
    store = ResultsStore(out / "ldpc_campaign.jsonl")
    cfg_key = _config_key(params=params, points=args.points,
                          min_errors=args.min_errors,
                          max_blocks=args.max_blocks, batch=args.batch,
                          dectype=args.dectype, max_iters=args.max_iters,
                          seed=args.seed)
    start_point, start_snr, start_ctr = 0, None, 0
    for p in range(args.points):
        prev = store.get(f"ldpc:{cfg_key}:p{p}")
        if prev is None:
            break
        start_point, start_snr, start_ctr = \
            p + 1, prev["next_snr"], prev["ctr"]

    def on_point(rec, state):
        store.append(f"ldpc:{cfg_key}:p{state['point']}",
                     {"record": list(rec), **state})
        print(json.dumps({"point": state["point"], "snr": rec[4],
                          "blocks": rec[5], "block_errs": rec[6]}))

    ldpc_waterfall_campaign(
        params, seed=args.seed, n_measurements=args.points,
        min_errors=args.min_errors, max_blocks=args.max_blocks,
        batch=args.batch, dectype=args.dectype, max_iters=args.max_iters,
        on_point=on_point, start_point=start_point, start_snr=start_snr,
        start_ctr=start_ctr)

    # Export the reference-format artifacts by REGENERATING them from the
    # store (all configs sharing this --out dir, in measurement order) —
    # a resumed run never duplicates results.txt lines.
    recs = [tuple(r["record"]) for r in store.records() if "record" in r]
    with open(txt, "w") as f:
        for rec in recs:
            f.write(record_to_tuple_line(rec) + "\n")
    records_to_csv(recs, out / "results.csv")
    plot_if_available(plot_waterfalls, out / "waterfall.png", recs)
    return recs


def cmd_concat_sweep(args):
    _init_jax(args)
    from .config import (SparcParams, LdpcParams, DecodeParams, param_calc,
                         param_calc_semi_protected)
    from .models.ldpc import get_code
    from .parallel.montecarlo import concat_ber_point
    from .io.results import ResultsStore, plot_ber_sweep, plot_if_available

    ldpc = LdpcParams(standard=args.standard, rate=args.rate, z=args.z)
    code = get_code(args.standard, args.rate, args.z)
    int_rate = ldpc.rate_float
    if args.semi_protected:
        # the second config block of performance_plots_general.py:50-65
        L_sparc, R_sparc_ldpc, L_sparc_ldpc, lengths, rate = \
            param_calc_semi_protected(args.R_sparc, args.mults,
                                      args.percent_protected, 2 ** args.logM,
                                      ldpc, int_rate, code.K)
    else:
        rate, L_sparc, L_sparc_ldpc, lengths = param_calc(
            args.mults, args.logM, ldpc, int_rate, args.R_sparc, code.K)
        R_sparc_ldpc = args.R_sparc
    sp_plain = SparcParams(P=args.P, R=rate, L=L_sparc, M=2 ** args.logM)
    sp_ldpc = SparcParams(P=args.P, R=R_sparc_ldpc, L=L_sparc_ldpc,
                          M=2 ** args.logM)
    decode = DecodeParams(t_max=args.t_max)
    decoders = args.decoders.split(",")
    snrs = np.linspace(args.snr_start, args.snr_stop, args.num_snrs)
    stem = "concat_sweep_semi" if args.semi_protected else "concat_sweep"
    store = ResultsStore(Path(args.out) / f"{stem}.jsonl")
    # store_version=2: rows before the round-4 SNR-convention change stored
    # the LINEAR snr under 'snr_db' with no 'snr' key; versioning the key
    # re-measures those points instead of mixing units in one resumed
    # series (advisor round-4)
    cfg_key = _config_key(ldpc=ldpc, sp_plain=sp_plain, sp_ldpc=sp_ldpc,
                          lengths=lengths, t_max=args.t_max, runs=args.runs,
                          semi=args.semi_protected, store_version=2)
    # one meta record per config: makes the committed artifact
    # self-describing (incl. lengths.L_unprotected for semi-protected runs)
    meta_key = f"meta:{cfg_key}"
    if not store.has(meta_key):
        store.append(meta_key, {"config": {
            "standard": args.standard, "rate": args.rate, "z": args.z,
            "P": args.P, "mults": args.mults, "logM": args.logM,
            "R_sparc": args.R_sparc, "t_max": args.t_max, "runs": args.runs,
            "semi_protected": bool(args.semi_protected),
            "percent_protected": (float(args.percent_protected)
                                  if args.semi_protected else 1.0),
            "overall_rate": float(rate), "L_sparc": int(L_sparc),
            "L_sparc_ldpc": int(L_sparc_ldpc),
            "lengths": {"k_ldpc": int(lengths.k_ldpc),
                        "mults": int(lengths.mults),
                        "L_unprotected": int(lengths.L_unprotected)}}})
    series = {d: [] for d in decoders}
    for snr in snrs:
        awgn_var = args.P / snr
        for d in decoders:
            key = f"concat:{cfg_key}:{d}:snr{snr:.3f}:s{args.seed}"
            if store.has(key):
                series[d].append(store.get(key))
                continue
            sp = sp_plain if d == "amp_only" else sp_ldpc
            # the whole runs-batch is one vmapped + dp-sharded device
            # program (parallel/montecarlo.py:concat_mc_trial_errors)
            row = concat_ber_point(sp, ldpc, lengths, d != "amp_only",
                                   decode, awgn_var, (args.seed, 0),
                                   n_trials=args.runs, decoder=d)
            # the reference's concat axis is LINEAR snr (awgn_var = P/snr,
            # performance_plots_general.py:96-98); store both conventions
            # (the sparc sweep stores the same pair, cmd_sparc_sweep)
            row.update({"snr": float(snr),
                        "snr_db": float(10 * np.log10(snr)), "decoder": d})
            store.append(key, row)
            series[d].append(row)
            print(json.dumps(row))
    plot_if_available(plot_ber_sweep, Path(args.out) / f"{stem}.png",
                      [series[d] for d in decoders], decoders)
    if args.save_npz:
        # the reference driver's snapshot layout
        # (performance_plots_general.py:138-139): (num_sims, num_snrs) arrays
        np.savez(args.save_npz,
                 ber_store_averages=np.array(
                     [[r["ber"] for r in series[d]] for d in decoders]),
                 ber_store_max=np.array(
                     [[r["ber_max"] for r in series[d]] for d in decoders]),
                 ber_store_min=np.array(
                     [[r["ber_min"] for r in series[d]] for d in decoders]),
                 snr_store=snrs)
    return series


def cmd_results2csv(args):
    if args.native:
        from .native.tools import results2csv_native
        out = results2csv_native(args.input, args.output)
    else:
        from .io.results import results_txt_to_csv
        out = results_txt_to_csv(args.input, args.output)
    if args.output is None:
        sys.stdout.write(out)


def cmd_plot_results(args):
    from .io.results import load_records, plot_waterfalls
    records = load_records(args.input)
    if not records:
        raise SystemExit(f"no measurement records found in {args.input}")
    plot_waterfalls(records, args.output, metric=args.metric)
    print(json.dumps({"records": len(records), "out": args.output,
                      "metric": args.metric}))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ldpc_sparc_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("sparc-sweep", help="SPARC AMP BER sweep")
    _add_common(p)
    p.add_argument("--P", type=float, default=15.0)
    p.add_argument("--R", type=float, default=1.3)
    p.add_argument("--L", type=int, default=1024)
    p.add_argument("--M", type=int, default=32)
    p.add_argument("--t-max", type=int, default=25)
    p.add_argument("--trials", type=int, default=64)
    p.add_argument("--num-snrs", type=int, default=8)
    p.add_argument("--snr-start", type=float, default=6.0)
    p.add_argument("--snr-stop", type=float, default=20.0)
    p.add_argument("--spatially-coupled", action="store_true")
    p.add_argument("--omega", type=int, default=6)
    p.add_argument("--Lambda", type=int, default=32)
    p.add_argument("--power-allocated", action="store_true")
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--R-PA-ratio", type=float, default=1.0)
    p.add_argument("--modulated", action="store_true",
                   help="K-PSK modulated SPARC (demo cell 14)")
    p.add_argument("--K", type=int, default=4)
    p.add_argument("--complex", action="store_true",
                   help="complex design (implied by --K > 2)")
    p.add_argument("--design-engine", choices=("srht", "dft"),
                   default="srht",
                   help="design ensemble: the real SRHT "
                        "(default) or the reference's exact complex "
                        "subsampled DFT (complex plain-W codes only)")
    p.set_defaults(fn=cmd_sparc_sweep)

    p = sub.add_parser("ldpc-campaign", help="LDPC BER waterfall campaign")
    _add_common(p)
    p.add_argument("--sim-id", type=int, default=None,
                   help="row 1..36 of the reference's grid-engine table "
                        "(overrides --standard/--rate/--z/--ptype)")
    p.add_argument("--standard", default="802.11n")
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=27)
    p.add_argument("--ptype", default="A")
    p.add_argument("--points", type=int, default=24)
    p.add_argument("--min-errors", type=int, default=100)
    p.add_argument("--max-blocks", type=int, default=400000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--dectype", default="sumprod2")
    p.add_argument("--max-iters", type=int, default=200)
    p.set_defaults(fn=cmd_ldpc_campaign)

    p = sub.add_parser("concat-sweep", help="concatenated decoder BER sweep")
    _add_common(p)
    p.add_argument("--standard", default="802.16")
    p.add_argument("--rate", default="1/2")
    p.add_argument("--z", type=int, default=150)
    p.add_argument("--P", type=float, default=19.44)
    p.add_argument("--mults", type=int, default=4)
    p.add_argument("--logM", type=int, default=1)
    p.add_argument("--R-sparc", type=float, default=1.0)
    p.add_argument("--t-max", type=int, default=25)
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--num-snrs", type=int, default=10)
    p.add_argument("--snr-start", type=float, default=2.0)
    p.add_argument("--snr-stop", type=float, default=6.0)
    p.add_argument("--decoders",
                   default="amp_only,sequential,naive,integrated")
    p.add_argument("--semi-protected", action="store_true",
                   help="unprotected section prefix + LDPC-protected rest "
                        "(performance_plots_general.py semi_protected=True)")
    p.add_argument("--percent-protected", type=float, default=0.6)
    p.add_argument("--save-npz", default=None,
                   help="also save the reference's Test_N.npz snapshot "
                        "layout (performance_plots_general.py:138-139)")
    p.set_defaults(fn=cmd_concat_sweep)

    p = sub.add_parser("results2csv",
                       help="convert reference results.txt to CSV")
    p.add_argument("input")
    p.add_argument("output", nargs="?", default=None)
    p.add_argument("--native", action="store_true",
                   help="use the native C++ converter "
                        "(native/results2csv.cpp) instead of the Python one")
    p.set_defaults(fn=cmd_results2csv)

    p = sub.add_parser("plot-results",
                       help="waterfall plots from results.txt or results.csv "
                            "(the reference's py/disp_res.py)")
    p.add_argument("input", help="results.txt (tuple lines) or results.csv")
    p.add_argument("output", nargs="?", default="waterfalls.pdf",
                   help=".pdf = multi-page per (standard, rate); .png = grid")
    p.add_argument("--metric", choices=("ber", "bler"), default="ber",
                   help="y-axis metric (BLER is computed from the same "
                        "records, io/results.py:waterfall_metrics)")
    p.set_defaults(fn=cmd_plot_results)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
