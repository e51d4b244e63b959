"""Export the on-chip campaign artifact through the reference's ENTIRE
post-processing workflow.

The 2018 pipeline is: grid jobs append tuple lines to data/results.txt ->
src/results2csv.c -> py/disp_res.py multi-page PDF
(ldpc_jossy/README.md:152-156). This script regenerates those exact
artifacts from our measured campaign.json (benchmarks/campaign_repro.py):
a user of the reference
can point their own disp_res.py at the files this writes.

Writes docs/artifacts/campaign_results.txt (the results.txt:1 tuple-line
format), campaign_results.csv (results2csv schema; the native C++
converter is byte-identical to the Python one, tests/test_results.py),
and campaign_waterfalls.pdf (one page per (standard, rate) group with
Shannon anchors, the disp_res.py:7-131 medium).

Usage: python benchmarks/export_campaign.py
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ART = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "artifacts")


def main():
    from ldpc_sparc_tpu.io.results import (record_to_tuple_line,
                                           records_to_csv, plot_waterfalls,
                                           plot_standard_comparison)
    doc = json.load(open(os.path.join(ART, "campaign.json")))
    records = []
    for cfg in doc["configs"]:
        for p in cfg["points"]:
            if "nbits" not in p:
                raise SystemExit(
                    "artifact predates per-point nbits/nbiterr/niters "
                    "fields; regenerate with benchmarks/campaign_repro.py")
            records.append((cfg["standard"], cfg["rate"], cfg["z"],
                            cfg["ptype"], p["snr"], p["nblocks"],
                            p["nblkerr"], p["nbits"], p["nbiterr"],
                            p["niters"]))
    txt = os.path.join(ART, "campaign_results.txt")
    with open(txt, "w") as f:
        for rec in records:
            f.write(record_to_tuple_line(rec) + "\n")
    records_to_csv(records, os.path.join(ART, "campaign_results.csv"))
    plot_waterfalls(records, os.path.join(ART, "campaign_waterfalls.pdf"),
                    title="On-chip 2018-campaign reproduction")
    plot_waterfalls(records,
                    os.path.join(ART, "campaign_waterfalls_bler.pdf"),
                    title="On-chip 2018-campaign reproduction (BLER)",
                    metric="bler")
    plot_standard_comparison(
        records, os.path.join(ART, "campaign_standard_comparison.pdf"))
    print(f"wrote {len(records)} records -> campaign_results.txt/.csv, "
          "campaign_waterfalls{,_bler}.pdf")


if __name__ == "__main__":
    main()
