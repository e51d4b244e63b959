"""CLI driver-surface tests for the two BER-sweep commands.

These are the framework's replacements for the reference's
edit-the-script experiment drivers (performance_plots_general.py); the
tests pin the full argv surface on tiny configs: resumable store
behavior, the self-describing meta record, the npz snapshot layout, and
the semi-protected real-prefix path.
"""

import json
import sys
from pathlib import Path

import numpy as np

from ldpc_sparc_tpu import cli


def test_sparc_sweep_cli_resumes(tmp_path):
    argv = ["sparc-sweep", "--platform", "cpu", "--L", "64", "--M", "16",
            "--R", "1.3", "--trials", "4", "--t-max", "8",
            "--num-snrs", "2", "--snr-start", "8", "--snr-stop", "12",
            "--out", str(tmp_path)]
    rows = cli.main(argv)
    assert len(rows) == 2
    store = (tmp_path / "sparc_sweep.jsonl").read_text().strip().splitlines()
    assert len(store) == 2
    # both SNR conventions recorded
    row = json.loads(store[0])
    assert "snr" in row and "snr_db" in row
    np.testing.assert_allclose(row["snr_db"], 10 * np.log10(row["snr"]))
    # re-run: all points served from the store, nothing re-measured
    rows2 = cli.main(argv)
    assert len(rows2) == 2
    assert (tmp_path / "sparc_sweep.jsonl").read_text().strip().splitlines() \
        == store


def test_sparc_sweep_cli_modulated(tmp_path):
    """--modulated/--K expose the K-PSK family (demo cell 14) on the
    driver surface; rows must carry the reference's ler/ver split."""
    argv = ["sparc-sweep", "--platform", "cpu", "--L", "64", "--M", "8",
            "--R", "2.6", "--modulated", "--K", "4", "--trials", "4",
            "--t-max", "6", "--num-snrs", "2", "--snr-start", "8",
            "--snr-stop", "15", "--out", str(tmp_path)]
    rows = cli.main(argv)
    assert len(rows) == 2
    row = json.loads((tmp_path / "sparc_sweep.jsonl")
                     .read_text().strip().splitlines()[0])
    for k in ("ler", "ver", "ser", "ber", "loc_errs", "val_errs"):
        assert k in row, k
    assert max(row["ler"], row["ver"]) <= row["ser"] + 1e-9
    assert row["ser"] <= row["ler"] + row["ver"] + 1e-9


def test_concat_sweep_cli_semi_protected_prefix(tmp_path):
    argv = ["concat-sweep", "--platform", "cpu", "--semi-protected",
            "--percent-protected", "0.9", "--standard", "802.16",
            "--rate", "1/2", "--z", "12", "--mults", "2", "--logM", "2",
            "--R-sparc", "0.8", "--t-max", "6", "--runs", "2",
            "--num-snrs", "2", "--snr-start", "4", "--snr-stop", "6",
            "--decoders", "amp_only,sequential",
            "--save-npz", str(tmp_path / "snap.npz"),
            "--out", str(tmp_path)]
    series = cli.main(argv)
    assert set(series) == {"amp_only", "sequential"}
    assert all(len(s) == 2 for s in series.values())
    rows = [json.loads(line) for line in
            (tmp_path / "concat_sweep_semi.jsonl").read_text().splitlines()]
    # self-describing meta record with a REAL prefix
    metas = [r["config"] for r in rows if "config" in r]
    assert len(metas) == 1
    assert metas[0]["semi_protected"] is True
    assert metas[0]["percent_protected"] == 0.9
    assert metas[0]["lengths"]["L_unprotected"] > 0
    # reference npz snapshot layout (performance_plots_general.py:138-139)
    snap = np.load(tmp_path / "snap.npz")
    assert snap["ber_store_averages"].shape == (2, 2)
    assert snap["snr_store"].tolist() == [4.0, 6.0]
    # plot emitted
    assert (tmp_path / "concat_sweep_semi.png").exists()


def test_sparc_sweep_cli_dft_engine(tmp_path):
    """--design-engine dft runs the reference-exact complex ensemble
    through the whole driver surface (resume keys carry the engine, so
    srht and dft sweeps in one --out dir never collide)."""
    base = ["sparc-sweep", "--platform", "cpu", "--L", "128", "--M", "8",
            "--R", "2.6", "--modulated", "--K", "4", "--trials", "4",
            "--t-max", "12", "--num-snrs", "1", "--snr-start", "15",
            "--snr-stop", "15", "--out", str(tmp_path)]
    rows_dft = cli.main(base + ["--design-engine", "dft"])
    rows_srht = cli.main(base)
    assert len(rows_dft) == len(rows_srht) == 1
    store = [json.loads(l) for l in
             (tmp_path / "sparc_sweep.jsonl").read_text().splitlines()]
    assert len(store) == 2, "engines must get distinct resume keys"


def test_ldpc_campaign_cli_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib the campaign still writes results.txt and
    results.csv and says the plot was skipped."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    from ldpc_sparc_tpu import cli
    cli.main(["ldpc-campaign", "--standard", "802.16", "--rate", "1/2",
              "--z", "3", "--points", "2", "--min-errors", "2",
              "--max-blocks", "16", "--batch", "8", "--max-iters", "10",
              "--out", str(tmp_path), "--platform", "cpu"])
    assert len((tmp_path / "results.txt").read_text().splitlines()) == 2
    assert (tmp_path / "results.csv").stat().st_size > 0
    assert not (tmp_path / "waterfall.png").exists()
    skipped = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if "plot_skipped" in line]
    assert skipped[0]["plot_skipped"].endswith("waterfall.png")


def test_concat_sweep_cli_without_matplotlib(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    from ldpc_sparc_tpu import cli
    series = cli.main(["concat-sweep", "--z", "12", "--mults", "1",
                       "--logM", "2", "--t-max", "3", "--runs", "2",
                       "--num-snrs", "1", "--decoders", "sequential",
                       "--out", str(tmp_path), "--platform", "cpu"])
    assert len(series["sequential"]) == 1
    assert (tmp_path / "concat_sweep.jsonl").exists()
    assert not (tmp_path / "concat_sweep.png").exists()
    assert "plot_skipped" in capsys.readouterr().out
