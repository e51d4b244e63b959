"""Resumable LDPC campaign and its batch counters.

The reference's append-only results.txt loses at most one point on a crash
(ldpc_awgn.py:109-114); SURVEY section 5 asks for resume per (config, SNR,
seed-block) cell. These tests prove the stronger contract: a campaign
interrupted after k points and resumed produces the IDENTICAL record set an
uninterrupted run produces — same keys, same adaptive-SNR trajectory — and
a CLI re-run into the same --out dir duplicates nothing.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from ldpc_sparc_tpu.config import LdpcParams
from ldpc_sparc_tpu.parallel.montecarlo import ldpc_waterfall_campaign


TINY = dict(seed=0, n_measurements=4, min_errors=2, max_blocks=32,
            batch=8, dectype="sumprod2", max_iters=10)


def test_campaign_resume_exact():
    params = LdpcParams(standard="802.16", rate="1/2", z=3, ptype="A")
    full = ldpc_waterfall_campaign(params, **TINY)
    assert len(full) == 4

    # interrupted after 2 points, capturing the per-point resume state
    states = []
    part1 = ldpc_waterfall_campaign(
        params, **{**TINY, "n_measurements": 2},
        on_point=lambda rec, st: states.append(st))
    last = states[-1]
    part2 = ldpc_waterfall_campaign(
        params, **TINY, start_point=last["point"] + 1,
        start_snr=last["next_snr"], start_ctr=last["ctr"])
    assert part1 + part2 == full


def test_campaign_cli_rerun_no_duplicates(tmp_path):
    from ldpc_sparc_tpu import cli
    argv = ["ldpc-campaign", "--standard", "802.16", "--rate", "1/2",
            "--z", "3", "--points", "3", "--min-errors", "2",
            "--max-blocks", "32", "--batch", "8", "--max-iters", "10",
            "--out", str(tmp_path), "--platform", "cpu"]
    cli.main(argv)
    txt1 = (tmp_path / "results.txt").read_text()
    assert len(txt1.strip().splitlines()) == 3
    # re-run: everything already measured -> identical file, no duplicates
    cli.main(argv)
    assert (tmp_path / "results.txt").read_text() == txt1
    # the store holds exactly the 3 point cells
    lines = (tmp_path / "ldpc_campaign.jsonl").read_text().strip().splitlines()
    assert len(lines) == 3


def _direct_counts(code, snr_db, root, ctr, batch, max_iters):
    """The campaign batch rebuilt by hand: the same per-codeword keys,
    BPSK over AWGN, one bp_decode call, counts summed on the host."""
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.ops.bp import bp_decode
    sigma2 = 1.0 / 10 ** (snr_db / 10.0)
    xs, llrs = [], []
    for i in range(ctr, ctr + batch):
        ku, kn = jax.random.split(jax.random.fold_in(root, i))
        u = jax.random.bernoulli(ku, 0.5, (code.K,)).astype(jnp.int32)
        x = np.asarray(code.encode(u))
        y = (1.0 - 2.0 * x) + np.sqrt(sigma2) * np.asarray(
            jax.random.normal(kn, (code.N,)))
        xs.append(x)
        llrs.append(2.0 / sigma2 * y)
    res = bp_decode(jnp.asarray(np.stack(llrs), jnp.float32), code.graph,
                    max_iters)
    errs = np.sum((np.asarray(res.app) < 0) != np.stack(xs).astype(bool),
                  axis=1)
    return (int(errs.sum()), int(np.sum(errs > 0)),
            int(np.asarray(res.iterations).sum()))


@pytest.mark.parametrize("meshed", [False, True])
def test_campaign_counters_match_direct_bp_decode(meshed):
    """The campaign's batch counters (one card, or the 'dp' mesh) equal a
    direct bp_decode of the same codewords."""
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.parallel.mesh import make_mesh
    from ldpc_sparc_tpu.parallel.montecarlo import _ldpc_block_counts
    from ldpc_sparc_tpu.utils import rng as rngmod
    code = get_code("802.16", "1/2", 3)
    root = rngmod.root_key(4)
    mesh = make_mesh(sec=1) if meshed else None
    got = _ldpc_block_counts(code, 1.0, root, 16, 8, 20, "sumprod2", mesh)
    want = _direct_counts(code, 1.0, root, 16, 8, 20)
    assert got == want
    assert want[1] > 0 and want[2] > 0      # real errors and iterations
