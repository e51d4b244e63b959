"""BER parity against the reference's measured 2018 campaign data.

The reference repo ships 1152 measured waterfall points
(ldpc_jossy/data/results.csv, produced by the grid-engine campaign of
ldpc_awgn.py). At matched (standard, rate, z, SNR) operating points our
BP decoder must reproduce the measured BER within Monte-Carlo confidence —
the bit/word-error validation the upstream README says can only be done
against published performance data (ldpc_jossy/README.md:133-137).

Skipped when the reference data directory is not present.
"""

import csv
import os
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ldpc_sparc_tpu.models.ldpc import get_code
from ldpc_sparc_tpu.ops.bp import bp_decode

REF_CSV = Path("/root/reference/ldpc_jossy/data/results.csv")


def load_reference_points(standard, rate_float, ptype_int, z):
    if not REF_CSV.exists():
        return []
    pts = []
    with open(REF_CSV) as f:
        for row in csv.reader(f):
            std, rate, pt, zz, snr, nblocks, nblkerr, nbits, nbiterr, nit = \
                [x.strip() for x in row]
            if (std == standard and abs(float(rate) - rate_float) < 1e-3
                    and int(pt) == ptype_int and int(zz) == z):
                pts.append({"snr": float(snr), "nbits": int(nbits),
                            "nbiterr": int(nbiterr),
                            "ber": int(nbiterr) / int(nbits)})
    return sorted(pts, key=lambda p: p["snr"])


def measure_ber(code, snr_db, n_blocks, seed):
    sigma2 = 1.0 / 10 ** (snr_db / 10.0)
    root = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.arange(n_blocks))

    def tx(key):
        ku, kn = jax.random.split(key)
        u = jax.random.bernoulli(ku, 0.5, (code.K,)).astype(jnp.int32)
        x = code.encode(u)
        y = (1.0 - 2.0 * x) + jnp.sqrt(sigma2) * jax.random.normal(
            kn, (code.N,))
        return x, 2.0 / sigma2 * y

    xs, llrs = jax.jit(jax.vmap(tx))(keys)
    res = bp_decode(jnp.asarray(llrs, jnp.float32), code.graph,
                    max_iters=200, method="sumprod")
    errs = int(jnp.sum((res.app < 0).astype(jnp.int32) != xs))
    return errs, n_blocks * code.K


@pytest.mark.skipif(not REF_CSV.exists(),
                    reason="reference campaign data not available")
@pytest.mark.parametrize("standard,rate,rate_f,z,ptype", [
    ("16", "1/2", 0.5, 3, "A"),
    ("11", "1/2", 0.5, 27, "A"),
    ("11", "5/6", 0.833333, 81, "A"),   # high rate + largest 802.11n z
    ("11", "3/4", 0.75, 54, "A"),
    ("16", "2/3", 0.666667, 27, "B"),   # type-B protograph family
    ("16", "3/4", 0.75, 81, "B"),
])
def test_ber_matches_reference_campaign(standard, rate, rate_f, z, ptype):
    std_name = "802.16" if standard == "16" else "802.11n"
    code = get_code(std_name, rate, z, ptype)
    pts = load_reference_points(standard, rate_f, 0 if ptype == "A" else 1, z)
    assert len(pts) >= 8, "expected a measured waterfall for this config"

    # sample the waterfall: a high-BER point, a mid point, and a low point
    high = pts[0]
    mid = next(p for p in pts if 1e-3 < p["ber"] < 3e-2)
    checked = 0
    for p, n_blocks in [(high, 200), (mid, 600)]:
        errs, nbits = measure_ber(code, p["snr"], n_blocks, seed=z)
        ours = errs / nbits
        ref = p["ber"]
        # binomial 4-sigma on both sides + small absolute floor; bit errors
        # within a block are correlated, widen by the typical burst size
        burst = 8.0
        sig = np.sqrt(burst * (ours * (1 - ours) / nbits +
                               ref * (1 - ref) / p["nbits"]))
        assert abs(ours - ref) < max(4 * sig, 0.015), \
            (std_name, z, p["snr"], ours, ref)
        checked += 1
    assert checked == 2
