"""One profiler trace of the LDPC campaign batch on the GPU.

Config: the bench's campaign cell (802.16 rate 1/2 z=27 type A, batch 512,
sumprod2, at most 200 BP iterations). Reports, beside the card's name and
power limit:

  * blocks_per_s: BP blocks/s of the double-buffered campaign loop
    (ldpc_waterfall_campaign) over 40 batches at 1.5 dB, profiler off;
  * per_bp_iteration: device kernels and device<->host copies per BP
    iteration, from traced batches at -3 dB, where every block runs to the
    iteration limit: (count at 200 iterations - count at 100) / 100;
  * device_idle_share: 1 - (union of device activity) / (first start to
    last end), over a traced window of 10 campaign batches at 1.5 dB.

Writes <out>/bp_trace.json and the raw traces under <out>/trace_*.
Usage: python benchmarks/bp_trace.py [--out chiprun_out/bp_trace]
"""

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_activity(trace_dir):
    """(start_ns, end_ns, name) of every event on the GPU planes' stream
    lines of the newest trace under trace_dir, plus event counts by line."""
    import jax
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    events, lines = [], {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name} | {line.name}"] = len(evs)
            if "stream" in line.name.lower():
                events += [(e.start_ns, e.end_ns, e.name) for e in evs]
    return events, lines


def idle_share(events):
    """1 - busy / span, busy the union of the event intervals."""
    iv = sorted((s, e) for s, e, _ in events)
    busy, cur_s, cur_e = 0.0, iv[0][0], iv[0][1]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return 1.0 - busy / (iv[-1][1] - iv[0][0])


def is_copy(name):
    return name.lower().startswith(("memcpy", "memset"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/bp_trace")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import LdpcParams
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.parallel.montecarlo import (_batch_counts_jit,
                                                    ldpc_waterfall_campaign)
    from ldpc_sparc_tpu.utils import rng as rngmod
    from ldpc_sparc_tpu.utils.compile_cache import enable_persistent_cache
    from ldpc_sparc_tpu.utils.device import device_record
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bp_trace: no GPU")
    enable_persistent_cache()
    os.makedirs(args.out, exist_ok=True)

    params = LdpcParams(standard="802.16", rate="1/2", z=27, ptype="A")
    batch = 512

    def campaign(n_batches):
        return ldpc_waterfall_campaign(
            params, seed=7, n_measurements=1, min_errors=10 ** 9,
            max_blocks=n_batches * batch, batch=batch, dectype="sumprod2",
            max_iters=200, start_snr=1.5)

    campaign(2)                                            # compile
    t0 = time.perf_counter()
    rec = campaign(40)[0]
    dt = time.perf_counter() - t0
    out = {"device": device_record(), "config": {
        "code": "802.16 1/2 z=27 A", "batch": batch, "dectype": "sumprod2",
        "max_iters": 200}, "blocks_per_s": rec[5] / dt,
        "campaign_window": {"snr_db": 1.5, "blocks": rec[5],
                            "block_errs": rec[6], "bp_iterations": rec[9],
                            "seconds": dt}}

    tdir = os.path.join(args.out, "trace_campaign")
    jax.profiler.start_trace(tdir)
    campaign(10)
    jax.profiler.stop_trace()
    events, lines = device_activity(tdir)
    out["device_idle_share"] = idle_share(events)
    out["campaign_trace_lines"] = lines

    code = get_code("802.16", "1/2", 27, "A")
    root = rngmod.root_key(3)
    counts = {}
    for iters in (200, 100):
        run = lambda: _batch_counts_jit(code, jnp.float32(-3.0), root,
                                        jnp.int32(0), batch, iters,
                                        "sumprod2").block_until_ready()
        run()                                              # compile
        tdir = os.path.join(args.out, f"trace_fail_{iters}")
        jax.profiler.start_trace(tdir)
        for _ in range(3):
            run()
        jax.profiler.stop_trace()
        events, _ = device_activity(tdir)
        counts[iters] = {
            "kernels_per_batch": sum(not is_copy(n) for *_, n in events) / 3,
            "copies_per_batch": sum(is_copy(n) for *_, n in events) / 3}
    out["per_batch_at_minus3db"] = counts
    out["per_bp_iteration"] = {
        k: (counts[200][k] - counts[100][k]) / 100
        for k in ("kernels_per_batch", "copies_per_batch")}
    with open(os.path.join(args.out, "bp_trace.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("device", "blocks_per_s",
                                          "device_idle_share",
                                          "per_bp_iteration")}))


if __name__ == "__main__":
    main()
