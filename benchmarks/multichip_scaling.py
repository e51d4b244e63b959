"""Multi-device scaling evidence on the virtual 8-device CPU mesh.

Absolute step times on the virtual mesh are NOT FLOP-meaningful (the mesh
paths on four real GPUs are exercised by `chip_smoke.py --four-cards`).
What this script documents *is* meaningful and mesh-shape-independent:

  * the COMMUNICATION PATTERN — which XLA collectives the ('dp','sec')
    shard_map program lowers to, counted from the compiled HLO, per mesh
    shape. The counts and operand shapes fix
    the per-iteration communication volume of the section-sharded AMP:
    one all-reduce of the replicated residual partials (n floats) per
    forward product + one all-reduce of the (Lr,) gamma matvec partials
    per iteration + one scalar pmax for the stop test, all over 'sec';
    a single 4-counter psum over 'dp' at the end.
  * PARTITION INVARIANCE — the psum-reduced error/iteration counters are
    bit-identical across every mesh shape (the same trials land on the
    same fold_in keys regardless of layout).
  * weak-scaling step times on the virtual mesh (relative trend only).

Writes docs/artifacts/multichip_scaling.json.

Usage: python benchmarks/multichip_scaling.py [--trials-per-dp 2]
"""

import argparse
import collections
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()

COLLECTIVE_RE = re.compile(
    r"\b(all-reduce|all-gather|reduce-scatter|collective-permute|"
    r"all-to-all)\b")


def count_collectives(hlo_text: str) -> dict:
    """Count collective ops in compiled HLO (start ops only, not -done)."""
    counts = collections.Counter()
    for line in hlo_text.splitlines():
        line = line.strip()
        if "=" not in line:
            continue
        rhs = line.split("=", 1)[1]
        m = COLLECTIVE_RE.search(rhs.split("(", 1)[0])
        if m:
            counts[m.group(1)] += 1
    return dict(counts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials-per-dp", type=int, default=2)
    ap.add_argument("--t-max", type=int, default=8)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams, DecodeParams
    from ldpc_sparc_tpu.parallel.mesh import make_mesh
    from ldpc_sparc_tpu.parallel.sharded import make_sharded_sim_step

    # SC config with Lc = Lambda = 32 column blocks: divisible by every
    # sec size up to 8 (CPU-sized; the layout, not the FLOPs, is the point)
    params = SparcParams(P=15.0, R=1.4, L=256, M=32,
                         spatially_coupled=True, omega=6, Lambda=32)
    decode = DecodeParams(t_max=args.t_max)

    mesh_shapes = [(1, 1), (2, 1), (4, 1), (8, 1),
                   (1, 2), (1, 4), (1, 8), (2, 4), (4, 2)]
    rows, counters_seen = [], {}
    for dp, sec in mesh_shapes:
        mesh = make_mesh(dp=dp, sec=sec)
        run, _ = make_sharded_sim_step(params, decode, awgn_var=1.0,
                                       mesh=mesh, seed=0)
        n_trials = args.trials_per_dp * 8  # constant GLOBAL work
        keys = jax.vmap(lambda i: jax.random.fold_in(
            jax.random.key(0), i))(jnp.arange(n_trials))
        sargs = run.step_args(keys)
        hlo = run.step.lower(*sargs).compile().as_text()
        colls = count_collectives(hlo)

        out = run(keys)  # compile+run
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = run(keys)
        dt = (time.perf_counter() - t0) / reps

        counters_seen[(dp, sec)] = tuple(out.values())
        row = {"mesh": f"{dp}x{sec}", "dp": dp, "sec": sec,
               "trials": n_trials, "step_ms": round(dt * 1e3, 1),
               "collectives": colls, "counters": out}
        rows.append(row)
        print(json.dumps(row), flush=True)

    base = counters_seen[(1, 1)]
    invariant = all(v == base for v in counters_seen.values())
    result = {
        "config": "SC SPARC L=256 M=32 omega=6 Lambda=32 R=1.4, "
                  f"t_max={args.t_max}, constant global work "
                  f"({args.trials_per_dp * 8} trials)",
        "partition_invariant_counters": invariant,
        "counters_1x1": dict(zip(["bit_errs", "sec_errs", "frame_errs",
                                  "iter_sum"], base)),
        "note": "virtual CPU mesh; collective counts/pattern are the "
                "hardware-relevant output, absolute times are not",
        "rows": rows,
    }
    print(json.dumps({"partition_invariant": invariant}))

    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs", "artifacts",
        "multichip_scaling.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)

    if not invariant:
        print("counters differ across mesh shapes!", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
