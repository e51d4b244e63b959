"""Multi-host Monte-Carlo smoke run.

Launches the dp-sharded SPARC Monte-Carlo across multiple PROCESSES with
`jax.distributed` — the same code path a real multi-host cluster uses
(each host sees its local devices; `psum` counters reduce across the
process boundary over the distributed runtime).

Run (single machine, 2 emulated hosts with 2 CPU devices each):

    python examples/multihost_mc.py --nprocs 2

The launcher spawns worker copies of itself with
JAX_COORDINATOR/PROCESS_ID env vars; each worker initializes
jax.distributed, builds the global mesh, and runs its shard. Worker 0
prints the psum-reduced counters, which must equal the single-process run.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def worker(nprocs: int, pid: int, port: int):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=2")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=nprocs, process_id=pid)
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import SparcParams, DecodeParams
    from ldpc_sparc_tpu.parallel.mesh import make_mesh
    from ldpc_sparc_tpu.parallel.montecarlo import sparc_mc_counts

    n_dev = len(jax.devices())
    assert n_dev == 2 * nprocs, f"global devices {n_dev}"
    mesh = make_mesh(sec=1)
    params = SparcParams(P=15.0, R=1.3, L=64, M=16)
    counts = sparc_mc_counts(params, DecodeParams(t_max=10), 1.0, seed=0,
                             n_trials=2 * n_dev, mesh=mesh)
    if pid == 0:
        print({"processes": nprocs, "global_devices": n_dev, **counts})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=19527)
    ap.add_argument("--worker", type=int, default=None)
    args = ap.parse_args()

    if args.worker is not None:
        worker(args.nprocs, args.worker, args.port)
        return

    procs = []
    for pid in range(args.nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "--nprocs", str(args.nprocs),
             "--port", str(args.port), "--worker", str(pid)],
            stdout=None if pid == 0 else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL))
    codes = [p.wait(timeout=600) for p in procs]
    assert all(c == 0 for c in codes), codes
    print("multi-process run OK")


if __name__ == "__main__":
    main()
