"""Multi-host benchmark hook — host-count scaling measurement points
(BASELINE.json "metric": iters/s at 1 chip, 1 host, N>=2 hosts;
VERDICT r2 missing item 2).

Two ways to run:

1. SEVERAL HOSTS (one process per host):

       # on every host i of N:
       python -m admm_library.bench.multihost \
           --coordinator <host0>:8476 --num-processes N --process-id i \
           --batch 1024 --horizon 50

   Each process joins via jax.distributed.initialize, lays the shared
   1024-scenario Monte-Carlo batch over the host-spanning ('data',)
   mesh, times the solve, and prints one JSON line with the per-host
   and global rates. Process 0's line is the scaling record. Give
   --coordinator, --num-processes and --process-id explicitly: nothing
   on a GPU host tells JAX of a cluster.

2. LOCALHOST SMOKE (CPU, what CI/this sandbox can measure):

       python -m admm_library.bench.multihost --spawn 2

   Spawns 2 copies of itself on localhost, each with 4 virtual CPU
   devices (an 8-device 2-process mesh), and prints the combined
   record. CPU rates are not device rates; the point is that the path
   is one command and the REPORTED SHAPE matches the multi-host run.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(n: int, argv_rest: list[str]) -> int:
    """Spawn n localhost worker copies (CPU backend, 4 virtual devices
    each) and print the combined scaling record."""
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in range(n):
        env = dict(env_base)
        env["ADMM_MH_FORCE_CPU"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "admm_library.bench.multihost",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n), "--process-id", str(pid),
             *argv_rest],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True))
    recs = []
    for p in procs:
        out, err = p.communicate(timeout=1200)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            sys.stderr.write(err[-4000:])
            return p.returncode
        recs.append(json.loads(out.strip().splitlines()[-1]))
    combined = {
        "config": "multihost_monte_carlo",
        "num_hosts": n,
        "records": recs,
        # Host-count scaling point: the lockstep rate of the
        # host-spanning solve (identical on every process — one global
        # program) plus the aggregate problem throughput.
        "iters_per_s": recs[0]["iters_per_s"],
        "problem_iters_per_s_global": sum(
            r["problem_iters_per_s_local"] for r in recs),
    }
    print(json.dumps(combined), flush=True)
    return 0


def worker(args) -> int:
    if os.environ.get("ADMM_MH_FORCE_CPU"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{args.local_devices}").strip()
    import jax

    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id)
    # x64 types enable the hybrid (f32 re-centered) precision path — the
    # one the 1e-6 metric names; iterations stay f32 either way.
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from .. import Settings
    from ..models import monte_carlo as mc
    from ..parallel.batch import (make_data_mesh, shard_batch,
                                  solve_batch_shared)
    from ..parallel.runtime import describe
    from ..solution import Status
    from .cli import _timed

    ndev = jax.device_count()
    batch = args.batch - args.batch % ndev if args.batch >= ndev else ndev
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(args.seed), batch=batch, N=args.horizon,
        dim=3, dtype=jnp.float32)
    mesh = make_data_mesh(ndev)
    qp_s, *_ = shard_batch(qp, mesh)
    precision = "hybrid" if jax.config.jax_enable_x64 else "single"
    s = Settings(eps_abs=args.eps, eps_rel=args.eps, precision=precision)
    sol, stats = _timed(lambda: solve_batch_shared(qp_s, s),
                        reps=args.reps)
    if jax.process_count() > 1:
        # Outputs span non-addressable devices; gather before fetching.
        from jax.experimental import multihost_utils
        gather = lambda a: np.asarray(
            multihost_utils.process_allgather(a, tiled=True))
    else:
        gather = np.asarray
    lane = gather(sol.iters).reshape(-1)
    status_v = gather(sol.status)
    rp_v, rd_v = gather(sol.r_prim), gather(sol.r_dual)
    iters = int(np.max(lane))
    dt = stats["wall_clock_s"]
    rec = {
        **describe(),
        "batch_global": batch,
        "batch_local": batch // jax.process_count(),
        "horizon": args.horizon,
        "eps": args.eps,
        "precision": precision,
        "status_all_solved": bool(np.all(
            status_v == int(Status.SOLVED))),
        "iters": iters,
        **stats,
        "iters_per_s": float(iters / dt),
        "problem_iters_per_s_local": float(
            iters * batch / jax.process_count() / dt),
        "r_prim_max": float(np.max(rp_v)),
        "r_dual_max": float(np.max(rd_v)),
    }
    print(json.dumps(rec), flush=True)
    if jax.process_count() > 1:
        jax.distributed.shutdown()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Host-count scaling benchmark (P4)")
    p.add_argument("--spawn", type=int, default=0,
                   help="spawn N localhost CPU processes (smoke mode)")
    p.add_argument("--coordinator", default=os.environ.get(
        "JAX_COORDINATOR_ADDRESS"))
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--local-devices", type=int, default=4,
                   help="virtual devices per spawned CPU process")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args, rest = p.parse_known_args(argv)
    if args.spawn:
        fwd = []
        for k in ("batch", "horizon", "eps", "reps", "seed",
                  "local_devices"):
            fwd += [f"--{k.replace('_', '-')}", str(getattr(args, k))]
        return spawn(args.spawn, fwd + rest)
    return worker(args)


if __name__ == "__main__":
    sys.exit(main())
