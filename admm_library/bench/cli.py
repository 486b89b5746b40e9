"""Benchmark harness — component S2 (SURVEY.md §2.2, §3.4).

Runs the five BASELINE.json configs and reports, per config:
    iters_per_s        ADMM iterations/s (lockstep loop rate x batch for
                       batched configs -> problem-iterations/s where noted)
    wall_clock_s       wall-clock of the timed solve (compile excluded)
    r_prim / r_dual    final unscaled residual inf-norms
    status             solver status

The primary BASELINE metric is config 5's lockstep iters/s on the
1024-scenario Monte-Carlo batch (target: >= 1e4 iters/s per chip on the
horizon-50 rendezvous set — BASELINE.json "north_star").

Compilation is set-up: every config compiles and runs once before it
is timed, and the persistent compilation cache
(utils/compile_cache.py) keeps compiled programs across processes.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import Settings, solve
from ..models import monte_carlo as mc
from ..models.clohessy_wiltshire import build_cw_rendezvous
from ..models.double_integrator import build_mpc_qp
from ..models.low_thrust import build_low_thrust_socp
from ..models.random_qp import random_box_qp
from ..parallel.batch import solve_batch_shared
from ..solution import Status
from ..utils.compile_cache import enable_compile_cache

EPS = 1e-6


def _timed(fn, *args, reps=20, budget_s=3.0):
    """Compile+run once (set-up, not timed), then measure two disciplines:

    * BLOCKING latency (`wall_clock_blocking_s`, `latency_single_shot_s`):
      each rep individually `block_until_ready`'d — what one caller who
      waits for each answer (an MPC loop) sees.
    * PIPELINED throughput (`wall_clock_s`, the headline basis): K solves
      dispatched back-to-back with ONE final block, per-solve =
      batch_time / K — what a batch server that overlaps dispatch with
      device work sees.

    Rep policy: floor of 5 blocking reps / 2 pipelined batches, early
    stop past `budget_s` per discipline. A config whose single solve
    exceeds `budget_s` gets one more blocking rep and no pipelined
    discipline (`wall_clock_s` = the blocking median)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    single = time.perf_counter() - t0
    if single > budget_s:
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        rep2 = time.perf_counter() - t0
        med = float(np.median([single, rep2]))
        stats = {
            "wall_clock_s": med,
            "wall_clock_min_s": float(min(single, rep2)),
            "wall_clock_mean_s": float(np.mean([single, rep2])),
            "wall_clock_spread": float(abs(single - rep2) / med),
            "pipeline_depth": 1,
            "pipeline_batches": 0,
            "wall_clock_blocking_s": med,
            "wall_clock_blocking_min_s": float(min(single, rep2)),
            "wall_clock_blocking_spread": float(
                abs(single - rep2) / med),
            "reps": 2,
            "latency_single_shot_s": single,
        }
        return out, stats
    times = []
    t_start = time.perf_counter()
    for i in range(max(reps, 5)):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        if i + 1 >= 5 and time.perf_counter() - t_start > budget_s:
            break
    times = np.asarray(times)
    med_blk = float(np.median(times))
    # Pipeline depth: bounded so one batch stays ~budget_s/3.
    k = int(np.clip(round((budget_s / 3.0) / max(med_blk, 1e-4)), 3, 10))
    pipe = []
    t_start = time.perf_counter()
    for b in range(4):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(k)]
        jax.block_until_ready(outs)
        pipe.append((time.perf_counter() - t0) / k)
        if b + 1 >= 2 and time.perf_counter() - t_start > budget_s:
            break
    pipe = np.asarray(pipe)
    stats = {
        "wall_clock_s": float(np.median(pipe)),
        "wall_clock_min_s": float(np.min(pipe)),
        "wall_clock_mean_s": float(np.mean(pipe)),
        "wall_clock_spread": float((np.max(pipe) - np.min(pipe))
                                   / np.median(pipe)),
        "pipeline_depth": k,
        "pipeline_batches": int(pipe.size),
        "wall_clock_blocking_s": med_blk,
        "wall_clock_blocking_min_s": float(np.min(times)),
        "wall_clock_blocking_spread": float(
            (np.max(times) - np.min(times)) / med_blk),
        "reps": int(times.size),
        "latency_single_shot_s": single,
    }
    return out, stats


def _settings_delta(s):
    """Non-default Settings fields — each config's report records the
    exact convergence criterion and tuning it ran with, so a capture is
    self-describing (ADVICE r4)."""
    import dataclasses
    base = Settings()
    return {f.name: getattr(s, f.name)
            for f in dataclasses.fields(s)
            if getattr(s, f.name) != getattr(base, f.name)}


def _report(name, sol, stats, batch=1, settings=None):
    """Bench record. `iters` is the lockstep (slowest-lane) count that
    sets wall-clock; per-lane honest counts are summarised so the
    throughput numbers stay interpretable (VERDICT r1 item 9). `stats`
    is the _timed dict (median/min/mean/spread/reps/single-shot)."""
    lane = np.asarray(sol.iters).reshape(-1)
    iters = int(np.max(lane))
    status = np.asarray(sol.status).reshape(-1)
    all_solved = bool(np.all(status == int(Status.SOLVED)))
    # Per-status histogram (VERDICT r3 item 10): a MAX_ITER lane must be
    # diagnosable from the JSON alone, not collapsed to NOT_ALL_SOLVED.
    vals, counts = np.unique(status, return_counts=True)
    status_counts = {Status(int(v)).name: int(c)
                     for v, c in zip(vals, counts)}
    dt = stats["wall_clock_s"]
    dev = jax.devices()[0]
    return {
        "config": name,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **({"settings": _settings_delta(settings)}
           if settings is not None else {}),
        "status": "SOLVED" if all_solved else "NOT_ALL_SOLVED",
        "status_counts": status_counts,
        "iters": iters,
        "iters_lane_mean": float(np.mean(lane)),
        "iters_lane_p50": float(np.percentile(lane, 50)),
        "iters_lane_max": int(np.max(lane)),
        "batch": batch,
        **stats,
        "iters_per_s": float(iters / dt),
        "problem_iters_per_s": float(iters * batch / dt),
        "r_prim": float(np.max(np.asarray(sol.r_prim))),
        "r_dual": float(np.max(np.asarray(sol.r_dual))),
    }


def bench_random_qp(seed: int = 0):
    """Config 1: box-constrained random dense QP (n=100, m=200)."""
    qp = random_box_qp(jax.random.PRNGKey(seed))
    s = Settings(eps_abs=EPS, eps_rel=EPS)
    sol, stats = _timed(lambda: solve(qp, s))
    return _report("random_qp", sol, stats, settings=s)


def bench_mpc(seed: int = 0):
    """Config 2: double-integrator min-energy rendezvous, N=50, banded."""
    rng = np.random.default_rng(seed)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=50, dim=3)
    s = Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block)
    sol, stats = _timed(lambda: solve(qp, s))
    return _report("mpc_rendezvous", sol, stats, settings=s)


def bench_cw(seed: int = 0):
    """Config 3: CW impulsive rendezvous, L1 min-fuel."""
    rng = np.random.default_rng(seed)
    s0 = np.array([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05])
    s0[:3] += rng.uniform(-20, 20, 3)
    qp, spec = build_cw_rendezvous(s0, N=20)
    s = Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000)
    sol, stats = _timed(lambda: solve(qp, s))
    return _report("cw_minfuel", sol, stats, settings=s)


def bench_low_thrust(seed: int = 0):
    """Config 4: low-thrust SOCP, N=200 nodes, thrust-magnitude cones.

    Near-absolute criterion (eps_abs=1e-6, eps_rel=5e-8): the problem
    is built in canonical units so the absolute term dominates. This
    DEGENERATE bang-bang SOCP (cost linear in the cone t's, ~191/200
    blocks at the cone tip at the optimum) defeats every f32 stage of
    the solver — measured on CPU: the raw f32 phase chatters at
    r_p 5.7e-2 after 50k iterations and the re-centered rounds are all
    safeguard-rejected from that point.
    The pipeline that lands 1e-6 (api.solve SOC delegation +
    _f64_continuation): f32 stages stall-exit fast (stall_checks=16),
    then chunked warm-started f64 ADMM with rho_soc_scale=100 (tip
    rows converge at the equality rate), with a tangent-linearized SOC
    polish attempt between chunks — the polish lands from a ~1e-5
    point with the correct 191-tip/9-boundary classification
    (r_p 6e-13, r_d 4e-7). 'inv' replaces the banded scan (200
    sequential 10x10 block steps — latency-bound at B=1) with one
    (n, n) matvec per iteration."""
    s0 = np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1])
    qp, spec = build_low_thrust_socp(s0, N=200)
    s = Settings(eps_abs=EPS, eps_rel=5e-8, band_block=spec.block,
                 max_iter=50000,
                 rho_soc_scale=100.0, stall_checks=16, backend="inv")
    sol, stats = _timed(lambda: solve(qp, s))
    return _report("low_thrust_socp", sol, stats, settings=s)


def bench_monte_carlo(seed: int = 0, batch: int = 1024):
    """Config 5 — THE BASELINE metric: 1024 dispersed horizon-50
    rendezvous QPs, shared-matrix batch, lockstep iters/s per chip.

    ADMM_BENCH_HISTORY=N records the on-device
    residual ring buffer (N slots) and emits the filled entries as
    `trace` [(iter, r_prim, r_dual), ...] — the bitwise-stability
    artifact: same-topology reruns are bitwise identical; different
    topologies agree to <= 1e-6 (reduction order differs across mesh
    shapes; see tests/test_batch_shared.py)."""
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(seed), batch=batch, N=50, dim=3)
    hist = int(os.environ.get("ADMM_BENCH_HISTORY", "0"))
    s = Settings(eps_abs=EPS, eps_rel=EPS, history=hist)
    sol, stats = _timed(lambda: solve_batch_shared(qp, s))
    rep = _report(f"monte_carlo_{batch}", sol, stats, batch=batch,
                  settings=s)
    if hist:
        h = np.asarray(sol.history)
        h = h[h[:, 0] > 0]
        h = h[np.argsort(h[:, 0])]
        rep["trace"] = [[float(a), float(b), float(c)] for a, b, c in h]
    return rep


def bench_consensus_mc(seed: int = 0, batch: int = 1024, N: int = 50,
                       n_blocks: int = 10, horizon_devices: int = 1):
    """Config 5 AS SPEC'D (BASELINE.json configs[5]): consensus ADMM over
    `batch` Monte-Carlo dispersed scenarios of the horizon-N rendezvous
    problem, horizon-block partitioned into `n_blocks` blocks, solved by
    `consensus_solve_mc` over a (data x horizon) mesh.

    On a single chip the mesh is 1x1 (all blocks device-local); the
    algorithm — block-local KKT solves, consensus averaging z-update,
    per-scenario masking — is identical to the multi-chip program.
    """
    from ..models.partitioned import partition_mpc_mc
    from ..parallel.consensus_mc import consensus_solve_mc
    from ..parallel.runtime import make_mesh

    ndev = len(jax.devices())
    h = min(horizon_devices, ndev)
    while n_blocks % h or ndev % h:
        h -= 1
    mesh = make_mesh(data=ndev // h, horizon=h)
    rng = np.random.default_rng(seed)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec, mpc, _ = partition_mpc_mc(
        jax.random.PRNGKey(seed), batch, s0, np.zeros(6), N=N,
        n_blocks=n_blocks, dim=3)
    # rho_edge_scale=30 is the sweep winner ON THIS horizon-50 set
    # (2750 -> 1525 lockstep iters at batch 32); it regresses
    # small consensus problems, so it lives here in the bench config,
    # not in the Settings default.
    s = Settings(eps_abs=EPS, eps_rel=EPS, rho_edge_scale=30.0)
    sol, stats = _timed(lambda: consensus_solve_mc(qp, spec, mesh, s))
    rep = _report(f"consensus_mc_{batch}", sol, stats, batch=batch,
                  settings=s)
    rep["n_blocks"] = n_blocks
    rep["mesh"] = dict(mesh.shape)
    return rep


def bench_horizon_spike(seed: int = 0, batch: int = 1024, N: int = 50,
                        parts: int = 10):
    """Config 5, horizon-partitioned WITHOUT the consensus iteration
    penalty: the same 1024-scenario horizon-50 batch as consensus_mc,
    but the x-update solves the block-tridiagonal KKT EXACTLY across
    the 10 horizon partitions (ops/spike.py SPIKE decomposition), so
    the ADMM iterates — and the 325-iteration count — are identical to
    the un-partitioned monte_carlo run by construction. Compare against
    consensus_mc_1024 (duplicated-boundary consensus ADMM: 1525
    lockstep iterations on the same physics) for the framework's answer
    to P2's boundary-negotiation penalty (VERDICT r3 item 5; momentum
    on the consensus duals diverges — PERF.md negative result)."""
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(seed), batch=batch, N=N, dim=3)
    s = Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block,
                 backend="spike", spike_parts=parts)
    sol, stats = _timed(lambda: solve_batch_shared(qp, s))
    rep = _report(f"horizon_spike_{batch}", sol, stats, batch=batch,
                  settings=s)
    rep["spike_parts"] = parts
    return rep


def bench_rowshard(seed: int = 0, n: int = 4096, m: int = 8192):
    """P3: ONE large QP (n=4096, m=8192 — A+P ≈ 200 MB f32) with A
    row-sharded over every available device, solved by the matrix-free
    row-sharded CG to ABSOLUTE 1e-6 via the hybrid re-centered path.

    On a multi-device mesh each CG step runs one psum over the row axis;
    on one device the mesh is 1-wide.
    """
    from ..parallel.batch import make_data_mesh
    from ..parallel.rowshard import solve_rowsharded_hybrid

    # Generate on the host CPU backend and upload once: the hybrid
    # driver's f64 true-residual bookkeeping is host-side (see
    # solve_rowsharded_hybrid) and needs a host copy of the matrices.
    # JAX PRNG bits are platform-independent and the generator's dots
    # are pinned to f32 (xprec), so the problem is identical either way.
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.default_device(cpu):
        qp_host = random_box_qp(jax.random.PRNGKey(seed), n=n, m=m,
                                dtype=jnp.float32)
    qp = jax.device_put(qp_host, jax.devices()[0])
    jax.block_until_ready(qp.A)
    ndev = len(jax.devices())
    mesh = make_data_mesh(ndev)
    s = Settings(eps_abs=EPS, eps_rel=EPS, backend="cg")
    sol, stats = _timed(
        lambda: solve_rowsharded_hybrid(qp, mesh, s, qp_host=qp_host),
        reps=8)
    rep = _report("rowshard_qp4096", sol, stats, settings=s)
    rep["n"], rep["m"], rep["n_devices"] = n, m, ndev
    return rep


def run_config(name: str, seed: int = 0):
    """Run one named benchmark config; returns its report dict."""
    return CONFIGS[name](seed)


CONFIGS = {
    "random_qp": bench_random_qp,
    "mpc_rendezvous": bench_mpc,
    "cw_minfuel": bench_cw,
    "low_thrust_socp": bench_low_thrust,
    "monte_carlo": bench_monte_carlo,
    # The 128-lane headline cell (its re-cut for one card is ROADMAP
    # Reach item c).
    "monte_carlo_128": lambda seed: bench_monte_carlo(seed, batch=128),
    "consensus_mc": bench_consensus_mc,
    "horizon_spike": bench_horizon_spike,
    "rowshard": bench_rowshard,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="ADMM benchmark harness")
    p.add_argument("configs", nargs="*", default=list(CONFIGS),
                   help=f"configs to run (default: all of {list(CONFIGS)})")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="also write the full capture (headline + configs "
                        "+ topology) as one JSON file")
    args = p.parse_args(argv)
    enable_compile_cache()
    out = []
    for name in args.configs:
        r = CONFIGS[name](args.seed)
        out.append(r)
        print(json.dumps(r), flush=True)
        if args.out:
            # Write after EVERY config: a crash in a late config must
            # not lose the capture.
            _write_capture(args.out, out)
    return out


def _write_capture(path, reports):
    import datetime

    from ..parallel.runtime import describe

    by_name = {r["config"]: r for r in reports}
    head = by_name.get("monte_carlo_128")
    capture = {
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
        "date": datetime.date.today().isoformat(),
        "eps": EPS,
        "timing": {
            "wall_clock_s": "per-solve PIPELINED wall-clock: K solves "
                            "dispatched back-to-back, one final block, "
                            "batch_time/K (median over batches)",
            "wall_clock_blocking_s": "median of per-rep blocking calls "
                                     "(incl. host sync each rep)",
            "latency_single_shot_s": "one isolated blocking call",
        },
        "headline": None if head is None else {
            "metric": "admm_iters_per_s_chip_mc_h50_batch128",
            "value": head["iters_per_s"],
            "vs_baseline": head["iters_per_s"] / 1.0e4,
        },
        "topology": describe(),
        "configs": by_name,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(capture, f, indent=1)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
