"""Bring-up check of the solver's main paths on one NVIDIA GPU.

Run from the root of the repository:

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # only the paths that span 4 cards

One process drives the card(s). Each phase prints one JSON line with its
status and wall time (compilation included); the last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and is printed only when every phase passed. The script exits non-zero,
with no such line, when JAX finds no GPU, when the package cannot be
imported, or when any phase fails.

One-card phases (sizes and settings as in admm_library/bench/cli.py):
  device        platform, card name and power limit, JAX version, flags;
  headline      solve_batch_shared on the 1024-scenario horizon-50 MC
                batch at eps 1e-6: every lane SOLVED, every lane passing
                an independent f64 KKT check on the host;
  headline_cpu  the same program at batch 128 on the card and on the CPU
                backend of this process, problem generated on each;
  single_qp     solve() on random_qp, mpc_rendezvous, cw_minfuel and
                low_thrust_socp, each SOLVED and oracle-checked;
  partitioned   horizon_spike (1024 x 10 parts), consensus_mc (1024 x 10
                blocks) and rowshard (n=4096, m=8192), each SOLVED.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

EPS = 1e-6
# check_every of the default Settings: the lockstep loop tests
# convergence once per this many iterations, so two runs that round
# differently can stop one interval apart.
CHECK_EVERY = 25
# x from the card vs x from the CPU backend, same data, same program run
# in f64 throughout (precision='double'): only reduction order differs
# (cuBLAS/cuSOLVER against the CPU's kernels), which moves x by ~1e-8
# (measured on the H100). A TF32 leak (10-bit mantissa) moves it ~1e-3.
X_TOL_SAME_PROGRAM = 1e-5
# The same comparison for the default hybrid pipeline: its f32 phase
# factors M in f32, where the explicit inverse carries kappa(M) * eps_f32
# ~ 1e-4 relative error (kappa ~ 8e4 on the headline batch) that differs
# between the two backends, so the lanes stop at different points of
# the 1e-6 residual ball; x moves by up to residual / curvature within
# it (1.3e-5 measured on the H100, with equal lockstep counts).
X_TOL_HYBRID = 5e-5
# Data-parallel mesh vs one device, same program: only the shared-rho
# geomean's reduction order differs.
X_TOL_MESH = 1e-6
# Two solves that stop independently at the 1e-6 mixed criterion (the
# single-QP solves on card vs CPU, partitioned solvers on 4 vs 1 card):
# each x is within ~residual / curvature of the optimum.
X_TOL_INDEPENDENT = 1e-4


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_name_and_power_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def linf(v, axis=-1):
    import numpy as np
    return np.max(np.abs(v), axis=axis)


def oracle_check(qp, x, z, y, eps_abs, eps_rel) -> dict:
    """Independent f64 KKT check of (x, z, y) on the host CPU.

    Residuals come from utils/oracle.kkt_residuals evaluated in f64 on
    the CPU backend (plus SOC-membership of z for cone rows); the mixed
    criterion's scales are recomputed here in numpy. Works for one
    problem or a bound-batched one (shared P, A; x of shape (B, n)).
    """
    import jax
    import numpy as np
    from admm_library.utils.oracle import kkt_residuals

    cpu = jax.devices("cpu")[0]
    f64 = np.float64
    host = jax.device_get((qp, x, z, y))
    qp_h, x, z, y = host
    with jax.default_device(cpu):
        qp64 = jax.device_put(qp_h, cpu).astype(f64)
        r_p, r_d, _ = kkt_residuals(
            qp64, *(jax.device_put(np.asarray(v, f64), cpu)
                    for v in (x, z, y)))
    r_p, r_d = np.asarray(r_p), np.asarray(r_d)
    P, A = np.asarray(qp_h.P, f64), np.asarray(qp_h.A, f64)
    q, lam = np.asarray(qp_h.q, f64), np.asarray(qp_h.lam, f64)
    x, z, y = (np.asarray(v, f64) for v in (x, z, y))
    Ax, Px, Aty = x @ A.T, x @ P.T, y @ A
    cone = qp_h.cone
    if cone.m_soc:
        zs = z[..., cone.m_box + cone.m_l1:]
        d = cone.soc_dims[0]
        check(cone.soc_uniform, "oracle supports uniform SOC blocks")
        blk = zs.reshape(zs.shape[:-1] + (cone.n_soc, d))
        viol = np.maximum(
            np.linalg.norm(blk[..., 1:], axis=-1) - blk[..., 0], 0.0)
        r_p = np.maximum(r_p, np.max(viol, axis=-1))
    l1 = 0.0
    if cone.m_l1:
        rows = A[cone.m_box:cone.m_box + cone.m_l1]
        l1 = float(np.max(lam[:, None] * np.abs(rows)))
    eps_p = eps_abs + eps_rel * np.maximum(linf(Ax), linf(z))
    eps_d = eps_abs + eps_rel * np.maximum(
        np.maximum(linf(Px), linf(Aty)), max(float(linf(q)), l1))
    ok = (r_p <= eps_p) & (r_d <= eps_d)
    check(bool(np.all(ok)),
          f"oracle: {int(np.size(ok) - np.sum(ok))} of {np.size(ok)} "
          f"fail the mixed {eps_abs:g}/{eps_rel:g} criterion "
          f"(worst r_p/eps_p {float(np.max(r_p / eps_p)):.3g}, "
          f"r_d/eps_d {float(np.max(r_d / eps_d)):.3g})")
    return {"oracle_r_prim": float(np.max(r_p)),
            "oracle_r_dual": float(np.max(r_d))}


def all_solved(status, what: str) -> None:
    import numpy as np
    from admm_library.solution import Status

    st = np.asarray(status).reshape(-1)
    bad = st != int(Status.SOLVED)
    check(not bool(np.any(bad)),
          f"{what}: {int(np.sum(bad))} of {st.size} not SOLVED "
          f"(statuses {sorted(set(st.tolist()))})")


def x_drift(a, b) -> float:
    """max|a - b| relative to 1 + max|b|, on the host."""
    import numpy as np
    a, b = (np.asarray(v, np.float64) for v in (a, b))
    if b.size == 0:
        return 0.0
    return float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))


# --------------------------------------------------------------------
# One-card phases
# --------------------------------------------------------------------

def device_phase(platform: str = "gpu") -> dict:
    """Require JAX's first device to be on `platform`; describe it."""
    import jax

    dev = jax.devices()[0]
    check(dev.platform == platform,
          f"JAX's first device is {dev.platform!r} ({dev.device_kind}), "
          f"not {platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "jax": jax.__version__,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "card": card_name_and_power_limit()}


def headline_phase(batch: int = 1024, N: int = 50, dim: int = 3) -> dict:
    """solve_batch_shared on the MC rendezvous batch at eps 1e-6."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from admm_library import Settings, resolve_backend
    from admm_library.models import monte_carlo as mc
    from admm_library.parallel import batch as pb

    qp, _, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(0), batch=batch, N=N, dim=dim)
    s = Settings(eps_abs=EPS, eps_rel=EPS)
    sol = jax.block_until_ready(pb.solve_batch_shared(qp, s))
    all_solved(sol.status, "headline")
    info = oracle_check(qp, sol.x, sol.z, sol.y, EPS, EPS)
    B, n, m = batch, qp.n, qp.m
    zeros = (jnp.zeros((B, n), qp.dtype), jnp.zeros((B, m), qp.dtype),
             jnp.zeros((B, m), qp.dtype))
    backend = resolve_backend(s)
    compiled = pb._solve_shared_jit.lower(
        qp, *zeros, settings=s, backend=backend).compile()
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {"batch": B, "n": n, "m": m, "backend": backend,
            "lockstep_iters": int(np.max(np.asarray(sol.iters))),
            "memory_analysis": {f: int(getattr(mem, f)) for f in fields
                                if hasattr(mem, f)},
            **info}


def headline_cpu_phase(batch: int = 128, N: int = 50, dim: int = 3) -> dict:
    """The headline program on the default device and on the CPU backend,
    each on a problem generated from the same seed on its own device:
    once in f64 throughout (the precision check) and once with the
    default hybrid pipeline."""
    import jax
    import numpy as np
    from admm_library import Settings
    from admm_library.models import monte_carlo as mc
    from admm_library.parallel.batch import solve_batch_shared

    cpu = jax.devices("cpu")[0]
    out = {"batch": batch}

    def run(s):
        qp, _, _ = mc.monte_carlo_mpc(
            jax.random.PRNGKey(0), batch=batch, N=N, dim=dim)
        return qp, jax.block_until_ready(solve_batch_shared(qp, s))

    for label, precision, tol in (("double", "double", X_TOL_SAME_PROGRAM),
                                  ("hybrid", "hybrid", X_TOL_HYBRID)):
        s = Settings(eps_abs=EPS, eps_rel=EPS, precision=precision)
        qp_d, sol_d = run(s)
        with jax.default_device(cpu):
            qp_c, sol_c = run(s)
        check(list(sol_c.x.devices()) == [cpu], "CPU run left the CPU")
        gen = max(x_drift(a, b) for a, b in zip(
            jax.tree.leaves(jax.device_get(qp_d)),
            jax.tree.leaves(jax.device_get(qp_c))))
        rec = {"gen_drift": gen, "x_drift": x_drift(sol_d.x, sol_c.x),
               "x_tol": tol,
               "iters_device": int(np.max(np.asarray(sol_d.iters))),
               "iters_cpu": int(np.max(np.asarray(sol_c.iters)))}
        out[label] = rec
        check(gen <= 1e-6, f"problem generated on the device differs "
                           f"from the CPU's by {gen:.3g} (relative)")
        all_solved(sol_d.status, f"{label} device run")
        all_solved(sol_c.status, f"{label} CPU run")
        check(rec["x_drift"] <= tol,
              f"{label}: x drift device vs CPU {rec['x_drift']:.3g} > "
              f"{tol:g}")
        check(abs(rec["iters_device"] - rec["iters_cpu"]) <= CHECK_EVERY,
              f"{label}: lockstep iterations device {rec['iters_device']}"
              f" vs CPU {rec['iters_cpu']}")
    return out


def _single_qp_problems(small: bool = False):
    """(name, qp, settings, compare_with_cpu) at bench/cli.py settings;
    `small` cuts the horizons for a CPU rehearsal."""
    import jax
    import numpy as np
    from admm_library import Settings
    from admm_library.models.clohessy_wiltshire import build_cw_rendezvous
    from admm_library.models.double_integrator import build_mpc_qp
    from admm_library.models.low_thrust import build_low_thrust_socp
    from admm_library.models.random_qp import random_box_qp

    out = []
    qp = random_box_qp(jax.random.PRNGKey(0), *((20, 40) if small else ()))
    out.append(("random_qp", qp, Settings(eps_abs=EPS, eps_rel=EPS), True))
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=8 if small else 50, dim=3)
    out.append(("mpc_rendezvous", qp,
                Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block),
                True))
    rng = np.random.default_rng(0)
    s0 = np.array([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05])
    s0[:3] += rng.uniform(-20, 20, 3)
    qp, spec = build_cw_rendezvous(s0, N=6 if small else 20)
    out.append(("cw_minfuel", qp,
                Settings(eps_abs=EPS, eps_rel=EPS, max_iter=50000), True))
    if small:
        qp, spec = build_low_thrust_socp(
            np.array([200.0, -1500.0, 50.0, 0.0, 0.8, -0.05]), N=25,
            dt=240.0, u_max=0.05)
    else:
        qp, spec = build_low_thrust_socp(
            np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=200)
    out.append(("low_thrust_socp", qp,
                Settings(eps_abs=EPS, eps_rel=5e-8, band_block=spec.block,
                         max_iter=50000, rho_soc_scale=100.0,
                         stall_checks=16, backend="inv"), False))
    return out


def single_qp_phase(small: bool = False) -> dict:
    """solve() on the four single-problem configs."""
    import jax
    import numpy as np
    from admm_library import api, solve

    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    # low_thrust_socp must end in the on-device f64 continuation: count
    # its calls through the module attribute solve() looks up.
    calls = []
    inner = api._f64_continuation

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    out = {}
    api._f64_continuation = counted
    try:
        for name, qp, s, compare in _single_qp_problems(small):
            t0 = time.perf_counter()
            calls.clear()
            sol = jax.block_until_ready(solve(qp, s))
            rec = {"seconds": time.perf_counter() - t0,
                   "iters": int(sol.iters)}
            all_solved(sol.status, name)
            check(list(sol.x.devices()) == [dev],
                  f"{name}: solution not on {dev}")
            rec.update(oracle_check(qp, sol.x, sol.z, sol.y,
                                    s.eps_abs, s.eps_rel))
            if name == "low_thrust_socp" and dev.platform == "gpu":
                check(len(calls) > 0,
                      "low_thrust_socp did not reach _f64_continuation")
                rec["f64_continuation_calls"] = len(calls)
            if compare:
                with jax.default_device(cpu):
                    sol_c = jax.block_until_ready(
                        solve(jax.device_put(qp, cpu), s))
                all_solved(sol_c.status, f"{name} on CPU")
                rec["x_drift_vs_cpu"] = x_drift(sol.x, sol_c.x)
                rec["iters_cpu"] = int(sol_c.iters)
                check(rec["x_drift_vs_cpu"] <= X_TOL_INDEPENDENT,
                      f"{name}: x drift vs CPU {rec['x_drift_vs_cpu']:.3g}")
            out[name] = rec
    finally:
        api._f64_continuation = inner
    return out


def partitioned_phase(batch: int = 1024, N: int = 50, parts: int = 10,
                      n_row: int = 4096, m_row: int = 8192) -> dict:
    """horizon_spike, consensus_mc and rowshard on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from admm_library import Settings
    from admm_library.models import monte_carlo as mc
    from admm_library.models.partitioned import partition_mpc_mc
    from admm_library.models.random_qp import random_box_qp
    from admm_library.parallel.batch import make_data_mesh, solve_batch_shared
    from admm_library.parallel.consensus_mc import consensus_solve_mc
    from admm_library.parallel.rowshard import solve_rowsharded_hybrid
    from admm_library.parallel.runtime import make_mesh

    out = {}
    t0 = time.perf_counter()
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(0), batch=batch, N=N, dim=3)
    s = Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block,
                 backend="spike", spike_parts=parts)
    sol = jax.block_until_ready(solve_batch_shared(qp, s))
    all_solved(sol.status, "horizon_spike")
    out["horizon_spike"] = {
        "seconds": time.perf_counter() - t0,
        "lockstep_iters": int(np.max(np.asarray(sol.iters))),
        **oracle_check(qp, sol.x, sol.z, sol.y, EPS, EPS)}

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qpc, cspec, _, _ = partition_mpc_mc(
        jax.random.PRNGKey(0), batch, s0, np.zeros(6), N=N,
        n_blocks=parts, dim=3)
    s = Settings(eps_abs=EPS, eps_rel=EPS, rho_edge_scale=30.0)
    csol = jax.block_until_ready(
        consensus_solve_mc(qpc, cspec, make_mesh(data=1, horizon=1,
                                                 devices=jax.devices()[:1]),
                           s))
    all_solved(csol.status, "consensus_mc")
    out["consensus_mc"] = {
        "seconds": time.perf_counter() - t0,
        "lockstep_iters": int(np.max(np.asarray(csol.iters)))}

    t0 = time.perf_counter()
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        qp_host = random_box_qp(jax.random.PRNGKey(0), n=n_row, m=m_row,
                                dtype=jnp.float32)
    qpr = jax.device_put(qp_host, jax.devices()[0])
    s = Settings(eps_abs=EPS, eps_rel=EPS, backend="cg")
    rsol = jax.block_until_ready(solve_rowsharded_hybrid(
        qpr, make_data_mesh(1), s, qp_host=qp_host))
    all_solved(rsol.status, "rowshard")
    out["rowshard"] = {
        "seconds": time.perf_counter() - t0, "iters": int(rsol.iters),
        **oracle_check(qp_host, rsol.x, rsol.z, rsol.y, EPS, EPS)}
    return out


# --------------------------------------------------------------------
# Four-card phases: each multi-card path against its one-card run
# --------------------------------------------------------------------

def four_card_data_parallel(n_dev: int = 4, batch: int = 1024,
                            N: int = 50) -> dict:
    """P1: the shared batch over a ('data',) mesh vs one device, in f64
    throughout (the 1e-6 rule: only the shared-rho geomean's reduction
    order differs) and with the default hybrid pipeline (whose f32 phase
    amplifies that rounding through kappa(M), as in headline_cpu)."""
    import jax
    import numpy as np
    from admm_library import Settings
    from admm_library.models import monte_carlo as mc
    from admm_library.parallel.batch import (make_data_mesh, shard_batch,
                                             solve_batch_shared)

    qp, _, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(0), batch=batch, N=N, dim=3)
    out = {}
    for precision, tol in (("double", X_TOL_MESH), ("hybrid", X_TOL_HYBRID)):
        s = Settings(eps_abs=EPS, eps_rel=EPS, precision=precision)
        sols = {}
        for k in (n_dev, 1):
            qp_k, *_ = shard_batch(qp, make_data_mesh(k))
            sols[k] = jax.block_until_ready(solve_batch_shared(qp_k, s))
            all_solved(sols[k].status,
                       f"{precision} data-parallel on {k} devices")
        dx = x_drift(jax.device_get(sols[n_dev].x),
                     jax.device_get(sols[1].x))
        out[precision] = {"x_drift": dx, "x_tol": tol, "lockstep_iters": {
            k: int(np.max(np.asarray(v.iters))) for k, v in sols.items()}}
        check(dx <= tol, f"{precision}: {n_dev}-device vs 1-device drift "
                         f"{dx:.3g} > {tol:g}")
    out["x_drift"] = max(v["x_drift"] for v in out.values())
    return out


def four_card_horizon_spike(n_dev: int = 4, batch: int = 1024,
                            N: int = 48) -> dict:
    """Horizon-sharded SPIKE on (data=1, horizon=n_dev) vs the
    un-partitioned solve_batch_shared (plain f64 ADMM on both sides, the
    algorithm the horizon-sharded solver implements; N=48 so the horizon
    splits evenly over 4 devices)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from admm_library import Settings
    from admm_library.models import monte_carlo as mc
    from admm_library.models.double_integrator import MPCSpec
    from admm_library.parallel.batch import solve_batch_shared
    from admm_library.parallel.horizon import (mpc_row_time, partition_qp,
                                               solve_horizon_sharded)
    from admm_library.parallel.runtime import make_mesh

    qp, _, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(0), batch=batch, N=N, dim=3, dtype=jnp.float64)
    mspec = MPCSpec(N=N, dim=3, dt=1.0)
    hp, hspec = partition_qp(qp, mspec.block, n_dev,
                             mpc_row_time(N, mspec.ns, mspec.nu))
    plain = Settings(eps_abs=EPS, eps_rel=EPS, precision="double",
                     scaling_iters=0, restart_every=0, stall_checks=0,
                     polish=False, eps_pinf=0.0, eps_dinf=0.0)
    sol_h = jax.block_until_ready(solve_horizon_sharded(
        hp, hspec, make_mesh(data=1, horizon=n_dev,
                             devices=jax.devices()[:n_dev]), plain))
    all_solved(sol_h.status, "horizon-sharded SPIKE")
    sol_r = jax.block_until_ready(
        solve_batch_shared(qp, plain.replace(backend="chol")))
    all_solved(sol_r.status, "un-partitioned reference")
    it_h = int(np.max(np.asarray(sol_h.iters)))
    it_r = int(np.max(np.asarray(sol_r.iters)))
    dx = x_drift(np.asarray(sol_h.x).reshape(batch, -1), sol_r.x)
    check(abs(it_h - it_r) <= CHECK_EVERY,
          f"iterations sharded {it_h} vs reference {it_r}")
    check(dx <= X_TOL_MESH, f"x drift {dx:.3g}")
    return {"x_drift": dx, "iters": it_h, "iters_reference": it_r}


def four_card_consensus_mc(n_dev: int = 4, batch: int = 1024, N: int = 48,
                           n_blocks: int = 8) -> dict:
    """consensus_mc on make_mesh(data=1, horizon=n_dev) vs one device."""
    import jax
    import numpy as np
    from admm_library import Settings
    from admm_library.models.partitioned import partition_mpc_mc
    from admm_library.parallel.consensus_mc import consensus_solve_mc
    from admm_library.parallel.runtime import make_mesh

    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec, _, _ = partition_mpc_mc(
        jax.random.PRNGKey(0), batch, s0, np.zeros(6), N=N,
        n_blocks=n_blocks, dim=3)
    s = Settings(eps_abs=EPS, eps_rel=EPS, rho_edge_scale=30.0)
    sols = {}
    for k in (n_dev, 1):
        mesh = make_mesh(data=1, horizon=k, devices=jax.devices()[:k])
        sols[k] = jax.block_until_ready(consensus_solve_mc(qp, spec, mesh, s))
        all_solved(sols[k].status, f"consensus_mc on {k} devices")
    dx = x_drift(jax.device_get(sols[n_dev].x), jax.device_get(sols[1].x))
    check(dx <= X_TOL_INDEPENDENT, f"x drift {dx:.3g}")
    return {"x_drift": dx, "lockstep_iters": {
        k: int(np.max(np.asarray(v.iters))) for k, v in sols.items()}}


def four_card_rowshard(n_dev: int = 4, n: int = 4096,
                       m: int = 8192) -> dict:
    """Row-sharded QP over n_dev devices vs one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from admm_library import Settings
    from admm_library.models.random_qp import random_box_qp
    from admm_library.parallel.batch import make_data_mesh
    from admm_library.parallel.rowshard import solve_rowsharded_hybrid

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        qp_host = random_box_qp(jax.random.PRNGKey(0), n=n, m=m,
                                dtype=jnp.float32)
    # Uncommitted copy: each mesh below places it on its own devices.
    qp = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), qp_host)
    s = Settings(eps_abs=EPS, eps_rel=EPS, backend="cg")
    sols = {}
    for k in (n_dev, 1):
        sols[k] = jax.block_until_ready(solve_rowsharded_hybrid(
            qp, make_data_mesh(k), s, qp_host=qp_host))
        all_solved(sols[k].status, f"rowshard on {k} devices")
    dx = x_drift(jax.device_get(sols[n_dev].x), jax.device_get(sols[1].x))
    check(dx <= X_TOL_INDEPENDENT, f"x drift {dx:.3g}")
    return {"x_drift": dx,
            "iters": {k: int(v.iters) for k, v in sols.items()}}


# --------------------------------------------------------------------

def run_phase(name: str, fn, results: dict) -> None:
    """Run one phase; print its JSON line; record pass/fail."""
    t0 = time.perf_counter()
    try:
        info = fn()
        status = "ok"
    except Exception as e:                       # noqa: BLE001 (boundary)
        traceback.print_exc()
        info = {"error": f"{type(e).__name__}: {e}"}
        status = "FAILED"
    results[name] = status
    print(json.dumps({"phase": name, "status": status,
                      "seconds": time.perf_counter() - t0, **info},
                     default=str), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the paths that span four cards, each "
                        "against its one-card run")
    args = p.parse_args(argv)

    import jax

    from admm_library.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    results: dict = {}
    run_phase("device", device_phase, results)
    if results["device"] != "ok":
        return 1
    if args.four_cards:
        n = len(jax.devices())
        if n < 4:
            print(f"--four-cards needs 4 devices, found {n}",
                  file=sys.stderr)
            return 1
        phases = [("data_parallel_4", four_card_data_parallel),
                  ("horizon_spike_4", four_card_horizon_spike),
                  ("consensus_mc_4", four_card_consensus_mc),
                  ("rowshard_4", four_card_rowshard)]
    else:
        phases = [("headline", headline_phase),
                  ("headline_cpu", headline_cpu_phase),
                  ("single_qp", single_qp_phase),
                  ("partitioned", partitioned_phase)]
    for name, fn in phases:
        run_phase(name, fn, results)
    if any(v != "ok" for v in results.values()):
        return 1
    print(card_name_and_power_limit(), flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
