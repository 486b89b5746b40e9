"""KKT backend shoot-out: the measurement behind `api._AUTO_BACKEND`.

For each bench cell and each backend (inv, chol, banded) this times

  * the per-iteration cost of one solver phase run for a fixed number of
    iterations (eps 0, stall exit and infeasibility checks off, so every
    backend runs exactly the same count; includes the factorisation and
    its adaptive-rho refreshes, amortised), in f32 and in f64 — the
    hybrid pipeline runs its bulk in f32 and its refinement in f64;
  * for the cells that finish in milliseconds, the end-to-end solve at
    the bench's 1e-6 settings with the backend forced.

Cells: monte_carlo_128 (shared-matrix batch, no declared band),
random_qp (dense), mpc_rendezvous and low_thrust_socp (block-banded
MPC structure declared). Prints one JSON line per measurement and a
markdown table.

    python scripts/bench_backends.py
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from admm_library import Settings, solve  # noqa: E402
from admm_library.api import _phase_jit  # noqa: E402
from admm_library.models import monte_carlo as mc  # noqa: E402
from admm_library.models.double_integrator import build_mpc_qp  # noqa
from admm_library.models.low_thrust import build_low_thrust_socp  # noqa
from admm_library.models.random_qp import random_box_qp  # noqa: E402
from admm_library.parallel.batch import solve_batch_shared  # noqa: E402
from admm_library.utils.compile_cache import enable_compile_cache  # noqa

EPS = 1e-6
ITERS = 250


def timed(fn, reps=3):
    out = jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, statistics.median(ts)


def cells():
    """(name, qp, band_block, batched, backends, e2e settings or None)."""
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(0), batch=128, N=50, dim=3)
    yield ("monte_carlo_128", qp, spec.block, True,
           ("inv", "chol", "banded"),
           Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block))
    qp = random_box_qp(jax.random.PRNGKey(0))
    yield ("random_qp", qp, 0, False, ("inv", "chol"),
           Settings(eps_abs=EPS, eps_rel=EPS))
    rng = np.random.default_rng(0)
    s0 = np.concatenate([rng.uniform(-2, 2, 3), rng.uniform(-0.2, 0.2, 3)])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=50, dim=3)
    yield ("mpc_rendezvous", qp, spec.block, False,
           ("inv", "chol", "banded"),
           Settings(eps_abs=EPS, eps_rel=EPS, band_block=spec.block))
    qp, spec = build_low_thrust_socp(
        np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=200)
    yield ("low_thrust_socp", qp, spec.block, False,
           ("inv", "chol", "banded"), None)


def per_iteration(qp, band, batched, backend, dtype):
    s = Settings(precision="single", eps_abs=0.0, eps_rel=0.0,
                 eps_pinf=0.0, eps_dinf=0.0, stall_checks=0,
                 max_iter=ITERS, backend=backend, band_block=band)
    q = qp.astype(dtype)
    if batched:
        fn = lambda: solve_batch_shared(q, s)                  # noqa: E731
    else:
        x0 = jnp.zeros((q.n,), dtype)
        z0 = jnp.zeros((q.m,), dtype)
        fn = lambda: _phase_jit(q, x0, z0, z0, s, backend)     # noqa: E731
    sol, dt = timed(fn)
    it = int(np.max(np.asarray(sol.iters)))
    return {"iters": it, "seconds": dt, "us_per_iter": 1e6 * dt / it}


def end_to_end(qp, batched, settings, backend):
    s = settings.replace(backend=backend)
    fn = ((lambda: solve_batch_shared(qp, s)) if batched
          else (lambda: solve(qp, s)))
    sol, dt = timed(fn)
    st = np.asarray(sol.status).reshape(-1)
    return {"iters": int(np.max(np.asarray(sol.iters))), "seconds": dt,
            "solved": bool(np.all(st == 1))}


def main():
    enable_compile_cache()
    dev = jax.devices()[0]
    rows = []
    for name, qp, band, batched, backends, e2e in cells():
        for be in backends:
            for dtype in (jnp.float32, jnp.float64):
                rec = {"cell": name, "backend": be,
                       "what": f"phase_{jnp.dtype(dtype).name}",
                       **per_iteration(qp, band, batched, be, dtype)}
                rows.append(rec)
                print(json.dumps(rec), flush=True)
            if e2e is not None:
                rec = {"cell": name, "backend": be, "what": "solve_1e-6",
                       **end_to_end(qp, batched, e2e, be)}
                rows.append(rec)
                print(json.dumps(rec), flush=True)
    print(f"\n{dev.device_kind}, {len(jax.devices())} device(s)")
    print("| cell | backend | measurement | iters | time | us/iter |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        per = r.get("us_per_iter")
        print(f"| {r['cell']} | {r['backend']} | {r['what']} | "
              f"{r['iters']} | {r['seconds'] * 1e3:.3f} ms | "
              f"{'' if per is None else f'{per:.2f}'} |")


if __name__ == "__main__":
    main()
