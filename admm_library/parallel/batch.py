"""Batch data parallelism — P1 (SURVEY.md §2.2, §3.2).

Two batch execution models:

1. `api.solve_batch` (generic): `vmap` over the full solver; every lane
   carries its own (P, A) and its own cached factor. Right when problems
   differ structurally in data.

2. `solve_batch_shared` (this module, the fast path): all lanes share
   (P, A, q is optional) and differ only in bounds/linear terms — exactly
   the Monte-Carlo dispersion shape (BASELINE.json configs[4]: dispersed
   initial states enter only the constraint bounds). The KKT matrix
   M = P + sigma I + A^T rho A is factored ONCE and every per-iteration
   solve is a single (B, n) x (n, n) matmul against the shared factor
   (with backend 'inv'). The while_loop is lockstep across lanes with
   per-lane convergence masking (frozen lanes keep their carry; honest
   per-lane iteration counts).

Sharding: lay the batch over a `('data',)` mesh axis with NamedSharding
(`shard_batch`). P/A/factor replicate; per-lane state shards; the only
cross-device traffic inside the loop is the `jnp.any(active)` predicate
reduction per check interval (SURVEY.md §3.2).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import xprec
from ..core import admm
from ..core.scaling import ruiz_equilibrate, scale_qp
from ..ops import kkt
from ..problem import QPData, objective
from ..settings import Settings
from ..solution import Solution, Status
from ..api import resolve_backend

_UNSOLVED = np.int32(int(Status.UNSOLVED))
_SOLVED = np.int32(int(Status.SOLVED))
_PINF = np.int32(int(Status.PRIMAL_INFEASIBLE))
_DINF = np.int32(int(Status.DUAL_INFEASIBLE))


class BatchCarry(NamedTuple):
    x: jax.Array            # (B, n)
    z: jax.Array            # (B, m)
    y: jax.Array            # (B, m)
    rho_bar: jax.Array      # scalar — shared so the factor stays shared
    fac: dict
    it: jax.Array           # scalar int32 (global lockstep count)
    iters_lane: jax.Array   # (B,) int32 honest per-lane counts
    status: jax.Array       # (B,) int32
    r_prim: jax.Array       # (B,)
    r_dual: jax.Array       # (B,)
    x_chk: jax.Array
    y_chk: jax.Array
    x_sum: jax.Array        # running iterate sums for restarted
    z_sum: jax.Array        # averaging (Settings.restart_every)
    y_sum: jax.Array
    avg_cnt: jax.Array      # int32 samples in the running sums
    best_ratio: jax.Array   # (B,) best scaled residual ratio per lane
    since_best: jax.Array   # (B,) int32 checks since best improved
    x_best: jax.Array       # best-ratio iterate per lane — what a
    z_best: jax.Array       # STALLED lane returns (the last iterate
    y_best: jax.Array       # can be a mid-transient excursion)
    rp_best: jax.Array
    rd_best: jax.Array
    alive: jax.Array        # bool: any lane UNSOLVED anywhere (global)
    hist: jax.Array         # (slots, 3) residual ring buffer
    hist_ptr: jax.Array


def _geomean_masked(v, mask):
    """Geometric mean of v over lanes where mask, 1.0 if none."""
    logv = jnp.where(mask, jnp.log(jnp.maximum(v, 1e-30)), 0.0)
    cnt = jnp.maximum(jnp.sum(mask), 1)
    return jnp.exp(jnp.sum(logv) / cnt)


def run_admm_batch_shared(qp: QPData, scaling, settings: Settings,
                          x0, z0, y0, backend: str,
                          band_block: int = 0,
                          data_axis: str | None = None,
                          rho0=None, z_off=None) -> BatchCarry:
    """Lockstep batched ADMM with one shared KKT factor.

    `qp` carries UNBATCHED P, A and BATCHED (B, m) l, u (and optionally
    batched q of shape (B, n)); iterates are (B, .). The shared scalar
    rho_bar adapts on the geometric-mean residual ratio of the still-
    active lanes, so the cached factor is refreshed for all lanes at
    once (a per-lane rho would break factor sharing — SURVEY.md A4).

    data_axis: when set, this driver runs INSIDE shard_map over that
    mesh axis with per-device lane shards — the batch-global quantities
    (loop liveness, the rho geomean) become psum reductions. Collectives
    are not allowed in a while_loop predicate under shard_map, so
    liveness is computed in the body and carried (`alive`).
    """
    dtype = qp.dtype
    eq_mask = admm.is_equality_row_shared(qp)
    rho0 = (jnp.asarray(settings.rho, dtype) if rho0 is None
            else jnp.clip(rho0.astype(dtype), settings.rho_min,
                          settings.rho_max))
    B = x0.shape[0]

    def factor(rho_bar):
        rv = admm.rho_vec_of(rho_bar, eq_mask, settings, qp.cone)
        return kkt.factor_condensed(
            qp.P, qp.A, settings.sigma, rv, backend, band_block,
            spike_parts=settings.spike_parts), rv

    fac0, _ = factor(rho0)
    big = jnp.full((B,), jnp.inf, dtype)
    slots = max(settings.history, 0)
    carry0 = BatchCarry(
        x=x0, z=z0, y=y0, rho_bar=rho0, fac=fac0,
        it=jnp.int32(0), iters_lane=jnp.zeros((B,), jnp.int32),
        status=jnp.full((B,), _UNSOLVED), r_prim=big, r_dual=big,
        x_chk=x0, y_chk=y0,
        x_sum=jnp.zeros_like(x0), z_sum=jnp.zeros_like(z0),
        y_sum=jnp.zeros_like(y0), avg_cnt=jnp.int32(0),
        best_ratio=big, since_best=jnp.zeros((B,), jnp.int32),
        x_best=x0, z_best=z0, y_best=y0, rp_best=big, rd_best=big,
        alive=jnp.asarray(True),
        hist=jnp.full((slots, 3), -1.0, dtype), hist_ptr=jnp.int32(0))

    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = admm.restart_cadence_checks(settings)

    def any_global(mask):
        if data_axis is None:
            return jnp.any(mask)
        return jax.lax.psum(
            jnp.sum(mask.astype(jnp.int32)), data_axis) > 0

    def geomean_global(v, mask):
        if data_axis is None:
            return _geomean_masked(v, mask)
        logv = jnp.where(mask, jnp.log(jnp.maximum(v, 1e-30)), 0.0)
        tot = jax.lax.psum(jnp.sum(logv), data_axis)
        cnt = jax.lax.psum(jnp.sum(mask), data_axis)
        return jnp.exp(tot / jnp.maximum(cnt, 1))

    def max_global(v):
        if data_axis is None:
            return jnp.max(v)
        return jax.lax.pmax(jnp.max(v), data_axis)

    def cond(c: BatchCarry):
        return c.alive & (c.it < settings.max_iter)

    def body(c: BatchCarry) -> BatchCarry:
        rho_vec = admm.rho_vec_of(c.rho_bar, eq_mask, settings, qp.cone)
        active = c.status == _UNSOLVED

        x, z, y = admm.iterate_block(
            qp, c.fac, c.x, c.z, c.y, rho_vec, settings, backend, k,
            z_off=z_off)
        # Freeze converged/infeasible lanes.
        am = active[:, None]
        x = jnp.where(am, x, c.x)
        z = jnp.where(am, z, c.z)
        y = jnp.where(am, y, c.y)
        it = c.it + k
        iters_lane = c.iters_lane + jnp.where(active, k, 0)

        res = admm.residuals(qp, scaling, x, z, y)

        # Per-lane restarted averaging (Settings.restart_every; see
        # core.admm.run_admm): adopt a lane's running average iff its
        # scaled residuals beat the lane's current iterate. Frozen lanes
        # never restart (their sums hold identical copies anyway).
        x_sum = c.x_sum + x
        z_sum = c.z_sum + z
        y_sum = c.y_sum + y
        cnt = c.avg_cnt + 1
        if restart_checks:
            boundary = (c.it // k) % restart_checks == restart_checks - 1

            def try_restart(args):
                x, z, y, res, xs, zs, ys, cnt = args
                denom = jnp.maximum(cnt, 1).astype(dtype)
                xa, za, ya = xs / denom, zs / denom, ys / denom
                res_a = admm.residuals(qp, scaling, xa, za, ya)
                take = active & (
                    admm.scaled_resid_ratio(res_a, settings)
                    < admm.scaled_resid_ratio(res, settings))
                tl = take[:, None]
                # nq (res[6]) is point-independent (q/lam only) and may
                # be scalar while the others are per-lane — keep it.
                res_o = tuple(jnp.where(take, ra, rc)
                              for ra, rc in zip(res_a[:6], res[:6])
                              ) + (res[6],)
                zero = lambda v: jnp.zeros_like(v)
                return (jnp.where(tl, xa, x), jnp.where(tl, za, z),
                        jnp.where(tl, ya, y), res_o,
                        zero(xs), zero(zs), zero(ys), jnp.int32(0))

            x, z, y, res, x_sum, z_sum, y_sum, cnt = jax.lax.cond(
                boundary, try_restart, lambda a: a,
                (x, z, y, res, x_sum, z_sum, y_sum, cnt))

        r_prim, r_dual = res[0], res[1]
        eps_p, eps_d = admm.eps_thresholds(res, settings)
        solved = (r_prim <= eps_p) & (r_dual <= eps_d)
        pinf, dinf = admm.infeasibility(
            qp, scaling, x - c.x_chk, y - c.y_chk, settings)
        numerr = ~(jnp.isfinite(r_prim) & jnp.isfinite(r_dual))
        new_status = jnp.where(
            numerr, jnp.int32(int(Status.NUMERICAL_ERROR)),
            jnp.where(solved, _SOLVED,
                      jnp.where(pinf, _PINF,
                                jnp.where(dinf, _DINF, _UNSOLVED))))
        # Per-lane stall exit (Settings.stall_checks; cf. core.admm).
        ratio_now = admm.scaled_resid_ratio(res, settings)
        improved = active & (ratio_now < c.best_ratio)
        best_ratio = jnp.where(improved, ratio_now, c.best_ratio)
        since_best = jnp.where(
            active, jnp.where(improved, 0, c.since_best + 1),
            c.since_best)
        iml = improved[:, None]
        x_best = jnp.where(iml, x, c.x_best)
        z_best = jnp.where(iml, z, c.z_best)
        y_best = jnp.where(iml, y, c.y_best)
        rp_best = jnp.where(improved, res[0], c.rp_best)
        rd_best = jnp.where(improved, res[1], c.rd_best)
        if settings.stall_checks > 0:
            stalled = since_best >= settings.stall_checks
            new_status = jnp.where(
                (new_status == _UNSOLVED) & stalled,
                jnp.int32(int(Status.STALLED)), new_status)
            # A stalling lane freezes at its BEST iterate, not the
            # current one — stall can fire mid-excursion (e.g. a
            # too-small warm rho sends the x-update on a transient).
            swap = active & stalled & (new_status == jnp.int32(
                int(Status.STALLED)))
            sl = swap[:, None]
            x = jnp.where(sl, x_best, x)
            z = jnp.where(sl, z_best, z)
            y = jnp.where(sl, y_best, y)
            res = (jnp.where(swap, rp_best, res[0]),
                   jnp.where(swap, rd_best, res[1])) + res[2:]
        status = jnp.where(active, new_status, c.status)
        r_prim = jnp.where(active, r_prim, c.r_prim)
        r_dual = jnp.where(active, r_dual, c.r_dual)

        # Shared adaptive rho from the active lanes' geomean ratio.
        rho_bar, fac = c.rho_bar, c.fac
        still = status == _UNSOLVED
        if settings.adaptive_rho:
            adapt_now = (c.it // k) % interval_checks == (interval_checks - 1)
            tiny = jnp.finfo(dtype).tiny
            _, _, nAx, nz, nPx, nAty, nq = res
            sp = res[0] / jnp.maximum(jnp.maximum(nAx, nz), tiny)
            sd = res[1] / jnp.maximum(
                jnp.maximum(jnp.maximum(nPx, nAty), nq), tiny)
            ratio = jnp.sqrt(geomean_global(sp, still)
                             / jnp.maximum(geomean_global(sd, still), tiny))
            new_rho = jnp.clip(
                rho_bar * ratio, settings.rho_min, settings.rho_max)
            tol = settings.adaptive_rho_tol
            changed = (ratio > tol) | (ratio < 1.0 / tol)
            do = adapt_now & changed & any_global(still)
            if backend == "cg":
                rho_bar = jnp.where(do, new_rho, rho_bar)
                rv = admm.rho_vec_of(rho_bar, eq_mask, settings, qp.cone)
                fac = dict(c.fac, rho=rv)
            else:
                fac = jax.lax.cond(
                    do, lambda r: factor(r)[0], lambda r: fac, new_rho)
                rho_bar = jnp.where(do, new_rho, rho_bar)

        alive = any_global(still)
        if slots > 0:
            entry = jnp.stack([it.astype(dtype), max_global(r_prim),
                               max_global(r_dual)])
            hist = jax.lax.dynamic_update_slice(
                c.hist, entry[None, :], (c.hist_ptr % slots, jnp.int32(0)))
            hist_ptr = c.hist_ptr + 1
        else:
            hist, hist_ptr = c.hist, c.hist_ptr

        return BatchCarry(
            x=x, z=z, y=y, rho_bar=rho_bar, fac=fac, it=it,
            iters_lane=iters_lane, status=status,
            r_prim=r_prim, r_dual=r_dual, x_chk=x, y_chk=y,
            x_sum=x_sum, z_sum=z_sum, y_sum=y_sum, avg_cnt=cnt,
            best_ratio=best_ratio, since_best=since_best,
            x_best=x_best, z_best=z_best, y_best=y_best,
            rp_best=rp_best, rd_best=rd_best,
            alive=alive, hist=hist, hist_ptr=hist_ptr)

    final = jax.lax.while_loop(cond, body, carry0)
    # Lanes that ran out of iterations also return their BEST iterate.
    unsolved = final.status == _UNSOLVED
    um = unsolved[:, None]
    x = jnp.where(um, final.x_best, final.x)
    z = jnp.where(um, final.z_best, final.z)
    y = jnp.where(um, final.y_best, final.y)
    r_prim = jnp.where(unsolved, final.rp_best, final.r_prim)
    r_dual = jnp.where(unsolved, final.rd_best, final.r_dual)
    status = jnp.where(
        unsolved, jnp.int32(int(Status.MAX_ITER)), final.status)
    return final._replace(status=status, x=x, z=z, y=y,
                          r_prim=r_prim, r_dual=r_dual)


def _phase(qp, x0, z0, y0, settings, backend, mesh=None, axis="data",
           scaling=None, rho0=None, z_off=None):
    # Exact-f32 dots throughout (no reduced-precision passes; xprec).
    with xprec.highest():
        return _phase_inner(qp, x0, z0, y0, settings, backend, mesh, axis,
                            scaling, rho0, z_off)


def _phase_inner(qp, x0, z0, y0, settings, backend, mesh=None,
                 axis="data", scaling=None, rho0=None, z_off=None):
    if scaling is not None:
        # Precomputed scaling (re-centered rounds: same P/A as phase 1,
        # so the iterative Ruiz loop would recompute identical factors).
        scaling = scaling.astype(qp.dtype)
        qps = scale_qp(qp, scaling)
    else:
        qps, scaling = ruiz_equilibrate(qp, settings.scaling_iters)
    if settings.warm_start:
        xs = scaling.scale_x(x0)
        zs = scaling.scale_z(z0)
        ys = scaling.scale_y(y0)
    else:
        xs, zs, ys = x0, z0, y0
    if z_off is not None:
        # Shifted-prox offsets live in z-space; keep the OFFSET dtype
        # (f64 from the re-centered rounds — ops/prox upcasts there).
        z_off = scaling.e.astype(z_off.dtype) * z_off
    if mesh is not None and mesh.shape[axis] > 1:
        # Multi-device: run the whole lockstep driver INSIDE shard_map —
        # per-device lane shards, device-local KKT factor and iteration
        # block, psum only for the loop liveness and the shared-rho
        # geomean.
        PA = P(axis)

        def lspec(leaf, base_ndim):
            return PA if leaf.ndim > base_ndim else P()

        qp_specs = QPData(
            P=lspec(qps.P, 2), q=lspec(qps.q, 1), A=lspec(qps.A, 2),
            l=lspec(qps.l, 1), u=lspec(qps.u, 1), lam=lspec(qps.lam, 1),
            cone=qps.cone)
        scal_specs = jax.tree.map(lambda _: P(), scaling)
        r0 = (jnp.asarray(settings.rho, qps.dtype) if rho0 is None
              else rho0.astype(qps.dtype))

        has_off = z_off is not None
        off_arg = (z_off if has_off
                   else jnp.zeros((), qps.dtype))
        off_spec = PA if has_off else P()

        def device_fn(qp_loc, scal, xs_, zs_, ys_, r0_, off_):
            c = run_admm_batch_shared(
                qp_loc, scal, settings, xs_, zs_, ys_, backend,
                band_block=settings.band_block, data_axis=axis, rho0=r0_,
                z_off=(off_ if has_off else None))
            return (c.x, c.z, c.y, c.rho_bar, c.iters_lane, c.status,
                    c.r_prim, c.r_dual, c.hist)

        fn = jax.shard_map(
            device_fn, mesh=mesh,
            in_specs=(qp_specs, scal_specs, PA, PA, PA, P(), off_spec),
            out_specs=(PA, PA, PA, P(), PA, PA, PA, PA, P()),
            check_vma=False)
        (cx, cz, cy, rho_bar, iters_lane, status, r_prim, r_dual,
         hist) = fn(qps, scaling, xs, zs, ys, r0, off_arg)
    else:
        carry = run_admm_batch_shared(
            qps, scaling, settings, xs, zs, ys, backend,
            band_block=settings.band_block, rho0=rho0, z_off=z_off)
        cx, cz, cy = carry.x, carry.z, carry.y
        rho_bar, iters_lane, status = (carry.rho_bar, carry.iters_lane,
                                       carry.status)
        r_prim, r_dual, hist = carry.r_prim, carry.r_dual, carry.hist
    x = scaling.unscale_x(cx)
    z = scaling.unscale_z(cz)
    y = scaling.unscale_y(cy)
    return Solution(
        x=x, z=z, y=y, status=status, iters=iters_lane,
        r_prim=r_prim, r_dual=r_dual,
        obj=objective(qp, x, z), rho=rho_bar, history=hist)


def _s32_of_shared(settings: Settings) -> Settings:
    """f32-phase settings (relaxed eps + f32 condition-number caps).

    rho_soc_scale is stripped here: the boost targets the LAST-DIGIT
    tip-row crawl (see Settings), but in the raw-coordinate f32 phase
    it wrecks conditioning — measured on chip (config 4): the boosted
    f32 phase chatters at r_p ~ 9e-3 where CPU/f64 converges. The
    re-centered correction rounds re-apply it (shifted coordinates
    restore f32 headroom, so the boost only steers the tail dynamics
    there)."""
    return settings.replace(
        precision="single",
        eps_abs=max(settings.hybrid_eps, settings.eps_abs),
        eps_rel=max(settings.hybrid_eps, settings.eps_rel),
        sigma=max(settings.sigma, 1e-5),
        rho_soc_scale=1.0,
        rho_eq_scale=min(settings.rho_eq_scale, 1e2))


def _clean64(v):
    v = v.astype(jnp.float64)
    return jnp.where(jnp.isfinite(v), v, 0.0)


def _solve_shared_recentered(qp: QPData, x0, z0, y0, settings: Settings,
                             backend: str, mesh=None, axis="data"):
    """Hybrid precision via f32 re-centering (all cone types).

    Round 0 solves in f32 to the f32 residual plateau (~1e-4 .. 1e-5 on
    O(100)-scale data). Each refinement round then re-solves the SAME
    QP with data shifted around the accumulated (x, y):

        g   = P x + q            (f64; becomes the correction's q)
        l,u <- l - Ax, u - Ax    (box rows: f64 shift, cast f32)

    whose exact solution (dx, dy) satisfies the ORIGINAL problem's
    stationarity for (x+dx, y+dy) and whose internal quantities live at
    the residual scale — f32 iterations there carry ~1e-11 absolute
    precision, so the target 1e-6 is reached without a single f64
    iteration. The constraint matrix is unchanged, so each round reuses
    the same factorisation structure, and a converged round exits at
    its first residual check (~check_every iterations of cost).

    L1/SOC rows do not shift affinely through their bounds; they keep
    the ORIGINAL bounds/lam and evaluate the SHIFTED prox with offset
    = Ax on those rows (prox of g(.+a) = prox_g(v+a) - a; ops/prox.
    project_cone). The offset rides in f64 (the prox upcasts), so the
    v + a rounding happens at f64, not at 6e-8·‖a‖ (this is what keeps
    SOCP/L1 batches out of the f64 iteration fallback).
    """
    f32, f64 = jnp.float32, jnp.float64
    s1 = _s32_of_shared(settings)
    qp64 = qp.astype(f64)
    # One Ruiz pass serves phase 1 AND every correction round: the
    # rounds keep the original (P, A), so re-equilibrating inside each
    # round recomputes identical (d, e) at full prologue cost.
    _, scaling1 = ruiz_equilibrate(qp.astype(f32), s1.scaling_iters)
    sol = _phase(qp.astype(f32), x0.astype(f32), z0.astype(f32),
                 y0.astype(f32), s1, backend, mesh, axis,
                 scaling=scaling1)
    p1_inf = (sol.status == _PINF) | (sol.status == _DINF)
    x_t = _clean64(sol.x)
    y_t = _clean64(sol.y)
    iters = sol.iters
    rho = sol.rho

    # Correction rounds: absolute eps at the target tolerance (the
    # eps_rel term scales with the tiny correction norms, so eps_abs
    # dominates — which is exactly the true total-residual criterion).
    s_c = s1.replace(eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
                     rho_soc_scale=settings.rho_soc_scale)
    B = x_t.shape[0]
    z_t64 = _clean64(sol.z)

    cone = qp.cone
    mb, ml = cone.m_box, cone.m_l1
    mixed = (ml + cone.m_soc) > 0
    act_tol = 10.0 * max(settings.hybrid_eps, settings.eps_abs)

    def mask_dual(y, z):
        """Dual BASE for re-centering — the part of the accumulated dual
        the correction's linear term absorbs (g_c includes Aᵀy_base;
        the round solves for the REMAINDER dy, warm-started near 0, so
        every correction quantity is O(residual) and f32 reaches
        absolute targets). Validity of y_base + dy per row type:
          box:  keep y only within act_tol of a bound (normal cones of
                boxes at a face are additive); strictly-inactive rows
                get exact-0 base so complementarity junk cannot
                accumulate across rounds.
          L1:   base = 0 — ∂(λ|z|) is BOUNDED (not a cone), so duals
                do not add; the correction's prox produces the complete
                L1 dual and it REPLACES (|dy| ≤ λ, so the f32
                cancellation floor is ~6e-8·‖λA‖ — fine for 1e-6).
          SOC:  base = Π_{N_SOC(z)}(y), the projection of the current
                dual onto the normal cone AT THE CURRENT PRIMAL:
                strictly-interior blocks → 0; boundary blocks → the
                component along the (single) normal ray n(z) =
                (1, -u/‖u‖)/√2; near-tip blocks → the polar-cone part
                of y (Moreau: y − Π_SOC(y)). Neither extreme works:
                base = 0 forces the correction to REBUILD O(‖q‖)-scale
                SOC duals in f32 (measured r_d ≈ 50 junk); keeping the
                raw y leaves off-ray components the correction's prox
                cannot cancel (the remainder lives on the ray only) —
                measured r_p pinned at 1e-4. Projection keeps the big
                valid part in g_c and leaves only the O(residual)
                ray-rotation remainder to solve in f32.
        """
        scale = 1.0 + jnp.abs(z)
        near_l = jnp.where(jnp.isfinite(qp64.l),
                           z - qp64.l <= act_tol * scale, False)
        near_u = jnp.where(jnp.isfinite(qp64.u),
                           qp64.u - z <= act_tol * scale, False)
        parts = [jnp.where((near_l | near_u)[..., :mb],
                           y[..., :mb], 0.0)]
        if ml:
            parts.append(jnp.zeros_like(y[..., mb:mb + ml]))
        if cone.m_soc:
            from ..ops.prox import project_soc_block
            d = cone.soc_dims[0]
            shp = z[..., mb + ml:].shape[:-1] + (cone.n_soc, d)
            zb = z[..., mb + ml:].reshape(shp)
            yb = y[..., mb + ml:].reshape(shp)
            t, u = zb[..., 0], zb[..., 1:]
            yt, yu = yb[..., 0], yb[..., 1:]
            nu = jnp.linalg.norm(u, axis=-1)
            sc = act_tol * (1.0 + jnp.abs(t) + nu)
            interior = nu <= t - sc
            tip = (nu <= sc) & (t <= sc)
            # Boundary outward normal ray n = (−1, u/‖u‖)/√2 (N_SOC(z)
            # at t = ‖u‖ > 0: <n, z> = 0 and n ∈ −SOC): base = <y,n>₊ n.
            safe = jnp.maximum(nu, jnp.finfo(z.dtype).tiny)
            cross = jnp.sum(yu * u, axis=-1) / safe - yt
            s_ray = 0.5 * jnp.maximum(cross, 0.0)
            ray_t = -s_ray
            ray_u = s_ray[..., None] * (u / safe[..., None])
            # Tip: polar-cone part via Moreau (y − Π_SOC(y)).
            pt, pu = project_soc_block(yt, yu)
            tip_t, tip_u = yt - pt, yu - pu
            bt = jnp.where(interior, 0.0,
                           jnp.where(tip, tip_t, ray_t))
            bu = jnp.where(interior[..., None], 0.0,
                           jnp.where(tip[..., None], tip_u, ray_u))
            base = jnp.concatenate([bt[..., None], bu], axis=-1)
            parts.append(base.reshape(z[..., mb + ml:].shape))
        return jnp.concatenate(parts, axis=-1)

    def round_fn(carry):
        x_t, y_t, z_t64, iters, rho, frozen = carry
        y_base = mask_dual(y_t, z_t64) if mixed else None
        Ax = xprec.einsum("...ij,...j->...i", qp64.A, x_t)
        Px = xprec.einsum("...ij,...j->...i", qp64.P, x_t)
        if mixed:
            # Dual re-centering: g_c = Px + q + Aᵀy_base; the round's
            # dual is the CORRECTION on that base (see mask_dual).
            Atyb = xprec.einsum("...ji,...j->...i", qp64.A, y_base)
            g = Px + qp64.q + Atyb
            # Box rows shift through the bounds; L1/SOC rows keep the
            # original bounds/lam and use the shifted prox (offset=Ax).
            l_c = jnp.concatenate(
                [qp64.l[..., :mb] - Ax[..., :mb], qp64.l[..., mb:]],
                axis=-1)
            u_c = jnp.concatenate(
                [qp64.u[..., :mb] - Ax[..., :mb], qp64.u[..., mb:]],
                axis=-1)
            z_off = jnp.concatenate(
                [jnp.zeros_like(Ax[..., :mb]), Ax[..., mb:]], axis=-1)
            y_warm = (y_t - y_base).astype(f32)
        else:
            # Box-only: g = Px + q, duals warm-started and REPLACED
            # (the correction problem is the original in shifted
            # coordinates, so its dual is a complete valid dual).
            g = Px + qp64.q
            l_c = qp64.l - Ax
            u_c = qp64.u - Ax
            z_off = None
            y_warm = y_t.astype(f32)
        qp_c = QPData(
            P=qp.P.astype(f32), q=g.astype(f32), A=qp.A.astype(f32),
            l=l_c.astype(f32), u=u_c.astype(f32),
            lam=qp.lam.astype(f32), cone=qp.cone)
        zc0 = (z_t64 - Ax).astype(f32)
        solc = _phase(qp_c, jnp.zeros((B, qp.n), f32), zc0,
                      y_warm, s_c, backend, mesh, axis,
                      scaling=scaling1, rho0=rho.astype(f32),
                      z_off=z_off)    # offset stays f64 (prox upcasts)
        x_n = x_t + _clean64(solc.x)
        if mixed:
            y_n = y_base + _clean64(solc.y)
        else:
            y_n = _clean64(solc.y)
        z_n = Ax + _clean64(solc.z)       # z_total ∈ C by construction
        # Round safeguard: accept a lane's round output only when it
        # improves the TRUE scaled residual ratio on the original f64
        # data — a round whose correction stalled mid-transient (bad
        # warm rho, misclassified dual base) must not corrupt the
        # accumulated point. Rejected lanes keep their iterate and are
        # FROZEN (re-running the identical construction would only
        # reproduce the rejection).
        ratio_old = _true_ratio(x_t, y_t, z_t64)
        ratio_new = _true_ratio(x_n, y_n, z_n)
        ok = ~frozen & (ratio_new < ratio_old)
        okl = ok[:, None]
        x_t = jnp.where(okl, x_n, x_t)
        y_t = jnp.where(okl, y_n, y_t)
        z_t64 = jnp.where(okl, z_n, z_t64)
        frozen = frozen | ~ok
        rstat = jnp.where(ok, solc.status,
                          jnp.int32(int(Status.STALLED)))
        return (x_t, y_t, z_t64, iters + solc.iters,
                solc.rho.astype(rho.dtype), frozen), rstat

    def _true_ratio(x, y, z):
        """Scaled residual ratio on the ORIGINAL f64 data (per lane)."""
        Ax = xprec.einsum("...ij,...j->...i", qp64.A, x)
        Px = xprec.einsum("...ij,...j->...i", qp64.P, x)
        Aty = xprec.einsum("...ji,...j->...i", qp64.A, y)
        linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
        r_p = linf(Ax - z)
        r_d = linf(Px + qp64.q + Aty)
        eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(
            linf(Ax), linf(z))
        eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
            jnp.maximum(linf(Px), linf(Aty)),
            jnp.maximum(linf(qp64.q), admm.l1_grad_scale_raw(qp64)))
        return jnp.maximum(r_p / eps_p, r_d / eps_d)

    carry = (x_t, y_t, z_t64, iters, rho, jnp.zeros((B,), bool))
    round_status = jnp.full((B,), _UNSOLVED)
    for r in range(max(settings.recenter_rounds, 0)):
        if r == 0:
            carry, round_status = round_fn(carry)
        else:
            # Skip later rounds at runtime once every lane met the
            # round criterion or froze (rejected round) — each round
            # costs a Ruiz pass + a factorisation + check_every
            # iterations even when it converges immediately.
            done = (round_status == _SOLVED) | carry[5]
            carry, round_status = jax.lax.cond(
                jnp.all(done),
                lambda c: (c, round_status), round_fn, carry)
    x_t, y_t, z_t64, iters, rho, _frozen = carry

    # True residuals/status in f64 on the ORIGINAL data.
    Ax = xprec.einsum("...ij,...j->...i", qp64.A, x_t)
    Px = xprec.einsum("...ij,...j->...i", qp64.P, x_t)
    Aty = xprec.einsum("...ji,...j->...i", qp64.A, y_t)
    z_t = z_t64
    r_p = jnp.max(jnp.abs(Ax - z_t), axis=-1)
    r_d = jnp.max(jnp.abs(Px + qp64.q + Aty), axis=-1)
    linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
    eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(
        linf(Ax), linf(z_t))
    # eps_d reference incl. the L1 gradient scale (matches the solver
    # loop — core.admm.l1_grad_scale).
    eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
        jnp.maximum(linf(Px), linf(Aty)),
        jnp.maximum(linf(qp64.q), admm.l1_grad_scale_raw(qp64)))
    solved = (r_p <= eps_p) & (r_d <= eps_d)
    status = jnp.where(
        p1_inf, sol.status,
        jnp.where(solved, _SOLVED, jnp.int32(int(Status.MAX_ITER))))
    d = qp.dtype
    rec = Solution(
        x=x_t.astype(d), z=z_t.astype(d), y=y_t.astype(d),
        status=status, iters=iters,
        r_prim=r_p.astype(d), r_dual=r_d.astype(d),
        obj=objective(qp64, x_t, z_t).astype(d), rho=rho.astype(d),
        history=sol.history.astype(d))

    # f64 iteration fallback for eps targets below the f32 dual floor
    # (~1e-7 * scale: the rounds re-derive duals in f32). lax.cond
    # skips the whole phase at runtime when every lane closed in f32 —
    # the common case for 1e-6 targets. Iterations are CAPPED at
    # f64_cap: this is a warm-started last-digit refiner, and lanes that
    # need more return MAX_ITER for api.solve's chunked
    # _f64_continuation (one compiled chunk program, re-dispatched).
    # stall_checks floor: when the refiner plateaus, exiting is always
    # right — honoring a caller's stall_checks=0 here would let it grind
    # the full cap inside the one device program.
    f64_cap = 8000
    s64 = settings.replace(precision="single", warm_start=True,
                           recenter_rounds=0,
                           stall_checks=max(settings.stall_checks, 16),
                           max_iter=min(settings.max_iter, f64_cap))

    def run64(args):
        x_w, z_w, y_w = args
        sol64 = _phase(qp64, x_w, z_w, y_w, s64, backend, mesh, axis)
        return Solution(
            x=sol64.x.astype(d), z=sol64.z.astype(d),
            y=sol64.y.astype(d),
            status=jnp.where(p1_inf, sol.status, sol64.status),
            iters=iters + sol64.iters,
            r_prim=sol64.r_prim.astype(d), r_dual=sol64.r_dual.astype(d),
            obj=sol64.obj.astype(d), rho=sol64.rho.astype(d),
            history=sol64.history.astype(d))

    def keep(args):
        return rec

    return jax.lax.cond(
        jnp.any(~solved & ~p1_inf), run64, keep, (x_t, z_t, y_t))


def _solve_shared_core(qp, x0, z0, y0, settings: Settings, backend: str,
                       mesh=None, axis="data"):
    precision = settings.precision
    if precision == "hybrid" and not jax.config.jax_enable_x64:
        precision = "single"
    if precision == "single":
        return _phase(qp, x0, z0, y0, settings, backend, mesh, axis)
    if precision == "double":
        f = jnp.float64
        return _phase(qp.astype(f), x0.astype(f), z0.astype(f),
                      y0.astype(f), settings, backend, mesh, axis)
    # hybrid: f32 re-centering — box rows shift through the bounds,
    # L1/SOC rows through the shifted prox (f64 offset). The f32 + f64
    # two-phase below remains only as the recenter_rounds=0 opt-out.
    if settings.recenter_rounds > 0:
        return _solve_shared_recentered(qp, x0, z0, y0, settings, backend,
                                        mesh, axis)
    s32 = _s32_of_shared(settings)
    f32, f64 = jnp.float32, jnp.float64
    sol32 = _phase(qp.astype(f32), x0.astype(f32), z0.astype(f32),
                   y0.astype(f32), s32, backend, mesh, axis)
    s64 = settings.replace(precision="single", warm_start=True)

    clean = _clean64

    sol64 = _phase(qp.astype(f64), clean(sol32.x),
                   clean(sol32.z), clean(sol32.y), s64, backend, mesh,
                   axis)
    p1_inf = (sol32.status == _PINF) | (sol32.status == _DINF)
    status = jnp.where(p1_inf, sol32.status, sol64.status)
    d = qp.dtype
    return Solution(
        x=sol64.x.astype(d), z=sol64.z.astype(d), y=sol64.y.astype(d),
        status=status, iters=sol32.iters + sol64.iters,
        r_prim=sol64.r_prim.astype(d), r_dual=sol64.r_dual.astype(d),
        obj=sol64.obj.astype(d), rho=sol64.rho.astype(d),
        history=sol64.history)


@partial(jax.jit, static_argnames=("settings", "backend", "mesh", "axis"))
def _solve_shared_jit(qp, x0, z0, y0, settings, backend, mesh=None,
                      axis="data"):
    return _solve_shared_core(qp, x0, z0, y0, settings, backend, mesh,
                              axis)


def solve_batch_shared(qp: QPData, settings: Settings = Settings(),
                       x0=None, z0=None, y0=None) -> Solution:
    """Solve B problems sharing (P, A) and differing in (l, u) and/or q.

    `qp` holds unbatched P (n, n) and A (m, n) with batched l, u (B, m)
    (q may be (n,) shared or (B, n) batched). One factorisation serves
    the whole batch; per-iteration x-solves are (B, n) matmuls.
    """
    if qp.l.ndim < 2:
        raise ValueError("solve_batch_shared expects batched l/u (B, m); "
                         "use solve() for a single problem")
    dtype = qp.dtype
    B = qp.l.shape[0]
    n, m = qp.n, qp.m
    if x0 is None:
        x0 = jnp.zeros((B, n), dtype)
    if z0 is None:
        z0 = jnp.zeros((B, m), dtype)
    if y0 is None:
        y0 = jnp.zeros_like(z0)
    backend = resolve_backend(settings)
    # Multi-device batches run the driver under shard_map (per-device
    # iteration + psum liveness); recover (mesh, axis) from the batch
    # sharding laid down by shard_batch.
    mesh, axis = None, "data"
    try:
        sh = qp.l.sharding
        if (isinstance(sh, NamedSharding) and len(qp.l.devices()) > 1
                and sh.spec and sh.spec[0] is not None):
            mesh, axis = sh.mesh, sh.spec[0]
    except Exception:
        mesh = None
    return _solve_shared_jit(qp, x0, z0, y0, settings, backend, mesh,
                             axis)


def make_data_mesh(n_devices: int | None = None,
                   devices=None, axis: str = "data") -> Mesh:
    """1-D device mesh over the data-parallel axis (P1)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np
    return Mesh(np.asarray(devices), (axis,))


def shard_batch(qp: QPData, mesh: Mesh, x0=None, z0=None, y0=None,
                axis: str = "data"):
    """Place a shared-matrix problem batch on a data-parallel mesh.

    Batched leaves (l, u, batched q, iterates) shard along `axis`;
    unbatched leaves (P, A, shared q) replicate. Returns the resharded
    (qp, x0, z0, y0) ready for `solve_batch_shared` — XLA then keeps
    every per-lane computation device-local; only the loop predicate
    reduction crosses devices (SURVEY.md §3.2).
    """
    def put(arr, batched):
        spec = P(axis) if batched else P()
        s = NamedSharding(mesh, spec)
        return jax.device_put(arr, s)

    qp2 = QPData(
        P=put(qp.P, qp.P.ndim > 2),
        q=put(qp.q, qp.q.ndim > 1),
        A=put(qp.A, qp.A.ndim > 2),
        l=put(qp.l, qp.l.ndim > 1),
        u=put(qp.u, qp.u.ndim > 1),
        lam=put(qp.lam, qp.lam.ndim > 1),
        cone=qp.cone)
    out = [qp2]
    for arr in (x0, z0, y0):
        out.append(None if arr is None else put(arr, True))
    return tuple(out)
