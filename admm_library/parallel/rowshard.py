"""Intra-problem tensor sharding — P3 (SURVEY.md §2.2).

For a SINGLE QP too large for one chip, shard the constraint matrix A by
ROW blocks across the mesh (the tensor-parallel analog). The x-update
uses the matrix-free CG backend, whose operator

    M v = P v + sigma v + A^T diag(rho) (A v)

decomposes as: local SpMV A_loc v (device-local rows), local weighted
transpose A_loc^T (rho_loc * A_loc v), then one `psum` over the row axis
to assemble the full n-vector — one collective per CG step.
P stays replicated (it is n x n; for the condensed form it is usually
diagonal-dominant and small relative to A's m x n).

The z-update, y-update, and per-row prox are embarrassingly row-local;
global residual inf-norms are `pmax` reductions. rho enters the CG
operator directly, so adaptive rho needs no refactorisation (SURVEY.md
A4: "prefer CG — matrix-free, rho enters trivially"): every device
computes the SAME residual-balance update from the already-psum/pmax-
reduced norms, so the shared rho scalar stays bitwise replicated.

Ruiz equilibration runs on the global problem BEFORE sharding (K4); the
device loop computes UNSCALED residuals from the scaling vectors and the
driver unscales the solution at exit.

SPMD needs an identical per-device cone layout (the prox is traced once
with a static ConeSpec). When the global [box | L1 | SOC] layout does
not shard uniformly, the driver INTERLEAVES rows round-robin so every
shard gets the same (m_box/ndev | m_l1/ndev | n_soc/ndev) mix, and
permutes z/y back on exit — so mixed-cone problems (thrust SOCP rows +
box dynamics) row-shard without caller gymnastics.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.scaling import ruiz_equilibrate
from ..ops.prox import project_cone
from ..problem import ConeSpec, QPData
from ..settings import Settings
from ..solution import Status
from .. import xprec

_UNSOLVED = np.int32(int(Status.UNSOLVED))
_SOLVED = np.int32(int(Status.SOLVED))


def _pmax(v, axis):
    return jax.lax.pmax(jnp.max(jnp.abs(v)), axis)


def uniform_row_permutation(cone: ConeSpec, m: int, ndev: int):
    """Row permutation making the shards cone-uniform.

    Returns (perm, cone_local): perm[new_row] = old_row such that the
    permuted rows split into ndev contiguous shards, each laid out
    [box | L1 | SOC] with identical counts. Requires the per-type row
    counts to divide ndev (SOC: uniform block dims, block count % ndev).
    Returns (None, cone) when the layout is already shard-uniform.
    """
    mb, ml1 = cone.m_box, cone.m_l1
    n_soc = cone.n_soc if cone.m_soc else 0
    if mb % ndev or ml1 % ndev:
        raise ValueError(
            f"box rows {mb} / L1 rows {ml1} must divide {ndev} devices")
    if cone.m_soc:
        if not cone.soc_uniform:
            raise ValueError("row sharding needs uniform SOC block dims")
        if n_soc % ndev:
            raise ValueError(
                f"{n_soc} SOC blocks not divisible by {ndev} devices")
    per_box, per_l1 = mb // ndev, ml1 // ndev
    per_soc = n_soc // ndev
    d = cone.soc_dims[0] if cone.m_soc else 0
    cone_loc = ConeSpec(m_box=per_box, m_l1=per_l1,
                        soc_dims=(d,) * per_soc)
    if ndev == 1 or (ml1 == 0 and n_soc == 0) or (mb == 0 and n_soc == 0) \
            or (mb == 0 and ml1 == 0):
        # Single row type (or single device): already uniform in order.
        return None, cone_loc
    perm = []
    for dev in range(ndev):
        perm.extend(range(dev * per_box, (dev + 1) * per_box))
        perm.extend(mb + dev * per_l1 + i for i in range(per_l1))
        base = mb + ml1 + dev * per_soc * d
        perm.extend(base + i for i in range(per_soc * d))
    return np.asarray(perm, np.int32), cone_loc


class RowShardSolution(NamedTuple):
    x: jax.Array            # (n,) replicated
    z: jax.Array            # (m,) row-assembled (original row order)
    y: jax.Array            # (m,)
    status: jax.Array
    iters: jax.Array
    r_prim: jax.Array
    r_dual: jax.Array
    rho: jax.Array


def solve_rowsharded(qp: QPData, mesh: Mesh, settings: Settings = Settings(),
                     x0=None, z0=None, y0=None,
                     axis: str = "data") -> RowShardSolution:
    """Solve ONE large QP with A/l/u/rho sharded by constraint rows (P3).

    Mixed cones are supported via automatic row interleaving (see module
    docstring); optional UNSCALED (x0, z0, y0) warm start. Backend is
    the matrix-free row-sharded CG; rho adapts for free.
    """
    ndev = mesh.shape[axis]
    m, n = qp.m, qp.n
    if m % ndev != 0:
        raise ValueError(f"m={m} rows not divisible by {ndev} devices")
    m_loc = m // ndev
    dtype = qp.dtype
    s = settings

    # --- K4: global Ruiz scaling (original row order) ---
    qps, scaling = ruiz_equilibrate(qp, s.scaling_iters)

    # --- shard-uniform row layout ---
    perm, cone_loc = uniform_row_permutation(qp.cone, m, ndev)
    if cone_loc.m_soc and cone_loc.m_soc % 1:
        raise ValueError("SOC block straddles a row shard")

    lam_full = jnp.zeros((m,), dtype)
    mb, ml1 = qp.cone.m_box, qp.cone.m_l1
    if ml1:
        lam_full = lam_full.at[mb:mb + ml1].set(qps.lam)
    eq = (qps.l == qps.u) & jnp.isfinite(qps.l) & (jnp.arange(m) < mb)

    A_s, l_s, u_s, lam_s, eq_s, e_s = (qps.A, qps.l, qps.u, lam_full, eq,
                                       scaling.e)
    if perm is not None:
        pidx = jnp.asarray(perm)
        A_s, l_s, u_s = A_s[pidx], l_s[pidx], u_s[pidx]
        lam_s, eq_s, e_s = lam_s[pidx], eq_s[pidx], e_s[pidx]

    if x0 is None:
        x0 = jnp.zeros((n,), dtype)
    if z0 is None:
        z0 = jnp.zeros((m,), dtype)
    if y0 is None:
        y0 = jnp.zeros((m,), dtype)
    # Warm starts: scale, then permute into shard order.
    xs = scaling.scale_x(x0)
    zs = scaling.scale_z(z0)
    ys = scaling.scale_y(y0)
    if perm is not None:
        zs, ys = zs[pidx], ys[pidx]

    d_v, c_v = scaling.d, scaling.c

    def device_fn(P_mat, q, A_loc, l_loc, u_loc, lam_loc, eq_loc,
                  x0_, z0_, y0_, d_, e_loc, c_):
        einv_loc = 1.0 / e_loc
        cd_inv = 1.0 / (c_ * d_)
        k = s.check_every
        interval_checks = max(1, s.adaptive_rho_interval // k)
        big = jnp.asarray(jnp.inf, dtype)
        # L1 gradient scale in the dual-norm reference (core.admm.
        # l1_grad_scale rationale); L1 rows are device-local, so the
        # column max is psum-free but needs a pmax over shards.
        if cone_loc.m_l1:
            sl_l1 = slice(cone_loc.m_box, cone_loc.m_box + cone_loc.m_l1)
            lamA = jnp.max(lam_loc[sl_l1, None] * jnp.abs(A_loc[sl_l1]),
                           axis=0)
            nlam = jax.lax.pmax(jnp.max(jnp.abs(cd_inv * lamA)), axis)
        else:
            nlam = jnp.zeros((), dtype)

        def rho_of(rb):
            return jnp.where(eq_loc, s.rho_eq_scale * rb, rb)

        def iter_once(_, carry):
            x, z, y, rho_bar = carry
            rho_loc = rho_of(rho_bar)
            rhs_loc = xprec.matmul(rho_loc * z - y, A_loc)
            rhs = (s.sigma * x - q + jax.lax.psum(rhs_loc, axis))
            xt = _cg_rowsharded(P_mat, A_loc, rho_loc, s.sigma, rhs,
                                axis, s.cg_tol, s.cg_max_iter)
            zt = xprec.matmul(A_loc, xt)
            a = s.alpha
            x_new = a * xt + (1 - a) * x
            w = a * zt + (1 - a) * z
            v = w + y / rho_loc
            nl = cone_loc.m_l1
            mbl = cone_loc.m_box
            lam_r = (lam_loc[mbl:mbl + nl] / rho_loc[mbl:mbl + nl]
                     if nl else lam_loc[:0])
            z_new = project_cone(v, l_loc, u_loc, lam_r, cone_loc)
            y_new = y + rho_loc * (w - z_new)
            return x_new, z_new, y_new, rho_bar

        def row_res(x, z, y):
            """Globally-reduced unscaled residual norms (7-tuple)."""
            Ax = xprec.matmul(A_loc, x)
            Aty = jax.lax.psum(xprec.matmul(y, A_loc), axis)
            Px = xprec.matmul(P_mat, x)
            r_p = _pmax(einv_loc * (Ax - z), axis)
            r_d = jnp.max(jnp.abs(cd_inv * (Px + q + Aty)))
            nAx = _pmax(einv_loc * Ax, axis)
            nz = _pmax(einv_loc * z, axis)
            nPx = jnp.max(jnp.abs(cd_inv * Px))
            nAty = jnp.max(jnp.abs(cd_inv * Aty))
            nq = jnp.maximum(jnp.max(jnp.abs(cd_inv * q)), nlam)
            return r_p, r_d, nAx, nz, nPx, nAty, nq

        def eps_of(res):
            _, _, nAx, nz, nPx, nAty, nq = res
            eps_p = s.eps_abs + s.eps_rel * jnp.maximum(nAx, nz)
            eps_d = s.eps_abs + s.eps_rel * jnp.maximum(
                nPx, jnp.maximum(nAty, nq))
            return eps_p, eps_d

        restart_checks = s.restart_every and max(1, s.restart_every // k)

        def infeasibility_local(dx_s, dy_s):
            """OSQP §3.4 certificates on row-sharded data (A6; cf.
            core.admm.infeasibility). dx_s is replicated (n,), dy_s
            row-local (m_loc,); all cross-shard quantities reduce via
            psum/pmax so every device computes identical verdicts."""
            eps_pi = jnp.asarray(s.eps_pinf, dtype)
            eps_di = jnp.asarray(s.eps_dinf, dtype)
            tiny = jnp.finfo(dtype).tiny
            mbl = cone_loc.m_box + cone_loc.m_l1

            # ---- primal infeasibility from dy ----
            dy = (e_loc / c_) * dy_s                     # unscaled, local
            ndy = jax.lax.pmax(jnp.max(jnp.abs(dy)), axis)
            dyn = dy / jnp.maximum(ndy, tiny)
            Aty = jax.lax.psum(
                xprec.matmul((c_ / e_loc) * dyn, A_loc), axis) * cd_inv
            cond_A = jnp.max(jnp.abs(Aty)) <= eps_pi
            lu_l = l_loc[:mbl] * einv_loc[:mbl]
            lu_u = u_loc[:mbl] * einv_loc[:mbl]
            dyb = dyn[:mbl]
            big_ = jnp.asarray(jnp.inf, dtype)
            pos = dyb > eps_pi
            neg = dyb < -eps_pi
            up = jnp.where(pos, jnp.where(jnp.isfinite(lu_u),
                                          lu_u * dyb, big_), 0.0)
            lo = jnp.where(neg, jnp.where(jnp.isfinite(lu_l),
                                          lu_l * dyb, big_), 0.0)
            sup = jax.lax.psum(jnp.sum(up + lo), axis)
            if cone_loc.m_soc:
                d_soc = cone_loc.soc_dims[0]
                blk = dyn[mbl:].reshape(cone_loc.n_soc, d_soc)
                ok = (jnp.linalg.norm(blk[:, 1:], axis=-1)
                      <= -blk[:, 0] + eps_pi)
                bad = jax.lax.psum(
                    jnp.sum((~ok).astype(jnp.int32)), axis) > 0
                sup = jnp.where(bad, jnp.inf, sup)
            pinf = (ndy > 0) & cond_A & (sup <= eps_pi)

            # ---- dual infeasibility from dx (replicated) ----
            dx = d_ * dx_s
            ndx = jnp.max(jnp.abs(dx))
            dxn = dx / jnp.maximum(ndx, tiny)
            Pdx = xprec.matmul(P_mat, dxn / d_) * cd_inv
            Adx = einv_loc * xprec.matmul(A_loc, dxn / d_)
            cond_P = jnp.max(jnp.abs(Pdx)) <= eps_di
            qdx = jnp.sum((cd_inv * q) * dxn)
            if cone_loc.m_l1:
                sl = slice(cone_loc.m_box, mbl)
                lam_u = lam_loc[sl] * e_loc[sl] / c_
                qdx = qdx + jax.lax.psum(
                    jnp.sum(lam_u * jnp.abs(Adx[sl])), axis)
            cond_q = qdx <= -eps_di
            av = Adx[:mbl]
            ok_up = (av <= eps_di) | ~jnp.isfinite(lu_u)
            ok_lo = (av >= -eps_di) | ~jnp.isfinite(lu_l)
            nbad = jax.lax.psum(
                jnp.sum((~(ok_up & ok_lo)).astype(jnp.int32)), axis)
            cond_box = nbad == 0
            cond_soc = jnp.asarray(True)
            if cone_loc.m_soc:
                d_soc = cone_loc.soc_dims[0]
                blk = Adx[mbl:].reshape(cone_loc.n_soc, d_soc)
                ok = (jnp.linalg.norm(blk[:, 1:], axis=-1)
                      <= blk[:, 0] + eps_di)
                cond_soc = jax.lax.psum(
                    jnp.sum((~ok).astype(jnp.int32)), axis) == 0
            dinf = (ndx > 0) & cond_P & cond_q & cond_box & cond_soc
            return pinf, dinf

        def cond(c):
            x, z, y, rho_bar, it, status, rp, rd, *_rest = c
            return (status == _UNSOLVED) & (it < s.max_iter)

        def body(c):
            (x, z, y, rho_bar, it, status, rp, rd,
             x_sum, z_sum, y_sum, avg_cnt, x_chk, y_chk) = c
            x, z, y, _ = jax.lax.fori_loop(
                0, k, iter_once, (x, z, y, rho_bar))
            it = it + k
            res = row_res(x, z, y)

            # Restarted averaging (Settings.restart_every; cf. core.
            # admm.run_admm). All reduction inputs are global, so the
            # take decision is bitwise-replicated across shards.
            x_sum = x_sum + x
            z_sum = z_sum + z
            y_sum = y_sum + y
            avg_cnt = avg_cnt + 1
            if restart_checks:
                boundary = ((it // k - 1) % restart_checks
                            == restart_checks - 1)

                def try_restart(args):
                    x, z, y, res, xs, zs, ys, cnt = args
                    denom = jnp.maximum(cnt, 1).astype(dtype)
                    xa, za, ya = xs / denom, zs / denom, ys / denom
                    res_a = row_res(xa, za, ya)
                    ep, ed = eps_of(res)
                    epa, eda = eps_of(res_a)
                    take = (jnp.maximum(res_a[0] / epa, res_a[1] / eda)
                            < jnp.maximum(res[0] / ep, res[1] / ed))
                    pick = lambda a, b: jnp.where(take, a, b)
                    res_o = tuple(pick(ra, rc)
                                  for ra, rc in zip(res_a[:6], res[:6])
                                  ) + (res[6],)
                    zero = lambda v: jnp.zeros_like(v)
                    return (pick(xa, x), pick(za, z), pick(ya, y), res_o,
                            zero(xs), zero(zs), zero(ys), jnp.int32(0))

                x, z, y, res, x_sum, z_sum, y_sum, avg_cnt = jax.lax.cond(
                    boundary, try_restart, lambda a: a,
                    (x, z, y, res, x_sum, z_sum, y_sum, avg_cnt))

            r_p, r_d, nAx, nz, nPx, nAty, nq = res
            eps_p, eps_d = eps_of(res)
            solved = (r_p <= eps_p) & (r_d <= eps_d)
            pinf, dinf = infeasibility_local(x - x_chk, y - y_chk)
            status = jnp.where(
                solved, _SOLVED,
                jnp.where(pinf, jnp.int32(int(Status.PRIMAL_INFEASIBLE)),
                          jnp.where(dinf,
                                    jnp.int32(int(Status.DUAL_INFEASIBLE)),
                                    _UNSOLVED)))
            # Adaptive rho (A4): free under CG. All inputs below are
            # globally-reduced scalars, so every device computes the
            # identical new rho — no extra collective.
            if s.adaptive_rho:
                adapt_now = ((it // k - 1) % interval_checks
                             == (interval_checks - 1))
                tiny = jnp.finfo(dtype).tiny
                sp = r_p / jnp.maximum(jnp.maximum(nAx, nz), tiny)
                sd = r_d / jnp.maximum(
                    jnp.maximum(jnp.maximum(nPx, nAty), nq), tiny)
                ratio = jnp.sqrt(sp / jnp.maximum(sd, tiny))
                new_rho = jnp.clip(rho_bar * ratio, s.rho_min, s.rho_max)
                tol = s.adaptive_rho_tol
                changed = (ratio > tol) | (ratio < 1.0 / tol)
                do = adapt_now & changed & (status == _UNSOLVED)
                rho_bar = jnp.where(do, new_rho, rho_bar)
            return (x, z, y, rho_bar, it, status, r_p, r_d,
                    x_sum, z_sum, y_sum, avg_cnt, x, y)

        init = (x0_, z0_, y0_, jnp.asarray(s.rho, dtype), jnp.int32(0),
                _UNSOLVED, big, big,
                jnp.zeros_like(x0_), jnp.zeros_like(z0_),
                jnp.zeros_like(y0_), jnp.int32(0), x0_, y0_)
        (x, z, y, rho_bar, it, status, rp, rd,
         *_rest) = jax.lax.while_loop(cond, body, init)
        status = jnp.where(
            status == _UNSOLVED, jnp.int32(int(Status.MAX_ITER)), status)
        return x, z, y, status, it, rp, rd, rho_bar

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(), P(axis), P(axis), P(), P(axis), P()),
        out_specs=(P(), P(axis), P(axis), P(), P(), P(), P(), P()),
        check_vma=False)
    with xprec.highest():
        x, z, y, status, it, rp, rd, rho = jax.jit(sharded)(
            qps.P, qps.q, A_s, l_s, u_s, lam_s, eq_s,
            xs, zs, ys, d_v, e_s, c_v)
    # Unscale; un-permute rows back to the caller's order.
    x = scaling.unscale_x(x)
    if perm is not None:
        inv = jnp.zeros_like(pidx).at[pidx].set(
            jnp.arange(m, dtype=pidx.dtype))
        z, y = z[inv], y[inv]
    z = scaling.unscale_z(z)
    y = scaling.unscale_y(y)
    return RowShardSolution(x=x, z=z, y=y, status=status, iters=it,
                            r_prim=rp, r_dual=rd, rho=rho)


def solve_rowsharded_hybrid(qp: QPData, mesh: Mesh,
                            settings: Settings = Settings(),
                            axis: str = "data",
                            qp_host: QPData | None = None
                            ) -> RowShardSolution:
    """Hybrid-precision row-sharded solve: f32 phase + re-centered f32
    refinement rounds to ABSOLUTE eps (VERDICT r2 item 6).

    Mirrors parallel/batch._solve_shared_recentered for the single-
    problem row-sharded case, box/equality cones (the 'single huge QP'
    shape): phase 1 solves in f32 to the f32 plateau; each round then
    re-solves the SAME row-sharded program with data shifted around the
    accumulated iterate (g = Px + q, bounds <- bounds - Ax in f64,
    cast f32), warm-started duals REPLACED. Every hot iteration stays
    f32; only the per-round shift (2 f64 matvecs) runs in f64. Rounds
    are host-staged (one sync per round, ~3 rounds total).

    Mixed-cone problems fall back to a single f32 phase at the relaxed
    hybrid_eps (honest status; extend with shifted-prox offsets the way
    batch.mask_dual does if mixed-cone rowshard at 1e-6 is ever needed).
    """
    f32 = jnp.float32
    if not jax.config.jax_enable_x64 or settings.precision != "hybrid":
        return solve_rowsharded(qp, mesh, settings, axis=axis)
    # ONE Settings (and therefore ONE compiled program) for phase 1 AND
    # every refinement round, so the rounds add no compilation: phase 1
    # runs at the caller's eps with a stall exit (it leaves at the f32
    # floor ~1e-4 with STALLED — honest, cheap), and the rounds reach
    # the absolute target at the correction scale where f32 has
    # headroom. Only problem DATA changes between dispatches.
    s1 = settings.replace(
        precision="single",
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        stall_checks=max(settings.stall_checks, 16))
    if qp.cone.m_l1 or qp.cone.m_soc:
        s_relaxed = s1.replace(
            eps_abs=max(settings.hybrid_eps, settings.eps_abs),
            eps_rel=max(settings.hybrid_eps, settings.eps_rel))
        return solve_rowsharded(qp.astype(f32), mesh, s_relaxed,
                                axis=axis)

    sol = solve_rowsharded(qp.astype(f32), mesh, s1, axis=axis)
    jax.block_until_ready(sol.x)

    # The f64 TRUE-residual + re-centering bookkeeping runs HOST-SIDE
    # in numpy (ROADMAP Speed item 6 is to move it onto the device).
    # The host needs the problem data in f64 exactly once — pass
    # `qp_host` (a host copy, e.g. the generator output before device
    # upload) to skip fetching the matrices back; without it they are
    # pulled from the device on first use. Per round the host does 3
    # (m, n) f64 matvecs (~0.3 GFLOP) and ships only iterate-sized
    # vectors to the device, so every hot iteration stays f32 sharded.
    hp = qp_host if qp_host is not None else qp

    def h64(v):
        return np.asarray(v, dtype=np.float64)

    A64, P64, q64 = h64(hp.A), h64(hp.P), h64(hp.q)
    l64, u64 = h64(hp.l), h64(hp.u)

    def clean(v):
        v = h64(v)
        return np.where(np.isfinite(v), v, 0.0)

    def true_resid(x_t, y_t, z_t):
        Ax = A64 @ x_t
        Px = P64 @ x_t
        Aty = A64.T @ y_t
        r_p = float(np.max(np.abs(Ax - z_t)))
        r_d = float(np.max(np.abs(Px + q64 + Aty)))
        eps_p = settings.eps_abs + settings.eps_rel * max(
            float(np.max(np.abs(Ax))), float(np.max(np.abs(z_t))))
        eps_d = settings.eps_abs + settings.eps_rel * max(
            float(np.max(np.abs(Px))), float(np.max(np.abs(Aty))),
            float(np.max(np.abs(q64))))
        return Ax, Px, r_p, r_d, (r_p <= eps_p) and (r_d <= eps_d)

    x_t = clean(sol.x)
    y_t = clean(sol.y)
    z_t = clean(sol.z)
    iters = int(sol.iters)
    rho = sol.rho
    s_c = s1            # identical Settings -> the SAME compiled program
    solved = False
    r_p = float(sol.r_prim)
    r_d = float(sol.r_dual)
    for _ in range(max(settings.recenter_rounds, 0)):
        Ax, Px, r_p, r_d, solved = true_resid(x_t, y_t, z_t)
        if solved:
            break
        qp_c = QPData(
            P=qp.P.astype(f32), q=jnp.asarray(Px + q64, f32),
            A=qp.A.astype(f32), l=jnp.asarray(l64 - Ax, f32),
            u=jnp.asarray(u64 - Ax, f32), lam=qp.lam.astype(f32),
            cone=qp.cone)
        solc = solve_rowsharded(
            qp_c, mesh, s_c, x0=jnp.zeros_like(qp_c.q),
            z0=jnp.asarray(z_t - Ax, f32), y0=jnp.asarray(y_t, f32),
            axis=axis)
        jax.block_until_ready(solc.x)
        x_t = x_t + clean(solc.x)
        y_t = clean(solc.y)
        z_t = Ax + clean(solc.z)
        iters = iters + int(solc.iters)
        rho = solc.rho
    if not solved:
        _, _, r_p, r_d, solved = true_resid(x_t, y_t, z_t)
    status = jnp.int32(int(Status.SOLVED if solved else Status.MAX_ITER))
    d = qp.dtype
    return RowShardSolution(
        x=jnp.asarray(x_t, d), z=jnp.asarray(z_t, d),
        y=jnp.asarray(y_t, d), status=status,
        iters=jnp.int32(iters),
        r_prim=jnp.asarray(r_p, d), r_dual=jnp.asarray(r_d, d), rho=rho)


def _cg_rowsharded(P_mat, A_loc, rho_loc, sigma, rhs, axis, tol, max_iter):
    """CG on the condensed operator with row-sharded A (replicated x).

    All devices carry identical copies of the CG vectors (n,); the only
    cross-device op is the psum inside the operator, so the iterates
    stay bitwise replicated.
    """

    def op(v):
        Av = xprec.matmul(A_loc, v)                          # (m_loc,)
        At = xprec.matmul(rho_loc * Av, A_loc)               # (n,) partial
        At = jax.lax.psum(At, axis)
        return xprec.matmul(P_mat, v) + sigma * v + At

    x = jnp.zeros_like(rhs)
    r = rhs - op(x)
    p = r
    rs = jnp.sum(r * r)
    tol2 = tol * tol * jnp.maximum(jnp.sum(rhs * rhs), 1.0)

    def cond(c):
        x, r, p, rs, it = c
        return (it < max_iter) & (rs > tol2)

    def body(c):
        x, r, p, rs, it = c
        Mp = op(p)
        alpha = rs / jnp.maximum(jnp.sum(p * Mp), jnp.finfo(rs.dtype).tiny)
        x = x + alpha * p
        r = r - alpha * Mp
        rs_new = jnp.sum(r * r)
        p = r + (rs_new / jnp.maximum(rs, jnp.finfo(rs.dtype).tiny)) * p
        return x, r, p, rs_new, it + 1

    x, *_ = jax.lax.while_loop(
        cond, body, (x, r, p, rs, jnp.asarray(0, jnp.int32)))
    return x
