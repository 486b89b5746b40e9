"""ADMM core engine (components A1-A6, SURVEY.md §2.2).

OSQP-style operator splitting (arXiv:1711.08013) on

    min ½xᵀPx + qᵀx + g(z)   s.t.  Ax = z,

with g the product-cone indicator/penalty (box + L1 + SOC, see ops/prox).
One iteration (diagonal penalty R = diag(rho_vec)):

    x̃   = (P + σI + AᵀRA)⁻¹ (σx − q + Aᵀ(Rz − y))     # cached factor, L0
    z̃   = A x̃
    x⁺  = α x̃ + (1−α) x                                 # over-relaxation
    w   = α z̃ + (1−α) z
    z⁺  = Π_g(w + y/R)                                   # prox, L1
    y⁺  = y + R (w − z⁺)

Execution model: the entire solve is ONE XLA computation — a
`lax.while_loop` whose body runs `check_every` fused iterations
(`lax.fori_loop`) followed by an amortised residual/termination check.
No host sync until the final Solution fetch (BASELINE.json "north_star":
"fused on-device kernels inside a jit'd lax.while_loop").

Everything here operates on the RUIZ-SCALED problem; residuals and
termination are computed in UNSCALED quantities via the Scaling vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp

from ..ops import kkt
from .. import xprec
from ..ops.prox import project_cone
from ..problem import QPData, is_equality_row
from ..settings import Settings
from ..solution import Status
from .scaling import Scaling

_UNSOLVED = np.int32(int(Status.UNSOLVED))
_SOLVED = np.int32(int(Status.SOLVED))
_PINF = np.int32(int(Status.PRIMAL_INFEASIBLE))
_DINF = np.int32(int(Status.DUAL_INFEASIBLE))
_NUMERR = np.int32(int(Status.NUMERICAL_ERROR))


def linf(v):
    return jnp.max(jnp.abs(v), axis=-1)


def rho_vec_of(rho_bar, eq_mask, settings: Settings, cone=None):
    """Per-row penalty: rho_bar, boosted on equality rows (OSQP §5.2).

    With `cone` given and Settings.rho_soc_scale != 1, SOC rows get
    their own boost. Min-fuel SOCPs are bang-bang: most cone blocks sit
    at the TIP (zero thrust) at the optimum, where the block acts as an
    equality (Ax_blk = 0) — but only box equalities get rho_eq_scale,
    so the tip rows converge at the slow inequality rate (measured on
    config 4: the entire 2.2e-6 primal plateau lives on tip-block u
    rows while r_dual sits at 1e-7). The scale is UNIFORM across all
    SOC rows so each block keeps a single rho and the cone projection
    remains the exact prox (a per-row weighted norm would change the
    projection).
    """
    rv = jnp.where(eq_mask, settings.rho_eq_scale * rho_bar, rho_bar)
    if cone is not None and cone.m_soc and settings.rho_soc_scale != 1.0:
        m = rv.shape[-1]
        soc = jnp.arange(m) >= (m - cone.m_soc)
        rv = jnp.where(soc, settings.rho_soc_scale * rho_bar, rv)
    return rv


def is_equality_row_shared(qp: QPData):
    """Equality-row mask shared across a bound-batched problem.

    For the shared-matrix batch path (parallel.batch) the per-row rho
    must be identical across lanes so the cached factor can be shared;
    Monte-Carlo dispersions perturb bound VALUES, not which rows are
    equalities, so lane 0's mask is authoritative.
    """
    eq = is_equality_row(qp)
    return eq[0] if eq.ndim > 1 else eq


class AdmmCarry(NamedTuple):
    x: jax.Array
    z: jax.Array
    y: jax.Array
    rho_bar: jax.Array          # scalar penalty level
    fac: dict                   # cached KKT factor (refreshed on rho update)
    it: jax.Array               # int32 iteration count
    status: jax.Array           # int32 Status
    r_prim: jax.Array
    r_dual: jax.Array
    x_chk: jax.Array            # x at previous check (dual-infeas delta)
    y_chk: jax.Array            # y at previous check (primal-infeas delta)
    x_sum: jax.Array            # running iterate sums for restarted
    z_sum: jax.Array            # averaging (Settings.restart_every);
    y_sum: jax.Array            # accumulated at check cadence
    avg_cnt: jax.Array          # int32 samples in the running sums
    best_ratio: jax.Array       # best scaled residual ratio seen
    since_best: jax.Array       # int32 checks since best improved
    hist: jax.Array             # (slots, 3) residual ring buffer
    hist_ptr: jax.Array


def admm_iteration(qp: QPData, fac, x, z, y, rho_vec, settings: Settings,
                   backend: str, z_off=None):
    """One ADMM iteration on the scaled problem (A1). Batch-dim agnostic.

    z_off: optional (m,) shifted-prox offset for L1/SOC rows (re-centered
    refinement; see ops/prox.project_cone).
    """
    rhs = (settings.sigma * x - qp.q
           + xprec.einsum("...ji,...j->...i", qp.A, rho_vec * z - y))
    xt = kkt.solve_condensed(
        fac, rhs, backend, refine_steps=settings.refine_steps,
        cg_tol=settings.cg_tol, cg_max_iter=settings.cg_max_iter)
    zt = xprec.einsum("...ij,...j->...i", qp.A, xt)
    a = settings.alpha
    x_new = a * xt + (1.0 - a) * x
    w = a * zt + (1.0 - a) * z
    v = w + y / rho_vec
    mb, ml = qp.cone.m_box, qp.cone.m_l1
    lam_over_rho = (qp.lam / rho_vec[..., mb:mb + ml]) if ml else qp.lam
    z_new = project_cone(v, qp.l, qp.u, lam_over_rho, qp.cone,
                         offset=z_off)
    y_new = y + rho_vec * (w - z_new)
    return x_new, z_new, y_new


def iterate_block(qp, fac, x, z, y, rho_vec, settings, backend, k: int,
                  z_off=None):
    """Run k fused iterations (the inner `lax.fori_loop` of A2)."""

    def body(_, xyz):
        return admm_iteration(qp, fac, *xyz, rho_vec, settings, backend,
                              z_off=z_off)

    return jax.lax.fori_loop(0, k, body, (x, z, y))


def l1_grad_scale(qp: QPData, scaling: Scaling):
    """Unscaled per-problem L1 objective gradient bound (scalar).

    max_j max_i λᵢ|A_l1[i, j]| — the largest dual-residual contribution
    the L1 subgradient λᵀ∂|A_l1 x| can produce per column. Folded into
    the norm_q scale (eps_d reference + rho-balancing denominator): on
    min-fuel LPs the objective lives ENTIRELY in λ (P ≈ 0, q = 0), so
    without this term the dual scale max(‖Px‖, ‖Aᵀy‖, ‖q‖) → 0 at the
    optimum (Aᵀy → -q - Px ≈ 0) and the OSQP rho-balancing ratio
    sqrt(sp/sd) collapses rho to rho_min (measured on the CW benchmark:
    rho pinned at 1e-6, r_p stalled at 5e-2). Returns 0 when m_l1 == 0.
    """
    cone = qp.cone
    if not cone.m_l1:
        return jnp.zeros((), qp.dtype)
    mb, ml = cone.m_box, cone.m_l1
    cd_inv = 1.0 / (scaling.c * scaling.d)
    lamA = jnp.max(
        qp.lam[..., :, None] * jnp.abs(qp.A[..., mb:mb + ml, :]), axis=-2)
    return linf(cd_inv * lamA)


def l1_grad_scale_raw(qp: QPData):
    """l1_grad_scale for UNSCALED data (no Scaling in hand): the final
    f64 criterion checks of the staged/re-centered paths and the polish
    acceptance test must use the SAME eps_d reference as the solver
    loop, or a loop-SOLVED point gets vetoed downstream."""
    cone = qp.cone
    if not cone.m_l1:
        return jnp.zeros((), qp.dtype)
    mb, ml = cone.m_box, cone.m_l1
    return jnp.max(
        qp.lam[..., :, None] * jnp.abs(qp.A[..., mb:mb + ml, :]))


def residuals(qp: QPData, scaling: Scaling, x, z, y, nlam=None):
    """Unscaled residual norms + eps_rel scale factors (A3).

    Returns (r_prim, r_dual, norm_Ax, norm_z, norm_Px, norm_Aty, norm_q)
    where norm_q includes the L1 gradient scale (see l1_grad_scale;
    pass a precomputed `nlam` to skip recomputing it per check).
    Inputs are SCALED iterates; outputs are UNSCALED norms.
    """
    einv = 1.0 / scaling.e
    cd_inv = 1.0 / (scaling.c * scaling.d)
    Ax = xprec.einsum("...ij,...j->...i", qp.A, x)
    Px = xprec.einsum("...ij,...j->...i", qp.P, x)
    Aty = xprec.einsum("...ji,...j->...i", qp.A, y)
    r_prim = linf(einv * (Ax - z))
    r_dual = linf(cd_inv * (Px + qp.q + Aty))
    if nlam is None:
        nlam = l1_grad_scale(qp, scaling)
    return (r_prim, r_dual,
            linf(einv * Ax), linf(einv * z),
            linf(cd_inv * Px), linf(cd_inv * Aty),
            jnp.maximum(linf(cd_inv * qp.q), nlam))


def eps_thresholds(res, settings: Settings):
    (_, _, nAx, nz, nPx, nAty, nq) = res
    eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(nAx, nz)
    eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
        jnp.maximum(nPx, nAty), nq)
    return eps_p, eps_d


def _support_box(dy, l, u, eps):
    """sup_{z in [l,u]} zᵀdy with ±inf bounds -> +inf when unbounded."""
    big = jnp.asarray(jnp.inf, dy.dtype)
    pos = dy > eps
    neg = dy < -eps
    up = jnp.where(pos, jnp.where(jnp.isfinite(u), u * dy, big), 0.0)
    lo = jnp.where(neg, jnp.where(jnp.isfinite(l), l * dy, big), 0.0)
    return jnp.sum(up + lo, axis=-1)


def infeasibility(qp: QPData, scaling: Scaling, dx_s, dy_s, settings):
    """OSQP §3.4 infeasibility certificates from iterate deltas (A6).

    dx_s, dy_s: SCALED deltas of x and y across the last check interval.
    Conditions are evaluated on unscaled, inf-norm-normalised directions.
    Extends OSQP's box-only test to L1 rows (penalty rows: a dual ray
    needs dy_l1 = 0, since the dual set is bounded there) and SOC rows
    (support 0 iff -dy in the cone; recession direction must lie in the
    cone), cf. SURVEY.md §2.2 A6.
    """
    cone = qp.cone
    mb, ml = cone.m_box, cone.m_l1
    dtype = dx_s.dtype
    eps_p = jnp.asarray(settings.eps_pinf, dtype)
    eps_d = jnp.asarray(settings.eps_dinf, dtype)

    # ---- primal infeasibility from dy ----
    dy = scaling.unscale_y(dy_s)
    ndy = linf(dy)
    dyn = dy / jnp.maximum(ndy, jnp.finfo(dtype).tiny)[..., None]
    # Aᵀ dy (unscaled) = (1/(c d)) Āᵀ dȳ-normalised; recompute from dyn via
    # scaled Ā: Aᵀ dyn = D⁻¹ Āᵀ (E⁻¹ dyn·c)/c ... simplest: use unscaled op.
    Aty = xprec.einsum(
        "...ji,...j->...i", qp.A, scaling.scale_y(dyn)) / (
            scaling.c * scaling.d)
    cond_A = linf(Aty) <= eps_p
    # Support of the constraint DOMAIN over box + L1 rows. L1 rows are
    # penalty rows with optional bounds: dom g there is [l, u] (all of R
    # when unbounded, in which case _support_box correctly returns +inf
    # for any nonzero dy — a dual ray needs dy = 0 on unbounded penalty
    # rows since the dual set {|y| <= lam} is bounded there).
    mbl = mb + ml
    lu_l = qp.l[..., :mbl] / scaling.e[..., :mbl]
    lu_u = qp.u[..., :mbl] / scaling.e[..., :mbl]
    sup = _support_box(dyn[..., :mbl], lu_l, lu_u, eps_p)
    if cone.m_soc:
        soc = dyn[..., mb + ml:]
        if cone.soc_uniform and cone.n_soc:
            d = cone.soc_dims[0]
            blk = soc.reshape(soc.shape[:-1] + (cone.n_soc, d))
            # support of SOC indicator is 0 iff -dy in SOC (self-dual).
            ok = jnp.linalg.norm(blk[..., 1:], axis=-1) <= -blk[..., 0] + eps_p
            bad_soc = ~jnp.all(ok, axis=-1)
        else:
            bads = []
            off = mb + ml
            for d in cone.soc_dims:
                blk = dyn[..., off:off + d]
                bads.append(~(jnp.linalg.norm(blk[..., 1:], axis=-1)
                              <= -blk[..., 0] + eps_p))
                off += d
            bad_soc = jnp.any(jnp.stack(bads, axis=-1), axis=-1)
        sup = jnp.where(bad_soc, jnp.inf, sup)
    primal_infeas = (ndy > 0) & cond_A & (sup <= eps_p)

    # ---- dual infeasibility (unboundedness) from dx ----
    dx = scaling.unscale_x(dx_s)
    ndx = linf(dx)
    dxn = dx / jnp.maximum(ndx, jnp.finfo(dtype).tiny)[..., None]
    Pdx = xprec.einsum("...ij,...j->...i", qp.P, dxn / scaling.d) / (
        scaling.c * scaling.d)
    Adx = xprec.einsum("...ij,...j->...i", qp.A, dxn / scaling.d) / scaling.e
    cond_P = linf(Pdx) <= eps_d
    qdx = xprec.einsum("...i,...i->...", qp.q / (scaling.c * scaling.d), dxn)
    if ml:
        lam_unscaled = qp.lam * scaling.e[..., mb:mb + ml] / scaling.c
        qdx = qdx + jnp.sum(
            lam_unscaled * jnp.abs(Adx[..., mb:mb + ml]), axis=-1)
    cond_q = qdx <= -eps_d
    # Recession of the constraint domain over box + bounded-L1 rows:
    # finite bounds force (A dx) = 0 in that direction.
    bl = qp.l[..., :mb + ml] / scaling.e[..., :mb + ml]
    bu = qp.u[..., :mb + ml] / scaling.e[..., :mb + ml]
    av = Adx[..., :mb + ml]
    ok_up = (av <= eps_d) | ~jnp.isfinite(bu)
    ok_lo = (av >= -eps_d) | ~jnp.isfinite(bl)
    cond_box = jnp.all(ok_up & ok_lo, axis=-1)
    cond_soc = jnp.asarray(True)
    if cone.m_soc:
        soc = Adx[..., mb + ml:]
        if cone.soc_uniform and cone.n_soc:
            d = cone.soc_dims[0]
            blk = soc.reshape(soc.shape[:-1] + (cone.n_soc, d))
            ok = jnp.linalg.norm(blk[..., 1:], axis=-1) <= blk[..., 0] + eps_d
            cond_soc = jnp.all(ok, axis=-1)
        else:
            oks = []
            off = mb + ml
            for d in cone.soc_dims:
                blk = Adx[..., off:off + d]
                oks.append(jnp.linalg.norm(blk[..., 1:], axis=-1)
                           <= blk[..., 0] + eps_d)
                off += d
            cond_soc = jnp.all(jnp.stack(oks, axis=-1), axis=-1)
    dual_infeas = (ndx > 0) & cond_P & cond_q & cond_box & cond_soc
    return primal_infeas, dual_infeas


def restart_cadence_checks(settings: Settings) -> int:
    """Restart boundary in units of residual checks (0 disables)."""
    if settings.restart_every <= 0:
        return 0
    return max(1, settings.restart_every // settings.check_every)


def scaled_resid_ratio(res, settings: Settings):
    """max(r_p/eps_p, r_d/eps_d): the restart comparison metric — the
    same mixed criterion termination uses, so 'better' means 'closer to
    stopping'."""
    eps_p, eps_d = eps_thresholds(res, settings)
    return jnp.maximum(res[0] / eps_p, res[1] / eps_d)


def adapt_rho(rho_bar, res, settings: Settings):
    """OSQP §5.2 residual-balancing rho update; returns (new_rho, changed)."""
    r_prim, r_dual, nAx, nz, nPx, nAty, nq = res
    dtype = rho_bar.dtype
    tiny = jnp.finfo(dtype).tiny
    sp = r_prim / jnp.maximum(jnp.maximum(nAx, nz), tiny)
    sd = r_dual / jnp.maximum(jnp.maximum(jnp.maximum(nPx, nAty), nq), tiny)
    ratio = jnp.sqrt(sp / jnp.maximum(sd, tiny))
    new = jnp.clip(rho_bar * ratio, settings.rho_min, settings.rho_max)
    tol = settings.adaptive_rho_tol
    changed = (ratio > tol) | (ratio < 1.0 / tol)
    return jnp.where(changed, new, rho_bar), changed


def run_admm(qp: QPData, scaling: Scaling, settings: Settings,
             x0, z0, y0, backend: str, band_block: int = 0,
             z_off=None, rho0=None) -> AdmmCarry:
    """Full on-device solve of the scaled problem (A2 driver).

    Returns the final carry (scaled iterates); callers unscale and wrap
    into a Solution. The loop is fully shape-static and jit-safe.
    z_off: optional SCALED shifted-prox offset for L1/SOC rows.
    rho0: optional TRACED initial rho-bar (warm-rho carry across
    host-chunked phases — api._f64_continuation — without baking the
    value into the static Settings hash, which would recompile the
    whole program per distinct rho).
    """
    dtype = qp.dtype
    eq_mask = is_equality_row(qp)
    rho0 = (jnp.asarray(settings.rho, dtype) if rho0 is None
            else jnp.asarray(rho0, dtype))

    def factor(rho_bar):
        rv = rho_vec_of(rho_bar, eq_mask, settings, qp.cone)
        return kkt.factor_condensed(
            qp.P, qp.A, settings.sigma, rv, backend, band_block,
            spike_parts=settings.spike_parts), rv

    fac0, _ = factor(rho0)
    slots = max(settings.history, 0)
    hist0 = jnp.full((slots, 3), -1.0, dtype)
    big = jnp.asarray(jnp.inf, dtype)
    carry0 = AdmmCarry(
        x=x0, z=z0, y=y0, rho_bar=rho0, fac=fac0,
        it=jnp.int32(0), status=_UNSOLVED, r_prim=big, r_dual=big,
        x_chk=x0, y_chk=y0,
        x_sum=jnp.zeros_like(x0), z_sum=jnp.zeros_like(z0),
        y_sum=jnp.zeros_like(y0), avg_cnt=jnp.int32(0),
        best_ratio=big, since_best=jnp.int32(0),
        hist=hist0, hist_ptr=jnp.int32(0))

    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    restart_checks = restart_cadence_checks(settings)

    def cond(c: AdmmCarry):
        return (c.status == _UNSOLVED) & (c.it < settings.max_iter)

    def body(c: AdmmCarry) -> AdmmCarry:
        rho_vec = rho_vec_of(c.rho_bar, eq_mask, settings, qp.cone)
        x, z, y = iterate_block(
            qp, c.fac, c.x, c.z, c.y, rho_vec, settings, backend, k,
            z_off=z_off)
        it = c.it + k

        res = residuals(qp, scaling, x, z, y)

        # Restarted averaging (Settings.restart_every): accumulate the
        # check-cadence iterate; at each restart boundary adopt the
        # running average iff its scaled residuals beat the current
        # iterate's (kills LP active-set chatter; monotone runs never
        # take it). The average stays cone-feasible: box/SOC are convex
        # sets and L1 rows are penalty rows.
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
                res_a = residuals(qp, scaling, xa, za, ya)
                take = (scaled_resid_ratio(res_a, settings)
                        < scaled_resid_ratio(res, settings))
                pick = lambda a, b: jnp.where(take, a, b)
                res_o = tuple(pick(ra, rc) for ra, rc in zip(res_a, res))
                zero = lambda v: jnp.zeros_like(v)
                return (pick(xa, x), pick(za, z), pick(ya, y), res_o,
                        zero(xs), zero(zs), zero(ys), jnp.int32(0))

            x, z, y, res, x_sum, z_sum, y_sum, cnt = jax.lax.cond(
                boundary, try_restart, lambda a: a,
                (x, z, y, res, x_sum, z_sum, y_sum, cnt))

        r_prim, r_dual = res[0], res[1]
        eps_p, eps_d = eps_thresholds(res, settings)
        solved = (r_prim <= eps_p) & (r_dual <= eps_d)

        pinf, dinf = infeasibility(
            qp, scaling, x - c.x_chk, y - c.y_chk, settings)
        # NaN tripwire (SURVEY.md §5.2): a failed factorisation or
        # divergent iterate poisons the residuals — stop immediately
        # instead of spinning to max_iter.
        numerr = ~(jnp.isfinite(r_prim) & jnp.isfinite(r_dual))
        status = jnp.where(
            numerr, _NUMERR,
            jnp.where(solved, _SOLVED,
                      jnp.where(pinf, _PINF,
                                jnp.where(dinf, _DINF, _UNSOLVED))))

        # Stall exit (Settings.stall_checks): no new best scaled ratio
        # for a whole window -> STALLED (chatter / precision floor).
        ratio_now = scaled_resid_ratio(res, settings)
        improved = ratio_now < c.best_ratio
        best_ratio = jnp.minimum(ratio_now, c.best_ratio)
        since_best = jnp.where(improved, 0, c.since_best + 1)
        if settings.stall_checks > 0:
            stalled = since_best >= settings.stall_checks
            status = jnp.where((status == _UNSOLVED) & stalled,
                               jnp.int32(int(Status.STALLED)), status)

        # Adaptive rho on its own cadence; refactor only when changed (A4).
        rho_bar, fac = c.rho_bar, c.fac
        if settings.adaptive_rho and backend != "cg":
            adapt_now = (c.it // k) % interval_checks == (interval_checks - 1)
            new_rho, changed = adapt_rho(rho_bar, res, settings)
            do = adapt_now & changed & (status == _UNSOLVED)
            fac = jax.lax.cond(
                do, lambda r: factor(r)[0], lambda r: fac, new_rho)
            rho_bar = jnp.where(do, new_rho, rho_bar)
        elif settings.adaptive_rho:
            # CG is matrix-free: rho enters the operator directly, adapt
            # every interval with no refactorisation cost.
            adapt_now = (c.it // k) % interval_checks == (interval_checks - 1)
            new_rho, changed = adapt_rho(rho_bar, res, settings)
            do = adapt_now & changed & (status == _UNSOLVED)
            rho_bar = jnp.where(do, new_rho, rho_bar)
            rv = rho_vec_of(rho_bar, eq_mask, settings, qp.cone)
            fac = dict(c.fac, rho=rv)

        if slots > 0:
            entry = jnp.stack([it.astype(dtype), r_prim, r_dual])
            hist = jax.lax.dynamic_update_slice(
                c.hist, entry[None, :], (c.hist_ptr % slots, jnp.int32(0)))
            hist_ptr = c.hist_ptr + 1
        else:
            hist, hist_ptr = c.hist, c.hist_ptr

        return AdmmCarry(
            x=x, z=z, y=y, rho_bar=rho_bar, fac=fac, it=it, status=status,
            r_prim=r_prim, r_dual=r_dual, x_chk=x, y_chk=y,
            x_sum=x_sum, z_sum=z_sum, y_sum=y_sum, avg_cnt=cnt,
            best_ratio=best_ratio, since_best=since_best,
            hist=hist, hist_ptr=hist_ptr)

    final = jax.lax.while_loop(cond, body, carry0)
    status = jnp.where(
        final.status == _UNSOLVED, jnp.int32(int(Status.MAX_ITER)),
        final.status)
    return final._replace(status=status)
