"""Solution polishing — A7 (SURVEY.md §2.2; OSQP §8 style).

First-order ADMM crawls through the last digits (LP-like min-fuel
problems spend tens of thousands of iterations between 1e-4 and 1e-6).
Polishing skips that tail: detect the active set at the current point,
then solve the equality-constrained reduced QP directly in f64.

Static-shape formulation: instead of slicing the active rows (dynamic
shapes), solve the weighted penalty system

    (P + delta I + A^T W A) x = -q_eff + A^T W b,
    W = diag(1/delta on active rows, 0 otherwise)

whose solution approaches the reduced-KKT solution as delta -> 0
(error O(delta * |y|)); two steps of iterative refinement in f64 push
the defect to machine level. L1 rows contribute exactly: rows clamped
at a bound behave like active box rows, rows at the kink (z = 0) are
fixed to zero, and rows in the smooth regime add lam * sign(z) to the
effective gradient with dual y = lam * sign(z).

SOC blocks polish via TANGENT LINEARIZATION (round 4): a block on the
cone boundary (t ~ ||u||, t > 0) contributes the single synthesized
equality row  a_t - u_hat' A_u = 0  (the tangent plane through the
origin at the current ray u_hat = u/||u||) with one scalar multiplier;
a block at the tip pins all its rows to 0; strictly-interior blocks
stay inactive with dual 0. Because the cone is curved, the first solve
lands O(dist^2) from the manifold but its dual DIRECTION is still the
o(1)-stale u_hat — so after the first AL pass the rays are refreshed
from the polished Ax and the system is refactored once (a 2-step
Gauss-Newton on the active manifold; the refresh cuts the dual-
direction error from O(|y| dist) to O(|y| dist^2)). This replaces the
round-3 rule "SOC blocks are not polished".

KNOWN LIMITATION (measured, round 4): the step lands only on
NON-DEGENERATE instances (strictly convex reduced Hessian on the
tangent space — tests/test_polish_soc.py). On degenerate min-fuel
SOCPs (config 4: cost linear in the cone's t, a ~585-dim near-flat
tangent null space) the linearized active-set system is unbounded
along the tangent plane even with the curvature term, the candidate
explodes, and the acceptance test vetoes it — the solver keeps the
unpolished point. No local linearization can fix this (same reason
one-shot polish of degenerate LPs fails); config 4 therefore runs the
dual re-centered rounds instead (api.solve SOC delegation; PERF.md).

The polished point is ACCEPTED only if it improves max(r_prim, r_dual)
— evaluated with the ordinary residual functions — so polish can never
make a solution worse.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..problem import QPData
from .. import xprec
from ..solution import Solution, Status


def _residuals_unscaled(qp: QPData, x, z, y):
    Ax = xprec.einsum("...ij,...j->...i", qp.A, x)
    Px = xprec.einsum("...ij,...j->...i", qp.P, x)
    Aty = xprec.einsum("...ji,...j->...i", qp.A, y)
    r_p = jnp.max(jnp.abs(Ax - z), axis=-1)
    r_d = jnp.max(jnp.abs(Px + qp.q + Aty), axis=-1)
    return r_p, r_d


def polish(qp: QPData, sol: Solution, eps_abs: float, eps_rel: float,
           act_tol: float = 1e-4, delta: float = 1e-7,
           force_accept: bool = False) -> Solution:
    """Polish `sol` on the (f64) problem `qp`. Static shapes throughout.

    act_tol: relative distance for active-set detection;
    delta: AL penalty weight; multiplier passes push the defect to machine level.
    force_accept: return the polished candidate unconditionally
    (diagnostics/tests — inspect the candidate the acceptance test saw).
    """
    with xprec.highest():
        return _polish_inner(qp, sol, eps_abs, eps_rel, act_tol, delta,
                             force_accept)


def _polish_inner(qp: QPData, sol: Solution, eps_abs: float, eps_rel: float,
                  act_tol: float, delta: float,
                  force_accept: bool = False) -> Solution:
    cone = qp.cone
    mb, ml = cone.m_box, cone.m_l1
    dtype = qp.dtype
    x0, z0, y0 = sol.x, sol.z, sol.y

    span = jnp.where(
        jnp.isfinite(qp.u) & jnp.isfinite(qp.l), qp.u - qp.l, 1.0)
    tol = act_tol * jnp.maximum(span, 1.0)

    low_act = jnp.isfinite(qp.l) & (z0 - qp.l <= tol)
    up_act = jnp.isfinite(qp.u) & (qp.u - z0 <= tol)
    b = jnp.where(up_act, jnp.where(jnp.isfinite(qp.u), qp.u, 0.0),
                  jnp.where(jnp.isfinite(qp.l), qp.l, 0.0))
    act = low_act | up_act

    q_eff = qp.q
    lam_sign = jnp.zeros_like(z0)
    if ml:
        sl = slice(mb, mb + ml)
        z_l1 = z0[..., sl]
        at_kink = jnp.abs(z_l1) <= tol[..., sl]
        # Kink rows become equalities to 0; smooth rows contribute the
        # fixed subgradient lam*sign(z).
        act = act.at[..., sl].set(act[..., sl] | at_kink)
        b = b.at[..., sl].set(jnp.where(at_kink, 0.0, b[..., sl]))
        sg = jnp.where(at_kink, 0.0, qp.lam * jnp.sign(z_l1))
        lam_sign = lam_sign.at[..., sl].set(sg)
        q_eff = q_eff + xprec.einsum(
            "...ji,...j->...i", qp.A,
            lam_sign)
    # --- SOC activation via tangent linearization (module docstring) ---
    # Uniform block dims only: the vectorised (n_soc, d) reshape below
    # requires them, and every builder emits uniform cones. Non-uniform
    # layouts fall back to the round-3 rule — SOC rows never activate,
    # keep the input dual there, project Ax per block for z, and let the
    # acceptance test decide (ADVICE r4).
    soc_lin = bool(cone.m_soc) and cone.soc_uniform
    soc0 = mb + ml
    if soc_lin:
        d = cone.soc_dims[0]
        shp = z0[..., soc0:].shape[:-1] + (cone.n_soc, d)
        zb = z0[..., soc0:].reshape(shp)
        t0_, u0_ = zb[..., 0], zb[..., 1:]
        nu0 = jnp.linalg.norm(u0_, axis=-1)
        tol_b = act_tol * (1.0 + jnp.abs(t0_) + nu0)
        # Complementarity-aware activation: a block whose dual carries a
        # positive normal-ray component is ACTIVE even when the primal
        # gap reads (noise-level) interior. Dropping such a block is not
        # merely suboptimal — with a cost linear in the cone's t
        # variable (every min-fuel/lossless-convexification SOCP) the
        # reduced problem is UNBOUNDED below in t and the polish
        # candidate explodes to O(1/(P_t + delta)) (measured: Gamma
        # -> -6e4 on config 4 from two misread blocks).
        yb0 = y0[..., soc0:].reshape(shp)
        yt0, yu0 = yb0[..., 0], yb0[..., 1:]
        u_dir0 = u0_ / jnp.maximum(nu0, jnp.finfo(dtype).tiny)[..., None]
        ray0 = jnp.maximum(
            jnp.sum(yu0 * u_dir0, axis=-1) - yt0, 0.0)
        dual_act = ray0 > act_tol * (
            1.0 + jnp.abs(yt0) + jnp.linalg.norm(yu0, axis=-1))
        interior = (nu0 <= t0_ - tol_b) & ~dual_act
        tip = (t0_ <= tol_b) & (nu0 <= tol_b)
        bnd = ~(interior | tip)
        # Tip blocks: pin ALL block rows to 0 (box-like equalities; b
        # on SOC rows is already 0).
        tip_rows = jnp.repeat(tip, d, axis=-1)
        act = act.at[..., soc0:].set(tip_rows)
        w_soc = jnp.where(bnd, 1.0 / delta, 0.0)        # (..., n_soc)
        tiny = jnp.finfo(dtype).tiny
        u_hat = u0_ / jnp.maximum(nu0, tiny)[..., None]
        A_soc = qp.A[..., soc0:, :].reshape(
            qp.A.shape[:-2] + (cone.n_soc, d, qp.n))

        def tan_rows(uh):
            """Synthesized tangent row per block: a_t - u_hat' A_u."""
            return A_soc[..., 0, :] - xprec.einsum(
                "...ke,...ken->...kn", uh, A_soc[..., 1:, :])

        A_tan = tan_rows(u_hat)
        # SQP multiplier estimate for the curvature term: the input
        # dual's normal-ray component (refreshed from the AL multiplier
        # after pass 1).
        s_curv = ray0
        c_curv = jnp.where(bnd, s_curv / jnp.maximum(nu0, tiny), 0.0)

    w = jnp.where(act, 1.0 / delta, 0.0)

    def build_M(A_tan_, c_curv_=None, uh_=None):
        M_ = (qp.P + delta * jnp.eye(qp.n, dtype=dtype)
              + xprec.einsum("...ji,...j,...jk->...ik", qp.A, w, qp.A))
        if soc_lin:
            M_ = M_ + xprec.einsum("...ki,...k,...kj->...ij",
                                   A_tan_, w_soc, A_tan_)
            # Lagrangian curvature of the active cone, (s/||u||) *
            # A_u' (I - u_hat u_hat') A_u: the tangent EQUALITY alone
            # deletes the norm bound, and with a cost linear in t
            # (min-fuel SOCPs) the reduced problem is unbounded along
            # the tangent plane — measured u -> -(dt/2e-6) * u_hat
            # blow-ups on config 4. The curvature term is what makes
            # this a genuine SQP/Newton step on the active manifold.
            r_u = xprec.einsum("...ke,...ken->...kn", uh_,
                               A_soc[..., 1:, :])
            M_ = M_ + xprec.einsum("...kdi,...k,...kdj->...ij",
                                   A_soc[..., 1:, :], c_curv_,
                                   A_soc[..., 1:, :])
            M_ = M_ - xprec.einsum("...ki,...k,...kj->...ij",
                                   r_u, c_curv_, r_u)
        return M_, jnp.linalg.cholesky(M_)

    M, L = (build_M(A_tan, c_curv, u_hat) if soc_lin
            else build_M(None))

    def solve_M(L_, M_, r):
        from jax.scipy.linalg import solve_triangular
        t = solve_triangular(L_, r[..., None], lower=True)
        x_ = solve_triangular(L_, t, lower=True, trans=1)[..., 0]
        for _ in range(2):                  # iterative refinement, f64
            rr = r - xprec.einsum("...ij,...j->...i", M_, x_)
            t = solve_triangular(L_, rr[..., None], lower=True)
            x_ = x_ + solve_triangular(L_, t, lower=True, trans=1)[..., 0]
        return x_

    # Augmented-Lagrangian passes on the active rows: each pass reuses
    # the cached factor and shrinks the constraint defect by ~O(delta
    # * kappa), so a moderate delta (stable to factor even when P is
    # singular on the state block, e.g. min-energy MPC) still reaches
    # machine-level defects — a single penalty solve at delta=1e-9
    # had cond(M) ~ 1/delta^2 and was rejected by the acceptance test.
    y_mult = jnp.zeros_like(z0)
    s_soc = (jnp.zeros(z0.shape[:-1] + (cone.n_soc,), dtype)
             if soc_lin else None)
    x = jnp.zeros_like(x0)
    for it in range(3):
        rhs = -q_eff + xprec.einsum(
            "...ji,...j->...i", qp.A, w * b - jnp.where(act, y_mult, 0.0))
        if soc_lin:
            rhs = rhs - xprec.einsum("...ki,...k->...i", A_tan, s_soc)
        x = solve_M(L, M, rhs)
        Ax = xprec.einsum("...ij,...j->...i", qp.A, x)
        y_mult = y_mult + w * (Ax - b)
        if soc_lin:
            s_soc = s_soc + w_soc * xprec.einsum(
                "...ki,...i->...k", A_tan, x)
            if it < 2:
                # Gauss-Newton ray refresh: re-linearize the active
                # cones at the polished point, refresh the curvature
                # multiplier from the AL estimate, and refactor — cuts
                # the dual-direction error from O(|y| dist) to
                # O(|y| dist^2) per refresh. Two refreshes (not one):
                # when the INPUT dual is coarse (rd ~ 1e-2) the first
                # curvature multiplier estimate is off by that much and
                # one refresh lands the dual only at ~1e-4 (measured on
                # the two-active-cone unit test); the second one
                # reaches the 1e-6 contract with margin.
                Axb = Ax[..., soc0:].reshape(shp)
                uA = Axb[..., 1:]
                nuA = jnp.linalg.norm(uA, axis=-1)
                u_hat = jnp.where((bnd & (nuA > tiny))[..., None],
                                  uA / jnp.maximum(nuA, tiny)[..., None],
                                  u_hat)
                A_tan = tan_rows(u_hat)
                # The cone multiplier is lambda = -s_soc (>= 0 when
                # active; the tangent row is t - u_hat'u and this dual
                # convention puts valid cone duals at y_t < 0 — cf.
                # mask_dual's normal ray n = (-1, u_hat)).
                s_ref = jnp.maximum(-s_soc, 0.0)
                c_curv = jnp.where(
                    bnd, s_ref / jnp.maximum(nuA, tiny), 0.0)
                M, L = build_M(A_tan, c_curv, u_hat)

    y = jnp.where(act, y_mult, 0.0) + lam_sign
    if soc_lin:
        # Boundary blocks: y = s * (1, -u_hat) (the tangent row's
        # multiplier mapped back onto the block's A rows); tip blocks:
        # the AL multipliers of the pinned rows; interior: 0.
        y_t = jnp.where(bnd, s_soc, 0.0)
        y_u = jnp.where(bnd[..., None], -s_soc[..., None] * u_hat, 0.0)
        y_bnd = jnp.concatenate([y_t[..., None], y_u], axis=-1)
        y_bnd = y_bnd.reshape(z0[..., soc0:].shape)
        y_tip = jnp.where(tip_rows, y_mult[..., soc0:], 0.0)
        y = y.at[..., soc0:].set(y_bnd + y_tip)
    elif cone.m_soc:
        # Non-uniform fallback: keep the input dual on SOC rows.
        y = y.at[..., soc0:].set(y0[..., soc0:])
    z = jnp.where(act, b, Ax)
    if cone.m_soc:
        # SOC z: the cone projection of Ax per block (exact membership;
        # for interior blocks the projection is the identity;
        # project_soc_rows handles non-uniform dims with a static loop).
        from ..ops.prox import project_soc_rows
        z_soc = project_soc_rows(Ax[..., soc0:], cone.soc_dims)
        z = z.at[..., soc0:].set(z_soc)
    if ml:
        sl = slice(mb, mb + ml)
        z = z.at[..., sl].set(jnp.where(act[..., sl], b[..., sl],
                                        Ax[..., sl]))

    from .admm import l1_grad_scale_raw
    nlam = l1_grad_scale_raw(qp)

    def _crit(xc, zc, yc):
        Axc = xprec.einsum("...ij,...j->...i", qp.A, xc)
        Pxc = xprec.einsum("...ij,...j->...i", qp.P, xc)
        Atyc = xprec.einsum("...ji,...j->...i", qp.A, yc)
        r_p = jnp.max(jnp.abs(Axc - zc), axis=-1)
        r_d = jnp.max(jnp.abs(Pxc + qp.q + Atyc), axis=-1)
        eps_p = eps_abs + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Axc), axis=-1), jnp.max(jnp.abs(zc), axis=-1))
        # eps_d reference matches the solver loop's (incl. the L1
        # gradient scale — core.admm.l1_grad_scale) or polish would
        # veto loop-SOLVED points on min-fuel LPs.
        eps_d = eps_abs + eps_rel * jnp.maximum(jnp.maximum(
            jnp.max(jnp.abs(Pxc), axis=-1),
            jnp.max(jnp.abs(Atyc), axis=-1)),
            jnp.maximum(jnp.max(jnp.abs(qp.q), axis=-1), nlam))
        return r_p, r_d, (r_p <= eps_p) & (r_d <= eps_d)

    r_p0, r_d0, solved0 = _crit(x0, z0, y0)
    r_p1, r_d1, solved1 = _crit(x, z, y)
    finite = jnp.all(jnp.isfinite(x), axis=-1)
    # ACCEPT only a polished point that outright satisfies the stopping
    # criterion (and beats an already-solved input). A merely-improved
    # but unconverged polish carries 1/delta-scaled duals from a
    # misidentified active set — poisonous as a warm start (observed:
    # it sent the f64 phase into a 40k-iteration stall on the CW
    # min-fuel problem).
    accepted = finite & solved1 & (
        ~solved0 | (jnp.maximum(r_p1, r_d1) < jnp.maximum(r_p0, r_d0)))
    if force_accept:
        accepted = finite | accepted

    def pick(a, b_):
        bb = accepted
        while bb.ndim < a.ndim:
            bb = bb[..., None]
        return jnp.where(bb, a, b_)

    x_f, z_f, y_f = pick(x, x0), pick(z, z0), pick(y, y0)
    r_p = jnp.where(accepted, r_p1, r_p0)
    r_d = jnp.where(accepted, r_d1, r_d0)
    solved_now = jnp.where(accepted, solved1, solved0)
    # Status reflects THIS eps, not the caller's earlier (possibly
    # relaxed-phase) criterion: only infeasibility verdicts pass
    # through; an unconverged point reports MAX_ITER.
    passthrough = jnp.isin(
        sol.status, jnp.asarray([int(Status.PRIMAL_INFEASIBLE),
                                 int(Status.DUAL_INFEASIBLE),
                                 int(Status.NUMERICAL_ERROR)], jnp.int32))
    status = jnp.where(
        solved_now, jnp.int32(int(Status.SOLVED)),
        jnp.where(passthrough, sol.status,
                  jnp.int32(int(Status.MAX_ITER))))

    from ..problem import objective
    return Solution(
        x=x_f, z=z_f, y=y_f, status=status, iters=sol.iters,
        r_prim=r_p, r_dual=r_d, obj=objective(qp, x_f, z_f),
        rho=sol.rho, history=sol.history)
