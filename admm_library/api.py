"""Public solver API (component S1, SURVEY.md §2.2).

`solve(problem, settings)` is traced once per (shapes, Settings) pair and
runs entirely on device: Ruiz scaling, factorisation, the fused ADMM
`lax.while_loop`, and unscaling are one XLA computation. There are exactly
two host<->device boundaries: problem upload and Solution fetch
(SURVEY.md §3.1).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from . import xprec
from .core import admm
from .core.polish import polish as polish_fn
from .core.scaling import ruiz_equilibrate, Scaling
from .problem import QPData, objective
from .settings import Settings
from .solution import Solution, Status


# KKT backend that backend='auto' resolves to, per JAX platform, for
# problems without and with declared block-banded (MPC) structure. The
# gpu entry is measured with scripts/bench_backends.py at the bench
# shapes on an H100 ('inv' wins every cell; PERF.md, Findings).
# The cpu entry keeps the exact-factor choice the f64 test suite is
# built on. A platform that was never measured has no entry, and
# resolving 'auto' there is an error.
_AUTO_BACKEND = {
    "cpu": {"dense": "chol", "banded": "banded"},
    "gpu": {"dense": "inv", "banded": "inv"},
}


def device_profile(platform: str | None = None) -> dict:
    """Measured per-platform choices for `platform` (default: the live
    JAX backend). Raises ValueError for a platform with no measurement."""
    platform = platform or jax.default_backend()
    try:
        return _AUTO_BACKEND[platform]
    except KeyError:
        raise ValueError(
            f"no measured KKT backend choice for platform {platform!r}; "
            f"pass Settings(backend=...) explicitly") from None


def resolve_backend(settings: Settings, platform: str | None = None) -> str:
    """Map backend='auto' to a concrete L0 backend at trace time, from
    the platform's measured choice (`device_profile`)."""
    if settings.backend != "auto":
        return settings.backend
    prof = device_profile(platform)
    return prof["banded" if settings.band_block > 0 else "dense"]


def _solve_one_phase(qp: QPData, x0, z0, y0, settings: Settings,
                     backend: str, z_off=None, rho0=None):
    # Exact-f32 dots for everything traced below (triangular solves,
    # residuals): reduced-precision passes diverge — see xprec.
    with xprec.highest():
        return _solve_one_phase_inner(qp, x0, z0, y0, settings, backend,
                                      z_off, rho0)


def _solve_one_phase_inner(qp: QPData, x0, z0, y0, settings: Settings,
                           backend: str, z_off=None, rho0=None):
    qps, scaling = ruiz_equilibrate(qp, settings.scaling_iters)
    if settings.warm_start:
        xs = scaling.scale_x(x0)
        zs = scaling.scale_z(z0)
        ys = scaling.scale_y(y0)
    else:
        xs, zs, ys = x0, z0, y0
    if z_off is not None:
        z_off = scaling.scale_z(z_off)      # offsets live in z-space
    carry = admm.run_admm(
        qps, scaling, settings, xs, zs, ys, backend,
        band_block=settings.band_block, z_off=z_off, rho0=rho0)
    x = scaling.unscale_x(carry.x)
    z = scaling.unscale_z(carry.z)
    y = scaling.unscale_y(carry.y)
    return Solution(
        x=x, z=z, y=y,
        status=carry.status, iters=carry.it,
        r_prim=carry.r_prim, r_dual=carry.r_dual,
        obj=objective(qp, x, z), rho=carry.rho_bar,
        history=carry.hist)


def _x64_available() -> bool:
    return jax.config.jax_enable_x64


def _solve_core(qp: QPData, x0, z0, y0, settings: Settings, backend: str):
    """Precision-strategy dispatcher around the single-phase solver.

    'hybrid' runs the bulk of the iterations in f32 to a relaxed
    tolerance, then re-equilibrates in f64 and warm-starts a second
    phase to the target tolerance (SURVEY.md §7).
    """
    precision = settings.precision
    if precision == "hybrid" and not _x64_available():
        precision = "single"    # no f64 types: best effort in f32

    if precision == "single":
        return _solve_one_phase(qp, x0, z0, y0, settings, backend)

    if precision == "double":
        qp64 = qp.astype(jnp.float64)
        sol = _solve_one_phase(
            qp64, x0.astype(jnp.float64), z0.astype(jnp.float64),
            y0.astype(jnp.float64), settings, backend)
        return sol

    # --- hybrid (traceable; used under vmap by solve_batch) ---
    s32 = _s32_of(settings)
    sol32 = _solve_one_phase(
        qp.astype(jnp.float32), x0.astype(jnp.float32),
        z0.astype(jnp.float32), y0.astype(jnp.float32), s32, backend)

    s64 = settings.replace(precision="single", warm_start=True)
    qp64 = qp.astype(jnp.float64)

    def clean(v):
        """Drop a poisoned f32 phase: NaN warm starts reset to zero."""
        v = v.astype(jnp.float64)
        return jnp.where(jnp.isfinite(v), v, 0.0)

    sol64 = _solve_one_phase(
        qp64, clean(sol32.x), clean(sol32.z), clean(sol32.y), s64,
        backend)

    # Preserve an infeasibility verdict from phase 1 (phase 2 would also
    # find it, but phase 1 saw it first — report consistently).
    p1_inf = (sol32.status == int(Status.PRIMAL_INFEASIBLE)) | (
        sol32.status == int(Status.DUAL_INFEASIBLE))
    status = jnp.where(p1_inf, sol32.status, sol64.status)
    out_dtype = qp.dtype
    return Solution(
        x=sol64.x.astype(out_dtype), z=sol64.z.astype(out_dtype),
        y=sol64.y.astype(out_dtype), status=status,
        iters=sol32.iters + sol64.iters,
        r_prim=sol64.r_prim.astype(out_dtype),
        r_dual=sol64.r_dual.astype(out_dtype),
        obj=sol64.obj.astype(out_dtype),
        rho=sol64.rho.astype(out_dtype), history=sol64.history)


@partial(jax.jit, static_argnames=("settings", "backend"))
def _solve_jit(qp, x0, z0, y0, settings, backend):
    return _solve_core(qp, x0, z0, y0, settings, backend)


@partial(jax.jit, static_argnames=("settings", "backend"))
def _phase_jit(qp, x0, z0, y0, settings, backend):
    return _solve_one_phase(qp, x0, z0, y0, settings, backend)


@partial(jax.jit, static_argnames=("settings", "backend"))
def _phase_off_jit(qp, x0, z0, y0, z_off, settings, backend):
    return _solve_one_phase(qp, x0, z0, y0, settings, backend, z_off=z_off)


@partial(jax.jit, static_argnames=("settings", "backend"))
def _phase_rho_jit(qp, x0, z0, y0, rho0, settings, backend):
    """Phase with a TRACED warm rho0 (see run_admm's rho0 note)."""
    return _solve_one_phase(qp, x0, z0, y0, settings, backend, rho0=rho0)


@partial(jax.jit, static_argnames=("eps_abs", "eps_rel", "act_tol"))
def _polish_jit(qp64, sol, eps_abs, eps_rel, act_tol):
    return polish_fn(qp64, sol, eps_abs, eps_rel, act_tol=act_tol)


@partial(jax.jit, static_argnames=("eps_abs", "eps_rel"))
def _warm_check_jit(qp64, x0, z0, y0, eps_abs, eps_rel):
    """f64 mixed-criterion check of a user-supplied warm start: when the
    caller's (x0, z0, y0) already satisfies the stopping criterion
    (MPC re-solves where the scenario barely moved), skip the solve
    entirely — the alternative roundtrips the point through the f32
    phase, which degrades the dual to f32 precision and then pays a
    full f64 tail to win the digits back (measured: warm-from-solution
    at eps 1e-9 cost ~1800 iterations through the shared path, MORE
    than the 1575 cold count)."""
    with xprec.highest():
        Ax = xprec.einsum("...ij,...j->...i", qp64.A, x0)
        Px = xprec.einsum("...ij,...j->...i", qp64.P, x0)
        Aty = xprec.einsum("...ji,...j->...i", qp64.A, y0)
        linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
        r_p = linf(Ax - z0)
        r_d = linf(Px + qp64.q + Aty)
        eps_p = eps_abs + eps_rel * jnp.maximum(linf(Ax), linf(z0))
        eps_d = eps_abs + eps_rel * jnp.maximum(
            jnp.maximum(linf(Px), linf(Aty)),
            jnp.maximum(linf(qp64.q), admm.l1_grad_scale_raw(qp64)))
        solved = (r_p <= eps_p) & (r_d <= eps_d)
        return r_p, r_d, solved, objective(qp64, x0, z0)


def _s32_of(settings: Settings) -> Settings:
    """f32-phase settings: relaxed eps + condition-number caps (the
    equality-rho boost times rho over sigma must stay well under
    1/eps_f32 ~ 8e6 or the f32 factorisation goes NaN — observed on the
    low-thrust SOCP; sigma does not move the ADMM fixed point)."""
    return settings.replace(
        precision="single",
        eps_abs=max(settings.hybrid_eps, settings.eps_abs),
        eps_rel=max(settings.hybrid_eps, settings.eps_rel),
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        polish=False)


def _finish(sol, sol32, settings, out_dtype):
    """Combine phase results: cast out, add iteration counts, preserve a
    phase-1 infeasibility verdict."""
    p1_inf = (sol32.status == int(Status.PRIMAL_INFEASIBLE)) | (
        sol32.status == int(Status.DUAL_INFEASIBLE))
    status = jnp.where(p1_inf, sol32.status, sol.status)
    return Solution(
        x=sol.x.astype(out_dtype), z=sol.z.astype(out_dtype),
        y=sol.y.astype(out_dtype), status=status,
        iters=sol32.iters + sol.iters,
        r_prim=sol.r_prim.astype(out_dtype),
        r_dual=sol.r_dual.astype(out_dtype),
        obj=sol.obj.astype(out_dtype),
        rho=sol.rho.astype(out_dtype), history=sol.history)


def _recentered_rounds(qp: QPData, qp64: QPData, sol0: Solution,
                       settings: Settings, backend: str, phase_off,
                       try_polish=None):
    """Run recenter_rounds f32 correction solves; returns (Solution(f64),
    solved: bool) or None when the cone layout can't be handled.

    Box rows shift exactly (bounds - Ax); L1/SOC rows keep their
    original bounds/lam and evaluate the shifted prox with offset = Ax
    (ops/prox.project_cone). Each round's true residuals are evaluated
    in f64 on the original data; rounds stop early once converged.
    """
    f32, f64 = jnp.float32, jnp.float64
    cone = qp.cone
    mb = cone.m_box

    def clean(v):
        v = v.astype(f64)
        return jnp.where(jnp.isfinite(v), v, 0.0)

    x_t, y_t, z_t = sol0.x, sol0.y, sol0.z
    iters = jnp.int32(0)
    rho = sol0.rho
    s_c = _s32_of(settings).replace(
        eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
        # Correction problems are feasible by construction; their
        # domains mix shifted and original rows, so certificates are
        # meaningless there — disable.
        eps_pinf=0.0, eps_dinf=0.0)

    nlam = admm.l1_grad_scale_raw(qp64)

    def true_resid(x_t, y_t, z_t):
        Ax = xprec.einsum("...ij,...j->...i", qp64.A, x_t)
        Px = xprec.einsum("...ij,...j->...i", qp64.P, x_t)
        Aty = xprec.einsum("...ji,...j->...i", qp64.A, y_t)
        r_p = jnp.max(jnp.abs(Ax - z_t), axis=-1)
        r_d = jnp.max(jnp.abs(Px + qp64.q + Aty), axis=-1)
        linf = lambda v: jnp.max(jnp.abs(v), axis=-1)
        eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(
            linf(Ax), linf(z_t))
        # eps_d reference incl. the L1 gradient scale (matches the
        # solver loop — core.admm.l1_grad_scale).
        eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
            jnp.maximum(linf(Px), linf(Aty)),
            jnp.maximum(linf(qp64.q), nlam))
        solved = (r_p <= eps_p) & (r_d <= eps_d)
        return Ax, Px, Aty, r_p, r_d, solved, eps_p, eps_d

    solved = False
    r_p = sol0.r_prim
    r_d = sol0.r_dual
    import math
    for _ in range(settings.recenter_rounds):
        Ax, Px, Aty, r_p, r_d, solved_d, eps_p, eps_d = true_resid(
            x_t, y_t, z_t)
        solved = bool(solved_d)                       # host sync
        if solved:
            break
        # Each round only needs to satisfy the ORIGINAL mixed criterion,
        # whose eps_rel term scales with the TOTAL norms — demanding the
        # raw eps_abs at the correction scale burns 100x the iterations
        # (measured on the low-thrust SOCP). Quantise to a power of two
        # so the Settings hash (a static jit arg) stays cache-stable.
        eps_round = float(jnp.minimum(eps_p, eps_d))
        eps_q = 2.0 ** math.floor(math.log2(max(eps_round,
                                                settings.eps_abs)))
        s_round = s_c.replace(eps_abs=eps_q, eps_rel=0.0)
        if settings.recenter_max_iter > 0:
            s_round = s_round.replace(max_iter=min(
                settings.max_iter, settings.recenter_max_iter))
        # g = Px + q ONLY (no A'y tilt): the correction problem is then
        # EXACTLY the original in shifted coordinates, so its dual is a
        # complete, structurally-valid dual for the original — summing
        # partial duals across rounds instead leaves junk on inactive
        # rows that tilts x off the true optimum while stationarity and
        # primal residuals look perfect (observed: 5e-4 solution error
        # at 1e-10 reported residuals). Duals are therefore WARM-STARTED
        # and replaced, never accumulated.
        g = Px + qp64.q
        l_c = jnp.concatenate(
            [qp64.l[..., :mb] - Ax[..., :mb], qp64.l[..., mb:]], axis=-1)
        u_c = jnp.concatenate(
            [qp64.u[..., :mb] - Ax[..., :mb], qp64.u[..., mb:]], axis=-1)
        off = jnp.concatenate(
            [jnp.zeros_like(Ax[..., :mb]), Ax[..., mb:]], axis=-1)
        qp_c = QPData(
            P=qp.P.astype(f32), q=g.astype(f32), A=qp.A.astype(f32),
            l=l_c.astype(f32), u=u_c.astype(f32),
            lam=qp.lam.astype(f32), cone=cone)
        sol_c = phase_off(qp_c, jnp.zeros_like(qp_c.q),
                          (z_t - Ax).astype(f32),
                          y_t.astype(f32),
                          off, s_round)    # offset stays f64 (prox upcasts)
        x_t = x_t + clean(sol_c.x)
        y_t = clean(sol_c.y)
        z_t = Ax + clean(sol_c.z)
        iters = iters + sol_c.iters
        rho = sol_c.rho.astype(f64)
        # Polish from the partially-converged round: on LP-like
        # problems (min-fuel L1) the active set locks in long before
        # the first-order tail finishes — landing here skips tens of
        # thousands of iterations (measured 60k -> ~4k on the CW
        # min-fuel benchmark).
        if try_polish is not None:
            cand = Solution(
                x=x_t, z=z_t, y=y_t, status=jnp.int32(0), iters=iters,
                r_prim=jnp.asarray(r_p, f64),
                r_dual=jnp.asarray(r_d, f64),
                obj=objective(qp64, x_t, z_t),
                rho=jnp.asarray(rho, f64), history=sol0.history)
            pol = try_polish(cand)
            if int(pol.status) == int(Status.SOLVED):    # host sync
                return dataclasses.replace(pol, iters=iters), True
    if not solved:
        _, _, _, r_p, r_d, solved_d, _, _ = true_resid(x_t, y_t, z_t)
        solved = bool(solved_d)
    status = jnp.int32(int(Status.SOLVED if solved else Status.MAX_ITER))
    sol = Solution(
        x=x_t, z=z_t, y=y_t, status=status, iters=iters,
        r_prim=jnp.asarray(r_p, f64), r_dual=jnp.asarray(r_d, f64),
        obj=objective(qp64, x_t, z_t), rho=jnp.asarray(rho, f64),
        history=sol0.history)
    return sol, solved


def _f64_continuation(qp: QPData, sol: Solution, settings: Settings,
                      backend: str, chunk: int = 2000) -> Solution:
    """Host-chunked, warm-started f64 iteration endgame (config-4 class).

    Degenerate min-fuel SOCPs defeat every f32 stage of this solver:
    the raw f32 phase chatters orders of magnitude above the 1e-4
    hand-off (measured on the N=200 low-thrust SOCP on CPU: r_p 5.7e-2
    after 50k iterations), and the re-centered correction rounds are
    then built around a point so far from the optimum that their
    dual-base classification (tip vs on-cone, parallel/batch.mask_dual)
    is meaningless — every round is rejected by the safeguard. What does
    converge is plain f64 ADMM with the SOC-row rho boost
    (Settings.rho_soc_scale), so when the delegated f32 machinery comes
    back unsolved we continue HERE: in f64, warm-started, until
    solved/stalled or one extra max_iter budget is spent.

    rho carries across chunks as a TRACED argument (run_admm rho0), so
    every chunk reuses one compiled program.
    """
    import math
    f64 = jnp.float64

    qp64 = qp.astype(f64)

    def clean(v):
        v = v.astype(f64)
        return jnp.where(jnp.isfinite(v), v, 0.0)

    x, z, y = (clean(v) for v in (sol.x, sol.z, sol.y))
    rho = float(jnp.max(sol.rho))
    if not (rho > 0.0 and math.isfinite(rho)):
        rho = settings.rho
    iters = int(sol.iters)
    budget = settings.max_iter
    used = 0
    out = sol
    # Chunks run with the stall exit OFF (a chunk is bounded at `chunk`
    # iterations, so there is nothing to save) — chatter on bang-bang
    # instances bounces r_p an order of magnitude between checks and a
    # windowed stall exit mid-chunk would freeze a transient. Progress
    # is judged ACROSS chunks instead: keep the best point seen, stop
    # after two consecutive chunks without a new best.
    s_chunk = settings.replace(
        precision="single", warm_start=True, polish=False,
        recenter_rounds=0, max_iter=chunk, stall_checks=0)

    def run_chunk(x_, z_, y_, rho_):
        return _phase_rho_jit(qp64, x_, z_, y_, jnp.float64(rho_),
                              s_chunk, backend)

    def run_polish(ph_):
        return _polish_jit(qp64, ph_, settings.eps_abs, settings.eps_rel,
                           1e-4)

    best = float("inf")
    dry = 0
    while used < budget and dry < 2:
        ph = run_chunk(x, z, y, rho)
        done_it = int(ph.iters)                             # host sync
        used += done_it
        iters += done_it
        if settings.polish:
            # Tangent-linearized SOC polish between chunks: on the
            # bang-bang low-thrust SOCP the candidate from a ~1e-5
            # warm point (6000 boosted-f64 iterations) lands at
            # r_p 6e-13 / r_d 4e-7 with the correct 191-tip/9-boundary
            # classification; polishing from the f32 phase's 5.7e-2
            # point fails, because tip/boundary classification is
            # meaningless there. Acceptance still vetoes bad
            # candidates, so early attempts cost one factor+solve each
            # and nothing else.
            pol = run_polish(ph)
            if int(pol.status) == int(Status.SOLVED):       # host sync
                return Solution(
                    x=pol.x.astype(qp.dtype),
                    z=pol.z.astype(qp.dtype),
                    y=pol.y.astype(qp.dtype), status=pol.status,
                    iters=jnp.int32(iters),
                    r_prim=pol.r_prim.astype(qp.dtype),
                    r_dual=pol.r_dual.astype(qp.dtype),
                    obj=pol.obj.astype(qp.dtype),
                    rho=ph.rho.astype(qp.dtype),
                    history=ph.history)
        score = float(jnp.maximum(ph.r_prim, ph.r_dual))
        if score < best or int(ph.status) == int(Status.SOLVED):
            best = score
            dry = 0
            out = Solution(
                x=ph.x, z=ph.z, y=ph.y, status=ph.status,
                iters=jnp.int32(iters),
                r_prim=ph.r_prim, r_dual=ph.r_dual, obj=ph.obj,
                rho=ph.rho, history=ph.history)
        else:
            dry += 1
            out = dataclasses.replace(out, iters=jnp.int32(iters))
        if int(ph.status) != int(Status.MAX_ITER) or done_it == 0:
            break
        x, z, y = ph.x, ph.z, ph.y
        rho = float(jnp.max(ph.rho))
    dtype = qp.dtype
    return Solution(
        x=out.x.astype(dtype), z=out.z.astype(dtype),
        y=out.y.astype(dtype), status=out.status, iters=out.iters,
        r_prim=out.r_prim.astype(dtype), r_dual=out.r_dual.astype(dtype),
        obj=out.obj.astype(dtype), rho=out.rho.astype(dtype),
        history=out.history)


def solve(qp: QPData, settings: Settings = Settings(),
          x0=None, z0=None, y0=None) -> Solution:
    """Solve one QP/SOCP. Optional (x0, z0, y0) warm start (A5), unscaled.

    The default hybrid precision runs as a STAGED pipeline of small
    compiled programs (f32 phase -> polish -> [f64 phase -> polish]),
    with one host sync on the polish status deciding whether the f64
    phase executes at all. Staging keeps each XLA program small (a
    single fused program with both branches under lax.cond compiled
    pathologically slowly) while preserving the runtime win: when
    polishing lands — the typical case — the solve ends after the f32
    loop plus one f64 KKT solve. Use solve_batch / solve_batch_shared
    for traceable batched solving.
    """
    dtype = qp.dtype
    n, m = qp.n, qp.m
    warm_given = x0 is not None and z0 is not None and y0 is not None
    if x0 is None:
        x0 = jnp.zeros(qp.P.shape[:-2] + (n,), dtype)
    if z0 is None:
        z0 = jnp.zeros(qp.A.shape[:-2] + (m,), dtype)
    if y0 is None:
        y0 = jnp.zeros_like(z0)
    backend = resolve_backend(settings)

    if warm_given and settings.warm_start and _x64_available():
        f64 = jnp.float64
        qp64w = qp.astype(f64)
        r_p, r_d, ok, obj = _warm_check_jit(
            qp64w, x0.astype(f64), z0.astype(f64), y0.astype(f64),
            settings.eps_abs, settings.eps_rel)
        if bool(ok):                                        # host sync
            return Solution(
                x=x0, z=z0, y=y0,
                status=jnp.int32(int(Status.SOLVED)),
                iters=jnp.int32(0),
                r_prim=r_p.astype(dtype), r_dual=r_d.astype(dtype),
                obj=obj.astype(dtype),
                rho=jnp.asarray(settings.rho, dtype),
                history=jnp.zeros((0, 3), dtype))

    precision = settings.precision
    if precision == "hybrid" and not _x64_available():
        precision = "single"
    if precision != "hybrid":
        return _solve_jit(qp, x0, z0, y0, settings, backend)

    if settings.recenter_rounds > 0 and (qp.cone.m_soc
                                         or qp.cone.m_l1 == 0):
        # SOC and BOX-ONLY problems: delegate to the shared-matrix
        # batch core at B=1 — ONE compiled program for the whole hybrid
        # pipeline (f32 phase + re-centered rounds + capped f64
        # fallback under lax.cond), where the staged path below runs
        # 3-6 small programs with a host sync between each. Measured
        # CPU iteration counts: box-only problems pay ~1.5-2x
        # iterations for skipping polish (cfg1 50 -> 100, cfg2 500 ->
        # 750). L1 problems stay on the staged path: polish is
        # decisive there (cfg3 625 staged vs 3000 shared — LP-like
        # chatter without it).
        #
        # SOC rounds note: the dual re-centered rounds (masked box base
        # + Moreau SOC base + per-round safeguard, parallel/batch.
        # _solve_shared_recentered) reach ~1.2e-6 absolute residuals in
        # pure f32 on non-degenerate SOCPs. Degenerate bang-bang
        # min-fuel SOCPs (config 4) defeat every f32 stage; the
        # chunked _f64_continuation below (+ its between-chunk
        # tangent-linearized SOC polish) is what lands 1e-6 there.
        from .parallel.batch import solve_batch_shared
        from .problem import QPData as _QPData
        qpb = _QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l[None], u=qp.u[None],
                      lam=qp.lam, cone=qp.cone)
        # SOC corrections converge geometrically per round (~30x); the
        # default 2 rounds can stop a hair above an ABSOLUTE target and
        # trip the capped f64 fallback — 4 rounds close it in f32, and
        # converged rounds are skipped at runtime anyway.
        s_del = settings
        if qp.cone.m_soc:
            s_del = settings.replace(
                recenter_rounds=max(settings.recenter_rounds, 4))
        solb = solve_batch_shared(qpb, s_del, x0=x0[None], z0=z0[None],
                                  y0=y0[None])
        sol = Solution(
            x=solb.x[0], z=solb.z[0], y=solb.y[0],
            status=solb.status[0], iters=solb.iters[0],
            r_prim=solb.r_prim[0], r_dual=solb.r_dual[0],
            obj=solb.obj[0], rho=solb.rho, history=solb.history)
        # Box-only problems return without a host sync: the shared
        # program's internal rounds + capped f64 fallback are the whole
        # pipeline, so solve() stays one async dispatch. Only SOC
        # problems pay the status check — they are the ones whose f32
        # machinery can fail wholesale (config 4) and need
        # _f64_continuation.
        if not qp.cone.m_soc or not _x64_available():
            return sol
        done = int(sol.status) in (                         # host sync
            int(Status.SOLVED), int(Status.PRIMAL_INFEASIBLE),
            int(Status.DUAL_INFEASIBLE))
        if done:
            return sol
        return _f64_continuation(qp, sol, settings, backend)

    def phase(qp_p, x_p, z_p, y_p, s_p):
        return _phase_jit(qp_p, x_p, z_p, y_p, s_p, backend)

    def do_polish(qp_p, sol_p, act_tol):
        return _polish_jit(qp_p, sol_p, settings.eps_abs, settings.eps_rel,
                           act_tol)

    f32, f64 = jnp.float32, jnp.float64
    sol32 = phase(
        qp.astype(f32), x0.astype(f32), z0.astype(f32), y0.astype(f32),
        _s32_of(settings))
    qp64 = qp.astype(f64)

    def clean(v):
        v = v.astype(f64)
        return jnp.where(jnp.isfinite(v), v, 0.0)

    sol32_64 = Solution(
        x=clean(sol32.x), z=clean(sol32.z), y=clean(sol32.y),
        status=sol32.status, iters=jnp.int32(0),
        r_prim=sol32.r_prim.astype(f64), r_dual=sol32.r_dual.astype(f64),
        obj=sol32.obj.astype(f64), rho=sol32.rho.astype(f64),
        history=sol32.history.astype(f64))

    if settings.polish:
        pol = do_polish(qp64, sol32_64, 10.0 * settings.hybrid_eps)
        if int(pol.status) == int(Status.SOLVED):       # host sync
            return _finish(pol, sol32, settings, dtype)

    # --- re-centered f32 refinement rounds (cf. parallel/batch.py) ---
    # Re-solve the SAME problem with data shifted around the current
    # iterate: box bounds shift exactly; L1/SOC rows use the shifted
    # prox (offset = Ax on those rows, original bounds/lam kept). All
    # hot-loop work stays f32; only the shift runs in f64.
    def phase_off(qp_p, x_p, z_p, y_p, off_p, s_p):
        return _phase_off_jit(qp_p, x_p, z_p, y_p, off_p, s_p, backend)

    if settings.recenter_rounds > 0:
        tp = ((lambda cand: do_polish(qp64, cand, 1e-4))
              if settings.polish else None)
        rec = _recentered_rounds(qp, qp64, sol32_64, settings, backend,
                                 phase_off=phase_off, try_polish=tp)
        if rec is not None:
            sol_r, solved_r = rec
            if solved_r:
                if settings.polish:
                    pol = do_polish(qp64, sol_r, 1e-4)
                    if int(pol.status) == int(Status.SOLVED):
                        return _finish(
                            dataclasses.replace(pol, iters=sol_r.iters),
                            sol32, settings, dtype)
                return _finish(sol_r, sol32, settings, dtype)
            sol32_64 = sol_r       # warm-start the f64 phase from it

    s64 = settings.replace(precision="single", warm_start=True,
                           polish=False)
    sol64 = phase(qp64, sol32_64.x, sol32_64.z, sol32_64.y, s64)
    if settings.polish:
        sol64 = dataclasses.replace(
            do_polish(qp64, sol64, 1e-4), iters=sol64.iters)
    return _finish(sol64, sol32, settings, dtype)


def solve_batch(qp_batch: QPData, settings: Settings = Settings(),
                x0=None, z0=None, y0=None) -> Solution:
    """Solve a batch of independent problems (leading batch axis on every
    array leaf of `qp_batch`) via `vmap` over the full solver (P1 core).

    JAX's while-loop batching freezes converged lanes automatically (the
    batched cond OR-reduces and finished lanes keep their carry), so the
    lockstep loop runs to the slowest problem with per-lane honest
    iteration counts (SURVEY.md §7 "hard parts").

    For Monte-Carlo batches that share (P, A) across scenarios use
    `parallel.batch.solve_batch_shared` — the shared-factor fast path.
    """
    dtype = qp_batch.dtype
    B = qp_batch.P.shape[0]
    n, m = qp_batch.n, qp_batch.m
    if x0 is None:
        x0 = jnp.zeros((B, n), dtype)
    if z0 is None:
        z0 = jnp.zeros((B, m), dtype)
    if y0 is None:
        y0 = jnp.zeros_like(z0)
    backend = resolve_backend(settings)
    fn = jax.jit(
        jax.vmap(partial(_solve_core, settings=settings, backend=backend)),
        static_argnames=())
    return fn(qp_batch, x0, z0, y0)
