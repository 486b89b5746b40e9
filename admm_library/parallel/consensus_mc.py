"""Monte-Carlo consensus ADMM over a 2-D (data x horizon) mesh —
P1 x P2 combined (BASELINE.json configs[4]: "Consensus ADMM over 1024
Monte-Carlo dispersed scenarios, horizon-block partitioned").

Topology (parallel/runtime.make_mesh): scenarios shard over the 'data'
axis, horizon blocks over the 'horizon' axis. Per device: (B_loc, S,
...) iterates. Per-block matrices (P, A, q) and their KKT factors are
SHARED across scenarios (dispersions enter only the bounds), so the
x-update is a factor-reuse batched solve; per-iteration cross-chip
traffic is the ns-sized `ppermute` edge exchange along 'horizon' plus
scalar reductions ('horizon' pmax for residuals, 'data' psum for the
shared-rho statistics and the loop predicate) (SURVEY.md §3.3).

Per-scenario convergence masking freezes finished scenarios lockstep,
with honest per-scenario iteration counts, exactly like
parallel.batch.run_admm_batch_shared.

Scaling/precision mirror parallel/consensus.py: one block-shared Ruiz
scaling with tied edge-row factors; hybrid precision = f32 iterations +
re-centered f32 refinement (no f64 iteration loop).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import numpy as np
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..api import resolve_backend
from ..ops import kkt
from ..problem import QPData
from ..settings import Settings
from ..solution import Status
from ..core.scaling import (Scaling, ruiz_equilibrate_blocks,
                            scale_qp_blocks)
from .consensus import ConsensusSpec, consensus_body, _linf_scen
from .. import xprec

_UNSOLVED = np.int32(int(Status.UNSOLVED))
_SOLVED = np.int32(int(Status.SOLVED))


class ConsensusMCSolution(NamedTuple):
    """x/z/y keep the (B, n_blocks, .) scenario-x-block layout, UNSCALED.
    history is the (slots, 3) [(iter, max r_prim, max r_dual)] ring
    buffer when settings.history > 0."""

    x: jax.Array
    z: jax.Array
    y: jax.Array
    status: jax.Array       # (B,)
    iters: jax.Array        # (B,) honest per-scenario counts
    r_prim: jax.Array       # (B,)
    r_dual: jax.Array       # (B,)
    rho: jax.Array
    history: jax.Array


def _geomean_masked_sharded(v, mask, data_axis):
    logv = jnp.where(mask, jnp.log(jnp.maximum(v, 1e-30)), 0.0)
    tot = jax.lax.psum(jnp.sum(logv), data_axis)
    cnt = jax.lax.psum(jnp.sum(mask), data_axis)
    return jnp.exp(tot / jnp.maximum(cnt, 1))


def run_consensus_mc(qp_blk: QPData, spec: ConsensusSpec,
                     settings: Settings, data_axis: str, horizon_axis: str,
                     block_ids, x0, z0, y0, backend: str, scaling_vecs,
                     z_off=None, rho0=None):
    """Device-local driver (runs INSIDE shard_map over both axes).

    qp_blk: block-local data with SCENARIO-BATCHED l/u — l, u have shape
    (B_loc, S, mb); P (S, nb, nb), A (S, mb, nb), q (S, nb) shared.
    x0/z0/y0: (B_loc, S, .). scaling_vecs = (d, e, c) block-shared Ruiz
    factors (residuals/termination computed UNSCALED).
    """
    dtype = qp_blk.dtype
    ml, ns = spec.m_local, spec.ns
    B_loc = x0.shape[0]
    d_s, e_s, c_s = scaling_vecs
    einv = 1.0 / e_s
    cd_inv = 1.0 / (c_s * d_s)

    idx = jnp.arange(spec.mb)
    # Equality boost from lane-0 bounds (dispersions change values, not
    # the equality pattern) + all edge rows.
    l0, u0 = qp_blk.l[0], qp_blk.u[0]
    box_eq = (l0 == u0) & jnp.isfinite(l0) & (
        idx[None, :] < spec.cone.m_box)
    edge = idx[None, :] >= ml
    eq_mask = box_eq | edge                                 # (S, mb)

    rho0 = (jnp.asarray(settings.rho, dtype) if rho0 is None
            else rho0.astype(dtype))
    edge_scale = (settings.rho_edge_scale if settings.rho_edge_scale > 0
                  else settings.rho_eq_scale)

    def rho_vec_of(rb):
        return jnp.where(box_eq, settings.rho_eq_scale * rb,
                         jnp.where(edge, edge_scale * rb, rb))

    def factor(rb):
        rv = rho_vec_of(rb)
        return kkt.factor_condensed(
            qp_blk.P, qp_blk.A, settings.sigma, rv, backend,
            settings.band_block)

    fac0 = factor(rho0)
    # L1 gradient scale for the dual-norm reference (core.admm.
    # l1_grad_scale rationale): shared across scenarios (lam/A shared).
    cone_loc = spec.cone
    if cone_loc.m_l1:
        mbx = cone_loc.m_box
        lamA = jnp.max(
            qp_blk.lam[..., :, None]
            * jnp.abs(qp_blk.A[..., mbx:mbx + cone_loc.m_l1, :]),
            axis=(-3, -2))
        nlam = jax.lax.pmax(jnp.max(jnp.abs(cd_inv * lamA)), horizon_axis)
    else:
        nlam = jnp.zeros((), dtype)
    big = jnp.full((B_loc,), jnp.inf, dtype)
    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    slots = max(settings.history, 0)
    hist0 = jnp.full((slots, 3), -1.0, dtype)

    carry0 = (x0, z0, y0, rho0, fac0, jnp.int32(0),
              jnp.zeros((B_loc,), jnp.int32),
              jnp.full((B_loc,), _UNSOLVED), big, big,
              jnp.asarray(True), hist0, jnp.int32(0),
              jnp.zeros_like(x0), jnp.zeros_like(z0), jnp.zeros_like(y0),
              jnp.int32(0), x0, y0)
    restart_checks = settings.restart_every and max(
        1, settings.restart_every // k)
    use_cert = settings.eps_pinf > 0 or settings.eps_dinf > 0

    def scen_res(x, z, y):
        """Per-scenario unscaled residual norms (7-tuple of (B_loc,))."""
        Ax = xprec.einsum("...ij,...j->...i", qp_blk.A, x)
        Px = xprec.einsum("...ij,...j->...i", qp_blk.P, x)
        Aty = xprec.einsum("...ji,...j->...i", qp_blk.A, y)
        r_p = _linf_scen(einv * (Ax - z), horizon_axis)     # (B_loc,)
        r_d = _linf_scen(cd_inv * (Px + qp_blk.q + Aty), horizon_axis)
        nAx = _linf_scen(einv * Ax, horizon_axis)
        nz = _linf_scen(einv * z, horizon_axis)
        nPx = _linf_scen(cd_inv * Px, horizon_axis)
        nAty = _linf_scen(cd_inv * Aty, horizon_axis)
        nq = jnp.maximum(
            jax.lax.pmax(jnp.max(jnp.abs(cd_inv * qp_blk.q)), horizon_axis), nlam)
        return r_p, r_d, nAx, nz, nPx, nAty, nq

    def scaled_ratio(res):
        r_p, r_d, nAx, nz, nPx, nAty, nq = res
        eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(nAx, nz)
        eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
            jnp.maximum(nPx, nAty), nq)
        return jnp.maximum(r_p / eps_p, r_d / eps_d)

    def cond(c):
        # `alive` is the psum-reduced liveness computed in the BODY —
        # collectives are not allowed in a while_loop predicate under
        # shard_map, so the body stores the reduction in the carry.
        it, alive = c[5], c[10]
        return alive & (it < settings.max_iter)

    def body(c):
        (x, z, y, rho_bar, fac, it, iters_sc, status, r_p_old, r_d_old,
         _alive, hist, hist_ptr, x_sum, z_sum, y_sum, avg_cnt,
         x_chk, y_chk) = c
        rho_vec = rho_vec_of(rho_bar)
        active = status == _UNSOLVED

        def inner(_, xyz):
            return consensus_body(
                qp_blk, spec, settings, horizon_axis, block_ids, fac,
                *xyz, rho_vec, backend, z_off=z_off)

        xn, zn, yn = jax.lax.fori_loop(0, k, inner, (x, z, y))
        am = active[:, None, None]
        x = jnp.where(am, xn, x)
        z = jnp.where(am, zn, z)
        y = jnp.where(am, yn, y)
        it = it + k
        iters_sc = iters_sc + jnp.where(active, k, 0)

        res = scen_res(x, z, y)

        # Per-scenario certificates from PRE-restart deltas (cf.
        # consensus.run_consensus; a restart wrecks the delta ray).
        if use_cert:
            from .consensus import infeasibility_blocks
            pinf, dinf = infeasibility_blocks(
                qp_blk, spec, settings, horizon_axis, block_ids,
                (d_s, e_s, c_s), x - x_chk, y - y_chk)
        x_chk, y_chk = x, y

        # Per-scenario restarted averaging (Settings.restart_every).
        # Norms are horizon-pmax-reduced, so the per-scenario take
        # decision is identical on every horizon-axis device.
        x_sum = x_sum + x
        z_sum = z_sum + z
        y_sum = y_sum + y
        avg_cnt = avg_cnt + 1
        if restart_checks:
            boundary = (it // k - 1) % restart_checks == restart_checks - 1

            def try_restart(args):
                x, z, y, res, xs, zs, ys, cnt = args
                denom = jnp.maximum(cnt, 1).astype(dtype)
                xa, za, ya = xs / denom, zs / denom, ys / denom
                res_a = scen_res(xa, za, ya)
                take = active & (scaled_ratio(res_a) < scaled_ratio(res))
                tsc = take[:, None, None]
                res_o = tuple(jnp.where(take, ra, rc)
                              for ra, rc in zip(res_a[:6], res[:6])
                              ) + (res[6],)
                zero = lambda v: jnp.zeros_like(v)
                return (jnp.where(tsc, xa, x), jnp.where(tsc, za, z),
                        jnp.where(tsc, ya, y), res_o,
                        zero(xs), zero(zs), zero(ys), jnp.int32(0))

            x, z, y, res, x_sum, z_sum, y_sum, avg_cnt = jax.lax.cond(
                boundary, try_restart, lambda a: a,
                (x, z, y, res, x_sum, z_sum, y_sum, avg_cnt))

        r_p, r_d, nAx, nz, nPx, nAty, nq = res
        eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(nAx, nz)
        eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
            jnp.maximum(nPx, nAty), nq)
        solved = (r_p <= eps_p) & (r_d <= eps_d)
        numerr = ~(jnp.isfinite(r_p) & jnp.isfinite(r_d))
        new_status = jnp.where(
            numerr, jnp.int32(int(Status.NUMERICAL_ERROR)),
            jnp.where(solved, _SOLVED, _UNSOLVED))
        if use_cert:
            new_status = jnp.where(
                new_status == _UNSOLVED,
                jnp.where(pinf, jnp.int32(int(Status.PRIMAL_INFEASIBLE)),
                          jnp.where(dinf,
                                    jnp.int32(int(Status.DUAL_INFEASIBLE)),
                                    new_status)), new_status)
        status = jnp.where(active, new_status, status)
        r_p = jnp.where(active, r_p, r_p_old)
        r_d = jnp.where(active, r_d, r_d_old)

        if settings.adaptive_rho:
            adapt_now = (it // k - 1) % interval_checks == (
                interval_checks - 1)
            tiny = jnp.finfo(dtype).tiny
            still = status == _UNSOLVED
            sp = r_p / jnp.maximum(jnp.maximum(nAx, nz), tiny)
            sd = r_d / jnp.maximum(
                jnp.maximum(jnp.maximum(nPx, nAty), nq), tiny)
            gp = _geomean_masked_sharded(sp, still, data_axis)
            gd = _geomean_masked_sharded(sd, still, data_axis)
            ratio = jnp.sqrt(gp / jnp.maximum(gd, tiny))
            new_rho = jnp.clip(
                rho_bar * ratio, settings.rho_min, settings.rho_max)
            tol = settings.adaptive_rho_tol
            changed = (ratio > tol) | (ratio < 1.0 / tol)
            any_still = jax.lax.psum(
                jnp.sum(still.astype(jnp.int32)), data_axis) > 0
            do = adapt_now & changed & any_still
            if backend == "cg":
                rho_bar = jnp.where(do, new_rho, rho_bar)
                fac = dict(fac, rho=rho_vec_of(rho_bar))
            else:
                fac = jax.lax.cond(
                    do, lambda r: factor(r), lambda r: fac, new_rho)
                rho_bar = jnp.where(do, new_rho, rho_bar)

        alive = jax.lax.psum(
            jnp.sum((status == _UNSOLVED).astype(jnp.int32)),
            data_axis) > 0

        if slots > 0:
            # Global residual trace: max over scenarios (data psum is
            # a max here — use pmax over the data axis too).
            gp_ = jax.lax.pmax(jnp.max(r_p), data_axis)
            gd_ = jax.lax.pmax(jnp.max(r_d), data_axis)
            entry = jnp.stack([it.astype(dtype), gp_, gd_])
            hist = jax.lax.dynamic_update_slice(
                hist, entry[None, :], (hist_ptr % slots, jnp.int32(0)))
            hist_ptr = hist_ptr + 1

        return (x, z, y, rho_bar, fac, it, iters_sc, status, r_p, r_d,
                alive, hist, hist_ptr, x_sum, z_sum, y_sum, avg_cnt,
                x_chk, y_chk)

    final = jax.lax.while_loop(cond, body, carry0)
    (x, z, y, rho_bar, _, it, iters_sc, status, r_p, r_d, _, hist,
     _hp, *_sums) = final
    status = jnp.where(
        status == _UNSOLVED, jnp.int32(int(Status.MAX_ITER)), status)
    return x, z, y, status, iters_sc, r_p, r_d, rho_bar, hist


@partial(jax.jit, static_argnames=("spec", "settings", "data_axis",
                                   "horizon_axis", "backend", "mesh",
                                   "has_off"))
def _phase_mc_jit(qp_blk, x0, z0, y0, z_off, rho0, scaling, spec,
                  settings, data_axis, horizon_axis, backend, mesh,
                  has_off):
    Bb = spec.n_blocks
    dtype = qp_blk.dtype
    block_ids = jnp.arange(Bb, dtype=jnp.int32)
    d_s = scaling.d.astype(dtype)
    e_s = scaling.e.astype(dtype)
    c_s = scaling.c.astype(dtype)
    xs = (x0 / d_s).astype(dtype)
    zs = (e_s * z0).astype(dtype)
    ys = ((c_s / e_s) * y0).astype(dtype)
    offs = (e_s * z_off).astype(dtype) if has_off else jnp.zeros((), dtype)

    def device_fn(P_b, q_b, A_b, lam_b, l_b, u_b, ids, x, z, y,
                  d_v, e_v, c_v, off, r0):
        qp_loc = QPData(P=P_b, q=q_b, A=A_b, l=l_b, u=u_b, lam=lam_b,
                        cone=qp_blk.cone)
        return run_consensus_mc(
            qp_loc, spec, settings, data_axis, horizon_axis, ids,
            x, z, y, backend, (d_v, e_v, c_v),
            z_off=(off if has_off else None), rho0=r0)

    PH = P(horizon_axis)
    PDH = P(data_axis, horizon_axis)
    PD = P(data_axis)
    off_spec = PDH if has_off else P()
    # q may carry a scenario axis (re-centered rounds: g = Px + q).
    q_spec = PDH if qp_blk.q.ndim == 3 else PH
    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PH, q_spec, PH, PH, PDH, PDH, PH,
                  PDH, PDH, PDH, P(), P(), P(), off_spec, P()),
        out_specs=(PDH, PDH, PDH, PD, PD, PD, PD, P(), P()),
        check_vma=False)
    with xprec.highest():
        x, z, y, status, it, rp, rd, rho, hist = sharded(
            qp_blk.P, qp_blk.q, qp_blk.A, qp_blk.lam, qp_blk.l, qp_blk.u,
            block_ids, xs, zs, ys, d_s, e_s, c_s, offs, rho0)
    return (d_s * x, z / e_s, (e_s / c_s) * y, status, it, rp, rd, rho,
            hist)


def _mc_phase(qp_blk, spec, mesh, settings, data_axis, horizon_axis,
              scaling, backend, x0, z0, y0, z_off=None, rho0=None
              ) -> ConsensusMCSolution:
    has_off = z_off is not None
    if z_off is None:
        z_off = jnp.zeros((), qp_blk.dtype)
    if rho0 is None:
        rho0 = jnp.asarray(settings.rho, qp_blk.dtype)
    out = _phase_mc_jit(qp_blk, x0, z0, y0, z_off, rho0, scaling, spec,
                        settings, data_axis, horizon_axis, backend, mesh,
                        has_off)
    return ConsensusMCSolution(*out)


def _recentered_consensus_mc(qp_blk, spec, settings, sol32, phase_fn):
    """Re-centered f32 refinement for box-cone scenario batches: the MC
    wrapper over consensus.recentered_rounds_blocks (shapes carry a
    leading scenario axis; residuals/status come out per-scenario). The
    correction's linear term g is per-SCENARIO ((B, Bb, nb)) — the phase
    path supports a scenario-batched q (it enters only the x-update rhs
    and residuals, which broadcast; the KKT factor depends on P/A only,
    so factor sharing across scenarios is unaffected)."""
    from .consensus import recentered_rounds_blocks

    x_t, z_t, y_t, status, iters, r_p, r_d = recentered_rounds_blocks(
        qp_blk, spec, settings, sol32, phase_fn)
    dtype = qp_blk.dtype
    return ConsensusMCSolution(
        x=x_t.astype(dtype), z=z_t.astype(dtype), y=y_t.astype(dtype),
        status=status, iters=iters,
        r_prim=r_p.astype(dtype), r_dual=r_d.astype(dtype),
        rho=sol32.rho, history=sol32.history)


def consensus_solve_mc(qp_blk: QPData, spec: ConsensusSpec, mesh: Mesh,
                       settings: Settings = Settings(),
                       x0=None, z0=None, y0=None, rho0=None,
                       data_axis: str = "data",
                       horizon_axis: str = "horizon"
                       ) -> ConsensusMCSolution:
    """Solve B dispersed scenarios of a block-partitioned problem over a
    2-D (data, horizon) mesh.

    qp_blk: P (n_blocks, nb, nb), A, q per-block shared; l, u
    scenario-batched (B, n_blocks, mb); lam (n_blocks, m_l1) shared.
    B must divide by mesh[data_axis], n_blocks by mesh[horizon_axis].
    Optional UNSCALED (x0, z0, y0) warm start, (B, n_blocks, .) layout.
    Hybrid precision = f32 + re-centered refinement (box cones).
    """
    Bb = spec.n_blocks
    B = qp_blk.l.shape[0]
    nd, nh = mesh.shape[data_axis], mesh.shape[horizon_axis]
    if B % nd != 0 or Bb % nh != 0:
        raise ValueError(
            f"batch {B} x blocks {Bb} not divisible by mesh "
            f"({nd} x {nh})")
    # Per-block factors carry no banded structure: 'auto' takes the
    # platform's dense choice.
    backend = resolve_backend(settings.replace(band_block=0))
    dtype = qp_blk.dtype
    if x0 is None:
        x0 = jnp.zeros((B, Bb, spec.nb), dtype)
    if z0 is None:
        z0 = jnp.zeros((B, Bb, spec.mb), dtype)
    if y0 is None:
        y0 = jnp.zeros((B, Bb, spec.mb), dtype)

    # Lay the data out on the mesh before compute.
    PH = NamedSharding(mesh, P(horizon_axis))
    PDH = NamedSharding(mesh, P(data_axis, horizon_axis))
    qp_blk = QPData(
        P=jax.device_put(qp_blk.P, PH), q=jax.device_put(qp_blk.q, PH),
        A=jax.device_put(qp_blk.A, PH), l=jax.device_put(qp_blk.l, PDH),
        u=jax.device_put(qp_blk.u, PDH),
        lam=jax.device_put(qp_blk.lam, PH), cone=qp_blk.cone)

    qp_s, scaling = ruiz_equilibrate_blocks(
        qp_blk, spec, settings.scaling_iters)

    if rho0 is not None:
        rho0 = jnp.asarray(rho0)

    def phase(qp_p, s, x_p, z_p, y_p, off=None, rho0=rho0):
        return _mc_phase(qp_p, spec, mesh, s, data_axis, horizon_axis,
                         scaling, backend, x_p, z_p, y_p, z_off=off,
                         rho0=rho0)

    precision = settings.precision
    if precision == "hybrid" and not jax.config.jax_enable_x64:
        precision = "single"
    if precision == "single":
        return phase(qp_s, settings, x0, z0, y0)
    if precision == "double":
        f = jnp.float64
        return phase(qp_s.astype(f), settings, x0.astype(f),
                     z0.astype(f), y0.astype(f))

    f32, f64 = jnp.float32, jnp.float64
    s32 = settings.replace(
        precision="single",
        eps_abs=max(settings.hybrid_eps, settings.eps_abs),
        eps_rel=max(settings.hybrid_eps, settings.eps_rel),
        sigma=max(settings.sigma, 1e-5),
        rho_eq_scale=min(settings.rho_eq_scale, 1e2),
        rho_edge_scale=(min(settings.rho_edge_scale, 1e2)
                        if settings.rho_edge_scale > 0 else -1.0))
    sol32 = phase(qp_s.astype(f32), s32, x0.astype(f32), z0.astype(f32),
                  y0.astype(f32))

    cone = spec.cone
    if cone.m_l1 == 0 and cone.m_soc == 0 and settings.recenter_rounds > 0:
        def phase_scaled_c(qp_c, s_c, x_c, z_c, y_c, off_c, rho0):
            qp_cs = scale_qp_blocks(qp_c, scaling.astype(f32), spec)
            return _mc_phase(
                qp_cs, spec, mesh, s_c, data_axis, horizon_axis,
                scaling.astype(f32), backend, x_c, z_c, y_c, z_off=off_c,
                rho0=rho0)

        return _recentered_consensus_mc(
            qp_blk, spec, settings, sol32, phase_scaled_c)

    def clean(v):
        v = v.astype(f64)
        return jnp.where(jnp.isfinite(v), v, 0.0)

    sol64 = phase(qp_s.astype(f64), settings.replace(precision="single"),
                  clean(sol32.x), clean(sol32.z), clean(sol32.y))
    return ConsensusMCSolution(
        x=sol64.x.astype(dtype), z=sol64.z.astype(dtype),
        y=sol64.y.astype(dtype), status=sol64.status,
        iters=sol32.iters + sol64.iters,
        r_prim=sol64.r_prim.astype(dtype),
        r_dual=sol64.r_dual.astype(dtype), rho=sol64.rho.astype(dtype),
        history=sol64.history)
