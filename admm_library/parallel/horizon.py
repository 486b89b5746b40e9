"""Horizon-sharded ADMM with an EXACT distributed SPIKE x-update (P2).

The multi-chip companion of the 'spike' KKT backend (ops/spike.py): one
long-horizon MPC problem (or a scenario batch of them) with variables,
constraint rows, and the block-tridiagonal KKT system all partitioned
along the TIME axis over a ('data', 'horizon') device mesh — the same
topology as parallel/consensus_mc.py, but WITHOUT the consensus
reformulation: the x-update solves the full condensed system exactly
across devices, so the iterate sequence (and iteration count) matches
the un-partitioned single-chip solver by construction. Measured on the
horizon-50 Monte-Carlo set that is 325 lockstep iterations where
boundary-averaging consensus needs 1525 (PERF.md; the diffusion limit
of one-hop consensus — Nesterov momentum on the boundary duals diverges,
documented there as a negative result).

Per-iteration cross-device traffic (all small):
  x-update   1 ppermute (neighbor g_first, (B_loc, b)) +
             1 all_gather of the reduced-interface rhs
             ((B_loc, parts, b) — a few KB) along 'horizon';
             every device then solves the tiny replicated separator
             system redundantly (deterministic, bitwise identical).
  SpMV halo  1 ppermute each way (A x needs the previous part's last
             state block; A'y scatters back the next part's first rows).
  residuals  pmax over 'horizon'; liveness/rho-geomean psum over 'data'.

Scope: box + L1 + uniform-SOC cones laid out [box | L1 | SOC] per part
with identical per-type counts across parts (round 5 — free-row padding
for box/L1; SOC blocks must be time-local, uniform-dim, equal-count,
which every model family here satisfies), shared P/A across scenarios,
precision 'single'/'double'. The staged hybrid/recenter/polish pipeline
stays on the un-partitioned drivers — this module's job is the
horizon-scaling program structure, proven by iterate parity with
solve_batch_shared in tests/test_horizon.py (box, L1, and SOC cases)
and the driver dryrun gate.

Reference basis: the reference ships no code (/root/reference/README.md:1-2,
SURVEY.md §0); this realises BASELINE.json "north_star" horizon-block
partitioning "with psum/all-gather residual reductions" — with
the reductions carrying an exact interface solve instead of a penalty
negotiation.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import xprec
from ..ops import banded as banded_ops
from ..ops.prox import project_cone
from ..problem import ConeSpec, QPData
from ..settings import Settings
from ..solution import Status
from .consensus import _neighbor_next, _neighbor_prev

_UNSOLVED = np.int32(int(Status.UNSOLVED))
_SOLVED = np.int32(int(Status.SOLVED))


@dataclasses.dataclass(frozen=True)
class HorizonSpec:
    """Static layout of the horizon-partitioned problem.

    parts  time partitions (each owns Np = N/parts variable blocks)
    b      variable block size (band_block of the source MPC)
    npb    Np * b variables per part
    mp     padded constraint rows per part
    cone   per-part cone layout [box | L1 | SOC], IDENTICAL across
           parts (padded with free rows) so one traced prox serves
           every part (VERDICT r4 item 4 — box-only was the v1 scope)
    """

    parts: int
    b: int
    npb: int
    mp: int
    cone: ConeSpec = ConeSpec()

    @property
    def ni(self) -> int:
        return self.npb - self.b

    def __hash__(self):
        return hash((self.parts, self.b, self.npb, self.mp, self.cone))


class HorizonParts(NamedTuple):
    """Partitioned problem data (leading axis = parts).

    A_loc  (parts, mp, npb)  rows of part p against part p's variables
    A_halo (parts, mp, b)    rows of part p against part p-1's LAST
                             variable block (zero for p = 0)
    P_diag (parts, npb)      diagonal objective (the MPC family's P)
    q      (parts, npb)
    l, u   ([B,] parts, mp)  bounds (scenario batch optional)
    lam    (parts, ml_loc)   per-part L1 weights (0 on padded rows)
    """

    A_loc: jax.Array
    A_halo: jax.Array
    P_diag: jax.Array
    q: jax.Array
    l: jax.Array
    u: jax.Array
    lam: jax.Array


def partition_qp(qp: QPData, b: int, parts: int, row_time) -> tuple:
    """Slice a banded MPC-family QP into HorizonParts (host-side, static).

    qp: P diagonal (asserted), A (m, n), l/u possibly scenario-batched
    (B, m). row_time: (m,) int array mapping each constraint row to a
    time step in [0, N); rows are grouped into parts of Np consecutive
    steps and padded with free rows (A = 0, bounds = +-inf) to a common
    per-part count. Asserts every row's support lies inside its part's
    variables plus the previous part's last block (the banded property).

    Mixed cones (VERDICT r4 item 4): each part's rows are laid out
    [box | L1 | SOC] with IDENTICAL per-type counts across parts — box
    and L1 segments pad with free rows (±inf bounds, lam = 0: both
    proxes are the identity there), SOC blocks must be whole within a
    part's time range, uniform in dim, and equal in per-part count (the
    time-local thrust cones of the model builders satisfy all three).

    Returns (HorizonParts, HorizonSpec) — HorizonSpec.cone carries the
    shared per-part ConeSpec.
    """
    A = np.asarray(qp.A, np.float64)
    Pd_full = np.asarray(qp.P, np.float64)
    if not np.allclose(Pd_full, np.diag(np.diag(Pd_full))):
        raise ValueError("partition_qp supports diagonal-P MPC problems")
    Pd_full = np.diag(Pd_full)
    q = np.asarray(qp.q, np.float64)
    l = np.asarray(qp.l, np.float64)
    u = np.asarray(qp.u, np.float64)
    lam = np.asarray(qp.lam, np.float64)
    cone = qp.cone
    mb_g, ml_g = cone.m_box, cone.m_l1
    m, n = A.shape
    N = n // b
    if N % parts or N // parts < 2:
        raise ValueError(f"{N} blocks not partitionable into {parts}")
    Np = N // parts
    npb = Np * b
    row_time = np.asarray(row_time)
    row_part = row_time // Np

    # --- per-part row sets, split by cone segment ---
    ridx = np.arange(m)
    is_box = ridx < mb_g
    is_l1 = (ridx >= mb_g) & (ridx < mb_g + ml_g)
    if cone.m_soc:
        if not cone.soc_uniform:
            raise ValueError("horizon partition needs uniform SOC dims")
        d = cone.soc_dims[0]
        soc_block = (ridx - mb_g - ml_g) // d          # block id per row
        blk_part = row_part[mb_g + ml_g::d] if d else None
        # Every SOC block must sit wholly inside one part.
        for kblk in range(cone.n_soc):
            rows_b = row_part[mb_g + ml_g + kblk * d:
                              mb_g + ml_g + (kblk + 1) * d]
            if len(set(rows_b.tolist())) != 1:
                raise ValueError(f"SOC block {kblk} straddles parts")
    box_rows = [np.nonzero(is_box & (row_part == p))[0]
                for p in range(parts)]
    l1_rows = [np.nonzero(is_l1 & (row_part == p))[0]
               for p in range(parts)]
    if cone.m_soc:
        soc_blocks = [np.nonzero(blk_part == p)[0] for p in range(parts)]
        n_soc_loc = len(soc_blocks[0])
        if any(len(sb) != n_soc_loc for sb in soc_blocks):
            raise ValueError(
                "per-part SOC block counts differ — pad the model or "
                "choose a partition aligned with the cone layout")
        soc_rows = [np.concatenate(
            [mb_g + ml_g + kblk * d + np.arange(d) for kblk in sb])
            if len(sb) else np.zeros(0, np.int64) for sb in soc_blocks]
        msoc_loc = n_soc_loc * d
    else:
        d, n_soc_loc, msoc_loc = 0, 0, 0
        soc_rows = [np.zeros(0, np.int64) for _ in range(parts)]
    mb_loc = max(len(r) for r in box_rows)
    ml_loc = max(len(r) for r in l1_rows) if ml_g else 0
    mp = mb_loc + ml_loc + msoc_loc
    cone_loc = ConeSpec(m_box=mb_loc, m_l1=ml_loc,
                        soc_dims=(d,) * n_soc_loc)

    batched = l.ndim == 2
    B = l.shape[0] if batched else 1
    A_loc = np.zeros((parts, mp, npb))
    A_halo = np.zeros((parts, mp, b))
    l_p = np.full((B, parts, mp), -np.inf)
    u_p = np.full((B, parts, mp), np.inf)
    lam_p = np.zeros((parts, ml_loc))
    l2 = l if batched else l[None]
    u2 = u if batched else u[None]
    for p in range(parts):
        # Per-part layout [box(pad) | L1(pad) | SOC]; global row order
        # within each segment is preserved.
        segs = [(box_rows[p], 0), (l1_rows[p], mb_loc),
                (soc_rows[p], mb_loc + ml_loc)]
        rows = np.concatenate([r for r, _ in segs]).astype(np.int64)
        dest = np.concatenate(
            [off + np.arange(len(r)) for r, off in segs]).astype(np.int64)
        c0 = p * npb
        Ap = A[rows]
        # Banded support check: nothing outside [c0 - b, c0 + npb).
        out = np.abs(Ap).sum(0)
        lo = max(c0 - b, 0)
        if out[:lo].sum() > 0 or out[c0 + npb:].sum() > 0:
            raise ValueError(f"part {p}: rows reach outside the band")
        A_loc[p, dest] = Ap[:, c0:c0 + npb]
        if p > 0:
            A_halo[p, dest] = Ap[:, c0 - b:c0]
            # The SPIKE factor truncates the cross-part coupling to
            # E = (A_loc' rho A_halo)[:, :b, :] — valid only when every
            # halo-touching row couples exclusively to the part's FIRST
            # variable block. A row that passed the band check above
            # but reached past [c0, c0+b) would silently drop coupling
            # and corrupt the factor (ADVICE r4) — reject it here.
            halo_rows = np.abs(Ap[:, c0 - b:c0]).sum(1) > 0
            beyond = np.abs(Ap[:, c0 + b:c0 + npb]).sum(1)
            if halo_rows.any() and (beyond[halo_rows] > 0).any():
                raise ValueError(
                    f"part {p}: halo rows reach past the first "
                    "variable block — unsupported coupling pattern")
        l_p[:, p, dest] = l2[:, rows]
        u_p[:, p, dest] = u2[:, rows]
        if len(l1_rows[p]):
            lam_p[p, :len(l1_rows[p])] = lam[l1_rows[p] - mb_g]
    if not batched:
        l_p, u_p = l_p[0], u_p[0]
    dt = qp.dtype
    hp = HorizonParts(
        A_loc=jnp.asarray(A_loc, dt), A_halo=jnp.asarray(A_halo, dt),
        P_diag=jnp.asarray(Pd_full.reshape(parts, npb), dt),
        q=jnp.asarray(q.reshape(parts, npb), dt),
        l=jnp.asarray(l_p, dt), u=jnp.asarray(u_p, dt),
        lam=jnp.asarray(lam_p, dt))
    return hp, HorizonSpec(parts=parts, b=b, npb=npb, mp=mp,
                           cone=cone_loc)


def mpc_row_time(N: int, ns: int, nu: int):
    """Row->time map for the double-integrator MPC layout
    (models/double_integrator.py:113-137: N*ns dynamics rows by step,
    ns terminal rows at step N-1, N*nu control rows by step)."""
    return np.concatenate([
        np.repeat(np.arange(N), ns),
        np.full(ns, N - 1),
        np.repeat(np.arange(N), nu)])


def lt_row_time(N: int):
    """Row->time map for the low-thrust SOCP layout
    (models/low_thrust.py:137-179: N*6 dynamics rows by step, 6 terminal
    rows at step N-1, N Gamma-bound rows by step, N SOC(4) blocks by
    step)."""
    return np.concatenate([
        np.repeat(np.arange(N), 6),
        np.full(6, N - 1),
        np.arange(N),
        np.repeat(np.arange(N), 4)])


def cw_sparse_row_time(N: int):
    """Row->time map for the banded CW min-fuel transcription
    (models/clohessy_wiltshire.build_cw_rendezvous_sparse: N*6 dynamics
    rows by step, 6 terminal rows at step N-1, N*3 L1 impulse rows by
    step)."""
    return np.concatenate([
        np.repeat(np.arange(N), 6),
        np.full(6, N - 1),
        np.repeat(np.arange(N), 3)])


# ---------------------------------------------------------------------
# Distributed SPIKE factor/solve (device-local code inside shard_map).
# Mirrors ops/spike.py with the part axis split local/global: interior
# eliminations are device-local batched matmuls; only the separator
# system is global (all_gather + redundant replicated solve).
# ---------------------------------------------------------------------


def _spike_factor_sharded(Mpp, E, spec: HorizonSpec, axis: str):
    """Mpp (S, npb, npb) local part-diagonal blocks, E (S, b, b) the
    coupling of each part's first row-block to the PREVIOUS part's
    separator (zero on global part 0). Returns the local factor dict
    with a REPLICATED reduced Cholesky."""
    S = Mpp.shape[0]
    ni, b = spec.ni, spec.b
    A_int = Mpp[:, :ni, :ni]
    Bl = Mpp[:, ni:, ni - b:ni]
    Dsep = Mpp[:, ni:, ni:]
    from jax.scipy.linalg import solve_triangular

    L = jnp.linalg.cholesky(A_int)
    eye = jnp.broadcast_to(jnp.eye(ni, dtype=Mpp.dtype), L.shape)
    Linv = solve_triangular(L, eye, lower=True)
    Ainv = xprec.einsum("...ji,...jk->...ik", Linv, Linv)
    V = xprec.matmul(Ainv[:, :, :b], E)
    W = xprec.matmul(Ainv[:, :, ni - b:], jnp.swapaxes(Bl, -1, -2))

    Vf, Vl = V[:, :b, :], V[:, ni - b:, :]
    # E'V_f of the NEXT part (cross-device at the boundary). The
    # neighbor helpers shift along axis -2, so flatten the (b, b)
    # matrices to rows first. _neighbor_next is device-cyclic; the LAST
    # global part has no right neighbor — its wrapped contribution is
    # zeroed via the part ids in _spike_reduce_factor.
    EtVf = xprec.einsum("pji,pjk->pik", E, Vf)          # (S, b, b)
    EtVf_next = _neighbor_next(
        EtVf.reshape(S, b * b), axis).reshape(S, b, b)
    Td = Dsep - xprec.matmul(Bl, W[:, ni - b:])
    Tl_loc = -xprec.matmul(Bl, Vl)                      # valid for p >= 1
    return {"Ainv": Ainv, "V": V, "W": W, "Bl": Bl, "E": E,
            "Td_part": Td, "EtVf_next": EtVf_next, "Tl_loc": Tl_loc}


def _spike_reduce_factor(fac, part_ids, n_parts, axis: str):
    """Assemble + factor the replicated separator system from the local
    pieces: Td[p] -= EtVf of part p+1; Tl[p-1] = Tl_loc[p] for p >= 1."""
    S, b, _ = fac["E"].shape
    is_last = (part_ids == n_parts - 1)[:, None, None]
    Td = fac["Td_part"] - jnp.where(is_last, 0.0, fac["EtVf_next"])
    Td_all = jax.lax.all_gather(Td, axis, tiled=True)      # (parts, b, b)
    Tl_all = jax.lax.all_gather(fac["Tl_loc"], axis, tiled=True)[1:]
    Tld, Tll = banded_ops.block_tridiag_cholesky(Td_all, Tl_all)
    return {"Tld": Tld, "Tll": Tll}


def _spike_solve_sharded(fac, red, rhs, part_ids, spec: HorizonSpec,
                         axis: str):
    """rhs (B, S, npb) local; returns x same shape. One ppermute + one
    all_gather along `axis`; the separator solve is replicated."""
    ni, b = spec.ni, spec.b
    S = rhs.shape[-2]
    ru, rs = rhs[..., :ni], rhs[..., ni:]
    g = xprec.einsum("pij,...pj->...pi", fac["Ainv"], ru)
    gf = g[..., :b]
    gf_next = _neighbor_next(gf, axis)                  # (B, S, b)
    E_next = _neighbor_next(
        fac["E"].reshape(S, b * b), axis).reshape(S, b, b)
    is_last = (part_ids == spec.parts - 1)[:, None]
    rs_t = (rs - xprec.einsum("pij,...pj->...pi", fac["Bl"],
                              g[..., ni - b:])
            - jnp.where(is_last, 0.0,
                        xprec.einsum("pji,...pj->...pi", E_next, gf_next)))
    # Replicated separator solve over all parts.
    rs_all = jax.lax.all_gather(rs_t, axis, axis=-2, tiled=True)
    lead = rs_all.shape[:-2]
    s_all = banded_ops.block_tridiag_solve(
        red["Tld"], red["Tll"], rs_all.reshape(lead + (spec.parts * b,)))
    s_all = s_all.reshape(lead + (spec.parts, b))
    s = jnp.take(s_all, part_ids, axis=-2)
    s_prev_all = jnp.concatenate(
        [jnp.zeros(lead + (1, b), s_all.dtype), s_all[..., :-1, :]],
        axis=-2)
    s_prev = jnp.take(s_prev_all, part_ids, axis=-2)
    u = (g - xprec.einsum("pij,...pj->...pi", fac["V"], s_prev)
         - xprec.einsum("pij,...pj->...pi", fac["W"], s))
    return jnp.concatenate([u, s], axis=-1)


class HorizonSolution(NamedTuple):
    """x (B, parts, npb) etc. per-scenario status/iters/residuals."""

    x: jax.Array
    z: jax.Array
    y: jax.Array
    status: jax.Array
    iters: jax.Array
    r_prim: jax.Array
    r_dual: jax.Array
    rho: jax.Array


def _run_horizon(hp: HorizonParts, spec: HorizonSpec, settings: Settings,
                 part_ids, x0, z0, y0, data_axis: str, horizon_axis: str):
    """Device-local ADMM driver (inside shard_map over both axes).

    hp fields carry the LOCAL part slices; l/u are (B_loc, S, mp).
    Plain ADMM semantics identical to parallel.batch.run_admm_batch_
    shared's core loop (x-solve, relax, box prox, dual update, masked
    lockstep, shared adaptive rho) with the x-solve distributed.
    """
    dtype = hp.q.dtype
    ax = horizon_axis
    S = hp.q.shape[0]
    ni, b, mp = spec.ni, spec.b, spec.mp
    B_loc = x0.shape[0]
    sigma = jnp.asarray(settings.sigma, dtype)

    cone = spec.cone
    mb_loc, ml_loc = cone.m_box, cone.m_l1
    l0, u0 = hp.l[0], hp.u[0]
    row_idx = jnp.arange(spec.mp)
    # Only box rows are equalities (cf. problem.is_equality_row).
    eq = (l0 == u0) & jnp.isfinite(l0) & (row_idx < mb_loc)
    is_soc_row = row_idx >= mb_loc + ml_loc

    def rho_vec_of(rb):
        rv = jnp.where(eq, settings.rho_eq_scale * rb, rb)
        if cone.m_soc and settings.rho_soc_scale != 1.0:
            rv = jnp.where(is_soc_row, settings.rho_soc_scale * rb, rv)
        return rv

    def halo_corner(rho_vec):
        """Next part's A_halo' rho A_halo lands on OUR separator block."""
        corner = xprec.einsum("pji,pj,pjk->pik", hp.A_halo, rho_vec,
                              hp.A_halo)                  # (S, b, b)
        nxt = _neighbor_next(corner.reshape(S, b * b), ax)
        is_last = (part_ids == spec.parts - 1)[:, None, None]
        return jnp.where(is_last, 0.0, nxt.reshape(S, b, b))

    def factor(rb):
        rv = rho_vec_of(rb)
        AtRA = xprec.einsum("pji,pj,pjk->pik", hp.A_loc, rv, hp.A_loc)
        Mpp = AtRA + jnp.eye(spec.npb, dtype=dtype) * sigma
        didx = jnp.arange(spec.npb)
        Mpp = Mpp.at[:, didx, didx].add(hp.P_diag)
        Mpp = Mpp.at[:, ni:, ni:].add(halo_corner(rv))
        # E couples OUR first variable block's rows to the previous
        # part's separator: A_loc' rho A_halo (banded support keeps it
        # inside the first b variable rows — asserted by partition_qp).
        E = xprec.einsum("pji,pj,pjk->pik", hp.A_loc, rv,
                         hp.A_halo)[:, :b, :]
        is_first = (part_ids == 0)[:, None, None]
        E = jnp.where(is_first, 0.0, E)
        fac = _spike_factor_sharded(Mpp, E, spec, ax)
        red = _spike_reduce_factor(fac, part_ids, spec.parts, ax)
        return {**fac, **red}, rv

    def spmv_A(x):
        """A x with the halo term (x (B, S, npb) -> (B, S, mp))."""
        loc = xprec.einsum("pij,...pj->...pi", hp.A_loc, x)
        x_last_prev = _neighbor_prev(x[..., ni:], ax)
        is_first = (part_ids == 0)[:, None]
        halo = xprec.einsum("pij,...pj->...pi", hp.A_halo, x_last_prev)
        return loc + jnp.where(is_first, 0.0, halo)

    def spmv_At(v):
        """A' v scattered back onto x (v (B, S, mp) -> (B, S, npb))."""
        loc = xprec.einsum("pji,...pj->...pi", hp.A_loc, v)
        mine = xprec.einsum("pji,...pj->...pi", hp.A_halo, v)  # (B,S,b)
        is_first = (part_ids == 0)[:, None]
        from_next = _neighbor_next(jnp.where(is_first, 0.0, mine), ax)
        is_last = (part_ids == spec.parts - 1)[:, None]
        from_next = jnp.where(is_last, 0.0, from_next)
        return loc.at[..., ni:].add(from_next)

    rho0 = jnp.asarray(settings.rho, dtype)
    fac0, _ = factor(rho0)
    k = settings.check_every
    interval_checks = max(1, settings.adaptive_rho_interval // k)
    alpha = settings.alpha
    big = jnp.full((B_loc,), jnp.inf, dtype)

    def linf_scen(v):
        return jax.lax.pmax(jnp.max(jnp.abs(v), axis=(-2, -1)), ax)

    nq = linf_scen(jnp.broadcast_to(hp.q, (1,) + hp.q.shape))
    if ml_loc:
        # L1 gradient scale in the dual-norm reference (cf. core.admm.
        # l1_grad_scale_raw): max_j max_i lam_i |A[i, j]| over the L1
        # rows — column support is local + halo; pmax over parts.
        sl = slice(mb_loc, mb_loc + ml_loc)
        lamA = jnp.maximum(
            jnp.max(hp.lam[:, :, None] * jnp.abs(hp.A_loc[:, sl, :]),
                    axis=(0, 1, 2)),
            jnp.max(hp.lam[:, :, None] * jnp.abs(hp.A_halo[:, sl, :]),
                    axis=(0, 1, 2)))
        nq = jnp.maximum(nq, jax.lax.pmax(lamA, ax))

    def body_iter(_, st):
        x, z, y, fac, rho_vec = st
        rhs = sigma * x - hp.q + spmv_At(rho_vec * z - y)
        xt = _spike_solve_sharded(fac, fac, rhs, part_ids, spec, ax)
        zt = spmv_A(xt)
        x_new = alpha * xt + (1.0 - alpha) * x
        w = alpha * zt + (1.0 - alpha) * z
        v = w + y / rho_vec
        lam_r = (hp.lam / rho_vec[..., mb_loc:mb_loc + ml_loc]
                 if ml_loc else hp.lam)
        z_new = project_cone(v, hp.l, hp.u, lam_r, cone)
        y_new = y + rho_vec * (w - z_new)
        return x_new, z_new, y_new, fac, rho_vec

    def residuals(x, z, y):
        Ax = spmv_A(x)
        Px = hp.P_diag * x
        Aty = spmv_At(y)
        r_p = linf_scen(Ax - z)
        r_d = linf_scen(Px + hp.q + Aty)
        return (r_p, r_d, linf_scen(Ax), linf_scen(z), linf_scen(Px),
                linf_scen(Aty), nq)

    def cond(c):
        it, alive = c[5], c[8]
        return alive & (it < settings.max_iter)

    def body(c):
        x, z, y, rho_bar, fac, it, iters_sc, status, _alive, rp_o, rd_o = c
        rho_vec = rho_vec_of(rho_bar)
        active = status == _UNSOLVED
        xn, zn, yn, *_ = jax.lax.fori_loop(
            0, k, body_iter, (x, z, y, fac, rho_vec))
        am = active[:, None, None]
        x = jnp.where(am, xn, x)
        z = jnp.where(am, zn, z)
        y = jnp.where(am, yn, y)
        it = it + k
        iters_sc = iters_sc + jnp.where(active, k, 0)

        r_p, r_d, nAx, nz, nPx, nAty, nq_ = residuals(x, z, y)
        eps_p = settings.eps_abs + settings.eps_rel * jnp.maximum(nAx, nz)
        eps_d = settings.eps_abs + settings.eps_rel * jnp.maximum(
            jnp.maximum(nPx, nAty), nq_)
        solved = (r_p <= eps_p) & (r_d <= eps_d)
        numerr = ~(jnp.isfinite(r_p) & jnp.isfinite(r_d))
        status = jnp.where(
            active,
            jnp.where(numerr, jnp.int32(int(Status.NUMERICAL_ERROR)),
                      jnp.where(solved, _SOLVED, _UNSOLVED)),
            status)
        r_p = jnp.where(active, r_p, rp_o)
        r_d = jnp.where(active, r_d, rd_o)

        if settings.adaptive_rho:
            adapt_now = (it // k - 1) % interval_checks == (
                interval_checks - 1)
            tiny = jnp.finfo(dtype).tiny
            still = status == _UNSOLVED
            sp = r_p / jnp.maximum(jnp.maximum(nAx, nz), tiny)
            sd = r_d / jnp.maximum(
                jnp.maximum(jnp.maximum(nPx, nAty), nq_), tiny)
            logr = jnp.where(still, jnp.log(
                jnp.sqrt(jnp.maximum(sp, tiny)
                         / jnp.maximum(sd, tiny))), 0.0)
            tot = jax.lax.psum(jnp.sum(logr), data_axis)
            cnt = jax.lax.psum(jnp.sum(still), data_axis)
            ratio = jnp.exp(tot / jnp.maximum(cnt, 1))
            new_rho = jnp.clip(rho_bar * ratio, settings.rho_min,
                               settings.rho_max)
            tol = settings.adaptive_rho_tol
            changed = (ratio > tol) | (ratio < 1.0 / tol)
            any_still = jax.lax.psum(
                jnp.sum(still.astype(jnp.int32)), data_axis) > 0
            do = adapt_now & changed & any_still
            fac = jax.lax.cond(do, lambda r: factor(r)[0],
                               lambda r: fac, new_rho)
            rho_bar = jnp.where(do, new_rho, rho_bar)

        alive = jax.lax.psum(
            jnp.sum((status == _UNSOLVED).astype(jnp.int32)),
            data_axis) > 0
        return (x, z, y, rho_bar, fac, it, iters_sc, status, alive,
                r_p, r_d)

    carry0 = (x0, z0, y0, rho0, fac0, jnp.int32(0),
              jnp.zeros((B_loc,), jnp.int32),
              jnp.full((B_loc,), _UNSOLVED), jnp.asarray(True), big, big)
    final = jax.lax.while_loop(cond, body, carry0)
    x, z, y, rho_bar, _, it, iters_sc, status, _, r_p, r_d = final
    status = jnp.where(status == _UNSOLVED,
                       jnp.int32(int(Status.MAX_ITER)), status)
    return x, z, y, status, iters_sc, r_p, r_d, rho_bar


@partial(jax.jit, static_argnames=("spec", "settings", "data_axis",
                                   "horizon_axis", "mesh"))
def _horizon_jit(hp, x0, z0, y0, spec, settings, data_axis, horizon_axis,
                 mesh):
    Bb = spec.parts
    part_ids = jnp.arange(Bb, dtype=jnp.int32)
    PH = P(horizon_axis)
    PDH = P(data_axis, horizon_axis)
    PD = P(data_axis)

    def device_fn(A_loc, A_halo, P_diag, q, l, u, lam, ids, x, z, y):
        hp_loc = HorizonParts(A_loc=A_loc, A_halo=A_halo, P_diag=P_diag,
                              q=q, l=l, u=u, lam=lam)
        return _run_horizon(hp_loc, spec, settings, ids, x, z, y,
                            data_axis, horizon_axis)

    sharded = shard_map(
        device_fn, mesh=mesh,
        in_specs=(PH, PH, PH, PH, PDH, PDH, PH, PH, PDH, PDH, PDH),
        out_specs=(PDH, PDH, PDH, PD, PD, PD, PD, P()),
        check_vma=False)
    with xprec.highest():
        return sharded(hp.A_loc, hp.A_halo, hp.P_diag, hp.q, hp.l, hp.u,
                       hp.lam, part_ids, x0, z0, y0)


def solve_horizon_sharded(hp: HorizonParts, spec: HorizonSpec, mesh: Mesh,
                          settings: Settings = Settings(),
                          data_axis: str = "data",
                          horizon_axis: str = "horizon"
                          ) -> HorizonSolution:
    """Solve the horizon-partitioned problem over a (data x horizon) mesh.

    hp.l/hp.u must be scenario-batched (B, parts, mp); B divides
    mesh[data_axis], parts divides mesh[horizon_axis]. Precision follows
    settings.precision ('single' | 'double'; the hybrid staging lives in
    the un-partitioned drivers — pass 'double' under x64 for oracle
    checks, 'single' for chip runs).
    """
    if hp.l.ndim != 3:
        raise ValueError("hp must be scenario-batched: l/u (B, parts, mp)")
    B = hp.l.shape[0]
    nd, nh = mesh.shape[data_axis], mesh.shape[horizon_axis]
    if B % nd or spec.parts % nh:
        raise ValueError(
            f"batch {B} x parts {spec.parts} not divisible by mesh "
            f"({nd} x {nh})")
    dtype = (jnp.float64 if settings.precision == "double"
             else jnp.float32)
    hp = HorizonParts(*[v.astype(dtype) for v in hp])
    x0 = jnp.zeros((B, spec.parts, spec.npb), dtype)
    z0 = jnp.zeros((B, spec.parts, spec.mp), dtype)
    y0 = jnp.zeros((B, spec.parts, spec.mp), dtype)
    PH = NamedSharding(mesh, P(horizon_axis))
    PDH = NamedSharding(mesh, P(data_axis, horizon_axis))
    hp = HorizonParts(
        A_loc=jax.device_put(hp.A_loc, PH),
        A_halo=jax.device_put(hp.A_halo, PH),
        P_diag=jax.device_put(hp.P_diag, PH),
        q=jax.device_put(hp.q, PH),
        l=jax.device_put(hp.l, PDH), u=jax.device_put(hp.u, PDH),
        lam=jax.device_put(hp.lam, PH))
    out = _horizon_jit(hp, x0, z0, y0, spec,
                       settings.replace(precision="single"), data_axis,
                       horizon_axis, mesh)
    return HorizonSolution(*out)
