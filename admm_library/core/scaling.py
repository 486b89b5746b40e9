"""Modified Ruiz equilibration (component K4, SURVEY.md §2.2; OSQP §5).

Scales the problem data so row/column infinity-norms of [P A; Aᵀ 0]
approach 1 plus a cost normalisation c — required for the f32 phases to
reach 1e-6 residuals robustly (SURVEY.md §7 "hard parts").

Scaled problem:  P̄ = c·D P D,  q̄ = c·D q,  Ā = E A D,  l̄ = E l,  ū = E u,
L1 weights λ̄ = c·λ/E. Recovery: x = D x̄, z = E⁻¹ z̄, y = c⁻¹ E ȳ.

SOC blocks must keep their cone geometry: a second-order cone is invariant
only under UNIFORM positive scaling, so E is forced constant within each
SOC block (geometric mean of the block's Ruiz factors) — the standard
SCS-style treatment.

Implemented as a fixed `lax.fori_loop` (static trip count) so the whole
equilibration jits into the solve prologue.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..problem import ConeSpec, QPData


def _scal_flatten(s):
    return ((s.d, s.e, s.c), None)


def _scal_unflatten(cls, aux, children):
    del aux
    return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Scaling:
    """Diagonal scaling state: d (n,), e (m,), cost scalar c."""

    d: jax.Array
    e: jax.Array
    c: jax.Array

    tree_flatten = _scal_flatten
    tree_unflatten = classmethod(_scal_unflatten)

    @classmethod
    def identity(cls, n, m, dtype):
        return cls(d=jnp.ones(n, dtype), e=jnp.ones(m, dtype),
                   c=jnp.ones((), dtype))

    # --- variable recovery (scaled -> unscaled) ---
    def unscale_x(self, xb):
        return self.d * xb

    def unscale_z(self, zb):
        return zb / self.e

    def unscale_y(self, yb):
        return (self.e / self.c) * yb

    # --- warm-start injection (unscaled -> scaled) ---
    def scale_x(self, x):
        return x / self.d

    def scale_z(self, z):
        return self.e * z

    def scale_y(self, y):
        return (self.c / self.e) * y

    def astype(self, dtype):
        return Scaling(d=self.d.astype(dtype), e=self.e.astype(dtype),
                       c=self.c.astype(dtype))


def _soc_block_uniform(e_step, cone: ConeSpec):
    """Replace per-row factors inside each SOC block by their geomean."""
    if not cone.soc_dims:
        return e_step
    mb = cone.m_box + cone.m_l1
    head = e_step[:mb]
    tail = e_step[mb:]
    parts = []
    if cone.soc_uniform:
        d = cone.soc_dims[0]
        blk = tail.reshape(cone.n_soc, d)
        g = jnp.exp(jnp.mean(jnp.log(blk), axis=1, keepdims=True))
        parts.append(jnp.broadcast_to(g, blk.shape).reshape(-1))
    else:
        off = 0
        for d in cone.soc_dims:
            blk = tail[off:off + d]
            g = jnp.exp(jnp.mean(jnp.log(blk)))
            parts.append(jnp.full((d,), g, e_step.dtype))
            off += d
    return jnp.concatenate([head] + parts)


def ruiz_equilibrate_blocks(qp_blk: QPData, spec, iters: int):
    """Block-shared Ruiz equilibration for consensus problems (K4 x P2).

    Computes ONE diagonal scaling (d (nb,), e (mb,), c) jointly over the
    stacked per-block data (P (Bb, nb, nb), A (Bb, mb, nb)) — max norms
    reduce over the block axis too — and applies it to every block.
    A single shared scaling is what keeps the consensus averaging valid:
    per-block scalings would scale the two copies of a boundary state
    differently and corrupt the agreement projection (VERDICT r1 item 4).

    Two extra invariances are enforced on e:
      * SOC blocks of the LOCAL cone stay uniformly scaled (cone
        geometry, as in `ruiz_equilibrate`);
      * the left-edge and right-edge row groups get the SAME factors
        (geometric mean), so the duplicated boundary-state copies of
        neighboring blocks live on identical scales and their pairwise
        average remains the exact subspace projection.

    `spec` is a parallel.consensus.ConsensusSpec. Returns
    (scaled QPData, Scaling). iters=0 -> identity.
    """
    nb, mb = spec.nb, spec.mb
    ml, ns = spec.m_local, spec.ns
    dtype = qp_blk.dtype
    if iters <= 0:
        return qp_blk, Scaling.identity(nb, mb, dtype)

    def safe_inv_sqrt(v):
        v = jnp.where((v < 1e-10) | ~jnp.isfinite(v), 1.0, v)
        return 1.0 / jnp.sqrt(v)

    def tie_edges(e_step):
        local = _soc_block_uniform(e_step[:ml], spec.cone)
        left = e_step[ml:ml + ns]
        right = e_step[ml + ns:]
        g = jnp.sqrt(left * right)
        return jnp.concatenate([local, g, g])

    mb_box = spec.cone.m_box
    ml1 = spec.cone.m_l1

    def body(_, carry):
        P, q, A, d, e, c = carry
        # Joint column norms over (block, row); P is (Bb, nb, nb).
        nx = jnp.maximum(jnp.max(jnp.abs(P), axis=(0, 1)),
                         jnp.max(jnp.abs(A), axis=(0, 1)))
        dx = safe_inv_sqrt(nx)
        ne = jnp.max(jnp.abs(A), axis=(0, 2))
        de = tie_edges(safe_inv_sqrt(ne))
        P = dx[None, :, None] * P * dx[None, None, :]
        q = dx[None, :] * q
        A = de[None, :, None] * A * dx[None, None, :]
        d = d * dx
        e = e * de
        # Cost normalisation incl. the L1 term (see ruiz_equilibrate:
        # omitting λ̄·|Ā| lets c explode on min-fuel LPs and the scaled
        # dual magnitudes break f32).
        cost_scale = jnp.maximum(
            jnp.mean(jnp.max(jnp.abs(P), axis=(0, 1))),
            jnp.max(jnp.abs(q)))
        if ml1:
            lam_bar = c * qp_blk.lam / e[mb_box:mb_box + ml1]
            cost_scale = jnp.maximum(cost_scale, jnp.max(jnp.abs(
                lam_bar[..., :, None] * A[:, mb_box:mb_box + ml1, :])))
        gamma = 1.0 / jnp.maximum(cost_scale, 1e-10)
        P = gamma * P
        q = gamma * q
        c = c * gamma
        return P, q, A, d, e, c

    d0 = jnp.ones(nb, dtype)
    e0 = jnp.ones(mb, dtype)
    c0 = jnp.ones((), dtype)
    P, q, A, d, e, c = jax.lax.fori_loop(
        0, iters, body, (qp_blk.P, qp_blk.q, qp_blk.A, d0, e0, c0))
    scaling = Scaling(d=d, e=e, c=c)
    qps = scale_qp_blocks(qp_blk, scaling, spec)
    qps = QPData(P=P, q=q, A=A, l=qps.l, u=qps.u, lam=qps.lam,
                 cone=qp_blk.cone)
    return qps, scaling


def scale_qp_blocks(qp_blk: QPData, scaling: Scaling, spec) -> QPData:
    """Apply a block-shared Scaling to (possibly scenario-batched) block
    data: P/q/A/l/u/lam of `qp_blk` with leading block (and scenario)
    axes. Used by the consensus re-centered rounds, whose correction
    problems keep the original (P, A) and hence the original factors."""
    d, e, c = scaling.d, scaling.e, scaling.c
    mb_box = spec.cone.m_box
    ml1 = spec.cone.m_l1
    P = c * (d[:, None] * qp_blk.P * d[None, :])
    q = c * (d * qp_blk.q)
    A = e[:, None] * qp_blk.A * d[None, :]
    l = jnp.where(jnp.isfinite(qp_blk.l), e * qp_blk.l, qp_blk.l)
    u = jnp.where(jnp.isfinite(qp_blk.u), e * qp_blk.u, qp_blk.u)
    lam = (c * qp_blk.lam / e[mb_box:mb_box + ml1]
           if ml1 else qp_blk.lam)
    return QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=qp_blk.cone)


def scale_qp(qp: QPData, scaling: Scaling) -> QPData:
    """Apply a precomputed Scaling to dense problem data (q/l/u may be
    batched with a leading lane axis). Used by the re-centered
    refinement rounds, whose correction problems keep the original
    (P, A) — re-running the iterative Ruiz loop there would recompute
    the exact same (d, e) at prologue cost (measured 2.8 ms/round on
    the batch-128 headline workload)."""
    d, e, c = scaling.d, scaling.e, scaling.c
    mb, ml = qp.cone.m_box, qp.cone.m_l1
    P = c * (d[:, None] * qp.P * d[None, :])
    q = c * (d * qp.q)
    A = e[:, None] * qp.A * d[None, :]
    l = jnp.where(jnp.isfinite(qp.l), e * qp.l, qp.l)
    u = jnp.where(jnp.isfinite(qp.u), e * qp.u, qp.u)
    lam = c * qp.lam / e[mb:mb + ml] if ml else qp.lam
    return QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=qp.cone)


def ruiz_equilibrate(qp: QPData, iters: int):
    """Return (scaled QPData, Scaling). iters=0 -> identity scaling."""
    n, m = qp.n, qp.m
    dtype = qp.dtype
    if iters <= 0:
        return qp, Scaling.identity(n, m, dtype)

    def norm_cols(M):
        return jnp.max(jnp.abs(M), axis=-2)

    def norm_rows(M):
        return jnp.max(jnp.abs(M), axis=-1)

    def safe_inv_sqrt(v):
        v = jnp.where((v < 1e-10) | ~jnp.isfinite(v), 1.0, v)
        return 1.0 / jnp.sqrt(v)

    mb, ml = qp.cone.m_box, qp.cone.m_l1

    def body(_, carry):
        P, q, A, d, e, c = carry
        # Column norms of the symmetric KKT block for the x variables.
        nx = jnp.maximum(norm_cols(P), norm_cols(A))
        dx = safe_inv_sqrt(nx)
        ne = norm_rows(A)
        de = safe_inv_sqrt(ne)
        de = _soc_block_uniform(de, qp.cone)
        P = dx[:, None] * P * dx[None, :]
        q = dx * q
        A = de[:, None] * A * dx[None, :]
        d = d * dx
        e = e * de
        # Cost normalisation (OSQP Alg. 2), extended with the L1 term:
        # the scaled objective is ½x̄ᵀP̄x̄ + q̄ᵀx̄ + Σᵢ λ̄ᵢ|Āᵢx̄| with
        # λ̄ = c·λ/e, so the per-column L1 gradient scale max_i λ̄ᵢ|Āᵢⱼ|
        # belongs in the normaliser. OSQP has no penalty rows and omits
        # it; on min-fuel LPs (P ≈ 0, q = 0) the bare P/q normaliser
        # drives c to ~1/‖P‖ ≈ 1e6, scaled duals to ~1e6, and the f32
        # dual-update rounding (~2⁻²⁴·1e6 ≈ 0.06 absolute) becomes a
        # primal-residual FLOOR — the measured 50k-iteration stall of
        # the CW benchmark at r_p ≈ 5e-2.
        cost_scale = jnp.maximum(jnp.mean(norm_cols(P)), jnp.max(jnp.abs(q)))
        if ml:
            lam_bar = c * qp.lam / e[mb:mb + ml]
            cost_scale = jnp.maximum(cost_scale, jnp.max(
                norm_cols(lam_bar[:, None] * A[mb:mb + ml, :])))
        gamma = 1.0 / jnp.maximum(cost_scale, 1e-10)
        P = gamma * P
        q = gamma * q
        c = c * gamma
        return P, q, A, d, e, c

    d0 = jnp.ones(n, dtype)
    e0 = jnp.ones(m, dtype)
    c0 = jnp.ones((), dtype)
    P, q, A, d, e, c = jax.lax.fori_loop(
        0, iters, body, (qp.P, qp.q, qp.A, d0, e0, c0))

    scaling = Scaling(d=d, e=e, c=c)
    l = jnp.where(jnp.isfinite(qp.l), e * qp.l, qp.l)
    u = jnp.where(jnp.isfinite(qp.u), e * qp.u, qp.u)
    mb, ml = qp.cone.m_box, qp.cone.m_l1
    lam = c * qp.lam / e[mb:mb + ml] if ml else qp.lam
    qps = QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=qp.cone)
    return qps, scaling
