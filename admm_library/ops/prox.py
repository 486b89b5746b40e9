"""Proximal operators / cone projections (components X1-X4, SURVEY.md §2.2).

All operators are elementwise/blockwise vectorised jnp code: they fuse into
the surrounding ADMM iteration under XLA. The product
cone layout is STATIC ([box | L1 | SOC], see problem.ConeSpec) so the
composite projection is a fixed concatenation of slices — no dynamic shapes
inside `jit`.

Reference parity: the pinned reference has no code (SURVEY.md §0); these
realise BASELINE.json "north_star" — "box, L1 soft-threshold for min-fuel,
second-order-cone for thrust magnitude".
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..problem import ConeSpec


def project_box(v, l, u):
    """X1: Euclidean projection onto [l, u] (entries may be +-inf)."""
    return jnp.clip(v, l, u)


def soft_threshold(v, thresh):
    """X2: prox of thresh*|.|_1 : sign(v) * max(|v| - thresh, 0)."""
    return jnp.sign(v) * jnp.maximum(jnp.abs(v) - thresh, 0.0)


def soft_threshold_box(v, thresh, l, u):
    """Prox of thresh*|z| + indicator[l, u] (1-D, elementwise).

    For a 1-D convex objective the constrained prox is the clip of the
    unconstrained prox, so this composite is EXACT: bounded L1 rows
    (e.g. per-axis impulse limits with min-fuel cost) need only one row
    instead of an L1 row + duplicate box row.
    """
    return jnp.clip(soft_threshold(v, thresh), l, u)


def project_soc_block(t, u, axis=-1):
    """X3: projection onto one second-order cone {(t,u): ||u||_2 <= t}.

    t: (...,) scalar head, u: (..., d-1) vector tail. Three closed-form
    branches, implemented branch-free with jnp.where (jit/vmap friendly):
      ||u|| <= t   -> identity
      ||u|| <= -t  -> origin
      else         -> ((t+||u||)/2) * (1, u/||u||)
    """
    nu = jnp.linalg.norm(u, axis=axis)
    # Safe inverse norm (the nu==0 branch never uses it).
    safe = jnp.where(nu > 0, nu, 1.0)
    c = 0.5 * (t + nu)
    in_cone = nu <= t
    in_polar = nu <= -t
    t_out = jnp.where(in_cone, t, jnp.where(in_polar, 0.0, c))
    scale = jnp.where(in_cone, 1.0,
                      jnp.where(in_polar, 0.0, c / safe))
    u_out = u * jnp.expand_dims(scale, axis)
    return t_out, u_out


def project_soc_rows(v, soc_dims, axis=-1):
    """Project rows of v laid out as concatenated SOC blocks.

    v: (..., sum(soc_dims)). Each block is (t, u_1..u_{d-1}). Uniform block
    dims take a reshape fast path (single vectorised projection across all
    blocks — the layout the builders emit); mixed dims fall
    back to a static Python loop over blocks (still jit-compatible: the
    loop is unrolled at trace time over static offsets).
    """
    if not soc_dims:
        return v
    dims = tuple(soc_dims)
    if len(set(dims)) == 1:
        d = dims[0]
        k = len(dims)
        blocks = v.reshape(v.shape[:-1] + (k, d))
        t, u = blocks[..., 0], blocks[..., 1:]
        t2, u2 = project_soc_block(t, u)
        out = jnp.concatenate([t2[..., None], u2], axis=-1)
        return out.reshape(v.shape)
    parts = []
    off = 0
    for d in dims:
        blk = v[..., off:off + d]
        t2, u2 = project_soc_block(blk[..., 0], blk[..., 1:])
        parts.append(jnp.concatenate([t2[..., None], u2], axis=-1))
        off += d
    return jnp.concatenate(parts, axis=-1)


def project_cone(v, l, u, lam_over_rho, cone: ConeSpec, offset=None):
    """X4: composite projection / prox onto the static product cone.

    v: (..., m) point to project; l, u: (..., m) bounds (used on box rows);
    lam_over_rho: (..., m_l1) soft-threshold levels for the L1 rows.
    Returns z = prox_g(v) with g = indicator(box) + lam|.|_1 + indicator(SOC).

    offset (optional, (..., m)): evaluates the SHIFTED prox on the L1
    and SOC segments — prox of g(. + a) is prox_g(v + a) - a — used by
    re-centered refinement, where those cones do not shift affinely the
    way box bounds do. Box rows ignore the offset (callers shift l/u
    exactly instead, which keeps box arithmetic at the correction
    scale); L1/SOC rows must then carry their ORIGINAL l/u/lam.
    """
    mb, ml = cone.m_box, cone.m_l1
    # The shifted segments compute in the OFFSET's dtype (callers pass
    # f64): v + a rounds at the total scale ||a||, which in f32 would
    # floor the correction residual at ~1e-7 * scale. The prox is
    # elementwise/blockwise work — a tiny fraction of iteration
    # cost even in f64 — so upcasting buys correction-scale
    # accuracy for free. Results cast back to v's dtype.
    hi = offset.dtype if offset is not None else None
    parts = []
    if mb:
        parts.append(project_box(v[..., :mb], l[..., :mb], u[..., :mb]))
    if ml:
        vl = v[..., mb:mb + ml]
        ll, lu = l[..., mb:mb + ml], u[..., mb:mb + ml]
        if offset is not None:
            a = offset[..., mb:mb + ml]
            out = soft_threshold_box(
                vl.astype(hi) + a, lam_over_rho.astype(hi),
                ll.astype(hi), lu.astype(hi)) - a
            parts.append(out.astype(v.dtype))
        else:
            parts.append(soft_threshold_box(vl, lam_over_rho, ll, lu))
    if cone.m_soc:
        vs = v[..., mb + ml:]
        if offset is not None:
            a = offset[..., mb + ml:]
            out = project_soc_rows(vs.astype(hi) + a, cone.soc_dims) - a
            parts.append(out.astype(v.dtype))
        else:
            parts.append(project_soc_rows(vs, cone.soc_dims))
    if len(parts) == 1:
        return parts[0]
    return jnp.concatenate(parts, axis=-1)
