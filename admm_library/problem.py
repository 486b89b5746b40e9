"""Canonical problem data (component M1 of SURVEY.md §2.2).

The framework solves problems of the form

    minimize    (1/2) xᵀ P x + qᵀ x  +  Σ_j λ_j |(A x)_j|          (L1 rows)
    subject to  l_i ≤ (A x)_i ≤ u_i                                 (box rows)
                (A x)_blk ∈ SOC(d)                                  (SOC rows)

i.e. an OSQP-style QP (`min ½xᵀPx+qᵀx s.t. l≤Ax≤u`) extended with two extra
row-block types on the splitting variable z = Ax: L1-penalised rows (min-fuel
impulsive ΔV costs, prox = soft-threshold) and second-order-cone blocks
(thrust-magnitude constraints, prox = SOC projection).

Row layout of A is STATIC and ordered  [box | L1 | SOC blocks]  so that the
z-update is a fixed composition of vectorised projections under `jit`
(no dynamic slicing under XLA).

Reference parity: the pinned reference (/root/reference, README.md:1-2) ships
no code; this canonical form realises BASELINE.json's "north_star" spec
(box, L1 soft-threshold, second-order cone on z = Ax).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from . import xprec


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Static description of the row blocks of A (not traced by JAX).

    Rows of A are ordered: ``m_box`` box rows first (equalities are box rows
    with l == u), then ``m_l1`` L1 rows, then one block of ``soc_dim`` rows
    per entry of ``soc_dims``. All fields are Python ints/tuples so a
    ConeSpec is hashable and usable as a `jit` static argument.
    """

    m_box: int = 0
    m_l1: int = 0
    soc_dims: Tuple[int, ...] = ()

    @property
    def m_soc(self) -> int:
        return sum(self.soc_dims)

    @property
    def m(self) -> int:
        return self.m_box + self.m_l1 + self.m_soc

    @property
    def n_soc(self) -> int:
        return len(self.soc_dims)

    @property
    def soc_uniform(self) -> bool:
        """True when every SOC block has the same dimension (fast path)."""
        return len(set(self.soc_dims)) <= 1

    def validate(self, m: int) -> None:
        if self.m != m:
            raise ValueError(
                f"ConeSpec covers {self.m} rows but A has {m} rows")


def _qp_flatten(qp):
    children = (qp.P, qp.q, qp.A, qp.l, qp.u, qp.lam)
    aux = qp.cone
    return children, aux


def _qp_unflatten(cls, aux, children):
    P, q, A, l, u, lam = children
    return cls(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=aux)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class QPData:
    """Canonical problem data pytree (arrays traced, `cone` static).

    Shapes: P (n,n) symmetric PSD, q (n,), A (m,n), l/u (m,), lam (m_l1,).
    May carry leading batch dimensions on every array (vmap-compatible).
    For box rows, l/u entries may be ±inf; for L1 and SOC rows l/u are
    ignored (conventionally ±inf). `lam` holds the per-row L1 weights.
    """

    P: jax.Array
    q: jax.Array
    A: jax.Array
    l: jax.Array
    u: jax.Array
    lam: jax.Array
    cone: ConeSpec

    tree_flatten = _qp_flatten
    tree_unflatten = classmethod(_qp_unflatten)

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def dtype(self):
        return self.P.dtype

    def astype(self, dtype) -> "QPData":
        return QPData(
            P=self.P.astype(dtype), q=self.q.astype(dtype),
            A=self.A.astype(dtype), l=self.l.astype(dtype),
            u=self.u.astype(dtype), lam=self.lam.astype(dtype),
            cone=self.cone)


def make_qp(P, q, A, l, u, cone: ConeSpec | None = None, lam=None) -> QPData:
    """Build a QPData, defaulting to an all-box cone layout.

    Symmetrises P. Infers dtype from P. `lam` defaults to zeros(m_l1).
    """
    P = jnp.asarray(P)
    dtype = P.dtype
    q = jnp.asarray(q, dtype)
    A = jnp.asarray(A, dtype)
    l = jnp.asarray(l, dtype)
    u = jnp.asarray(u, dtype)
    m = A.shape[-2]
    if cone is None:
        cone = ConeSpec(m_box=m)
    cone.validate(m)
    if lam is None:
        lam = jnp.zeros(A.shape[:-2] + (cone.m_l1,), dtype)
    else:
        lam = jnp.asarray(lam, dtype)
    P = 0.5 * (P + jnp.swapaxes(P, -1, -2))
    return QPData(P=P, q=q, A=A, l=l, u=u, lam=lam, cone=cone)


def is_equality_row(qp: QPData) -> jax.Array:
    """Boolean mask of rows treated as equalities (box rows with l == u).

    Used for the per-row rho scaling (OSQP §5.2: rho_i is boosted on
    equality rows).
    """
    eq = (qp.l == qp.u) & jnp.isfinite(qp.l)
    # Only box rows can be equalities; L1/SOC rows never are.
    idx = jnp.arange(qp.m)
    return eq & (idx < qp.cone.m_box)


def objective(qp: QPData, x: jax.Array, z: jax.Array | None = None):
    """Objective value ½xᵀPx + qᵀx + Σ λ|z_l1| (uses z for the L1 term)."""
    quad = 0.5 * xprec.einsum("...i,...ij,...j->...", x, qp.P, x)
    lin = xprec.einsum("...i,...i->...", qp.q, x)
    l1 = 0.0
    if qp.cone.m_l1 > 0:
        w = z if z is not None else xprec.einsum("...ij,...j->...i", qp.A, x)
        sl = w[..., qp.cone.m_box:qp.cone.m_box + qp.cone.m_l1]
        l1 = jnp.sum(qp.lam * jnp.abs(sl), axis=-1)
    return quad + lin + l1
