"""Random dense QP generators (component M2, SURVEY.md §2.2).

Benchmark config 1 [BASELINE.json "configs"[0]]: box-constrained random
dense QP (n=100, m=200), vanilla OSQP-style ADMM.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import xprec
from ..problem import ConeSpec, QPData, make_qp


def random_box_qp(key, n: int = 100, m: int = 200, dtype=jnp.float32,
                  cond_scale: float = 1.0) -> QPData:
    """Seeded random dense box-constrained QP with a nonempty interior.

    P = R Rᵀ + 0.1 I (strictly convex), A dense Gaussian, bounds built
    around A x_feas so the problem is always feasible.
    """
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    R = jax.random.normal(k1, (n, n), dtype) / jnp.sqrt(n)
    P = cond_scale * xprec.matmul(R, R.T) + 0.1 * jnp.eye(n, dtype=dtype)
    q = jax.random.normal(k2, (n,), dtype)
    A = jax.random.normal(k3, (m, n), dtype) / jnp.sqrt(n)
    x_feas = jax.random.normal(k4, (n,), dtype)
    Ax = xprec.matmul(A, x_feas)
    spread = jnp.abs(jax.random.normal(k5, (m,), dtype)) + 0.1
    l = Ax - spread
    u = Ax + spread
    return make_qp(P, q, A, l, u, cone=ConeSpec(m_box=m))


def random_eq_ineq_qp(key, n: int = 60, m_eq: int = 10, m_in: int = 80,
                      dtype=jnp.float32) -> QPData:
    """Random QP mixing equality rows (l == u) and inequality rows."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    R = jax.random.normal(k1, (n, n), dtype) / jnp.sqrt(n)
    P = xprec.matmul(R, R.T) + 0.1 * jnp.eye(n, dtype=dtype)
    q = jax.random.normal(k2, (n,), dtype)
    A = jax.random.normal(k3, (m_eq + m_in, n), dtype) / jnp.sqrt(n)
    x_feas = jax.random.normal(k4, (n,), dtype)
    Ax = xprec.matmul(A, x_feas)
    spread = jnp.abs(jax.random.normal(k5, (m_eq + m_in,), dtype)) + 0.1
    b = Ax[:m_eq]
    l = jnp.concatenate([b, Ax[m_eq:] - spread[m_eq:]])
    u = jnp.concatenate([b, Ax[m_eq:] + spread[m_eq:]])
    return make_qp(P, q, A, l, u, cone=ConeSpec(m_box=m_eq + m_in))
