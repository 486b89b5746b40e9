"""Test oracle (component S3, SURVEY.md §2.2 / §4.2).

The pinned reference publishes no solver outputs to compare against
(SURVEY.md §0), and the sandbox has no network for external solvers, so
correctness is validated against problems CONSTRUCTED to have known KKT
solutions: pick x*, choose an active set with dual signs, then derive q so
that (x*, y*) satisfies the KKT conditions exactly. Any solver output can
then be checked against (x*, y*) and against the raw KKT residuals.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .. import xprec
from ..problem import ConeSpec, QPData, make_qp


def qp_known_solution(seed: int, n: int = 50, m: int = 100,
                      n_active: int = 20, dtype=jnp.float64):
    """Box QP with a constructed optimal primal-dual pair.

    Returns (QPData, x_star, y_star). Construction (numpy, host-side):
      - A ~ N(0,1)/sqrt(n), P = RRᵀ + I (SPD)
      - x* ~ N(0,1); z* = A x*
      - rows [0, n_active): active at the upper bound, y*_i > 0, u_i = z*_i
        (and l_i well below); odd ones instead active at the lower bound
        with y*_i < 0.
      - remaining rows: strict slack, y*_i = 0.
      - q = -P x* - Aᵀ y*   =>  stationarity holds exactly.
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = R @ R.T + np.eye(n)
    x = rng.standard_normal(n)
    z = A @ x
    y = np.zeros(m)
    l = z - (1.0 + rng.random(m))
    u = z + (1.0 + rng.random(m))
    for i in range(n_active):
        mag = 0.1 + rng.random()
        if i % 2 == 0:
            u[i] = z[i]
            y[i] = mag
        else:
            l[i] = z[i]
            y[i] = -mag
    q = -P @ x - A.T @ y
    qp = make_qp(
        jnp.asarray(P, dtype), jnp.asarray(q, dtype), jnp.asarray(A, dtype),
        jnp.asarray(l, dtype), jnp.asarray(u, dtype),
        cone=ConeSpec(m_box=m))
    return qp, jnp.asarray(x, dtype), jnp.asarray(y, dtype)


def kkt_residuals(qp: QPData, x, z, y):
    """Raw unscaled KKT residual inf-norms: (primal, dual, complementarity).

    primal: ||Ax - z||_inf plus box violation of z
    dual:   ||Px + q + Aᵀy||_inf
    comp:   box complementarity  max_i min(|y_i| dist-to-bound terms)
    """
    Ax = xprec.einsum("...ij,...j->...i", qp.A, x)
    r_p = jnp.max(jnp.abs(Ax - z), axis=-1)
    viol = jnp.maximum(qp.l - z, 0.0) + jnp.maximum(z - qp.u, 0.0)
    viol = jnp.where(jnp.isfinite(viol), viol, 0.0)
    r_p = jnp.maximum(r_p, jnp.max(viol, axis=-1))
    r_d = jnp.max(jnp.abs(
        xprec.einsum("...ij,...j->...i", qp.P, x) + qp.q
        + xprec.einsum("...ji,...j->...i", qp.A, y)), axis=-1)
    yp = jnp.maximum(y, 0.0)
    ym = jnp.minimum(y, 0.0)
    du = jnp.where(jnp.isfinite(qp.u), qp.u - z, 0.0)
    dl = jnp.where(jnp.isfinite(qp.l), z - qp.l, 0.0)
    comp = jnp.max(jnp.abs(yp * du) + jnp.abs(ym * dl), axis=-1)
    return r_p, r_d, comp


def solve_box_qp_activeset(qp: QPData, max_iter: int = 200):
    """Tiny dense primal active-set refiner (host-side numpy, f64).

    Independent ground-truth for small box QPs: start from the clipped
    unconstrained minimiser, iteratively solve the equality-constrained
    KKT system on the current active set until primal/dual feasible.
    Returns (x, y). For test use only (small n, m).
    """
    P = np.asarray(qp.P, np.float64)
    q = np.asarray(qp.q, np.float64)
    A = np.asarray(qp.A, np.float64)
    l = np.asarray(qp.l, np.float64)
    u = np.asarray(qp.u, np.float64)
    m, n = A.shape
    x = np.linalg.solve(P, -q)
    active_u = np.zeros(m, bool)
    active_l = np.zeros(m, bool)
    for _ in range(max_iter):
        z = A @ x
        viol_u = z > u + 1e-10
        viol_l = z < l - 1e-10
        active_u |= viol_u
        active_l |= viol_l
        active_l &= ~active_u
        act = active_u | active_l
        k = int(act.sum())
        if k == 0:
            x = np.linalg.solve(P, -q)
            y = np.zeros(m)
        else:
            Aa = A[act]
            b = np.where(active_u, u, l)[act]
            K = np.block([[P, Aa.T], [Aa, np.zeros((k, k))]])
            rhs = np.concatenate([-q, b])
            sol = np.linalg.lstsq(K, rhs, rcond=None)[0]
            x = sol[:n]
            ya = sol[n:]
            y = np.zeros(m)
            y[act] = ya
            # Drop constraints with wrong-sign multipliers.
            drop_u = active_u & (y < -1e-10)
            drop_l = active_l & (y > 1e-10)
            if drop_u.any() or drop_l.any():
                active_u &= ~drop_u
                active_l &= ~drop_l
                continue
        z = A @ x
        if (z <= u + 1e-8).all() and (z >= l - 1e-8).all():
            return jnp.asarray(x), jnp.asarray(y)
    return jnp.asarray(x), jnp.asarray(y)
