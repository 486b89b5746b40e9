"""Plain reference for a solve: the KKT conditions of the problem, in f64.

The solver answers a convex problem

    minimize 1/2 x'Px + q'x + g(z)   subject to  Ax = z,

where g is the indicator of box rows [l, u], an L1 penalty lam|z| on
L1 rows (with optional bounds), and the indicator of a second-order
cone on each SOC block. A returned triple (x, z, y) is an answer to it
to the tolerance (eps_abs, eps_rel) when, with every norm the maximum
norm,

    primal   ||Ax - z||                      <= eps_p
    dual     ||Px + q + A'y||                <= eps_d
    cone     ||z - prox_g(z + y)||           <= eps_p

eps_p = eps_abs + eps_rel max(||Ax||, ||z||) and eps_d = eps_abs +
eps_rel max(||Px||, ||A'y||, ||q||, max|lam A_l1|) are the stopping
scales of OSQP (arXiv:1711.08013, section 3.4). The third line holds
exactly when z lies in the domain of g and y is a subgradient of g at
z (z = prox_g(z + y) <=> y in dg(z)), which covers feasibility, the
signs of the multipliers and complementarity. Without it the dual line
says nothing: A has full column rank, so some y meets it for any x.

`kkt_ratio` is the largest of the three left sides over its scale; an
answer meets the tolerance when it is at most 1. Everything here is
numpy in f64 and uses only the problem data the benchmark made.
"""
from __future__ import annotations

import numpy as np


def _linf(v):
    return np.max(np.abs(v), axis=-1)


def _prox_g(v, prob: dict, l, u):
    """prox of g with unit step at v (K, m)."""
    mb, ml = prob["m_box"], prob["m_l1"]
    parts = [np.clip(v[:, :mb], l[:, :mb], u[:, :mb])]
    if ml:
        w = v[:, mb:mb + ml]
        lam = prob["lam"]
        soft = np.sign(w) * np.maximum(np.abs(w) - lam, 0.0)
        parts.append(np.clip(soft, l[:, mb:mb + ml], u[:, mb:mb + ml]))
    off = mb + ml
    for d in prob["soc_dims"]:
        parts.append(_project_soc(v[:, off:off + d]))
        off += d
    return np.concatenate(parts, axis=-1)


def _project_soc(blk):
    """Projection of (K, d) rows (t, w) onto {||w|| <= t}."""
    t, w = blk[:, 0], blk[:, 1:]
    nw = np.linalg.norm(w, axis=-1)
    a = 0.5 * (t + nw)
    scale = a / np.where(nw > 0, nw, 1.0)
    proj = np.concatenate([a[:, None], scale[:, None] * w], axis=-1)
    proj = np.where((nw <= t)[:, None], blk, proj)
    return np.where((nw <= -t)[:, None], 0.0, proj)


def kkt_ratio(prob: dict, l, u, x, z, y, eps_abs: float,
              eps_rel: float) -> dict:
    """Per answer: the primal, dual and cone residuals and their worst
    ratio to the tolerance. l, u: (K, m); x: (K, n); z, y: (K, m)."""
    f64 = np.float64
    P, q, A = (np.asarray(prob[k], f64) for k in ("P", "q", "A"))
    l, u, x, z, y = (np.atleast_2d(np.asarray(v, f64))
                     for v in (l, u, x, z, y))
    Ax = x @ A.T
    Px = x @ P.T
    Aty = y @ A
    r_p = _linf(Ax - z)
    r_d = _linf(Px + q + Aty)
    r_c = _linf(z - _prox_g(z + y, prob, l, u))
    mb, ml = prob["m_box"], prob["m_l1"]
    nlam = 0.0
    if ml:
        nlam = float(np.max(np.asarray(prob["lam"], f64)[:, None]
                            * np.abs(A[mb:mb + ml])))
    eps_p = eps_abs + eps_rel * np.maximum(_linf(Ax), _linf(z))
    eps_d = eps_abs + eps_rel * np.maximum(
        np.maximum(_linf(Px), _linf(Aty)), max(float(_linf(q)), nlam))
    ratio = np.maximum(np.maximum(r_p / eps_p, r_d / eps_d), r_c / eps_p)
    ratio = np.where(np.isfinite(ratio), ratio, np.inf)
    return {"r_prim": r_p, "r_dual": r_d, "r_cone": r_c, "kkt_ratio": ratio}
