"""Low-thrust rendezvous SOCP with thrust-magnitude cones, numpy f64.

A copy of the problem that the solver's models/low_thrust.py makes,
kept with the benchmark so that the problems a change is judged on
cannot move with the change. Lossless convexification (Acikmese &
Ploen, 2007):

    minimize    sum_k Gamma_k dt          (fuel proxy, plus tiny
    subject to  s_{k+1} = F s_k + G u_k    regularisation)
                ||u_k||_2 <= Gamma_k       (SOC(4) per node)
                0 <= Gamma_k <= u_max
                s_N = s_target

with Hill-Clohessy-Wiltshire dynamics, zero-order-hold control, in
canonical units (length unit = ||r0|| of the nominal initial state,
time unit = 1 / mean motion). Variables are ordered by node, block
[u_k (3), Gamma_k, s_{k+1} (6)]. Rows: [box rows | SOC blocks]. A
dispersed initial state enters only the first 6 bounds and keeps the
nominal canonical units, so a dispersion shares (P, q, A).
"""
from __future__ import annotations

import numpy as np


def _hcw_stm(n: float, t: float) -> np.ndarray:
    """Closed-form HCW state-transition matrix (x radial, y along-track,
    z cross-track)."""
    s, c = np.sin(n * t), np.cos(n * t)
    P = np.zeros((6, 6))
    P[0, 0] = 4.0 - 3.0 * c
    P[0, 3] = s / n
    P[0, 4] = 2.0 * (1.0 - c) / n
    P[1, 0] = 6.0 * (s - n * t)
    P[1, 1] = 1.0
    P[1, 3] = 2.0 * (c - 1.0) / n
    P[1, 4] = (4.0 * s - 3.0 * n * t) / n
    P[2, 2] = c
    P[2, 5] = s / n
    P[3, 0] = 3.0 * n * s
    P[3, 3] = c
    P[3, 4] = 2.0 * s
    P[4, 0] = 6.0 * n * (c - 1.0)
    P[4, 3] = -2.0 * s
    P[4, 4] = 4.0 * c - 3.0
    P[5, 2] = -n * s
    P[5, 5] = c
    return P


def _zoh_control(n: float, dt: float, order: int = 24) -> np.ndarray:
    """G = int_0^dt Phi(dt - tau) B dtau by Gauss-Legendre quadrature
    (exact to rounding for the trigonometric HCW integrand)."""
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)
    nodes, weights = np.polynomial.legendre.leggauss(order)
    G = np.zeros((6, 3))
    for tau, w in zip(0.5 * dt * (nodes + 1.0), weights):
        G += 0.5 * dt * w * (_hcw_stm(n, dt - tau) @ B)
    return G


def _units(cfg: dict):
    """(length unit, time unit) from the nominal initial state."""
    s0 = np.asarray(cfg["s0_nominal"], np.float64)
    return max(float(np.linalg.norm(s0[:3])), 1.0), 1.0 / float(
        cfg["n_mean"])


def _to_nd(s, lu: float, tu: float):
    s = np.asarray(s, np.float64)
    return np.concatenate([s[..., :3] / lu, s[..., 3:] * (tu / lu)], -1)


def build(cfg: dict) -> dict:
    """(P, q, A, l, u) of the configuration at its nominal s0, in f64."""
    N = int(cfg["N"])
    lu, tu = _units(cfg)
    s0 = _to_nd(cfg["s0_nominal"], lu, tu)
    s_t = _to_nd(cfg["s_target"], lu, tu)
    dt = float(cfg["dt"]) / tu
    u_max = float(cfg["u_max"]) * tu ** 2 / lu
    F, G = _hcw_stm(1.0, dt), _zoh_control(1.0, dt)
    b = 10
    n = N * b

    Pd = np.full(n, float(cfg["state_reg"]))
    q = np.zeros(n)
    for k in range(N):
        Pd[k * b:k * b + 4] = float(cfg["ctrl_reg"])
        q[k * b + 3] = dt
    m_dyn, m_term, m_g, m_soc = N * 6, 6, N, N * 4
    m = m_dyn + m_term + m_g + m_soc
    A = np.zeros((m, n))
    l = np.zeros(m)
    u = np.zeros(m)
    for k in range(N):
        r, s_k = k * 6, k * b + 4
        A[r:r + 6, s_k:s_k + 6] = np.eye(6)
        A[r:r + 6, k * b:k * b + 3] = -G
        if k > 0:
            A[r:r + 6, s_k - b:s_k - b + 6] = -F
    l[:6] = u[:6] = F @ s0
    r = m_dyn
    A[r:r + 6, (N - 1) * b + 4:N * b] = np.eye(6)
    l[r:r + 6] = u[r:r + 6] = s_t
    r = m_dyn + m_term
    for k in range(N):
        A[r + k, k * b + 3] = 1.0
    u[r:r + m_g] = u_max
    r = m_dyn + m_term + m_g
    for k in range(N):
        A[r + 4 * k, k * b + 3] = 1.0
        A[r + 4 * k + 1:r + 4 * k + 4, k * b:k * b + 3] = np.eye(3)
    l[r:] = -np.inf
    u[r:] = np.inf
    return {"P": np.diag(Pd), "q": q, "A": A, "l": l, "u": u,
            "lam": np.zeros(0), "m_box": m_dyn + m_term + m_g, "m_l1": 0,
            "soc_dims": (4,) * N}


def bounds(cfg: dict, prob: dict, s0: np.ndarray):
    """(l, u) of shape (K, m) for K dispersed SI initial states (K, 6),
    in the nominal canonical units."""
    lu, tu = _units(cfg)
    F = _hcw_stm(1.0, float(cfg["dt"]) / tu)
    rhs = _to_nd(s0, lu, tu) @ F.T
    K = rhs.shape[0]
    l = np.repeat(prob["l"][None], K, axis=0)
    u = np.repeat(prob["u"][None], K, axis=0)
    l[:, :6] = rhs
    u[:, :6] = rhs
    return l, u
