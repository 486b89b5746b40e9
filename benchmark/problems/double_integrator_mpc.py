"""Double-integrator min-energy rendezvous MPC, built in numpy f64.

A copy of the problem that the solver's models/double_integrator.py
makes (horizon N, `dim` spatial axes, step dt), kept with the benchmark
so that the problems a change is judged on cannot move with the change.

Variables are ordered by time step, x = [u_0, s_1, u_1, s_2, ...,
u_{N-1}, s_N] with s_k = (r_k, v_k). Rows, all of them box rows:
dynamics equalities s_{k+1} - F s_k - G u_k = (F s_0 for k = 0, else 0),
the terminal equality s_N = s_target, and the control bounds
|u_k| <= u_max. Objective: 1/2 sum ||u_k||^2 plus `state_reg` on the
states. The initial state enters only the first 2*dim bounds, so a
dispersion of s0 shares (P, q, A).
"""
from __future__ import annotations

import numpy as np


def _dynamics(dim: int, dt: float):
    F = np.eye(2 * dim)
    F[:dim, dim:] = dt * np.eye(dim)
    G = np.zeros((2 * dim, dim))
    G[:dim] = 0.5 * dt * dt * np.eye(dim)
    G[dim:] = dt * np.eye(dim)
    return F, G


def build(cfg: dict) -> dict:
    """(P, q, A, l, u) of the configuration at its nominal s0, in f64."""
    N, dim, dt = int(cfg["N"]), int(cfg["dim"]), float(cfg["dt"])
    ns, nu = 2 * dim, dim
    b = nu + ns
    n = N * b
    F, G = _dynamics(dim, dt)
    s0 = np.asarray(cfg["s0_nominal"], np.float64)
    s_target = np.asarray(cfg["s_target"], np.float64)

    Pd = np.full(n, float(cfg["state_reg"]))
    for k in range(N):
        Pd[k * b:k * b + nu] = 1.0
    m_dyn, m_term, m_u = N * ns, ns, N * nu
    m = m_dyn + m_term + m_u
    A = np.zeros((m, n))
    l = np.zeros(m)
    u = np.zeros(m)
    for k in range(N):
        r, s_k = k * ns, k * b + nu
        A[r:r + ns, s_k:s_k + ns] = np.eye(ns)
        A[r:r + ns, k * b:k * b + nu] = -G
        if k > 0:
            A[r:r + ns, s_k - b:s_k - b + ns] = -F
    l[:ns] = u[:ns] = F @ s0
    r = m_dyn
    A[r:r + ns, (N - 1) * b + nu:N * b] = np.eye(ns)
    l[r:r + ns] = u[r:r + ns] = s_target
    r = m_dyn + m_term
    for k in range(N):
        A[r + k * nu:r + (k + 1) * nu, k * b:k * b + nu] = np.eye(nu)
    l[r:] = -float(cfg["u_max"])
    u[r:] = float(cfg["u_max"])
    return {"P": np.diag(Pd), "q": np.zeros(n), "A": A, "l": l, "u": u,
            "lam": np.zeros(0), "m_box": m, "m_l1": 0, "soc_dims": ()}


def bounds(cfg: dict, prob: dict, s0: np.ndarray):
    """(l, u) of shape (K, m) for K initial states s0 (K, 2*dim)."""
    dim = int(cfg["dim"])
    F, _ = _dynamics(dim, float(cfg["dt"]))
    rhs = np.asarray(s0, np.float64) @ F.T
    K = rhs.shape[0]
    l = np.repeat(prob["l"][None], K, axis=0)
    u = np.repeat(prob["u"][None], K, axis=0)
    l[:, :2 * dim] = rhs
    u[:, :2 * dim] = rhs
    return l, u
