"""Double-integrator min-energy rendezvous MPC builder (M3, SURVEY.md §2.2).

Benchmark config 2 [BASELINE.json "configs"[1]]: horizon N=50, banded KKT.

Discrete double integrator in `dim` spatial dimensions with step dt:

    r_{k+1} = r_k + v_k dt + a_k dt²/2
    v_{k+1} = v_k + a_k dt

Decision variables are ordered BY TIME STEP so the condensed ADMM matrix
M = P + σI + Aᵀρ A is block-tridiagonal with block size b = 3*dim
(controls + next state per step):

    x = [u_0, s_1, u_1, s_2, ..., u_{N-1}, s_N]      s_k = (r_k, v_k)

Constraint rows of A (all box rows):
    dynamics equalities  s_{k+1} - F s_k - G u_k = 0   (s_0 enters the rhs)
    terminal equality    s_N = s_target               (rendezvous)
    control bounds       |u_k| <= u_max

Objective: min-energy  ½ Σ ||u_k||²  (+ tiny state regularisation so P is
strictly convex on the whole variable block).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .. import xprec
from ..problem import ConeSpec, QPData, make_qp


@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """Static description of the MPC instance (shapes + matrices)."""

    N: int
    dim: int
    dt: float

    @property
    def ns(self) -> int:
        return 2 * self.dim

    @property
    def nu(self) -> int:
        return self.dim

    @property
    def block(self) -> int:
        return self.nu + self.ns

    @property
    def n(self) -> int:
        return self.N * self.block


def dynamics_matrices(spec: MPCSpec):
    """F (ns,ns), G (ns,nu) of the exact discrete double integrator."""
    d, dt = spec.dim, spec.dt
    F = np.eye(2 * d)
    F[:d, d:] = dt * np.eye(d)
    G = np.zeros((2 * d, d))
    G[:d] = 0.5 * dt * dt * np.eye(d)
    G[d:] = dt * np.eye(d)
    return F, G


def build_mpc_qp(s0, s_target, N: int = 50, dim: int = 3, dt: float = 1.0,
                 u_max: float = 1.0, state_reg: float = 1e-8,
                 dtype=jnp.float32):
    """Build the banded min-energy rendezvous QP.

    Returns (QPData, MPCSpec). Recommended settings: band_block=spec.block,
    backend='banded' (resolve_backend does this when band_block is set).

    s0, s_target: (2*dim,) initial and target states. s0 only enters the
    constraint BOUNDS (l = u = rhs on the first dynamics rows), so a
    Monte-Carlo dispersion of s0 keeps P and A shared across the batch —
    the shared-matrix fast path (SURVEY.md §3.2).
    """
    spec = MPCSpec(N=N, dim=dim, dt=dt)
    ns, nu, b = spec.ns, spec.nu, spec.block
    n = spec.n
    F, G = dynamics_matrices(spec)
    s0 = np.asarray(s0, np.float64)
    s_target = np.asarray(s_target, np.float64)

    # Variable index helpers inside the time-ordered layout.
    def u_idx(k):
        return k * b

    def s_idx(k):          # s_{k+1} lives in block k
        return k * b + nu

    # --- objective ---
    Pd = np.full(n, state_reg)
    for k in range(N):
        Pd[u_idx(k):u_idx(k) + nu] = 1.0
    P = np.diag(Pd)
    q = np.zeros(n)

    # --- constraints ---
    m_dyn = N * ns
    m_term = ns
    m_u = N * nu
    m = m_dyn + m_term + m_u
    A = np.zeros((m, n))
    l = np.zeros(m)
    u = np.zeros(m)

    # dynamics rows: s_{k+1} - F s_k - G u_k = (F s_0 if k == 0 else 0)
    for k in range(N):
        r = k * ns
        A[r:r + ns, s_idx(k):s_idx(k) + ns] = np.eye(ns)
        A[r:r + ns, u_idx(k):u_idx(k) + nu] = -G
        if k > 0:
            A[r:r + ns, s_idx(k - 1):s_idx(k - 1) + ns] = -F
            rhs = np.zeros(ns)
        else:
            rhs = F @ s0
        l[r:r + ns] = rhs
        u[r:r + ns] = rhs

    # terminal equality s_N = s_target
    r = m_dyn
    A[r:r + ns, s_idx(N - 1):s_idx(N - 1) + ns] = np.eye(ns)
    l[r:r + ns] = s_target
    u[r:r + ns] = s_target

    # control bounds
    r = m_dyn + m_term
    for k in range(N):
        A[r + k * nu:r + (k + 1) * nu, u_idx(k):u_idx(k) + nu] = np.eye(nu)
    l[r:] = -u_max
    u[r:] = u_max

    qp = make_qp(
        jnp.asarray(P, dtype), jnp.asarray(q, dtype), jnp.asarray(A, dtype),
        jnp.asarray(l, dtype), jnp.asarray(u, dtype), cone=ConeSpec(m_box=m))
    return qp, spec


def rollout(spec: MPCSpec, s0, x):
    """Simulate the dynamics under the controls in solution vector x.

    Returns states (N+1, ns). Used by tests to verify physics invariants
    independently of the constraint residuals (SURVEY.md §4.2).
    """
    F, G = dynamics_matrices(spec)
    F = jnp.asarray(F, x.dtype)
    G = jnp.asarray(G, x.dtype)
    b, nu = spec.block, spec.nu
    us = jnp.stack([x[k * b:k * b + nu] for k in range(spec.N)])
    s = jnp.asarray(s0, x.dtype)
    out = [s]
    for k in range(spec.N):
        s = xprec.matmul(F, s) + xprec.matmul(G, us[k])
        out.append(s)
    return jnp.stack(out)


def mpc_bounds_for_s0(qp: QPData, spec: MPCSpec, s0):
    """Rebuild (l, u) for a new initial state, keeping P, A, q fixed.

    This is the Monte-Carlo dispersion hook (M6): only the first ns rows'
    bounds depend on s0.
    """
    F, _ = dynamics_matrices(spec)
    rhs = xprec.matmul(jnp.asarray(F, qp.dtype), jnp.asarray(s0, qp.dtype))
    ns = spec.ns
    l = qp.l.at[..., :ns].set(rhs)
    u = qp.u.at[..., :ns].set(rhs)
    return l, u
