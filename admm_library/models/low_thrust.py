"""Low-thrust trajectory SOCP with thrust-magnitude cones (M5, SURVEY.md §2.2).

Benchmark config 4 [BASELINE.json "configs"[3]]: N=200 nodes, per-node
second-order-cone thrust-magnitude constraints in the lossless-
convexification style (Acikmese & Ploen): introduce a slack Gamma_k with

    minimize    sum_k Gamma_k * dt        (fuel proxy)
    subject to  s_{k+1} = F s_k + G u_k   (ZOH-discretised CW dynamics)
                ||u_k||_2 <= Gamma_k      (SOC(4) per node)
                0 <= Gamma_k <= u_max
                s_N = s_target

Variables are ordered BY TIME STEP, block b = [u_k(3), Gamma_k(1),
s_{k+1}(6)] of size 10, so the condensed ADMM matrix M = P + sigma I +
A^T rho A is block-tridiagonal -> the banded backend (K2) factors it in
O(N b^3). Row layout follows problem.py's static [box | L1 | SOC] order.

Reference parity: the pinned reference has no code (SURVEY.md §0); this
realises BASELINE.json "north_star" "second-order-cone for thrust
magnitude" on a genuine astrodynamics transcription.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .. import xprec
from ..problem import ConeSpec, QPData, make_qp
from .clohessy_wiltshire import cw_stm


@dataclasses.dataclass(frozen=True)
class LowThrustSpec:
    """Static description of the low-thrust SOCP instance.

    The QP is built in CANONICAL (nondimensional) units — the standard
    astrodynamics practice (cf. Vallado's canonical units): length unit
    LU = ‖r0‖ (the initial separation), time unit TU = 1/n_mean (so the
    nondimensional mean motion is 1). All problem data is then O(1),
    which makes the ABSOLUTE eps_abs stopping criterion physically
    meaningful (1e-6 ≈ millimetres at LU ~ km) instead of demanding
    5e-10 RELATIVE precision of f32/f64 iterations on metre-scaled
    states (the round-2 bench reported r_prim 8e-4 on this config for
    exactly that reason). `x` solutions are nondimensional; the
    helpers below (thrust_profile, rollout) convert back to SI.
    """

    N: int
    dt: float                   # node spacing [s] (dimensional)
    n_mean: float               # mean motion [rad/s] (dimensional)
    lu: float = 1.0             # length unit [m]
    tu: float = 1.0             # time unit [s]

    @property
    def block(self) -> int:
        return 10               # u(3) + Gamma(1) + state(6)

    @property
    def n(self) -> int:
        return self.N * self.block

    def state_to_nd(self, s):
        """SI state (m, m/s) -> nondimensional (LU, LU/TU)."""
        s = np.asarray(s, np.float64)
        return np.concatenate([s[..., :3] / self.lu,
                               s[..., 3:] * (self.tu / self.lu)], -1)

    def accel_from_nd(self, u_nd):
        """Nondimensional control (LU/TU^2) -> SI accel (m/s^2)."""
        return u_nd * (self.lu / self.tu ** 2)


def _zoh_control_matrix(n_mean: float, dt: float, order: int = 24):
    """G = int_0^dt Phi(dt - tau) B dtau by Gauss-Legendre quadrature.

    The HCW STM is trigonometric/polynomial, so a 24-point rule is exact
    to machine precision for any realistic n*dt. Host-side f64.
    """
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)
    nodes, weights = np.polynomial.legendre.leggauss(order)
    # Map [-1, 1] -> [0, dt].
    taus = 0.5 * dt * (nodes + 1.0)
    G = np.zeros((6, 3))
    for tau, w in zip(taus, weights):
        G += 0.5 * dt * w * (cw_stm(n_mean, dt - tau) @ B)
    return G


def build_low_thrust_socp(s0, s_target=None, N: int = 200, dt: float = 60.0,
                          n_mean: float = 1.1288e-3, u_max: float = 0.01,
                          state_reg: float = 1e-8, ctrl_reg: float = 1e-6,
                          dtype=jnp.float32):
    """Build the banded low-thrust rendezvous SOCP. Returns (QPData, spec).

    Recommended settings: band_block=spec.block (resolve_backend then
    picks the block-tridiagonal backend). s0 enters only the first
    dynamics rows' bounds -> Monte-Carlo dispersions share (P, q, A)
    (shared-matrix fast path, SURVEY.md §3.2); see `lt_bounds_for_s0`.
    """
    s0 = np.asarray(s0, np.float64)
    s_t = (np.zeros(6) if s_target is None
           else np.asarray(s_target, np.float64))
    # Canonical units: LU = initial separation, TU = 1/n (nondim mean
    # motion = 1). See LowThrustSpec docstring.
    lu = max(float(np.linalg.norm(s0[:3])), 1.0)
    tu = 1.0 / n_mean
    spec = LowThrustSpec(N=N, dt=dt, n_mean=n_mean, lu=lu, tu=tu)
    b = spec.block
    nvar = spec.n
    s0 = spec.state_to_nd(s0)
    s_t = spec.state_to_nd(s_t)
    dt_nd = dt / tu
    u_max = u_max * tu ** 2 / lu
    F = cw_stm(1.0, dt_nd)
    G = _zoh_control_matrix(1.0, dt_nd)

    def u_idx(k):
        return k * b

    def g_idx(k):
        return k * b + 3

    def s_idx(k):           # state s_{k+1} lives in block k
        return k * b + 4

    # --- objective: min sum Gamma_k dt (+ tiny regularisation) ---
    Pd = np.full(nvar, state_reg)
    q = np.zeros(nvar)
    for k in range(N):
        Pd[u_idx(k):u_idx(k) + 3] = ctrl_reg
        Pd[g_idx(k)] = ctrl_reg
        q[g_idx(k)] = dt_nd
    P = np.diag(Pd)

    # --- constraint rows ---
    m_dyn = N * 6
    m_term = 6
    m_g = N
    m_soc = N * 4
    m = m_dyn + m_term + m_g + m_soc
    A = np.zeros((m, nvar))
    l = np.zeros(m)
    u = np.zeros(m)

    # dynamics: s_{k+1} - F s_k - G u_k = (F s_0 if k == 0 else 0)
    for k in range(N):
        r = k * 6
        A[r:r + 6, s_idx(k):s_idx(k) + 6] = np.eye(6)
        A[r:r + 6, u_idx(k):u_idx(k) + 3] = -G
        if k > 0:
            A[r:r + 6, s_idx(k - 1):s_idx(k - 1) + 6] = -F
            rhs = np.zeros(6)
        else:
            rhs = F @ s0
        l[r:r + 6] = rhs
        u[r:r + 6] = rhs

    # terminal equality s_N = s_target
    r = m_dyn
    A[r:r + 6, s_idx(N - 1):s_idx(N - 1) + 6] = np.eye(6)
    l[r:r + 6] = s_t
    u[r:r + 6] = s_t

    # Gamma bounds 0 <= Gamma_k <= u_max
    r = m_dyn + m_term
    for k in range(N):
        A[r + k, g_idx(k)] = 1.0
    l[r:r + m_g] = 0.0
    u[r:r + m_g] = u_max

    # SOC rows: per node, block (Gamma_k, u_k) in SOC(4)
    r = m_dyn + m_term + m_g
    for k in range(N):
        A[r + 4 * k, g_idx(k)] = 1.0
        A[r + 4 * k + 1:r + 4 * k + 4, u_idx(k):u_idx(k) + 3] = np.eye(3)
    l[r:] = -np.inf
    u[r:] = np.inf

    cone = ConeSpec(m_box=m_dyn + m_term + m_g, soc_dims=(4,) * N)
    qp = make_qp(
        jnp.asarray(P, dtype), jnp.asarray(q, dtype), jnp.asarray(A, dtype),
        jnp.asarray(l, dtype), jnp.asarray(u, dtype), cone=cone)
    return qp, spec


def lt_bounds_for_s0(qp: QPData, spec: LowThrustSpec, s0):
    """Rebuild (l, u) for a dispersed initial state; P, q, A unchanged.

    Monte-Carlo hook (M6). Supports batched s0 (..., 6); s0 is SI and
    is nondimensionalised with the spec's canonical units.
    """
    F = jnp.asarray(cw_stm(1.0, spec.dt / spec.tu), qp.dtype)
    rhs = xprec.einsum("ij,...j->...i", F,
                     jnp.asarray(spec.state_to_nd(s0), qp.dtype))
    batch = rhs.shape[:-1]
    l = jnp.broadcast_to(qp.l, batch + qp.l.shape[-1:])
    u = jnp.broadcast_to(qp.u, batch + qp.u.shape[-1:])
    l = l.at[..., :6].set(rhs)
    u = u.at[..., :6].set(rhs)
    return l, u


def thrust_profile(spec: LowThrustSpec, x):
    """Extract (u (N,3), Gamma (N,)) from the solution vector.

    Values are NONDIMENSIONAL (LU/TU^2); convert to SI accel with
    spec.accel_from_nd. Cone feasibility ‖u‖ <= Gamma is unit-free."""
    b = spec.block
    blocks = x.reshape(x.shape[:-1] + (spec.N, b))
    return blocks[..., :3], blocks[..., 3]


def rollout(spec: LowThrustSpec, s0, x):
    """Integrate the discrete dynamics under the solved controls.

    Returns NONDIMENSIONAL states (N+1, 6); s0 is SI. Independent
    physics check (SURVEY.md §4.2).
    """
    F = jnp.asarray(cw_stm(1.0, spec.dt / spec.tu), x.dtype)
    G = jnp.asarray(_zoh_control_matrix(1.0, spec.dt / spec.tu), x.dtype)
    us, _ = thrust_profile(spec, x)
    s = jnp.asarray(spec.state_to_nd(s0), x.dtype)
    out = [s]
    for k in range(spec.N):
        s = xprec.matmul(F, s) + xprec.matmul(G, us[k])
        out.append(s)
    return jnp.stack(out)
