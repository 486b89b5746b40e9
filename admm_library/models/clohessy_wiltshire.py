"""Clohessy-Wiltshire impulsive rendezvous, L1 min-fuel (M4, SURVEY.md §2.2).

Benchmark config 3 [BASELINE.json "configs"[2]]: CW/HCW linear relative
dynamics with analytic state-transition matrix, impulsive delta-V decision
variables, and an L1 min-fuel cost handled by the soft-threshold prox (X2).

The reference repo ships no code (/root/reference README.md:1-2 only names
"ADMM ... for astrodynamics problems"); this builder realises the classic
impulsive-rendezvous formulation the reference targets.

Hill/Clohessy-Wiltshire frame: x radial (away from Earth), y along-track,
z cross-track; target on a circular orbit with mean motion n. State
s = (x, y, z, vx, vy, vz). Impulses dv_k are applied at node times k*dt:

    s_{k+1} = Phi(dt) (s_k + B dv_k),      B = [0; I3]

Condensed transcription (states eliminated through the analytic STM — the
astrodynamics-idiomatic form for impulsive maneuver planning): decision
vector X = [dv_0, ..., dv_{N-1}] with the rendezvous condition

    sum_k Phi(dt)^{N-k} B dv_k = s_target - Phi(dt)^N s_0.

Canonical-form layout (problem.py row order [box | L1 | SOC]):
    box rows:  6 terminal equality rows, then 3N per-axis impulse bounds
    L1 rows:   3N identity rows on the dv variables, weight lam
P is a small regularisation eps*I (the objective is the L1 term).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from .. import xprec
from ..problem import ConeSpec, QPData, make_qp


@dataclasses.dataclass(frozen=True)
class CWSpec:
    """Static description of the impulsive CW instance."""

    N: int                  # number of impulses
    dt: float               # node spacing [s or normalised]
    n_mean: float           # target mean motion [rad / time-unit]
    s_target: tuple = (0.0,) * 6
    row_scale: tuple = (1.0,) * 6   # terminal-row normalisation factors
    # Canonical units of the SPARSE transcription (1.0 = dimensional).
    lu: float = 1.0         # length unit [m]
    tu: float = 1.0         # time unit [s]

    @property
    def n(self) -> int:
        return 3 * self.N

    def state_to_nd(self, s):
        """SI state (m, m/s) -> nondimensional (LU, LU/TU)."""
        s = np.asarray(s, np.float64)
        return np.concatenate([s[..., :3] / self.lu,
                               s[..., 3:] * (self.tu / self.lu)], -1)


def cw_stm(n: float, t: float) -> np.ndarray:
    """Analytic 6x6 HCW state-transition matrix Phi(t) (host-side, f64).

    Standard closed form (e.g. Vallado, "Fundamentals of Astrodynamics",
    Hill's equations solution). x radial, y along-track, z cross-track.
    """
    s, c = np.sin(n * t), np.cos(n * t)
    P = np.zeros((6, 6))
    # position rows
    P[0, 0] = 4.0 - 3.0 * c
    P[0, 3] = s / n
    P[0, 4] = 2.0 * (1.0 - c) / n
    P[1, 0] = 6.0 * (s - n * t)
    P[1, 1] = 1.0
    P[1, 3] = 2.0 * (c - 1.0) / n
    P[1, 4] = (4.0 * s - 3.0 * n * t) / n
    P[2, 2] = c
    P[2, 5] = s / n
    # velocity rows
    P[3, 0] = 3.0 * n * s
    P[3, 3] = c
    P[3, 4] = 2.0 * s
    P[4, 0] = 6.0 * n * (c - 1.0)
    P[4, 3] = -2.0 * s
    P[4, 4] = 4.0 * c - 3.0
    P[5, 2] = -n * s
    P[5, 5] = c
    return P


def build_cw_rendezvous(s0, s_target=None, N: int = 20, dt: float = 300.0,
                        n_mean: float = 1.1288e-3, dv_max: float = 1.0,
                        lam: float = 1.0, reg: float = 1e-6,
                        dtype=jnp.float32):
    """Build the L1 min-fuel impulsive CW rendezvous problem.

    s0: (6,) initial relative state; s_target: (6,) final state (default 0 =
    rendezvous with the target). n_mean defaults to a ~400 km LEO orbit
    (n = sqrt(mu/a^3) ~ 1.13e-3 rad/s). Returns (QPData, CWSpec).

    s0 enters only the terminal-equality BOUNDS, so Monte-Carlo initial
    dispersions share (P, q, A) across the batch — the shared-matrix fast
    path (SURVEY.md §3.2); see `cw_bounds_for_s0`.
    """
    s0 = np.asarray(s0, np.float64)
    s_t = (np.zeros(6) if s_target is None
           else np.asarray(s_target, np.float64))
    nvar = 3 * N
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)

    # Terminal map: T[:, 3k:3k+3] = Phi^{N-k} B.
    Phi = cw_stm(n_mean, dt)
    T = np.zeros((6, nvar))
    PhiB = Phi @ B                      # Phi^1 B for the last impulse
    for k in range(N - 1, -1, -1):
        T[:, 3 * k:3 * k + 3] = PhiB
        PhiB = Phi @ PhiB
    rhs = s_t - np.linalg.matrix_power(Phi, N) @ s0

    # Row-normalise the terminal map: CW STM entries span ~5 orders of
    # magnitude between position rows (metres over an orbit) and velocity
    # rows; without this the L1/LP-like problem crawls (observed: r_p
    # plateaus for tens of thousands of iterations). Dividing a row and
    # its rhs by the row norm leaves the constraint unchanged.
    rown = np.linalg.norm(T, axis=1, keepdims=True)
    rown = np.where(rown > 0, rown, 1.0)
    T = T / rown
    rhs = rhs / rown[:, 0]
    spec = CWSpec(N=N, dt=dt, n_mean=n_mean,
                  s_target=tuple(map(float, s_t)),
                  row_scale=tuple(map(float, rown[:, 0])))

    # Row layout: 6 terminal equalities (box), then 3N BOUNDED L1 rows —
    # the impulse box bounds fold into the L1 prox (exact composite
    # clip(soft_threshold), ops/prox.soft_threshold_box), halving m and
    # avoiding duplicated identity rows.
    m_eq, m_l1 = 6, nvar
    m = m_eq + m_l1
    A = np.zeros((m, nvar))
    A[:m_eq] = T
    A[m_eq:] = np.eye(nvar)
    l = np.concatenate([rhs, np.full(nvar, -dv_max)])
    u = np.concatenate([rhs, np.full(nvar, dv_max)])

    P = reg * np.eye(nvar)
    q = np.zeros(nvar)
    cone = ConeSpec(m_box=m_eq, m_l1=m_l1)
    qp = make_qp(
        jnp.asarray(P, dtype), jnp.asarray(q, dtype), jnp.asarray(A, dtype),
        jnp.asarray(l, dtype), jnp.asarray(u, dtype), cone=cone,
        lam=jnp.full(m_l1, lam, dtype))
    return qp, spec


def build_cw_rendezvous_sparse(s0, s_target=None, N: int = 20,
                               dt: float = 300.0,
                               n_mean: float = 1.1288e-3,
                               dv_max: float = 1.0, lam: float = 1.0,
                               reg: float = 1e-6, dtype=jnp.float32):
    """Banded state-space transcription of the L1 min-fuel CW problem.

    Unlike `build_cw_rendezvous` (states eliminated through the STM —
    6 dense terminal rows spanning every impulse), this keeps the states
    as decision variables so A is BLOCK-BANDED and the problem horizon-
    partitions (parallel/horizon.py). Variables per step k (block b=9):
    [dv_k (3), s_{k+1} (6)]. Rows, in the canonical [box | L1] order:

        N*6 dynamics equalities  s_{k+1} - Phi s_k - Phi B dv_k = rhs_k
             (rhs_0 = Phi s_0, else 0) — time k; s_k sits in the LAST 6
             entries of block k-1 (the halo block)
        6   terminal equalities  s_N = s_target — time N-1
        N*3 bounded L1 rows on dv_k (lam, ±dv_max) — time k

    Built in CANONICAL units (LU = ‖r0‖, TU = 1/n — nondimensional mean
    motion 1, all data O(1)): the horizon SPIKE path runs WITHOUT Ruiz
    scaling (exact-partition parity), and in raw SI seconds the STM's
    s/n ≈ t entries (~600) push the explicit-inverse Schur pieces to a
    1e-4 solve defect in f64 (measured round 5); canonical units
    restore machine-level defects. dv and lam are nondimensional
    (LU/TU); spec.lu/tu convert back.

    Same physics/optimum as the condensed form (the states are
    eliminated exactly there); row_time map:
    parallel.horizon.cw_sparse_row_time. Returns (QPData, CWSpec).
    """
    s0 = np.asarray(s0, np.float64)
    s_t = (np.zeros(6) if s_target is None
           else np.asarray(s_target, np.float64))
    lu = max(float(np.linalg.norm(s0[:3])), 1.0)
    tu = 1.0 / n_mean
    spec0 = CWSpec(N=N, dt=dt, n_mean=n_mean, lu=lu, tu=tu)
    s0 = spec0.state_to_nd(s0)
    s_t = spec0.state_to_nd(s_t)
    dv_max = dv_max * tu / lu
    b = 9
    nvar = N * b
    Phi = cw_stm(1.0, dt / tu)
    B = np.zeros((6, 3))
    B[3:, :] = np.eye(3)
    PhiB = Phi @ B

    def dv_idx(k):
        return k * b

    def s_idx(k):            # state s_{k+1} lives in block k
        return k * b + 3

    m_dyn, m_term, m_l1 = N * 6, 6, N * 3
    m_box = m_dyn + m_term
    m = m_box + m_l1
    A = np.zeros((m, nvar))
    l = np.zeros(m)
    u = np.zeros(m)
    for k in range(N):
        r = k * 6
        A[r:r + 6, s_idx(k):s_idx(k) + 6] = np.eye(6)
        A[r:r + 6, dv_idx(k):dv_idx(k) + 3] = -PhiB
        if k > 0:
            A[r:r + 6, s_idx(k - 1):s_idx(k - 1) + 6] = -Phi
            rhs = np.zeros(6)
        else:
            rhs = Phi @ s0
        l[r:r + 6] = rhs
        u[r:r + 6] = rhs
    r = m_dyn
    A[r:r + 6, s_idx(N - 1):s_idx(N - 1) + 6] = np.eye(6)
    l[r:r + 6] = s_t
    u[r:r + 6] = s_t
    r = m_box
    for k in range(N):
        A[r + 3 * k:r + 3 * k + 3, dv_idx(k):dv_idx(k) + 3] = np.eye(3)
    l[r:] = -dv_max
    u[r:] = dv_max

    P = reg * np.eye(nvar)
    q = np.zeros(nvar)
    cone = ConeSpec(m_box=m_box, m_l1=m_l1)
    qp = make_qp(
        jnp.asarray(P, dtype), jnp.asarray(q, dtype), jnp.asarray(A, dtype),
        jnp.asarray(l, dtype), jnp.asarray(u, dtype), cone=cone,
        lam=jnp.full(m_l1, lam, dtype))
    spec = CWSpec(N=N, dt=dt, n_mean=n_mean,
                  s_target=tuple(map(float, s_t)), lu=lu, tu=tu)
    return qp, spec


def cw_sparse_bounds_for_s0(qp: QPData, spec: CWSpec, s0):
    """Rebuild (l, u) of the SPARSE transcription for a dispersed s0.

    Only the first 6 dynamics rows (rhs_0 = Phi s_0) depend on s0, so
    Monte-Carlo dispersions share (P, q, A). Batched s0 (..., 6) ok;
    s0 is SI and is nondimensionalised with the spec's canonical units.
    """
    Phi = jnp.asarray(cw_stm(1.0, spec.dt / spec.tu), qp.dtype)
    rhs = xprec.einsum("ij,...j->...i", Phi,
                     jnp.asarray(spec.state_to_nd(s0), qp.dtype))
    batch = rhs.shape[:-1]
    l = jnp.broadcast_to(qp.l, batch + qp.l.shape[-1:])
    u = jnp.broadcast_to(qp.u, batch + qp.u.shape[-1:])
    l = l.at[..., :6].set(rhs)
    u = u.at[..., :6].set(rhs)
    return l, u


def cw_bounds_for_s0(qp: QPData, spec: CWSpec, s0):
    """Rebuild (l, u) for a dispersed initial state, keeping P, q, A fixed.

    Monte-Carlo hook (M6): only the 6 terminal-equality bounds depend on
    s0. Works with batched s0 of shape (..., 6): returns (..., m) bounds.
    """
    PhiN = jnp.asarray(
        np.linalg.matrix_power(cw_stm(spec.n_mean, spec.dt), spec.N),
        qp.dtype)
    s0 = jnp.asarray(s0, qp.dtype)
    s_t = jnp.asarray(spec.s_target, qp.dtype)
    rown = jnp.asarray(spec.row_scale, qp.dtype)
    rhs = (s_t - xprec.einsum("ij,...j->...i", PhiN, s0)) / rown
    batch = rhs.shape[:-1]
    l = jnp.broadcast_to(qp.l, batch + qp.l.shape[-1:])
    u = jnp.broadcast_to(qp.u, batch + qp.u.shape[-1:])
    l = l.at[..., :6].set(rhs)
    u = u.at[..., :6].set(rhs)
    return l, u


def dv_impulses(spec: CWSpec, x):
    """Reshape solution vector into (N, 3) impulses."""
    return x.reshape(x.shape[:-1] + (spec.N, 3))


def propagate(spec: CWSpec, s0, x):
    """Roll the impulsive dynamics forward; returns states (N+1, 6).

    states[k] is the state at node k BEFORE the impulse dv_k; states[N]
    is the final (rendezvous) state. Independent physics check for tests
    (SURVEY.md §4.2).
    """
    Phi = jnp.asarray(cw_stm(spec.n_mean, spec.dt), x.dtype)
    dvs = dv_impulses(spec, x)
    s = jnp.asarray(s0, x.dtype)
    out = [s]
    for k in range(spec.N):
        s_plus = s.at[3:].add(dvs[k])
        s = xprec.matmul(Phi, s_plus)
        out.append(s)
    return jnp.stack(out)
