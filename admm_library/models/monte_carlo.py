"""Monte-Carlo scenario dispersion builders (M6, SURVEY.md §2.2).

Benchmark config 5 [BASELINE.json "configs"[4]]: 1024 dispersed scenarios.
A dispersion perturbs the initial state s0; for every supported model the
initial state enters only the constraint BOUNDS, so the batch shares
(P, q, A) — produced here as a bound-batched QPData for the shared-matrix
fast path (`parallel.batch.solve_batch_shared`), where one KKT factor
serves all 1024 lanes and per-iteration solves are (B, n) matmuls.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..problem import QPData
from . import clohessy_wiltshire as cw
from . import double_integrator as di
from . import low_thrust as lt


def disperse_s0(key, s0_nominal, sigma_pos: float, sigma_vel: float,
                batch: int, dtype=jnp.float32):
    """Gaussian initial-state dispersion: (batch, ns) states.

    The first half of the state is position (sigma_pos), the second half
    velocity (sigma_vel).
    """
    s0 = jnp.asarray(s0_nominal, dtype)
    ns = s0.shape[-1]
    d = ns // 2
    noise = jax.random.normal(key, (batch, ns), dtype)
    scale = jnp.concatenate([
        jnp.full((d,), sigma_pos, dtype), jnp.full((ns - d,), sigma_vel,
                                                   dtype)])
    return s0 + noise * scale


def _with_bounds(qp: QPData, l, u) -> QPData:
    return QPData(P=qp.P, q=qp.q, A=qp.A, l=l, u=u, lam=qp.lam,
                  cone=qp.cone)


def monte_carlo_mpc(key, batch: int = 1024, N: int = 50, dim: int = 3,
                    sigma_pos: float = 0.1, sigma_vel: float = 0.01,
                    dtype=jnp.float32):
    """Dispersed double-integrator rendezvous MPC batch (configs 2+5).

    Returns (bound-batched QPData, MPCSpec, s0 batch (B, 2*dim)).
    """
    s0_nom = jnp.concatenate([
        jnp.ones((dim,), dtype), -0.5 * jnp.ones((dim,), dtype)])
    qp, spec = di.build_mpc_qp(
        s0_nom, jnp.zeros(2 * dim, dtype), N=N, dim=dim, dtype=dtype)
    s0s = disperse_s0(key, s0_nom, sigma_pos, sigma_vel, batch, dtype)
    l, u = jax.vmap(lambda s: di.mpc_bounds_for_s0(qp, spec, s))(s0s)
    return _with_bounds(qp, l, u), spec, s0s


def monte_carlo_cw(key, batch: int = 1024, N: int = 20,
                   sigma_pos: float = 50.0, sigma_vel: float = 0.05,
                   dtype=jnp.float32):
    """Dispersed CW impulsive min-fuel rendezvous batch (configs 3+5).

    Nominal: 1 km along-track offset, small radial/velocity errors.
    Returns (bound-batched QPData, CWSpec, s0 batch (B, 6)).
    """
    s0_nom = jnp.asarray([100.0, -1000.0, 20.0, 0.1, 0.5, -0.05], dtype)
    qp, spec = cw.build_cw_rendezvous(s0_nom, N=N, dtype=dtype)
    s0s = disperse_s0(key, s0_nom, sigma_pos, sigma_vel, batch, dtype)
    l, u = cw.cw_bounds_for_s0(qp, spec, s0s)
    return _with_bounds(qp, l, u), spec, s0s


def monte_carlo_low_thrust(key, batch: int = 128, N: int = 200,
                           sigma_pos: float = 50.0, sigma_vel: float = 0.05,
                           dtype=jnp.float32):
    """Dispersed low-thrust SOCP batch (configs 4+5).

    Returns (bound-batched QPData, LowThrustSpec, s0 batch (B, 6)).
    """
    s0_nom = jnp.asarray([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1], dtype)
    qp, spec = lt.build_low_thrust_socp(s0_nom, N=N, dtype=dtype)
    s0s = disperse_s0(key, s0_nom, sigma_pos, sigma_vel, batch, dtype)
    l, u = lt.lt_bounds_for_s0(qp, spec, s0s)
    return _with_bounds(qp, l, u), spec, s0s
