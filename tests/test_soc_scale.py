"""Settings.rho_soc_scale — the SOC-row penalty boost (round 4).

Degenerate bang-bang min-fuel SOCPs park most cone blocks at the TIP,
where the block acts as an equality (Ax_blk = 0) that rho_eq_scale
does not cover; boosting the SOC rows makes those rows converge at the
equality rate (config-4 CPU sweep: 40,725 -> ~9k iterations and
r_prim strictly below absolute 1e-6). The value is a PER-INSTANCE
tuning — on the N=50 low-thrust instance the same boost is 20x WORSE
(111k vs 4.8k iterations, measured round 4) — so the default is 1.0
(no boost) and the tuned value lives in the config-4 bench settings
only.
"""
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status, solve
from admm_library.core.admm import rho_vec_of
from admm_library.problem import ConeSpec, QPData


def test_rho_vec_soc_scale_rows():
    """SOC rows get rho_soc_scale * rho_bar; eq/box rows unaffected.

    The scale must be UNIFORM across a block's rows so the cone
    projection stays the exact prox.
    """
    cone = ConeSpec(m_box=4, soc_dims=(3, 3))
    eq = jnp.array([True, True, False, False] + [False] * 6)
    s = Settings(rho_eq_scale=1e3, rho_soc_scale=40.0)
    rv = np.asarray(rho_vec_of(jnp.asarray(0.5), eq, s, cone))
    np.testing.assert_allclose(rv[:2], 500.0)
    np.testing.assert_allclose(rv[2:4], 0.5)
    np.testing.assert_allclose(rv[4:], 20.0)
    # Default scale 1.0: SOC rows at plain rho_bar (no extra branch).
    rv0 = np.asarray(rho_vec_of(jnp.asarray(0.5), eq, Settings(), cone))
    np.testing.assert_allclose(rv0[4:], 0.5)


def test_soc_scale_preserves_solution():
    """Boosted SOC rho must converge to the SAME solution (the penalty
    re-weighting changes the trajectory, not the fixed point): cone
    projection of c = (1, 2, 0) onto SOC(3) is (1.5, 1.5, 0)."""
    n = 3
    c = jnp.array([1.0, 2.0, 0.0])
    qp = QPData(P=jnp.eye(n), q=-c, A=jnp.eye(n),
                l=jnp.full(n, -jnp.inf), u=jnp.full(n, jnp.inf),
                lam=jnp.zeros(0), cone=ConeSpec(soc_dims=(3,)))
    s = Settings(eps_abs=1e-8, eps_rel=0.0, max_iter=20000,
                 precision="double", polish=False, recenter_rounds=0,
                 rho_soc_scale=50.0)
    sol = solve(qp, s)
    assert int(sol.status) == int(Status.SOLVED)
    np.testing.assert_allclose(np.asarray(sol.x), [1.5, 1.5, 0.0],
                               atol=1e-7)
