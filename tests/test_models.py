"""Astrodynamics model builders: physics invariants (SURVEY.md §4.2)."""
import jax
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status, solve
from admm_library.models import clohessy_wiltshire as cw
from admm_library.models import low_thrust as lt
from admm_library.models import monte_carlo as mc

TOL = Settings(eps_abs=1e-8, eps_rel=1e-8, max_iter=40000)


def test_cw_stm_properties():
    n = 1.2e-3
    # Phi(0) = I; composition Phi(a)Phi(b) = Phi(a+b) (LTI flow).
    np.testing.assert_allclose(cw.cw_stm(n, 0.0), np.eye(6), atol=1e-14)
    a, b = 137.0, 402.0
    np.testing.assert_allclose(
        cw.cw_stm(n, a) @ cw.cw_stm(n, b), cw.cw_stm(n, a + b),
        rtol=1e-10, atol=1e-10)


def test_cw_rendezvous_min_fuel():
    s0 = np.array([100.0, -800.0, 30.0, 0.1, 0.4, -0.02])
    qp, spec = cw.build_cw_rendezvous(
        s0, N=10, dt=600.0, dv_max=2.0, dtype=jnp.float64)
    sol = solve(qp, TOL)
    assert int(sol.status) == int(Status.SOLVED)
    # Physics: propagating the impulses must reach the target.
    states = cw.propagate(spec, s0, sol.x)
    assert float(jnp.max(jnp.abs(states[-1]))) < 1e-4
    # Impulse bounds respected.
    dvs = cw.dv_impulses(spec, sol.x)
    assert float(jnp.max(jnp.abs(dvs))) <= 2.0 + 1e-6
    # L1 structure: soft-threshold should produce genuinely sparse burns.
    frac_zero = float(jnp.mean(jnp.abs(dvs) < 1e-7))
    assert frac_zero > 0.2


def test_low_thrust_socp():
    s0 = np.array([200.0, -1500.0, 50.0, 0.0, 0.8, -0.05])
    qp, spec = lt.build_low_thrust_socp(
        s0, N=25, dt=240.0, u_max=0.05, dtype=jnp.float64)
    # eps_rel=1e-9: the rollout check below re-integrates the dynamics,
    # which amplifies per-row constraint defects ~1000x over the
    # horizon; the solver stops exactly at the mixed criterion (the old
    # emulated-f64 phase overshot it), so the test requests a tolerance
    # tight enough for the physics bound rather than relying on
    # overshoot.
    s = TOL.replace(band_block=spec.block, eps_rel=1e-9)
    sol = solve(qp, s)
    assert int(sol.status) == int(Status.SOLVED)
    states = lt.rollout(spec, s0, sol.x)
    scale = float(jnp.max(jnp.abs(states)))
    assert float(jnp.max(jnp.abs(states[-1]))) < 1e-5 * scale
    # Thrust magnitude inside the cone (with small tolerance).
    us, gam = lt.thrust_profile(spec, sol.x)
    nu = jnp.linalg.norm(us, axis=-1)
    assert float(jnp.max(nu - gam)) < 1e-5
    # Gamma is nondimensional (canonical units); compare in SI.
    gam_si = spec.accel_from_nd(gam)
    assert float(jnp.max(gam_si)) <= 0.05 + 1e-6


def test_low_thrust_banded_equals_dense():
    s0 = np.array([100.0, -500.0, 10.0, 0.0, 0.3, 0.0])
    qp, spec = lt.build_low_thrust_socp(
        s0, N=12, dt=300.0, u_max=0.05, dtype=jnp.float64)
    # recenter_rounds=0: this test compares the K2 banded backend to
    # the dense K1 through the full solver, so both must run the same
    # (f64-phase) precision strategy; the f32 re-centering endpoint is
    # path-dependent on this LP-like SOCP at equal mixed tolerance.
    sol_b = solve(qp, TOL.replace(band_block=spec.block, backend="banded",
                                  recenter_rounds=0))
    sol_d = solve(qp, TOL.replace(backend="chol", recenter_rounds=0))
    # The SOCP is LP-like in the Gamma slacks, so primal points at equal
    # residual tolerance may differ; the OBJECTIVE must agree (the K2
    # factor itself is verified against K1 to 1e-10 in test_kkt).
    assert int(sol_b.status) == int(Status.SOLVED)
    np.testing.assert_allclose(
        float(sol_b.obj), float(sol_d.obj), rtol=1e-4)


def test_monte_carlo_builders_share_matrices():
    key = jax.random.key(0)
    qp, spec, s0s = mc.monte_carlo_cw(key, batch=8, N=6, dtype=jnp.float64)
    assert qp.P.ndim == 2 and qp.A.ndim == 2      # shared
    assert qp.l.shape[0] == 8 and qp.u.shape[0] == 8  # batched bounds
    qp2, spec2, _ = mc.monte_carlo_mpc(key, batch=4, N=8, dtype=jnp.float64)
    assert qp2.A.ndim == 2 and qp2.l.shape[0] == 4
    qp3, spec3, _ = mc.monte_carlo_low_thrust(
        key, batch=4, N=10, dtype=jnp.float64)
    assert qp3.A.ndim == 2 and qp3.l.shape[0] == 4
