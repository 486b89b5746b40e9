"""Shared-matrix batch path + data-parallel sharding (P1, SURVEY.md §4.4).

Runs on the 8-device virtual CPU mesh from conftest.py.
"""
import jax
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status, solve
from admm_library.models import monte_carlo as mc
from admm_library.models.double_integrator import rollout
from admm_library.parallel.batch import (
    make_data_mesh, shard_batch, solve_batch_shared)
from admm_library.problem import QPData

TOL = Settings(eps_abs=1e-8, eps_rel=1e-8)


def _lane(qp, i):
    """Extract lane i of a bound-batched problem as a single problem."""
    return QPData(P=qp.P, q=qp.q, A=qp.A, l=qp.l[i], u=qp.u[i],
                  lam=qp.lam, cone=qp.cone)


def test_shared_batch_matches_single():
    qp, spec, s0s = mc.monte_carlo_mpc(
        jax.random.key(0), batch=4, N=8, dim=2, dtype=jnp.float64)
    sols = solve_batch_shared(qp, TOL)
    assert np.all(np.asarray(sols.status) == int(Status.SOLVED))
    for i in range(4):
        single = solve(_lane(qp, i), TOL)
        np.testing.assert_allclose(sols.x[i], single.x, atol=1e-5)


def test_shared_batch_physics():
    qp, spec, s0s = mc.monte_carlo_mpc(
        jax.random.key(1), batch=6, N=10, dim=2, dtype=jnp.float64)
    sols = solve_batch_shared(qp, TOL)
    for i in range(6):
        states = rollout(spec, s0s[i], sols.x[i])
        assert float(jnp.max(jnp.abs(states[-1]))) < 1e-5


def test_shared_batch_banded_backend():
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.key(2), batch=4, N=8, dim=2, dtype=jnp.float64)
    s = TOL.replace(band_block=spec.block)
    sols = solve_batch_shared(qp, s)
    assert np.all(np.asarray(sols.status) == int(Status.SOLVED))


def test_shared_batch_honest_lane_iters():
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.key(3), batch=8, N=8, dim=2, dtype=jnp.float64)
    sols = solve_batch_shared(qp, TOL)
    iters = np.asarray(sols.iters)
    assert iters.shape == (8,)
    # Lanes converge at different checks; counts must not all be equal
    # to the global lockstep maximum unless they genuinely coincide.
    assert np.all(iters > 0)
    assert np.all(iters % TOL.check_every == 0)


def test_sharded_batch_over_mesh():
    """P1 over an 8-device mesh: results identical to unsharded run.

    Agreement is asserted at solve tolerance, not bitwise: the
    shared-rho geomean is
    a cross-lane reduction whose order differs across topologies
    (SURVEY.md §7 bitwise-stability scope: same-topology bitwise,
    cross-topology tolerance-level)."""
    assert jax.device_count() >= 8
    s = TOL
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.key(4), batch=16, N=6, dim=2, dtype=jnp.float64)
    ref = solve_batch_shared(qp, s)

    mesh = make_data_mesh(8)
    qp_s, *_ = shard_batch(qp, mesh)
    sols = solve_batch_shared(qp_s, s)
    assert np.all(np.asarray(sols.status) == int(Status.SOLVED))
    np.testing.assert_allclose(sols.x, ref.x, atol=1e-6)


def test_shared_batch_cw_l1():
    qp, spec, s0s = mc.monte_carlo_cw(
        jax.random.key(5), batch=4, N=6, dtype=jnp.float64)
    sols = solve_batch_shared(qp, Settings(
        eps_abs=1e-8, eps_rel=1e-8, max_iter=40000))
    assert np.all(np.asarray(sols.status) == int(Status.SOLVED))
    from admm_library.models import clohessy_wiltshire as cw
    for i in range(4):
        states = cw.propagate(spec, s0s[i], sols.x[i])
        assert float(jnp.max(jnp.abs(states[-1]))) < 1e-3


def test_recentered_hybrid_matches_double():
    """The f32 re-centering rounds must reach deep (1e-8) tolerances and
    agree with a full f64 solve — without any f64 iteration phase."""
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.key(6), batch=4, N=8, dim=2, dtype=jnp.float64)
    s_hyb = Settings(eps_abs=1e-8, eps_rel=1e-8, precision="hybrid",
                     recenter_rounds=2)
    s_dbl = Settings(eps_abs=1e-8, eps_rel=1e-8, precision="double")
    hyb = solve_batch_shared(qp, s_hyb)
    dbl = solve_batch_shared(qp, s_dbl)
    assert np.all(np.asarray(hyb.status) == int(Status.SOLVED))
    assert float(np.max(np.asarray(hyb.r_prim))) <= 1e-7
    assert float(np.max(np.asarray(hyb.r_dual))) <= 1e-7
    np.testing.assert_allclose(
        np.asarray(hyb.x), np.asarray(dbl.x), atol=1e-6)


def test_recentered_zero_rounds_falls_back():
    """recenter_rounds=0 selects the classic f32 -> f64 two-phase."""
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.key(7), batch=3, N=6, dim=2, dtype=jnp.float64)
    s = Settings(eps_abs=1e-8, eps_rel=1e-8, recenter_rounds=0)
    sol = solve_batch_shared(qp, s)
    assert np.all(np.asarray(sol.status) == int(Status.SOLVED))


def test_batch_history_trace():
    """Residual ring buffer wired into the batch path."""
    import numpy as np
    from admm_library.models import monte_carlo as mc
    from admm_library.parallel.batch import solve_batch_shared

    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(4), batch=8, N=8, dim=2, dtype=jnp.float32)
    s = Settings(eps_abs=1e-5, eps_rel=1e-5, precision="single",
                 history=64)
    sol = solve_batch_shared(qp, s)
    hist = np.asarray(sol.history)
    filled = hist[hist[:, 0] > 0]
    filled = filled[np.argsort(filled[:, 0])]
    assert filled.shape[0] >= 1
    assert np.all(np.diff(filled[:, 0]) > 0)


def test_residual_trace_stability_across_topologies():
    """SURVEY.md §7 "bitwise stability": (a) same-topology repeat runs
    produce BITWISE-identical residual traces; (b) 1-device and 8-device
    topologies agree on the trace to <= 1e-6 (reduction orders differ
    across mesh shapes, so bitwise is only promised per-topology)."""
    import numpy as np
    from admm_library.models import monte_carlo as mc
    from admm_library.parallel.batch import (
        make_data_mesh, shard_batch, solve_batch_shared)

    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(6), batch=16, N=8, dim=2, dtype=jnp.float32)
    s = Settings(eps_abs=1e-5, eps_rel=1e-5, precision="single",
                 history=128)

    h1 = np.asarray(solve_batch_shared(qp, s).history)
    h1b = np.asarray(solve_batch_shared(qp, s).history)
    assert np.array_equal(h1, h1b)          # bitwise, same topology

    qp_s, *_ = shard_batch(qp, make_data_mesh(8))
    h8 = np.asarray(solve_batch_shared(qp_s, s).history)
    h8b = np.asarray(solve_batch_shared(qp_s, s).history)
    assert np.array_equal(h8, h8b)          # bitwise, same topology

    f1 = h1[h1[:, 0] > 0]
    f8 = h8[h8[:, 0] > 0]
    k = min(len(f1), len(f8))
    assert k >= 1
    # Same iteration stamps; residuals agree across topologies to 1e-6.
    assert np.array_equal(f1[:k, 0], f8[:k, 0])
    np.testing.assert_allclose(f1[:k, 1:], f8[:k, 1:], atol=1e-6)
