"""Monte-Carlo consensus over a 2-D (data x horizon) mesh (P1 x P2)."""
import jax
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status
from admm_library.models.double_integrator import rollout
from admm_library.models.partitioned import (
    assemble_trajectory, partition_mpc_mc)
from admm_library.parallel import runtime
from admm_library.parallel.consensus import consensus_solve
from admm_library.parallel.consensus_mc import consensus_solve_mc

S0 = np.array([1.0, -2.0, 0.3, -0.1])
ST = np.zeros(4)
TOL = Settings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000)


def test_consensus_mc_2d_mesh():
    mesh = runtime.make_mesh(data=2, horizon=4)
    qp_mc, spec, mpc, s0s = partition_mpc_mc(
        jax.random.key(0), batch=4, s0_nominal=S0, s_target=ST,
        N=8, n_blocks=4, dim=2, u_max=2.0, dtype=jnp.float64)
    sol = consensus_solve_mc(qp_mc, spec, mesh, TOL)
    assert sol.x.shape == (4, 4, spec.nb)
    assert np.all(np.asarray(sol.status) == int(Status.SOLVED))
    # Boundary copies agree per scenario; stitched physics reach target.
    x = np.asarray(sol.x)
    for b in range(4):
        for blk in range(1, 4):
            np.testing.assert_allclose(
                x[b, blk, :spec.ns], x[b, blk - 1, -spec.ns:], atol=1e-5)
        us, _ = assemble_trajectory(spec, mpc, sol.x[b])
        traj = rollout(mpc, np.asarray(s0s[b], np.float64),
                       jnp.asarray(np.concatenate(
                           [np.concatenate([us[k], np.zeros(mpc.ns)])
                            for k in range(mpc.N)])))
        assert float(jnp.max(jnp.abs(traj[-1] - ST))) < 1e-4


def test_consensus_mc_matches_single_scenario():
    """B=1 MC result == plain consensus_solve on the same problem."""
    mesh2 = runtime.make_mesh(data=1, horizon=8)
    qp_mc, spec, mpc, s0s = partition_mpc_mc(
        jax.random.key(1), batch=1, s0_nominal=S0, s_target=ST,
        N=16, n_blocks=8, dim=2, u_max=2.0, sigma_pos=0.0,
        sigma_vel=0.0, dtype=jnp.float64)
    sol_mc = consensus_solve_mc(qp_mc, spec, mesh2, TOL)
    assert np.all(np.asarray(sol_mc.status) == int(Status.SOLVED))

    from admm_library.models.partitioned import partition_mpc
    from admm_library.parallel.batch import make_data_mesh
    qp_blk, spec1, _ = partition_mpc(
        S0, ST, N=16, n_blocks=8, dim=2, u_max=2.0, dtype=jnp.float64)
    sol_1 = consensus_solve(
        qp_blk, spec1, make_data_mesh(8, axis="horizon"), TOL)
    np.testing.assert_allclose(
        np.asarray(sol_mc.x[0]), np.asarray(sol_1.x), atol=2e-5)


def test_consensus_mc_honest_per_scenario_iters():
    mesh = runtime.make_mesh(data=4, horizon=2)
    qp_mc, spec, mpc, _ = partition_mpc_mc(
        jax.random.key(2), batch=8, s0_nominal=S0, s_target=ST,
        N=8, n_blocks=2, dim=2, u_max=2.0, dtype=jnp.float64)
    sol = consensus_solve_mc(qp_mc, spec, mesh, TOL)
    iters = np.asarray(sol.iters)
    assert iters.shape == (8,)
    assert np.all(iters > 0)
    assert np.all(iters % TOL.check_every == 0)


def test_consensus_mc_infeasible_lane():
    """A6 on the scenario-batched consensus path (VERDICT r2 item 5):
    with zero control authority, scenarios whose drift misses the
    target are PRIMAL_INFEASIBLE per lane."""
    import numpy as np
    import jax.numpy as jnp
    from admm_library import Settings, Status
    from admm_library.models.partitioned import partition_mpc_mc
    from admm_library.parallel.consensus_mc import consensus_solve_mc
    from admm_library.parallel.runtime import make_mesh
    import jax

    s0 = np.array([1.0, -2.0, 0.3, -0.1])
    s_t = np.array([50.0, 40.0, 0.0, 0.0])
    qp, spec, mpc, _ = partition_mpc_mc(
        jax.random.PRNGKey(0), 4, s0, s_t, N=8, n_blocks=4, dim=2,
        u_max=0.0)
    mesh = make_mesh(data=2, horizon=4)
    sol = consensus_solve_mc(qp, spec, mesh,
                             Settings(precision="single", max_iter=4000))
    assert np.all(np.asarray(sol.status)
                  == int(Status.PRIMAL_INFEASIBLE)), np.asarray(sol.status)
