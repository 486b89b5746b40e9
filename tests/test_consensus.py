"""Consensus ADMM over horizon blocks — P2 (SURVEY.md §3.3, §4.4).

Runs on the 8-device virtual CPU mesh from conftest.py.
"""
import jax
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status, solve
from admm_library.models.double_integrator import build_mpc_qp, rollout
from admm_library.models.partitioned import (
    assemble_trajectory, partition_mpc)
from admm_library.parallel.batch import make_data_mesh
from admm_library.parallel.consensus import consensus_solve

S0 = np.array([1.0, -2.0, 0.3, -0.1])
ST = np.zeros(4)


def _mesh(n, axis="horizon"):
    return make_data_mesh(n, axis=axis)


def test_consensus_matches_monolithic():
    N, B = 16, 8
    qp_blk, spec, mpc = partition_mpc(
        S0, ST, N=N, n_blocks=B, dim=2, u_max=2.0, dtype=jnp.float64)
    sol = consensus_solve(
        qp_blk, spec, _mesh(8),
        Settings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000))
    assert int(sol.status) == int(Status.SOLVED)
    us, ss = assemble_trajectory(spec, mpc, sol.x)

    qp_mono, spec_mono = build_mpc_qp(
        S0, ST, N=N, dim=2, u_max=2.0, dtype=jnp.float64)
    sol_mono = solve(qp_mono, Settings(eps_abs=1e-9, eps_rel=1e-9))
    b, nu = spec_mono.block, spec_mono.nu
    us_mono = np.stack([np.asarray(sol_mono.x[k * b:k * b + nu])
                        for k in range(N)])
    np.testing.assert_allclose(us, us_mono, atol=5e-5)


def test_consensus_boundary_agreement_and_physics():
    N, B = 24, 8
    qp_blk, spec, mpc = partition_mpc(
        S0, ST, N=N, n_blocks=B, dim=2, u_max=2.0, dtype=jnp.float64)
    sol = consensus_solve(
        qp_blk, spec, _mesh(8),
        Settings(eps_abs=1e-8, eps_rel=1e-8, max_iter=30000))
    assert int(sol.status) == int(Status.SOLVED)
    # Duplicated boundary copies agree across blocks.
    x = np.asarray(sol.x)
    ns = spec.ns
    for b in range(1, B):
        right_prev = x[b - 1, -ns:]       # last state of block b-1
        left_copy = x[b, :ns]
        np.testing.assert_allclose(left_copy, right_prev, atol=1e-6)
    # Stitched controls satisfy the physics end-to-end.
    us, _ = assemble_trajectory(spec, mpc, sol.x)
    states = rollout(
        mpc, S0, jnp.asarray(np.concatenate(
            [np.concatenate([us[k], np.zeros(mpc.ns)]) for k in range(N)])))
    # rollout expects the monolithic layout [u_k, s_{k+1}]*N; zeros for
    # states are ignored by rollout (it only reads the u slots).
    assert float(jnp.max(jnp.abs(states[-1] - jnp.asarray(ST)))) < 1e-4


def test_consensus_blocks_per_device():
    """More blocks than devices: 16 blocks on 8 devices (2 per device)."""
    N, B = 32, 16
    qp_blk, spec, mpc = partition_mpc(
        S0, ST, N=N, n_blocks=B, dim=2, u_max=2.0, dtype=jnp.float64)
    sol = consensus_solve(
        qp_blk, spec, _mesh(8),
        Settings(eps_abs=1e-7, eps_rel=1e-7, max_iter=30000))
    assert int(sol.status) == int(Status.SOLVED)
    x = np.asarray(sol.x)
    for b in range(1, B):
        np.testing.assert_allclose(
            x[b, :spec.ns], x[b - 1, -spec.ns:], atol=1e-5)


def test_consensus_warm_start_and_history():
    """A5 on the consensus path: re-solving from a converged solution
    costs (far) fewer iterations; the residual ring buffer is wired."""
    N, B = 16, 8
    qp_blk, spec, mpc = partition_mpc(
        S0, ST, N=N, n_blocks=B, dim=2, u_max=2.0, dtype=jnp.float64)
    s = Settings(eps_abs=1e-7, eps_rel=1e-7, max_iter=20000, history=64)
    sol = consensus_solve(qp_blk, spec, _mesh(8), s)
    assert int(sol.status) == int(Status.SOLVED)
    cold_iters = int(sol.iters)

    warm = consensus_solve(
        qp_blk, spec, _mesh(8), s, x0=sol.x, z0=sol.z, y0=sol.y,
        rho0=sol.rho)
    assert int(warm.status) == int(Status.SOLVED)
    assert int(warm.iters) <= cold_iters // 4

    # Residual trace: populated entries are (iter, r_p, r_d); it is a
    # RING buffer, so sort by the iteration stamp before checking.
    hist = np.asarray(sol.history)
    filled = hist[hist[:, 0] > 0]
    filled = filled[np.argsort(filled[:, 0])]
    assert filled.shape[0] >= 2
    assert np.all(np.diff(filled[:, 0]) > 0)
    assert np.all(filled[:, 1:] >= 0)


def test_consensus_1e8_no_f64_loop():
    """VERDICT r1 item 4 gate: eps 1e-8 on the MPC set via f32 phases +
    re-centered refinement only (the hybrid box-cone path runs no f64
    iteration phase by construction)."""
    qp_blk, spec, mpc = partition_mpc(
        S0, ST, N=16, n_blocks=8, dim=2, u_max=2.0, dtype=jnp.float64)
    sol = consensus_solve(
        qp_blk, spec, _mesh(8),
        Settings(eps_abs=1e-8, eps_rel=1e-8, max_iter=30000))
    assert int(sol.status) == int(Status.SOLVED)
    assert float(sol.r_prim) <= 1e-7    # mixed criterion incl. eps_rel
    assert float(sol.r_dual) <= 1e-7


def test_consensus_primal_infeasible():
    """A6 on the consensus path (VERDICT r2 item 5): zero control
    authority + an unreachable terminal equality -> the block problem
    is primal infeasible and the certificate must fire (not MAX_ITER)."""
    import numpy as np
    from admm_library.models.partitioned import partition_mpc
    from admm_library.parallel.batch import make_data_mesh
    from admm_library.parallel.consensus import consensus_solve

    s0 = np.array([1.0, -2.0, 0.3, -0.1])
    s_t = np.array([50.0, 40.0, 0.0, 0.0])
    qp_blk, cspec, mpc = partition_mpc(
        s0, s_t, N=8, n_blocks=4, dim=2, u_max=0.0)
    mesh = make_data_mesh(4, axis="horizon")
    sol = consensus_solve(qp_blk, cspec, mesh,
                          Settings(precision="single", max_iter=4000))
    assert int(sol.status) == int(Status.PRIMAL_INFEASIBLE)
