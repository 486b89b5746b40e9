"""Horizon-sharded exact-SPIKE ADMM driver (parallel/horizon.py).

The load-bearing property: the distributed x-update solves the SAME
condensed system as the un-partitioned solver, so the horizon partition
costs NO iterations — verified as iterate parity (identical lockstep
iteration counts, matching solutions) against solve_batch_shared with
all staging disabled, on an 8-virtual-device (data x horizon) mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np

from admm_library import Settings
from admm_library.models import monte_carlo as mc
from admm_library.models.double_integrator import MPCSpec
from admm_library.parallel.batch import solve_batch_shared
from admm_library.parallel.horizon import (HorizonParts, mpc_row_time,
                                               partition_qp,
                                               solve_horizon_sharded)
from admm_library.parallel.runtime import make_mesh
from admm_library.solution import Status

# Plain-ADMM settings: no Ruiz scaling, no restart averaging, no stall
# exit, no polish — the horizon driver implements the core loop only,
# and parity must compare identical algorithms.
PLAIN = Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                 scaling_iters=0, restart_every=0, stall_checks=0,
                 polish=False, eps_pinf=0.0, eps_dinf=0.0)


def _build(batch=4, N=8, dim=2, seed=0):
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(seed), batch=batch, N=N, dim=dim,
        dtype=jnp.float64)
    mspec = MPCSpec(N=N, dim=dim, dt=1.0)
    row_time = mpc_row_time(N, mspec.ns, mspec.nu)
    return qp, mspec, row_time


def test_partition_roundtrip():
    """Partitioned (A_loc, A_halo) reassemble the dense A exactly."""
    qp, mspec, row_time = _build()
    hp, hspec = partition_qp(qp, mspec.block, 4, row_time)
    assert hspec.parts == 4 and hspec.npb == 2 * mspec.block
    # Apply both forms to a random x and compare row sums per part.
    rng = np.random.default_rng(0)
    x = rng.standard_normal(qp.n)
    xp = x.reshape(4, hspec.npb)
    Ax_dense = np.asarray(qp.A) @ x
    for p in range(4):
        loc = np.asarray(hp.A_loc)[p] @ xp[p]
        if p > 0:
            loc = loc + np.asarray(hp.A_halo)[p] @ xp[p - 1][-hspec.b:]
        # Rows of part p in the dense ordering:
        rows = np.nonzero(np.asarray(row_time) // (8 // 4) == p)[0]
        np.testing.assert_allclose(loc[:len(rows)], Ax_dense[rows],
                                   rtol=0, atol=1e-12)


def test_horizon_matches_unpartitioned():
    """Iterate parity on a (data=2, horizon=4) mesh: same lockstep
    iteration counts and matching solutions as solve_batch_shared."""
    qp, mspec, row_time = _build(batch=4, N=8, dim=2)
    hp, hspec = partition_qp(qp, mspec.block, 4, row_time)
    mesh = make_mesh(data=2, horizon=4)
    sol_h = solve_horizon_sharded(hp, hspec, mesh, PLAIN)
    assert np.all(np.asarray(sol_h.status) == int(Status.SOLVED)), \
        np.asarray(sol_h.status)

    sol_ref = solve_batch_shared(qp, PLAIN.replace(backend="chol"))
    assert np.all(np.asarray(sol_ref.status) == int(Status.SOLVED))
    np.testing.assert_array_equal(np.asarray(sol_h.iters),
                                  np.asarray(sol_ref.iters))
    x_h = np.asarray(sol_h.x).reshape(4, -1)
    x_r = np.asarray(sol_ref.x)
    dx = np.max(np.abs(x_h - x_r))
    assert dx < 1e-8 * (1.0 + np.max(np.abs(x_r))), dx


def test_horizon_mesh_shapes_agree():
    """The same program on (1x1), (1x4) and (4x1) meshes returns the
    same solution (cross-topology stability of the exact partition)."""
    qp, mspec, row_time = _build(batch=4, N=8, dim=2)
    hp, hspec = partition_qp(qp, mspec.block, 4, row_time)
    sols = []
    for d, h in ((1, 1), (1, 4), (4, 1)):
        mesh = make_mesh(data=d, horizon=h,
                         devices=jax.devices()[:d * h])
        sol = solve_horizon_sharded(hp, hspec, mesh, PLAIN)
        assert np.all(np.asarray(sol.status) == int(Status.SOLVED))
        sols.append(np.asarray(jax.device_get(sol.x)))
    for other in sols[1:]:
        assert np.max(np.abs(other - sols[0])) < 1e-8


def test_horizon_f32():
    """f32 (the hot-loop dtype) converges at a relaxed tolerance."""
    qp, mspec, row_time = _build(batch=2, N=8, dim=2)
    hp, hspec = partition_qp(qp, mspec.block, 4, row_time)
    mesh = make_mesh(data=1, horizon=2, devices=jax.devices()[:2])
    s = PLAIN.replace(precision="single", eps_abs=1e-4, eps_rel=1e-4)
    sol = solve_horizon_sharded(hp, hspec, mesh, s)
    assert np.all(np.asarray(sol.status) == int(Status.SOLVED))
    assert float(np.max(np.asarray(sol.r_prim))) < 1e-3


def test_horizon_l1_matches_unpartitioned():
    """L1 rows (banded CW min-fuel transcription): iterate parity with
    solve_batch_shared on a (data=2, horizon=4) mesh (VERDICT r4 item 4
    — the v1 scope was box-only)."""
    from admm_library.models.clohessy_wiltshire import (
        build_cw_rendezvous_sparse, cw_sparse_bounds_for_s0)
    from admm_library.parallel.horizon import cw_sparse_row_time
    from admm_library.problem import QPData

    N = 8
    qp1, spec = build_cw_rendezvous_sparse(
        np.array([5.0, -3.0, 1.0, 0.01, 0.02, -0.01]), N=N, dt=600.0,
        lam=0.1, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    s0s = (np.array([5.0, -3.0, 1.0, 0.01, 0.02, -0.01])
           + 0.1 * rng.standard_normal((4, 6)))
    l, u = cw_sparse_bounds_for_s0(qp1, spec, s0s)
    qp = QPData(P=qp1.P, q=qp1.q, A=qp1.A, l=l, u=u, lam=qp1.lam,
                cone=qp1.cone)
    row_time = cw_sparse_row_time(N)
    hp, hspec = partition_qp(qp, 9, 4, row_time)
    assert hspec.cone.m_l1 > 0
    mesh = make_mesh(data=2, horizon=4)
    sol_h = solve_horizon_sharded(hp, hspec, mesh, PLAIN)
    assert np.all(np.asarray(sol_h.status) == int(Status.SOLVED)), \
        np.asarray(sol_h.status)
    sol_ref = solve_batch_shared(qp, PLAIN.replace(backend="chol"))
    assert np.all(np.asarray(sol_ref.status) == int(Status.SOLVED))
    np.testing.assert_array_equal(np.asarray(sol_h.iters),
                                  np.asarray(sol_ref.iters))
    x_h = np.asarray(sol_h.x).reshape(4, -1)
    x_r = np.asarray(sol_ref.x)
    dx = np.max(np.abs(x_h - x_r))
    assert dx < 1e-8 * (1.0 + np.max(np.abs(x_r))), dx


def test_horizon_soc_matches_unpartitioned():
    """SOC blocks (low-thrust thrust-magnitude cones): iterate parity
    with solve_batch_shared on a (data=1, horizon=4) mesh."""
    from admm_library.models.low_thrust import (build_low_thrust_socp,
                                                    lt_bounds_for_s0)
    from admm_library.parallel.horizon import lt_row_time
    from admm_library.problem import QPData

    N = 8
    qp1, spec = build_low_thrust_socp(
        np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1]), N=N,
        dt=600.0, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    s0s = (np.array([500.0, -2000.0, 100.0, 0.0, 1.0, -0.1])
           + np.array([20, 20, 5, 0.01, 0.01, 0.01])
           * rng.standard_normal((2, 6)))
    l, u = lt_bounds_for_s0(qp1, spec, s0s)
    qp = QPData(P=qp1.P, q=qp1.q, A=qp1.A, l=l, u=u, lam=qp1.lam,
                cone=qp1.cone)
    row_time = lt_row_time(N)
    hp, hspec = partition_qp(qp, spec.block, 4, row_time)
    assert hspec.cone.m_soc > 0
    mesh = make_mesh(data=1, horizon=4, devices=jax.devices()[:4])
    s = PLAIN.replace(max_iter=40000)
    sol_h = solve_horizon_sharded(hp, hspec, mesh, s)
    assert np.all(np.asarray(sol_h.status) == int(Status.SOLVED)), \
        np.asarray(sol_h.status)
    sol_ref = solve_batch_shared(qp, s.replace(backend="chol"))
    assert np.all(np.asarray(sol_ref.status) == int(Status.SOLVED))
    np.testing.assert_array_equal(np.asarray(sol_h.iters),
                                  np.asarray(sol_ref.iters))
    x_h = np.asarray(sol_h.x).reshape(2, -1)
    x_r = np.asarray(sol_ref.x)
    dx = np.max(np.abs(x_h - x_r))
    assert dx < 1e-8 * (1.0 + np.max(np.abs(x_r))), dx
