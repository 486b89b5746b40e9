"""Aux subsystems: checkpoint/resume, profiling, runtime (SURVEY.md §5)."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status, solve
from admm_library.models.random_qp import random_box_qp
from admm_library.parallel import runtime
from admm_library.utils import checkpoint, profiling


def test_checkpoint_resume_warm_start(tmp_path):
    """Resume from checkpoint = warm start; converges almost immediately
    and elastic recovery reaches the same solution (SURVEY.md §5.3)."""
    qp = random_box_qp(jax.random.key(11), n=30, m=60, dtype=jnp.float64)
    s = Settings(eps_abs=1e-9, eps_rel=0.0)
    sol = solve(qp, s)
    path = os.path.join(tmp_path, "state.npz")
    checkpoint.save_state(path, sol)

    x0, z0, y0 = checkpoint.resume_warm_start(path)
    resumed = solve(qp, s, x0=x0, z0=z0, y0=y0)
    assert int(resumed.status) == int(Status.SOLVED)
    assert int(resumed.iters) <= 3 * s.check_every
    np.testing.assert_allclose(resumed.x, sol.x, atol=1e-6)


def test_checkpoint_atomic_overwrite(tmp_path):
    qp = random_box_qp(jax.random.key(12), n=10, m=20, dtype=jnp.float64)
    sol = solve(qp, Settings())
    path = os.path.join(tmp_path, "s.npz")
    checkpoint.save_state(path, sol)
    checkpoint.save_state(path, sol)      # overwrite in place
    st = checkpoint.load_state(path)
    assert set(st) >= {"x", "z", "y", "rho"}
    assert not os.path.exists(path + ".tmp")


def test_profiling_timed_excludes_compile():
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    out, t = profiling.timed(f, x)
    assert float(out) == 64.0 * 64 * 64
    assert t < 1.0          # steady-state call, not the compile


def test_runtime_mesh_axes():
    mesh = runtime.make_mesh()
    assert mesh.axis_names == (runtime.DATA_AXIS, runtime.HORIZON_AXIS)
    assert mesh.devices.size == jax.device_count()
    mesh2 = runtime.make_mesh(horizon=2)
    assert mesh2.shape[runtime.HORIZON_AXIS] == 2
    info = runtime.describe()
    assert info["process_count"] == 1
    # initialize() without coordinator env is a safe no-op.
    runtime.initialize()


def test_elastic_recovery_mid_solve(tmp_path):
    """Fault-injection drill (SURVEY.md §5.3): a run is killed mid-solve
    (simulated by a max_iter cap), its state checkpointed, and the solve
    resumed on a SMALLER device mesh from the snapshot — the resumed
    solve must converge to the same solution as an uninterrupted run."""
    from admm_library.models import monte_carlo as mc
    from admm_library.parallel.batch import (
        make_data_mesh, shard_batch, solve_batch_shared)

    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.key(21), batch=8, N=6, dim=2, dtype=jnp.float64)
    s = Settings(eps_abs=1e-8, eps_rel=1e-8)
    ref = solve_batch_shared(qp, s)
    assert np.all(np.asarray(ref.status) == int(Status.SOLVED))

    # "Fail" after a few checks on the full 8-device mesh.
    mesh8 = make_data_mesh(8)
    qp8, *_ = shard_batch(qp, mesh8)
    partial = solve_batch_shared(qp8, s.replace(max_iter=2 * s.check_every))
    path = os.path.join(tmp_path, "elastic.npz")
    checkpoint.save_state(path, partial)

    # Recover on a 4-device mesh, warm-started from the snapshot.
    mesh4 = make_data_mesh(4)
    x0, z0, y0 = checkpoint.resume_warm_start(path)
    qp4, x0, z0, y0 = shard_batch(qp, mesh4, x0, z0, y0)
    resumed = solve_batch_shared(qp4, s, x0=x0, z0=z0, y0=y0)
    assert np.all(np.asarray(resumed.status) == int(Status.SOLVED))
    np.testing.assert_allclose(
        np.asarray(resumed.x), np.asarray(ref.x), atol=1e-6)
