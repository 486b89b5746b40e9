"""Solver correctness vs constructed-KKT oracle (SURVEY.md §4.2-4.3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_library import Settings, Status, solve, solve_batch
from admm_library.core.scaling import ruiz_equilibrate
from admm_library.models.random_qp import random_box_qp, random_eq_ineq_qp
from admm_library.utils import oracle

TOL = Settings(eps_abs=1e-8, eps_rel=1e-8, max_iter=20000)


def test_ruiz_equilibration_norms():
    qp = random_box_qp(jax.random.key(0), n=30, m=50, dtype=jnp.float64)
    qps, sc = ruiz_equilibrate(qp, 15)
    colnorm = jnp.max(jnp.maximum(
        jnp.max(jnp.abs(qps.P), axis=0), jnp.max(jnp.abs(qps.A), axis=0)))
    rownorm_A = jnp.max(jnp.abs(qps.A), axis=1)
    assert float(jnp.max(rownorm_A)) < 1.3
    assert float(jnp.min(rownorm_A)) > 0.5
    assert float(colnorm) < 1.3
    # Scaled-back data reproduces the original.
    P_back = qps.P / sc.c / sc.d[:, None] / sc.d[None, :]
    np.testing.assert_allclose(P_back, qp.P, rtol=1e-10)


@pytest.mark.parametrize("backend", ["chol", "inv", "cg"])
def test_solve_known_solution(backend):
    qp, x_star, y_star = oracle.qp_known_solution(0, n=40, m=80)
    sol = solve(qp, TOL.replace(backend=backend))
    assert int(sol.status) == int(Status.SOLVED)
    np.testing.assert_allclose(sol.x, x_star, atol=1e-5)
    r_p, r_d, comp = oracle.kkt_residuals(qp, sol.x, sol.z, sol.y)
    assert float(r_p) < 1e-6 and float(r_d) < 1e-6 and float(comp) < 1e-5


def test_solve_matches_activeset_oracle():
    qp = random_box_qp(jax.random.key(1), n=30, m=60, dtype=jnp.float64)
    sol = solve(qp, TOL)
    x_ref, y_ref = oracle.solve_box_qp_activeset(qp)
    r_p, r_d, _ = oracle.kkt_residuals(
        qp, x_ref, jnp.asarray(qp.A) @ x_ref, y_ref)
    # Oracle itself must be valid before we compare against it.
    assert float(r_p) < 1e-7 and float(r_d) < 1e-7
    np.testing.assert_allclose(sol.x, x_ref, atol=1e-5)


def test_solve_config1_shape():
    """Benchmark config 1: n=100, m=200 random dense box QP to 1e-6."""
    qp = random_box_qp(jax.random.key(2), n=100, m=200, dtype=jnp.float64)
    sol = solve(qp, Settings(eps_abs=1e-6, eps_rel=1e-6))
    assert int(sol.status) == int(Status.SOLVED)
    assert float(sol.r_prim) < 1e-4  # unscaled abs resid at OSQP criterion
    r_p, r_d, _ = oracle.kkt_residuals(qp, sol.x, sol.z, sol.y)
    assert float(r_p) < 1e-5 and float(r_d) < 1e-5


def test_equality_rows():
    qp = random_eq_ineq_qp(jax.random.key(3), dtype=jnp.float64)
    sol = solve(qp, TOL)
    assert int(sol.status) == int(Status.SOLVED)
    # equality rows hold tightly
    Ax = jnp.asarray(qp.A) @ sol.x
    np.testing.assert_allclose(Ax[:10], qp.l[:10], atol=1e-6)


def test_warm_start_fewer_iters():
    qp = random_box_qp(jax.random.key(4), n=50, m=100, dtype=jnp.float64)
    s = Settings(eps_abs=1e-9, eps_rel=0.0)
    cold = solve(qp, s)
    warm = solve(qp, s, x0=cold.x, z0=cold.z, y0=cold.y)
    assert int(warm.iters) <= int(cold.iters)
    # Nearly immediate: hybrid precision roundtrips the warm start through
    # f32 (phase 1), so the staged pipeline needs a few check intervals
    # (f32 phase + a re-centered round + the f64 finish each take >= 1)
    # to recover the last digits -> bound is 5 checks, not 1.
    assert int(warm.iters) <= 5 * s.check_every


def test_deterministic_bitwise():
    """Bitwise-stable convergence trace across runs (BASELINE north_star)."""
    qp = random_box_qp(jax.random.key(5), n=40, m=80, dtype=jnp.float64)
    s = Settings(history=32)
    a = solve(qp, s)
    b = solve(qp, s)
    assert np.array_equal(np.asarray(a.x), np.asarray(b.x))
    assert np.array_equal(np.asarray(a.history), np.asarray(b.history))


def test_residual_history_ring_buffer():
    qp = random_box_qp(jax.random.key(6), n=30, m=60, dtype=jnp.float64)
    sol = solve(qp, Settings(history=64, check_every=25))
    h = np.asarray(sol.history)
    used = h[h[:, 0] > 0]
    assert used.shape[0] >= 1
    # Iterations recorded in ascending order; residuals broadly decreasing.
    assert np.all(np.diff(used[:, 0]) > 0)
    assert used[-1, 1] <= used[0, 1] * 10


def test_primal_infeasible_detection():
    # x in R, constraints: x <= -1 and x >= 1 -> infeasible.
    P = jnp.eye(1, dtype=jnp.float64)
    q = jnp.zeros(1, dtype=jnp.float64)
    A = jnp.asarray([[1.0], [1.0]], dtype=jnp.float64)
    l = jnp.asarray([-jnp.inf, 1.0], dtype=jnp.float64)
    u = jnp.asarray([-1.0, jnp.inf], dtype=jnp.float64)
    from admm_library.problem import make_qp
    sol = solve(make_qp(P, q, A, l, u), Settings())
    assert int(sol.status) == int(Status.PRIMAL_INFEASIBLE)


def test_dual_infeasible_detection():
    # min -x s.t. x >= 0 -> unbounded below (dual infeasible).
    P = jnp.zeros((1, 1), dtype=jnp.float64)
    q = jnp.asarray([-1.0], dtype=jnp.float64)
    A = jnp.asarray([[1.0]], dtype=jnp.float64)
    l = jnp.asarray([0.0], dtype=jnp.float64)
    u = jnp.asarray([jnp.inf], dtype=jnp.float64)
    from admm_library.problem import make_qp
    sol = solve(make_qp(P, q, A, l, u), Settings())
    assert int(sol.status) == int(Status.DUAL_INFEASIBLE)


def test_solve_batch_vmap():
    keys = jax.random.split(jax.random.key(7), 4)
    qps = [random_box_qp(k, n=20, m=40, dtype=jnp.float64) for k in keys]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    sols = solve_batch(batch, TOL)
    assert sols.x.shape == (4, 20)
    assert np.all(np.asarray(sols.status) == int(Status.SOLVED))
    for i, qp in enumerate(qps):
        single = solve(qp, TOL)
        np.testing.assert_allclose(sols.x[i], single.x, atol=1e-6)
