"""Row-sharded single-problem solver — P3 (SURVEY.md §2.2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_library import Settings, Status, solve
from admm_library.models.random_qp import random_box_qp
from admm_library.parallel.batch import make_data_mesh
from admm_library.parallel.rowshard import solve_rowsharded


def test_rowsharded_matches_single():
    qp = random_box_qp(jax.random.key(21), n=32, m=64, dtype=jnp.float64)
    mesh = make_data_mesh(8)
    s = Settings(eps_abs=1e-8, eps_rel=1e-8, precision="single",
                 adaptive_rho=False)
    sol = solve_rowsharded(qp, mesh, s)
    assert int(sol.status) == int(Status.SOLVED)
    ref = solve(qp, Settings(eps_abs=1e-9, eps_rel=1e-9))
    np.testing.assert_allclose(sol.x, ref.x, atol=1e-5)
    # Assembled z matches A x.
    np.testing.assert_allclose(
        np.asarray(qp.A) @ np.asarray(sol.x), sol.z, atol=1e-6)


def test_rowsharded_rejects_straddling_soc():
    from admm_library.problem import ConeSpec, QPData
    n, m = 16, 16
    cone = ConeSpec(m_box=6, soc_dims=(5, 5))
    qp = QPData(
        P=jnp.eye(n, dtype=jnp.float64),
        q=jnp.zeros(n, dtype=jnp.float64),
        A=jnp.eye(m, n, dtype=jnp.float64),
        l=jnp.full(m, -jnp.inf, dtype=jnp.float64),
        u=jnp.full(m, jnp.inf, dtype=jnp.float64),
        lam=jnp.zeros(0, dtype=jnp.float64), cone=cone)
    mesh = make_data_mesh(8)
    with pytest.raises(ValueError):
        solve_rowsharded(qp, mesh, Settings())


def test_rowsharded_l1_matches_single():
    """Rowsharded L1 (min-fuel style) problem end-to-end vs single-chip
    (VERDICT r1 item 6)."""
    from admm_library.problem import ConeSpec, QPData

    rng = np.random.default_rng(5)
    n, m_box, m_l1 = 24, 32, 16
    m = m_box + m_l1
    A = jnp.asarray(rng.standard_normal((m, n)), jnp.float64)
    Pm = jnp.asarray(np.eye(n) * 0.5, jnp.float64)
    q = jnp.asarray(rng.standard_normal(n), jnp.float64)
    l = jnp.concatenate([jnp.full((m_box,), -2.0),
                         jnp.full((m_l1,), -jnp.inf)]).astype(jnp.float64)
    u = -l
    lam = jnp.full((m_l1,), 0.3, jnp.float64)
    qp = QPData(P=Pm, q=q, A=A, l=l, u=u, lam=lam,
                cone=ConeSpec(m_box=m_box, m_l1=m_l1))
    mesh = make_data_mesh(8)
    s = Settings(eps_abs=1e-8, eps_rel=1e-8, precision="single")
    sol = solve_rowsharded(qp, mesh, s)
    assert int(sol.status) == int(Status.SOLVED)
    ref = solve(qp, Settings(eps_abs=1e-9, eps_rel=1e-9))
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x),
                               atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(qp.A) @ np.asarray(sol.x), np.asarray(sol.z),
        atol=1e-6)


def test_rowsharded_soc_matches_single():
    """Rowsharded SOC problem (one cone per shard after interleave)
    solved end-to-end vs single-chip."""
    from admm_library.problem import ConeSpec, QPData

    rng = np.random.default_rng(7)
    ndev, d = 8, 4
    n = 24
    m_box = 16
    m_soc = ndev * d
    m = m_box + m_soc
    A = jnp.asarray(rng.standard_normal((m, n)) * 0.5, jnp.float64)
    Pm = jnp.asarray(np.eye(n), jnp.float64)
    q = jnp.asarray(rng.standard_normal(n), jnp.float64)
    l = jnp.concatenate([
        jnp.full((m_box,), -3.0),
        jnp.full((m_soc,), -jnp.inf)]).astype(jnp.float64)
    u = jnp.concatenate([
        jnp.full((m_box,), 3.0),
        jnp.full((m_soc,), jnp.inf)]).astype(jnp.float64)
    qp = QPData(P=Pm, q=q, A=A, l=l, u=u,
                lam=jnp.zeros(0, dtype=jnp.float64),
                cone=ConeSpec(m_box=m_box, soc_dims=(d,) * ndev))
    mesh = make_data_mesh(8)
    s = Settings(eps_abs=1e-7, eps_rel=1e-7, precision="single",
                 max_iter=50000)
    sol = solve_rowsharded(qp, mesh, s)
    assert int(sol.status) == int(Status.SOLVED)
    ref = solve(qp, Settings(eps_abs=1e-9, eps_rel=1e-9, max_iter=50000))
    np.testing.assert_allclose(np.asarray(sol.x), np.asarray(ref.x),
                               atol=1e-5)
    # Every SOC block of z is feasible: ||tail|| <= head.
    z = np.asarray(sol.z)[m_box:].reshape(ndev, d)
    assert np.all(np.linalg.norm(z[:, 1:], axis=1) <= z[:, 0] + 1e-6)


def test_rowsharded_warm_start():
    qp = random_box_qp(jax.random.key(22), n=32, m=64, dtype=jnp.float64)
    mesh = make_data_mesh(8)
    s = Settings(eps_abs=1e-8, eps_rel=1e-8, precision="single")
    sol = solve_rowsharded(qp, mesh, s)
    assert int(sol.status) == int(Status.SOLVED)
    warm = solve_rowsharded(qp, mesh, s, x0=sol.x, z0=sol.z, y0=sol.y)
    assert int(warm.status) == int(Status.SOLVED)
    assert int(warm.iters) <= max(int(sol.iters) // 4, s.check_every)


def test_rowsharded_primal_infeasible():
    """A6 on the row-sharded path (VERDICT r2 item 5): a constructed
    infeasible problem must return PRIMAL_INFEASIBLE, not burn
    max_iter."""
    from admm_library.problem import make_qp
    n, m = 8, 16
    rng = np.random.default_rng(3)
    Arows = rng.standard_normal((8, n))
    # Rows i and i+8 share a'x but demand a'x <= -1 and a'x >= 1.
    A = np.vstack([Arows, Arows])
    l = np.concatenate([np.full(8, -np.inf), np.full(8, 1.0)])
    u = np.concatenate([np.full(8, -1.0), np.full(8, np.inf)])
    qp = make_qp(jnp.eye(n, dtype=jnp.float64),
                 jnp.zeros(n, dtype=jnp.float64),
                 jnp.asarray(A, jnp.float64),
                 jnp.asarray(l, jnp.float64), jnp.asarray(u, jnp.float64))
    mesh = make_data_mesh(8)
    sol = solve_rowsharded(qp, mesh, Settings(precision="single"))
    assert int(sol.status) == int(Status.PRIMAL_INFEASIBLE)


def test_rowsharded_dual_infeasible():
    """Unbounded problem over the row shards -> DUAL_INFEASIBLE."""
    from admm_library.problem import make_qp
    n, m = 8, 16
    A = np.eye(m, n)
    A[8:] = np.eye(8, n)
    l = np.zeros(m)
    u = np.full(m, np.inf)
    q = -np.ones(n)
    qp = make_qp(jnp.zeros((n, n), dtype=jnp.float64),
                 jnp.asarray(q, jnp.float64), jnp.asarray(A, jnp.float64),
                 jnp.asarray(l, jnp.float64), jnp.asarray(u, jnp.float64))
    mesh = make_data_mesh(8)
    sol = solve_rowsharded(qp, mesh, Settings(precision="single"))
    assert int(sol.status) == int(Status.DUAL_INFEASIBLE)


def test_rowsharded_hybrid_absolute_eps():
    """Hybrid rowshard path (f32 phase + re-centered f32 rounds) reaches
    ABSOLUTE 1e-6 residuals on an f32-input problem — the path the
    rowshard bench config runs (VERDICT r2 item 6)."""
    from admm_library.parallel.rowshard import solve_rowsharded_hybrid

    qp = random_box_qp(jax.random.key(33), n=32, m=64, dtype=jnp.float32)
    mesh = make_data_mesh(8)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6)
    sol = solve_rowsharded_hybrid(qp, mesh, s)
    assert int(sol.status) == int(Status.SOLVED)
    # Residuals recomputed in f64 on the original data inside the
    # driver; assert against the mixed criterion's absolute floor.
    assert float(sol.r_prim) <= 1e-5
    assert float(sol.r_dual) <= 1e-5
    ref = solve(qp.astype(jnp.float64),
                Settings(eps_abs=1e-9, eps_rel=1e-9))
    np.testing.assert_allclose(sol.x, ref.x, atol=1e-4, rtol=1e-4)
