"""SPIKE partitioned block-tridiagonal KKT backend (ops/spike.py).

Covers: exactness vs dense on random SPD block-tridiagonal systems and
the real MPC condensed matrix; the kkt.factor_condensed/solve_condensed
'spike' backend plumbing; and ADMM-iterate equivalence — the spike
x-update must reproduce the un-partitioned solver's iterates (same
iteration count, matching solution), which is the whole point of the
backend (no consensus iteration penalty).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_library import Settings, solve
from admm_library.models.monte_carlo import monte_carlo_mpc
from admm_library.ops import kkt
from admm_library.ops.spike import spike_factor, spike_solve
from admm_library.parallel.batch import solve_batch_shared
from admm_library.solution import Status


def _random_block_tridiag(rng, N, b, dtype=jnp.float64):
    diag = rng.standard_normal((N, b, b))
    diag = np.einsum("nij,nkj->nik", diag, diag) + 5 * np.eye(b)
    low = 0.3 * rng.standard_normal((N - 1, b, b))
    n = N * b
    M = np.zeros((n, n))
    for i in range(N):
        M[i * b:(i + 1) * b, i * b:(i + 1) * b] = diag[i]
    for i in range(N - 1):
        M[(i + 1) * b:(i + 2) * b, i * b:(i + 1) * b] = low[i]
        M[i * b:(i + 1) * b, (i + 1) * b:(i + 2) * b] = low[i].T
    return jnp.asarray(M, dtype)


@pytest.mark.parametrize("parts", [2, 4, 10])
def test_spike_matches_dense(parts):
    rng = np.random.default_rng(0)
    M = _random_block_tridiag(rng, N=20, b=6)
    fac = spike_factor(M, 6, parts)
    rhs = jnp.asarray(rng.standard_normal((5, 120)))
    x = spike_solve(fac, rhs)
    err = jnp.max(jnp.abs(jnp.einsum("ij,bj->bi", M, x) - rhs))
    assert float(err) < 1e-10


def test_spike_on_mpc_condensed():
    """Real MPC condensed matrix (the exact production use)."""
    qp, spec, _ = monte_carlo_mpc(jax.random.PRNGKey(0), batch=4, N=50,
                                  dim=3, dtype=jnp.float64)
    rho = 0.1 * jnp.ones(qp.m, jnp.float64)
    M = kkt.condensed_matrix(qp.P, qp.A, 1e-6, rho)
    fac = spike_factor(M, spec.block, 10)
    rng = np.random.default_rng(1)
    rhs = jnp.asarray(rng.standard_normal((3, qp.n)))
    x = spike_solve(fac, rhs)
    err = jnp.max(jnp.abs(jnp.einsum("ij,bj->bi", M, x) - rhs))
    assert float(err) < 1e-9


def test_spike_backend_plumbing():
    """factor_condensed/solve_condensed with backend='spike' agree with
    'chol' on the same system, including iterative refinement."""
    qp, spec, _ = monte_carlo_mpc(jax.random.PRNGKey(2), batch=2, N=10,
                                  dim=2, dtype=jnp.float64)
    rho = 0.3 * jnp.ones(qp.m, jnp.float64)
    fs = kkt.factor_condensed(qp.P, qp.A, 1e-6, rho, "spike",
                              band_block=spec.block, spike_parts=5)
    fc = kkt.factor_condensed(qp.P, qp.A, 1e-6, rho, "chol")
    rng = np.random.default_rng(3)
    rhs = jnp.asarray(rng.standard_normal((4, qp.n)))
    xs = kkt.solve_condensed(fs, rhs, "spike", refine_steps=1)
    xc = kkt.solve_condensed(fc, rhs, "chol")
    assert float(jnp.max(jnp.abs(xs - xc))) < 1e-9


def test_spike_admm_iterates_match_unpartitioned():
    """THE property that kills P2's iteration penalty: ADMM with the
    spike x-update takes the SAME number of iterations as the
    un-partitioned 'chol' solver on the flagship Monte-Carlo batch and
    lands on the same solution (the x-update solves the same system
    exactly, so the iterate sequences coincide up to roundoff)."""
    qp, spec, _ = monte_carlo_mpc(jax.random.PRNGKey(0), batch=8, N=50,
                                  dim=3, dtype=jnp.float64)
    base = Settings(eps_abs=1e-6, eps_rel=1e-6, precision="double",
                    band_block=spec.block)
    sol_ref = solve_batch_shared(qp, base.replace(backend="chol"))
    sol_spk = solve_batch_shared(
        qp, base.replace(backend="spike", spike_parts=10))
    assert np.all(np.asarray(sol_ref.status) == int(Status.SOLVED))
    assert np.all(np.asarray(sol_spk.status) == int(Status.SOLVED))
    it_ref = np.asarray(sol_ref.iters)
    it_spk = np.asarray(sol_spk.iters)
    # Identical systems solved exactly => identical check-cadence
    # iteration counts (roundoff can move a lane across a check
    # boundary in principle; require exact match — observed stable).
    np.testing.assert_array_equal(it_ref, it_spk)
    dx = np.max(np.abs(np.asarray(sol_ref.x) - np.asarray(sol_spk.x)))
    assert dx < 1e-6 * (1.0 + np.max(np.abs(np.asarray(sol_ref.x))))


def test_spike_single_solve():
    """solve() accepts backend='spike' for a single banded QP."""
    from admm_library.models.double_integrator import build_mpc_qp

    s0 = np.array([1.0, -2.0, 0.5, 0.1, -0.1, 0.0])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=20, dim=3)
    s = Settings(eps_abs=1e-6, eps_rel=1e-6, band_block=spec.block,
                 backend="spike", spike_parts=4, precision="double")
    sol = solve(qp, s)
    assert int(sol.status) == int(Status.SOLVED)
    assert float(sol.r_prim) < 1e-6 and float(sol.r_dual) < 1e-6
