"""Unit tests for L0 KKT backends K1/K2/K3 (SURVEY.md §4.1)."""
import jax.numpy as jnp
import numpy as np
import pytest

from admm_library.ops import banded, kkt


def _random_system(seed, n=40, m=60):
    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    P = R @ R.T + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    rho = np.abs(rng.standard_normal(m)) + 0.5
    rhs = rng.standard_normal(n)
    return (jnp.asarray(P), jnp.asarray(A), jnp.asarray(rho),
            jnp.asarray(rhs))


@pytest.mark.parametrize("backend", ["chol", "inv", "cg"])
def test_condensed_solve_residual(backend):
    P, A, rho, rhs = _random_system(0)
    sigma = 1e-6
    fac = kkt.factor_condensed(P, A, sigma, rho, backend)
    x = kkt.solve_condensed(fac, rhs, backend, cg_tol=1e-12, cg_max_iter=500)
    M = kkt.condensed_matrix(P, A, sigma, rho)
    assert float(jnp.max(jnp.abs(M @ x - rhs))) < 1e-8


@pytest.mark.parametrize("backend", ["chol", "inv"])
def test_condensed_solve_batched_rhs(backend):
    P, A, rho, _ = _random_system(1)
    rhs = jnp.asarray(np.random.default_rng(2).standard_normal((7, 40)))
    fac = kkt.factor_condensed(P, A, 1e-6, rho, backend)
    x = kkt.solve_condensed(fac, rhs, backend)
    M = kkt.condensed_matrix(P, A, 1e-6, rho)
    assert float(jnp.max(jnp.abs(rhs - x @ M.T))) < 1e-8


@pytest.mark.parametrize("backend", ["chol", "inv"])
def test_condensed_factor_batched_matrix(backend):
    """Batched (blocks, n, n) factor — the consensus per-block shape.

    The 'inv' factor's identity rhs is broadcast to L's batch dims
    explicitly, because a triangular_solve lowering need not broadcast
    an unbatched rhs against a batched L. The CPU backend accepts
    either, so this test guards the SHAPE CONTRACT only; the lowering
    on the card is exercised by chip_smoke.py's consensus_mc phase.
    """
    sys = [_random_system(s, n=24, m=30) for s in range(3)]
    P = jnp.stack([t[0] for t in sys])
    A = jnp.stack([t[1] for t in sys])
    rho = jnp.stack([t[2] for t in sys])
    rhs = jnp.stack([t[3] for t in sys])
    fac = kkt.factor_condensed(P, A, 1e-6, rho, backend)
    x = kkt.solve_condensed(fac, rhs, backend)
    M = kkt.condensed_matrix(P, A, 1e-6, rho)
    r = jnp.einsum("bij,bj->bi", M, x) - rhs
    assert float(jnp.max(jnp.abs(r))) < 1e-8


def test_cg_batched_lockstep():
    P, A, rho, _ = _random_system(3)
    rhs = jnp.asarray(np.random.default_rng(4).standard_normal((5, 40)))
    fac = kkt.factor_condensed(P, A, 1e-6, rho, "cg")
    x = kkt.solve_condensed(fac, rhs, "cg", cg_tol=1e-12, cg_max_iter=500)
    M = kkt.condensed_matrix(P, A, 1e-6, rho)
    assert float(jnp.max(jnp.abs(rhs - x @ M.T))) < 1e-8


def _block_tridiag_dense(seed, N=8, b=6):
    """Random SPD block-tridiagonal matrix as a dense array."""
    rng = np.random.default_rng(seed)
    n = N * b
    M = np.zeros((n, n))
    for i in range(N):
        D = rng.standard_normal((b, b))
        M[i*b:(i+1)*b, i*b:(i+1)*b] = D @ D.T + (2.0 + b) * np.eye(b)
        if i < N - 1:
            B = rng.standard_normal((b, b)) * 0.3
            M[(i+1)*b:(i+2)*b, i*b:(i+1)*b] = B
            M[i*b:(i+1)*b, (i+1)*b:(i+2)*b] = B.T
    return jnp.asarray(M)


def test_block_extraction_roundtrip():
    M = _block_tridiag_dense(5)
    diag, low = banded.dense_to_block_tridiag(M, 6)
    assert diag.shape == (8, 6, 6)
    assert low.shape == (7, 6, 6)
    np.testing.assert_allclose(diag[2], M[12:18, 12:18])
    np.testing.assert_allclose(low[0], M[6:12, 0:6])


def test_block_tridiag_cholesky_matches_dense():
    """K2 vs K1 on the same banded problem (SURVEY.md §4.1: agree ~1e-10)."""
    M = _block_tridiag_dense(6)
    diag, low = banded.dense_to_block_tridiag(M, 6)
    Ld, Ll = banded.block_tridiag_cholesky(diag, low)
    rhs = jnp.asarray(np.random.default_rng(7).standard_normal(48))
    x_band = banded.block_tridiag_solve(Ld, Ll, rhs)
    x_dense = jnp.linalg.solve(M, rhs)
    np.testing.assert_allclose(x_band, x_dense, atol=1e-10)


def test_block_tridiag_solve_batched():
    M = _block_tridiag_dense(8)
    diag, low = banded.dense_to_block_tridiag(M, 6)
    Ld, Ll = banded.block_tridiag_cholesky(diag, low)
    rhs = jnp.asarray(np.random.default_rng(9).standard_normal((3, 48)))
    x = banded.block_tridiag_solve(Ld, Ll, rhs)
    np.testing.assert_allclose(x, jnp.linalg.solve(M, rhs.T).T, atol=1e-10)


def test_banded_backend_through_kkt():
    """banded backend on an MPC-like condensed matrix."""
    rng = np.random.default_rng(10)
    N, b = 6, 4
    n = N * b
    # Build P block-diagonal and A with one-step couplings so M is
    # block-tridiagonal.
    P = np.zeros((n, n))
    for i in range(N):
        D = rng.standard_normal((b, b))
        P[i*b:(i+1)*b, i*b:(i+1)*b] = D @ D.T + np.eye(b)
    A = np.zeros((N * b, n))
    for i in range(N):
        A[i*b:(i+1)*b, i*b:(i+1)*b] = np.eye(b)
        if i > 0:
            A[i*b:(i+1)*b, (i-1)*b:i*b] = rng.standard_normal((b, b)) * 0.2
    rho = np.abs(rng.standard_normal(N * b)) + 0.5
    P, A, rho = jnp.asarray(P), jnp.asarray(A), jnp.asarray(rho)
    fac = kkt.factor_condensed(P, A, 1e-6, rho, "banded", band_block=b)
    rhs = jnp.asarray(rng.standard_normal(n))
    x = kkt.solve_condensed(fac, rhs, "banded")
    M = kkt.condensed_matrix(P, A, 1e-6, rho)
    assert float(jnp.max(jnp.abs(M @ x - rhs))) < 1e-9
