"""Condensed-KKT factor/solve backends (components K1/K3-ref, SURVEY.md §2.2).

The ADMM x-update solves the regularized KKT system; we use the condensed
form (OSQP §4, arXiv:1711.08013):

    M = P + sigma*I + Aᵀ diag(rho) A,      M x̃ = rhs

M is symmetric positive definite. Backends:

  'chol' — dense Cholesky, cached across iterations; triangular solves per
           iteration. Reference-quality accuracy.
  'inv'  — explicit M⁻¹, cached; each iteration's solve is ONE matmul
           (a batched (B,n)x(n,n) product for the Monte-Carlo
           shared-matrix batch) instead of two sequential triangular
           solves. Optional iterative refinement recovers Cholesky-level
           accuracy.
  'cg'   — matrix-free conjugate gradient on M (rho enters trivially, so
           adaptive rho needs no refactorisation). Lockstep-batched with
           per-problem convergence masking.

The factor is a plain dict pytree so it threads through `lax.while_loop`
carries and `vmap` unchanged. All solves accept rhs with arbitrary leading
batch dims against an unbatched factor (the shared-matrix fast path).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from . import banded as banded_ops
from .. import xprec


def condensed_matrix(P, A, sigma, rho_vec):
    """M = P + sigma I + Aᵀ diag(rho) A (supports leading batch dims)."""
    n = P.shape[-1]
    AtRA = xprec.einsum("...ji,...j,...jk->...ik", A, rho_vec, A)
    eye = jnp.eye(n, dtype=P.dtype)
    return P + sigma * eye + AtRA


def factor_condensed(P, A, sigma, rho_vec, backend: str, band_block: int = 0,
                     spike_parts: int = 0):
    """Build the cached factor for the requested backend.

    Returns a dict pytree. 'M' is kept for refinement and CG matvecs.

    Traced under exact-f32 dot precision: reduced-precision dot passes
    (bf16, TF32) leave ||I - Minv M|| too large for the solver to
    converge (see xprec module docstring).
    """
    with xprec.highest():
        return _factor_condensed(P, A, sigma, rho_vec, backend, band_block,
                                 spike_parts)


def _factor_condensed(P, A, sigma, rho_vec, backend: str, band_block: int,
                      spike_parts: int = 0):
    if backend == "cg":
        # Matrix-free: keep the operator pieces only.
        return {"P": P, "A": A, "rho": rho_vec,
                "sigma": jnp.asarray(sigma, P.dtype)}
    M = condensed_matrix(P, A, sigma, rho_vec)
    if backend == "chol":
        L = jnp.linalg.cholesky(M)
        return {"M": M, "L": L}
    if backend == "inv":
        L = jnp.linalg.cholesky(M)
        # Match L's batch dims explicitly: triangular_solve does not
        # broadcast an unbatched rhs against a batched L.
        eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype),
                               L.shape)
        Linv = solve_triangular(L, eye, lower=True)
        Minv = xprec.einsum("...ji,...jk->...ik", Linv, Linv)
        return {"M": M, "Minv": Minv}
    if backend == "banded":
        if band_block <= 0:
            raise ValueError("banded backend requires band_block > 0")
        diag, low = banded_ops.dense_to_block_tridiag(M, band_block)
        Ld, Ll = banded_ops.block_tridiag_cholesky(diag, low)
        return {"M": M, "Ld": Ld, "Ll": Ll}
    if backend == "spike":
        if band_block <= 0 or spike_parts <= 0:
            raise ValueError(
                "spike backend requires band_block > 0 and spike_parts > 0")
        from . import spike as spike_ops
        fac = spike_ops.spike_factor(M, band_block, spike_parts)
        return {"M": M, **fac}
    raise ValueError(f"unknown backend {backend!r}")


def _chol_solve(L, rhs):
    """Solve (L Lᵀ) x = rhs.

    Two batching regimes:
      * shared factor: L (n, n), rhs (..., n) — the Monte-Carlo fast
        path; all lanes go through one pair of triangular solves.
      * matched batch: L (..., n, n), rhs (..., n) with identical
        leading dims — per-block factors (consensus P2).
    """
    n = L.shape[-1]
    if L.ndim == 2:
        flat = rhs.reshape(-1, n).T                  # (n, K)
        y = solve_triangular(L, flat, lower=True)
        x = solve_triangular(L, y, lower=True, trans=1)
        return x.T.reshape(rhs.shape)
    if rhs.ndim == L.ndim - 1:
        y = solve_triangular(L, rhs[..., None], lower=True)
        x = solve_triangular(L, y, lower=True, trans=1)
        return x[..., 0]
    # Extra leading batch dims on rhs against per-block factors (the
    # scenario-batched consensus case: L (S, n, n), rhs (B..., S, n)).
    # Fold the scenario dims into rhs COLUMNS so each block does one
    # multi-rhs triangular solve — triangular_solve does not rank-
    # broadcast.
    lead = rhs.shape[:-2]
    S = L.shape[0]
    K = 1
    for d in lead:
        K *= d
    r = jnp.moveaxis(rhs.reshape((K, S, n)), 0, -1)  # (S, n, K)
    y = solve_triangular(L, r, lower=True)
    x = solve_triangular(L, y, lower=True, trans=1)
    return jnp.moveaxis(x, -1, 0).reshape(rhs.shape)


def _matvec_M(fac, v):
    """M @ v for rhs-batched v against an unbatched factor."""
    if "M" in fac:
        return xprec.einsum("...ij,...j->...i", fac["M"], v)
    Av = xprec.einsum("...ij,...j->...i", fac["A"], v)
    AtRAv = xprec.einsum("...ji,...j->...i", fac["A"], fac["rho"] * Av)
    Pv = xprec.einsum("...ij,...j->...i", fac["P"], v)
    return Pv + fac["sigma"] * v + AtRAv


def cg_solve(fac, rhs, x0=None, tol=1e-9, max_iter=200):
    """Lockstep-batched conjugate gradient on M x = rhs.

    Runs all lanes of the leading batch dims together inside one
    `lax.while_loop`; converged lanes freeze via masking. Matrix-free:
    uses P/A/rho matvecs so adaptive rho never forces a refactor.
    """
    x = jnp.zeros_like(rhs) if x0 is None else x0
    r = rhs - _matvec_M(fac, x)
    p = r
    rs = jnp.sum(r * r, axis=-1)
    tol2 = (tol * tol) * jnp.maximum(jnp.sum(rhs * rhs, axis=-1), 1.0)

    def cond(carry):
        x, r, p, rs, it = carry
        return (it < max_iter) & jnp.any(rs > tol2)

    def body(carry):
        x, r, p, rs, it = carry
        Mp = _matvec_M(fac, p)
        pMp = jnp.sum(p * Mp, axis=-1)
        active = rs > tol2
        alpha = jnp.where(active, rs / jnp.where(pMp > 0, pMp, 1.0), 0.0)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Mp
        rs_new = jnp.sum(r * r, axis=-1)
        beta = jnp.where(active, rs_new / jnp.where(rs > 0, rs, 1.0), 0.0)
        p = r + beta[..., None] * p
        rs = jnp.where(active, rs_new, rs)
        return x, r, p, rs, it + 1

    x, r, p, rs, it = jax.lax.while_loop(
        cond, body, (x, r, p, rs, jnp.asarray(0, jnp.int32)))
    return x


def solve_condensed(fac, rhs, backend: str, refine_steps: int = 0,
                    cg_tol: float = 1e-9, cg_max_iter: int = 200):
    """Solve M x = rhs with the cached factor; optional iterative refinement.

    rhs: (..., n); factor may be unbatched (shared) while rhs is batched —
    the shared-matrix Monte-Carlo fast path (SURVEY.md §6 envelope).
    """
    if backend == "chol":
        x = _chol_solve(fac["L"], rhs)
    elif backend == "inv":
        x = xprec.einsum("...ij,...j->...i", fac["Minv"], rhs)
    elif backend == "banded":
        x = banded_ops.block_tridiag_solve(fac["Ld"], fac["Ll"], rhs)
    elif backend == "spike":
        from . import spike as spike_ops
        x = spike_ops.spike_solve(fac, rhs)
    elif backend == "cg":
        return cg_solve(fac, rhs, tol=cg_tol, max_iter=cg_max_iter)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    for _ in range(refine_steps):
        r = rhs - _matvec_M(fac, x)
        if backend == "chol":
            x = x + _chol_solve(fac["L"], r)
        elif backend == "inv":
            x = x + xprec.einsum("...ij,...j->...i", fac["Minv"], r)
        elif backend == "spike":
            from . import spike as spike_ops
            x = x + spike_ops.spike_solve(fac, r)
        else:
            x = x + banded_ops.block_tridiag_solve(fac["Ld"], fac["Ll"], r)
    return x
