"""Partitioned block-tridiagonal KKT solver (SPIKE / nested dissection).

The horizon-partitioned answer to P2's iteration penalty: consensus-ADMM
(parallel/consensus*.py) duplicates boundary states and negotiates them
through penalty averaging, which propagates boundary information ONE
block-hop per iteration — measured 1525 lockstep iterations vs 325 for
the same physics un-partitioned (PERF.md; Nesterov momentum on the
duals diverges or chatters, documented there). This module removes the
penalty a different way: solve the x-update's condensed system

    M x = rhs,   M = P + sigma I + A' diag(rho) A   (block-tridiagonal)

EXACTLY across the partition, so the ADMM iterates are IDENTICAL to the
un-partitioned single-chip solver — same 325 iterations by construction
— while the solve itself decomposes over horizon pieces:

  * partition the N diagonal blocks into `parts` pieces; the LAST block
    of each piece is its separator, the first Np-1 blocks its interior;
  * pre-factor each interior (dense inverse: the per-iteration interior
    solve becomes one batched matmul, the same trade the 'inv'
    backend makes — SURVEY.md §2.2 K1) and the two "spikes"
    V = A_int^-1 e_f E (left coupling) and W = A_int^-1 e_l B (right);
  * eliminate interiors onto the separators: the Schur complement is
    block-TRIDIAGONAL in the `parts` separators (b x b blocks), factored
    once by the existing lax.scan block Cholesky (ops/banded.py);
  * per solve: batched interior matmul, tiny separator solve (scan of
    length `parts`), batched back-substitution matmul.

Sharded over a 'horizon' mesh axis the same math needs exactly one
ppermute (neighbor g_first exchange), one all_gather of the reduced
rhs (parts*b floats ~ a few hundred bytes, ICI), a redundant separator
solve on every device, and the local back-substitution — a handful of
tiny collectives per ADMM iteration instead of a convergence penalty.

Reference basis: the reference repo ships no solver code at all
(/root/reference/README.md:1-2 is the entire statement; SURVEY.md §0);
the algorithm is the standard SPIKE / substructuring decomposition of a
banded SPD system, specialised to the MPC block-tridiagonal KKT
(SURVEY.md §2.2 K2, §7 "scan-based block elimination ... is the basis
for the P2 partitioning").
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

from . import banded as banded_ops
from .. import xprec


def spike_factor(M, b: int, parts: int) -> dict:
    """Pre-factor a dense block-tridiagonal SPD M for partitioned solves.

    M: (n, n) with n = N*b, N divisible by `parts`, N//parts >= 2.
    Entries outside the block-tridiagonal band are ignored (the MPC
    condensed matrix is exactly banded; asserted in tests).

    Returns a dict pytree (threads through lax.while_loop carries like
    every other ops.kkt factor):
      Ainv (parts, ni, ni)  interior inverses, ni = (N/parts - 1)*b
      V, W (parts, ni, b)   spikes: A_int^-1 e_f E  /  A_int^-1 e_l B
      Bl   (parts, b, b)    separator-row x interior-last-col coupling
      E    (parts, b, b)    first-interior-row x previous-separator-col
                            coupling (E[0] = 0: no left neighbor)
      Tld, Tll              block Cholesky of the separator Schur
                            complement ((parts, b, b) / (parts-1, b, b))
    """
    n = M.shape[-1]
    if M.ndim != 2:
        raise ValueError("spike_factor requires an unbatched (shared) M")
    if n % b != 0:
        raise ValueError(f"matrix dim {n} not divisible by block size {b}")
    N = n // b
    if N % parts != 0:
        raise ValueError(f"{N} blocks not divisible by {parts} parts")
    Np = N // parts
    if Np < 2:
        raise ValueError(f"need >=2 blocks per part, got {Np}")
    npb = Np * b
    ni = (Np - 1) * b

    blocks = M.reshape(parts, npb, parts, npb)
    idx = jnp.arange(parts)
    Mpp = blocks[idx, :, idx, :]                     # (parts, npb, npb)
    A_int = Mpp[:, :ni, :ni]
    Bl = Mpp[:, ni:, ni - b:ni]                      # sep rows, int cols
    Dsep = Mpp[:, ni:, ni:]
    # Cross-part coupling: first interior row-block of part p against
    # the separator (last) col-block of part p-1.
    sub = blocks[idx[1:], :, idx[:-1], :]            # (parts-1, npb, npb)
    E = jnp.zeros((parts, b, b), M.dtype)
    E = E.at[1:].set(sub[:, :b, ni:])

    L = jnp.linalg.cholesky(A_int)
    eye = jnp.broadcast_to(jnp.eye(ni, dtype=M.dtype), L.shape)
    Linv = solve_triangular(L, eye, lower=True)
    Ainv = xprec.einsum("...ji,...jk->...ik", Linv, Linv)

    # Spikes: A^-1 restricted to the first / last b columns hits the
    # e_f / e_l embeddings directly.
    V = xprec.matmul(Ainv[:, :, :b], E)              # (parts, ni, b)
    W = xprec.matmul(Ainv[:, :, ni - b:], jnp.swapaxes(Bl, -1, -2))

    # Separator Schur complement, block-tridiagonal in `parts`:
    #   Td[p] = Dsep[p] - Bl[p] W[p]_l - E[p+1]' V[p+1]_f
    #   Tl[p-1] (s_{p-1} <-> s_p) = -Bl[p] V[p]_l
    Vf, Vl = V[:, :b, :], V[:, ni - b:, :]
    Wl = W[:, ni - b:, :]
    Td = Dsep - xprec.matmul(Bl, Wl)
    Td = Td.at[:-1].add(-xprec.einsum("pji,pjk->pik", E[1:], Vf[1:]))
    Tl = -xprec.matmul(Bl[1:], Vl[1:])               # (parts-1, b, b)
    Tld, Tll = banded_ops.block_tridiag_cholesky(Td, Tl)
    return {"Ainv": Ainv, "V": V, "W": W, "Bl": Bl, "E": E,
            "Tld": Tld, "Tll": Tll}


def spike_solve(fac, rhs):
    """Solve M x = rhs with a spike_factor; rhs (..., n) batched.

    Interior work is two batched (parts, ., ni) x (parts, ni, .)
    einsums; the only sequential piece is the separator
    block-tridiagonal solve, a scan of length `parts`.
    """
    Ainv, V, W, Bl, E = fac["Ainv"], fac["V"], fac["W"], fac["Bl"], fac["E"]
    parts, ni, b = V.shape
    npb = ni + b
    lead = rhs.shape[:-1]
    r = rhs.reshape(lead + (parts, npb))
    ru, rs = r[..., :ni], r[..., ni:]

    g = xprec.einsum("pij,...pj->...pi", Ainv, ru)
    gl = g[..., ni - b:]
    gf_next = jnp.concatenate(
        [g[..., 1:, :b], jnp.zeros(lead + (1, b), g.dtype)], axis=-2)
    E_next = jnp.concatenate([E[1:], jnp.zeros((1, b, b), E.dtype)])
    rs_t = (rs - xprec.einsum("pij,...pj->...pi", Bl, gl)
            - xprec.einsum("pji,...pj->...pi", E_next, gf_next))

    s = banded_ops.block_tridiag_solve(
        fac["Tld"], fac["Tll"], rs_t.reshape(lead + (parts * b,)))
    s = s.reshape(lead + (parts, b))
    s_prev = jnp.concatenate(
        [jnp.zeros(lead + (1, b), s.dtype), s[..., :-1, :]], axis=-2)
    u = (g - xprec.einsum("pij,...pj->...pi", V, s_prev)
         - xprec.einsum("pij,...pj->...pi", W, s))
    x = jnp.concatenate([u, s], axis=-1)
    return x.reshape(lead + (parts * npb,))
