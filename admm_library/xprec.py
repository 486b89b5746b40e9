"""f32 matmul precision policy (correctness-critical).

A convex solver cannot run on reduced-precision f32 dots. The in-graph
Cholesky -> triangular-solve -> explicit-inverse factor needs
||I - M^-1 M|| well below 1, and every ADMM iteration feeds the error
of its KKT solve back into the next. A GPU may compute f32 dots in TF32
(10 explicit mantissa bits) unless told otherwise, which is enough to
stall or diverge the iteration at the 1e-6 targets.

Policy: every dot on the solver path requests HIGHEST explicitly (IEEE
f32, no TF32), and trace-level entry points additionally run under
`highest()` so decomposition lowerings (cholesky, triangular_solve)
pick it up too. The problem builders (models/) and the independent
oracle (utils/oracle.py) use the same helpers, so a seed yields the same
problem data on every platform.

On CPU these annotations are no-ops, so tests exercise identical code.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def einsum(subscripts, *operands, **kw):
    """jnp.einsum pinned to exact-f32 dot precision."""
    kw.setdefault("precision", HIGHEST)
    return jnp.einsum(subscripts, *operands, **kw)


def matmul(a, b):
    """a @ b pinned to exact-f32 dot precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def highest():
    """Trace-time context: exact-f32 for every dot traced inside,
    including those emitted by decomposition lowerings."""
    return jax.default_matmul_precision("highest")
