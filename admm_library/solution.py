"""Solution / status types (component S1 of SURVEY.md §2.2)."""
from __future__ import annotations

import dataclasses
import enum

import jax
import jax.numpy as jnp


class Status(enum.IntEnum):
    """Solver status codes (device-friendly small ints)."""

    UNSOLVED = 0
    SOLVED = 1
    MAX_ITER = 2
    PRIMAL_INFEASIBLE = 3
    DUAL_INFEASIBLE = 4
    NUMERICAL_ERROR = 5
    # The scaled residual ratio stopped improving for Settings.
    # stall_checks consecutive checks (chatter / precision floor): the
    # loop exits early instead of burning max_iter. Staged hybrid
    # drivers treat it like MAX_ITER (re-center and continue) — a
    # stalled f32 phase is EXPECTED; the next round restores headroom.
    STALLED = 6


def _sol_flatten(s):
    return ((s.x, s.z, s.y, s.status, s.iters, s.r_prim, s.r_dual,
             s.obj, s.rho, s.history), None)


def _sol_unflatten(cls, aux, children):
    del aux
    return cls(*children)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Solution:
    """Solver result pytree. All leaves may carry leading batch dims.

    history is a (history_slots, 3) array of (iteration, r_prim, r_dual)
    snapshots from the on-device ring buffer (empty when history=0);
    unused slots hold -1 in the iteration column.
    """

    x: jax.Array
    z: jax.Array
    y: jax.Array
    status: jax.Array      # int32, values from Status
    iters: jax.Array       # int32
    r_prim: jax.Array
    r_dual: jax.Array
    obj: jax.Array
    rho: jax.Array
    history: jax.Array

    tree_flatten = _sol_flatten
    tree_unflatten = classmethod(_sol_unflatten)

    @property
    def solved(self):
        return self.status == int(Status.SOLVED)

    def status_name(self) -> str:
        s = int(self.status) if jnp.ndim(self.status) == 0 else None
        return Status(s).name if s is not None else "<batched>"


# AOT-export support (see problem.py): Solution is the out_tree of the
# serialized solver programs.
try:
    jax.export.register_pytree_node_serialization(
        Solution, serialized_name="admm_library.Solution",
        serialize_auxdata=lambda aux: b"", deserialize_auxdata=lambda b: None)
except (AttributeError, ValueError):
    pass

