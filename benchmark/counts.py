"""Operations and bytes that one ADMM iteration needs, from its shapes.

Counted from the algorithm (OSQP, arXiv:1711.08013, section 3), not
from any implementation, so the count reads the same whatever computes
the iteration. For one problem (lane) with n variables and m rows,
against a KKT factor shared by all lanes of a batch:

  rhs   = sigma x - q + A'(R z - y)      2mn + 2m + 3n
  x~    = M^-1 rhs                       2n^2   (one solve with the
                                                 factor; refinement
                                                 steps are not counted)
  z~    = A x~                           2mn
  x+    = a x~ + (1 - a) x               3n
  w     = a z~ + (1 - a) z               3m
  z+    = prox(w + y / R)                4m     (divide, add, clip)
  y+    = y + R (w - z+)                 3m
  check every k iterations: A x, P x, A'y    (4mn + 2n^2) / k

so  flops per lane-iteration = 4mn + 2n^2 + 6n + 12m
                               + (4mn + 2n^2) / k.

Bytes are the least traffic to memory: the lane's x, z, y, l and u
read once and x, z, y written once, (2n + 6m) words per lane-iteration,
and the shared A and M^-1, (mn + n^2) words per lockstep iteration of
the batch (on every chip that holds a copy). P is stored dense by the
solver, and counted dense.
"""
from __future__ import annotations


def lane_flops(n: int, m: int, check_every: int) -> float:
    """Floating-point operations of one ADMM iteration of one lane."""
    return (4.0 * m * n + 2.0 * n * n + 6.0 * n + 12.0 * m
            + (4.0 * m * n + 2.0 * n * n) / check_every)


def lane_words(n: int, m: int) -> float:
    """Words one lane reads and writes in one iteration."""
    return 2.0 * n + 6.0 * m


def shared_words(n: int, m: int) -> float:
    """Words of the shared matrices read in one lockstep iteration."""
    return float(m * n + n * n)


def least_time(lane_iters: int, lockstep_iters: int, copies: int, n: int,
               m: int, word_bytes: int, check_every: int,
               flops_per_s: float, bytes_per_s: float):
    """(seconds, bound) that the chip(s) need at least for the given
    iterations: the larger of operations over peak and bytes over
    bandwidth, and which of the two binds ('compute' or 'memory').
    `copies` is the number of chips holding the shared matrices."""
    flops = lane_iters * lane_flops(n, m, check_every)
    nbytes = word_bytes * (lane_iters * lane_words(n, m)
                           + copies * lockstep_iters * shared_words(n, m))
    t_c, t_m = flops / flops_per_s, nbytes / bytes_per_s
    return (t_c, "compute") if t_c >= t_m else (t_m, "memory")
