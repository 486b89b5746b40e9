"""Solver settings (SURVEY.md §5.6 config/flag system).

A frozen, hashable dataclass so the whole Settings object can be a `jit`
static argument: changing a setting retraces, using the same settings hits
the compile cache. Mirrors OSQP's settings surface (reference ships no code;
see SURVEY.md §0) specialised for an on-device execution model
(check_every amortises residual checks across the iterations of the
on-device `lax.while_loop`).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Settings:
    # --- ADMM penalty / splitting parameters (OSQP defaults) ---
    rho: float = 0.1            # initial penalty rho-bar
    rho_eq_scale: float = 1e3   # rho boost on equality rows (l == u)
    # Separate penalty scale for consensus AGREEMENT (edge) rows in the
    # horizon-partitioned solvers. Edge rows are equality-like but their
    # targets MOVE every iteration (the neighbor average), so the huge
    # equality boost that helps pinned dynamics rows overdamps the
    # boundary negotiation. Swept on the horizon-50 consensus-MC set:
    # 30 cuts lockstep iterations ~2x vs tying edge rows to
    # rho_eq_scale (2750 -> 1525 at batch 32) — but
    # that value regresses SMALL consensus problems to MAX_ITER (the
    # round-3 test_two_process_mesh failure), so the sweep winner lives
    # in the consensus-MC bench config, NOT here. The default -1 follows
    # rho_eq_scale, which is robust across problem scales.
    rho_edge_scale: float = -1.0
    # rho boost on SOC rows (uniform across each block so the cone
    # projection stays the exact prox). Degenerate min-fuel SOCPs are
    # bang-bang: most blocks sit at the cone TIP at the optimum, acting
    # as equalities (Ax_blk = 0) that the eq boost does not cover —
    # config 4's primal residual plateaus on exactly those rows.
    # Swept on that config (CPU f64, scripts/ records): see bench
    # config for the tuned value; 1.0 = no boost (default, neutral for
    # all other workloads).
    rho_soc_scale: float = 1.0
    sigma: float = 1e-6         # x-update regularisation
    alpha: float = 1.6          # over-relaxation in (0, 2)

    # --- termination ---
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    # Infeasibility certificate tolerances (A6). OSQP defaults to 1e-4;
    # 1e-5 is stricter against false positives while still firing on
    # the normalised delta rays a few hundred iterations into a
    # divergent run (a 1e-8 tolerance demands a ray cleanliness the
    # per-check deltas of chattering/restarted runs never reach —
    # measured A'dy/‖dy‖ ~ 1e-7 on a certified-infeasible consensus
    # problem even after 2000 iterations).
    eps_pinf: float = 1e-5      # primal infeasibility tolerance
    eps_dinf: float = 1e-5      # dual infeasibility tolerance
    max_iter: int = 20000
    check_every: int = 25       # residual/termination cadence (on-device)

    # --- adaptive rho (A4) ---
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 100   # in iterations; multiple of check_every
    adaptive_rho_tol: float = 5.0      # update only if ratio drifts this much
    rho_min: float = 1e-6
    rho_max: float = 1e6

    # --- restarted iterate averaging (PDLP-style) ---
    # Degenerate LP-like problems (min-fuel L1 costs) make plain ADMM
    # CHATTER: the active set oscillates and r_prim plateaus for tens of
    # thousands of iterations (measured: the CW min-fuel benchmark f32
    # phase sat at r_p ~ 9e-2 for 50k iterations). The ergodic average
    # of the chattering iterates converges where the last iterate does
    # not, so every `restart_every` iterations the solver compares the
    # running average of the check-cadence iterates against the current
    # iterate and RESTARTS from the average when it has strictly better
    # scaled residuals (measured on that benchmark: 13,625 -> 1,025
    # iterations in f64; the f32 stall disappears entirely). Monotone
    # runs never take the restart (the average lags the iterate), so
    # well-behaved QPs are unaffected. 0 disables.
    restart_every: int = 200
    # Stall exit: leave the loop with Status.STALLED once the best
    # scaled residual ratio has not improved for this many consecutive
    # checks (0 disables). With check_every=25 the default window is
    # 400 iterations — two restart boundaries; if neither the iterates
    # nor the averaged restarts find a new best in that window the loop
    # is at its precision floor or chattering, and burning the rest of
    # max_iter is pure waste (measured: the f32 phase of the CW
    # min-fuel benchmark burned 50k iterations at a 9e-2 plateau). The
    # staged hybrid drivers then RE-CENTER, which restores f32 headroom
    # and continues the convergence where a longer loop could not.
    stall_checks: int = 16

    # --- scaling (K4) ---
    scaling_iters: int = 10     # 0 disables Ruiz equilibration

    # --- precision strategy (SURVEY.md §7) ---
    # 'hybrid' (default): bulk iterations in f32 down to `hybrid_eps`,
    #   then re-centered f32 rounds and, only where those fall short, a
    #   warm-started f64 phase to the target eps.
    # 'single': solve entirely in the problem's own dtype.
    # 'double': cast the problem to f64 up front.
    precision: str = "hybrid"
    hybrid_eps: float = 1e-4    # f32 phase target (abs and rel)
    # Re-centered refinement: instead of an f64 iteration phase,
    # re-solve the SAME QP in f32 with data shifted around the current
    # iterate (q <- Px+q+A'y, bounds <- bounds - Ax). The correction
    # problem lives at the residual scale (~1e-4), where f32's relative
    # precision gives ~1e-11 absolute, so every hot-loop iteration stays
    # f32; only the shift (a few f64 matmuls per round) runs in f64.
    # Rounds beyond convergence terminate at their first residual check.
    recenter_rounds: int = 2
    # Per-round iteration cap for the staged solve()'s re-centering:
    # LP-like problems (min-fuel L1) crawl through the first-order tail,
    # but polish usually lands from a partially-converged round — the
    # staged path tries polish after every round, so rounds only need
    # to refine the active set, not converge. 0 disables the cap.
    recenter_max_iter: int = 2000

    # --- linear system backend (L0) ---
    # 'auto' | 'chol' (dense Cholesky of condensed system)
    # | 'inv' (explicit inverse; per-iteration solve = one matmul)
    # | 'banded' (block-tridiagonal Cholesky, MPC structure, K2)
    # | 'cg' (matrix-free conjugate gradient, K3)
    # | 'spike' (partitioned block-tridiagonal SPIKE/nested dissection:
    #   the horizon-partitioned x-update solved EXACTLY, so the ADMM
    #   iterates match the un-partitioned solver — no consensus
    #   iteration penalty; requires band_block > 0 and spike_parts > 0)
    backend: str = "auto"
    # Horizon partition count for backend='spike' (ops/spike.py): the
    # N=n/band_block diagonal blocks split into this many pieces, each
    # contributing one separator block to the reduced interface system.
    spike_parts: int = 0
    cg_tol: float = 1e-9
    cg_max_iter: int = 200
    refine_steps: int = 1       # iterative-refinement steps on the KKT solve

    # --- banded backend structure hints (set by MPC builders) ---
    # Block-tridiagonal block size; 0 means "not banded".
    band_block: int = 0

    # --- misc ---
    warm_start: bool = True
    # A7 solution polishing (hybrid path): after the f32 phase, detect
    # the active set and solve the reduced KKT system in f64; when it
    # lands (typical), the entire f64 iteration phase is skipped.
    polish: bool = True
    polish_refine_steps: int = 3
    history: int = 0            # residual ring-buffer slots (0 disables)

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        if self.check_every < 1:
            raise ValueError("check_every must be >= 1")
        if self.backend not in (
                "auto", "chol", "inv", "banded", "cg", "spike"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.backend == "spike" and self.spike_parts <= 0:
            raise ValueError("backend 'spike' requires spike_parts > 0")
        if self.precision not in ("hybrid", "single", "double"):
            raise ValueError(f"unknown precision {self.precision!r}")
