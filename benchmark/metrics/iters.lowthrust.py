"""Mean solver iterations per solve, f32 and f64 phases together."""
import readers


def read(run):
    return readers.mean_lockstep_iters(run)
