"""Mean solver iterations per solve."""
import readers


def read(run):
    return readers.mean_lockstep_iters(run)
