"""Mean lockstep (slowest-lane) iterations per batch."""
import readers


def read(run):
    return readers.mean_lockstep_iters(run)
