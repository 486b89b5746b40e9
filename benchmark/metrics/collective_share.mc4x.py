"""Share of the traced window in collectives with no compute beside them, %."""
import readers


def read(run):
    return readers.collective_share(run)
