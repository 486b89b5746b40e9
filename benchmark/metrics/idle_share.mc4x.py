"""Share of the traced window with no op on the device, averaged over
the four chips, %."""
import readers


def read(run):
    return readers.idle_share(run)
