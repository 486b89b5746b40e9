"""Device busy time per solver iteration, us."""
import readers


def read(run):
    return readers.device_us_per_iter(run)
