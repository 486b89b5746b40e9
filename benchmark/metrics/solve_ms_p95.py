"""95th percentile of dispatch to solution on the host, every solve."""
import readers


def read(run):
    return readers.latency_ms(run, 95.0)
