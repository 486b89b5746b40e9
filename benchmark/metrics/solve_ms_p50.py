"""Median time from dispatch to the solution on the host, every solve."""
import readers


def read(run):
    return readers.latency_ms(run, 50.0)
