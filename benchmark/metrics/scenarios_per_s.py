"""Dispersion scenarios solved (status SOLVED) per second of the window."""
import readers


def read(run):
    return readers.solved_rate(run)
