"""Least time for the window's ADMM iterations over the four chips'
summed device busy time, %."""
import readers


def read(run):
    return readers.iteration_roofline(run)
