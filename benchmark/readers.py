"""Arithmetic shared by the metric readers in metrics/<name>.py.

A reader gets the run (run.py `Run`): the window's calls, each with its
lanes, solved lanes, lockstep (slowest-lane) and summed lane iterations
and its host times; the reduced trace (traced runs only, else None);
the card's peaks. A reader that finds nothing to read returns None and
its metric is left out of the result line.
"""
from __future__ import annotations

import numpy as np

import counts


def solved_rate(run):
    """Lanes or solves that came back SOLVED, per second of the window."""
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c["solved"] for c in run.calls) / run.window_s


def latency_ms(run, q: float):
    """Percentile `q` of dispatch-to-host time over every call, in ms."""
    if not run.calls:
        return None
    lat = [c["t_done"] - c["t_dispatch"] for c in run.calls]
    return 1e3 * float(np.percentile(lat, q))


def mean_lockstep_iters(run):
    """Mean over calls of the slowest lane's iterations (Solution.iters);
    for single solves, the mean iterations per solve."""
    if not run.calls:
        return None
    return float(np.mean([c["iters_max"] for c in run.calls]))


def _busy(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    return list(run.trace["busy_s"].values())


def idle_share(run):
    """1 - device busy / traced window, averaged over chips, in %."""
    busy = _busy(run)
    if busy is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - float(np.mean(busy)) / run.trace["window_s"])


def device_us_per_iter(run):
    """Device busy time per solver iteration, in us (chip average)."""
    busy = _busy(run)
    iters = sum(c["iters_sum"] for c in run.calls) if run.calls else 0
    if busy is None or iters == 0:
        return None
    return 1e6 * float(np.mean(busy)) / iters


def collective_share(run):
    """Time in collective ops with no other op on the chip, over the
    traced window, averaged over chips, in %."""
    if run.trace is None or not run.trace["collective_exposed_s"]:
        return None
    exp = list(run.trace["collective_exposed_s"].values())
    return 100.0 * float(np.mean(exp)) / run.trace["window_s"]


def iteration_roofline(run):
    """Least time the chips need for the window's ADMM iterations
    (counts.py, against the card's peaks) over their summed busy time,
    in %. Every lane-iteration is held to the FP32 rate; an f64
    iteration needs more, so the share is a lower bound."""
    busy = _busy(run)
    if busy is None or run.peaks is None or not run.calls:
        return None
    cfg = run.cfg
    n, m = int(cfg["n"]), int(cfg["m"])
    word = np.dtype(cfg["dtype"]).itemsize
    t, bound = counts.least_time(
        sum(c["iters_sum"] for c in run.calls),
        sum(c["iters_max"] for c in run.calls), run.chips, n, m, word,
        int(cfg["settings"]["check_every"]), run.peaks["fp32_flops"],
        run.peaks["hbm_bytes_per_s"])
    run.roofline_bound = bound
    return 100.0 * t / float(np.sum(busy))
