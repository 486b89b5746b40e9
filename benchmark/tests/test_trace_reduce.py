"""The trace reduction on a small trace recorded on an H100, and its
interval arithmetic on a trace written by hand."""
import os

import pytest

import run
import trace_reduce as T

DATA = os.path.join(os.path.dirname(__file__), "data",
                    "gpu_small.xplane.pb")


def test_recorded_gpu_trace():
    trace = T.load(DATA)
    assert list(trace["devices"]) == [0]
    names = {n for n, _, _ in trace["spans"]}
    assert {"draw", "dispatch", "result_to_host"} <= names
    t0, t1 = run.trace_window(trace)
    red = T.reduce(trace, t0, t1)
    busy = red["busy_s"][0]
    assert 0 < busy < red["window_s"] == (t1 - t0) / 1e9
    # Busy and idle together fill the window.
    idle = sum(s for _, s in red["idle_gaps"])
    assert busy + idle == pytest.approx(red["window_s"], rel=1e-9)
    ops = [s for _, s in red["device_ops"]]
    assert ops == sorted(ops, reverse=True) and len(ops) <= 10
    assert red["collective_exposed_s"][0] == 0.0


def test_interval_arithmetic_by_hand():
    ns = 1e-9
    trace = {
        "devices": {
            0: [("fusion", 0, 10), ("ncclDevKernel_AllReduce_Sum", 5, 15),
                ("fusion.2", 20, 30), ("before", -10, -5)],
            1: [("fusion", 0, 40)],
        },
        "spans": [("dispatch", 0, 2), ("result_to_host", 2, 18),
                  ("draw", 18, 19), ("dispatch", 19, 20),
                  ("result_to_host", 20, 40), ("other", 0, 40)],
    }
    red = T.reduce(trace, 0, 40)
    assert red["window_s"] == pytest.approx(40 * ns)
    # Device 0: [0, 15] and [20, 30] busy; the all-reduce runs alone
    # over [10, 15]. Events outside the window do not count.
    assert red["busy_s"][0] == pytest.approx(25 * ns)
    assert red["collective_exposed_s"][0] == pytest.approx(5 * ns)
    assert red["busy_s"][1] == pytest.approx(40 * ns)
    assert red["collective_exposed_s"][1] == 0.0
    # Device 0's gaps [15, 20] and [30, 40] both overlap result_to_host
    # most.
    [(label, seconds)] = red["idle_gaps"]
    assert label.startswith("result_to_host (gaps 2,")
    assert seconds == pytest.approx(15 * ns)
    assert dict(red["device_ops"])["fusion"] == pytest.approx(50 * ns)


def test_union_and_subtract():
    assert T._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert T._subtract([(0, 10), (20, 30)], [(2, 4), (8, 22)]) == [
        (0, 2), (4, 8), (22, 30)]
