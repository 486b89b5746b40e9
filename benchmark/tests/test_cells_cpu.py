"""Every cell's machinery on the CPU at a tiny size: draw, upload,
warm-up, window loop, the check of the answers and the arithmetic of
every metric. The command itself refuses the CPU."""
import json
import os

import numpy as np
import pytest

import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def prepared():
    """One set-up per cell, shared by the tests of this module."""
    import jax
    cache = {}

    def get(name, shrink):
        if name not in cache:
            cell = shrink(run.load_cell(name))
            devices = jax.devices()[:cell["workload"]["chips"]]
            cache[name] = (cell, devices,
                           run.prepare(cell, 2 ** 31 + 11, devices))
        return cache[name]
    return get


def fake_trace(window_s: float, chips: int) -> dict:
    busy = {i: 0.6 * window_s for i in range(chips)}
    return {"window_s": window_s, "busy_s": busy,
            "collective_exposed_s": {i: 0.01 * window_s
                                     for i in range(chips)},
            "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("name", CELLS)
def test_cell_window_check_and_metrics(name, prepared, tiny):
    cell, devices, (prob, pool, items, fn) = prepared(name, tiny)
    window = run.run_window(fn, items, pool["order"], 1.0,
                            cell["traffic"]["check"], 5)
    assert window["calls"] and window["t1"] > window["t0"]
    assert all(c["solved"] == c["lanes"] for c in window["calls"])
    worst = run.check_answers(prob, pool, window["kept"], cell["cfg"])
    correct, checks = run.decide(worst, cell["limits"])
    assert correct, checks
    lanes = cell["traffic"].get("batch", 1)
    assert worst["answers"] >= min(len(window["calls"]),
                                   cell["traffic"]["check"]) * lanes

    r = run.Run(cell, window, 1.5, len(devices))
    e2e = run.read_metrics(r, cell["end_to_end"])
    assert set(e2e) == {m["name"] for m in cell["end_to_end"]}
    assert e2e["setup_s"]["value"] == 1.5
    assert all(v["value"] > 0 for v in e2e.values())

    # Without a trace the device metrics find nothing to read.
    untraced = run.read_metrics(r, cell["per_layer"])
    assert all(m.startswith("iters.") for m in untraced)
    r = run.Run(cell, window, 1.5, len(devices),
                fake_trace(r.window_s, len(devices)),
                {"fp32_flops": 67e12, "fp64_flops": 34e12,
                 "hbm_bytes_per_s": 3.35e12})
    per = run.read_metrics(r, cell["per_layer"])
    assert set(per) == {m["name"] for m in cell["per_layer"]}
    for m, v in per.items():
        if m.startswith("idle_share"):
            assert v["value"] == pytest.approx(40.0)
        if m == "collective_share.mc4x":
            assert v["value"] == pytest.approx(1.0)
        if m.startswith("iters."):
            assert v["value"] == np.mean(
                [c["iters_max"] for c in window["calls"]])


def test_sample_is_drawn_from_the_seed_and_keeps_the_slowest():
    def answers(seed):
        sample = run.AnswerSample(5, seed)
        for i in range(200):
            sample.add({"i": i, "iters": np.array([1000 if i == 37 else i])})
        return [a["i"] for a in sample.answers()]

    a, b, c = answers(3), answers(3), answers(4)
    assert a == b and a != c
    assert 37 in a and len(a) in (5, 6)
    assert len(set(a)) == len(a)


def test_command_refuses_the_cpu(capsys):
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc == 3
    assert capsys.readouterr().out == ""
