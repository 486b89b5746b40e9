"""A run whose timed path is broken underneath comes out not correct.

Each test drives a cell as a run does (set-up, warm-up, window, the
check of the sampled answers, the decision against the cell's limits)
at a tiny size on the CPU, with the entry point's answer broken in one
of the ways a change could break it:

  unchanged   the solve returns the state it starts from (zeros);
  half_batch  half of the batch left out: its lanes carry answers of
              the other half;
  exchange    the exchange between chips left out: every chip's lanes
              carry what the first chip computed;
  altered     one answer altered where it is produced (one entry of x).

A fault applies where the cell can have it: single solves have no
batch to halve and no chips to exchange between.
"""
import dataclasses
import json
import os

import pytest

import run

BENCH = json.load(open(os.path.join(run.ROOT, "BENCHMARK.json")))


def unchanged(sol, chips):
    zero = lambda v: v * 0
    return dataclasses.replace(sol, x=zero(sol.x), z=zero(sol.z),
                               y=zero(sol.y))


def _repeat_first(v, parts):
    """The first 1/parts of the lanes, repeated over all of them."""
    import jax.numpy as jnp
    B = v.shape[0]
    return jnp.concatenate([v[:B // parts]] * parts, axis=0)


def half_batch(sol, chips):
    return dataclasses.replace(sol, x=_repeat_first(sol.x, 2),
                               z=_repeat_first(sol.z, 2),
                               y=_repeat_first(sol.y, 2))


def exchange(sol, chips):
    return dataclasses.replace(sol, x=_repeat_first(sol.x, chips),
                               z=_repeat_first(sol.z, chips),
                               y=_repeat_first(sol.y, chips))


def altered(sol, chips):
    x = sol.x.reshape(-1, sol.x.shape[-1])
    x = x.at[0, 0].add(1e-3).reshape(sol.x.shape)
    return dataclasses.replace(sol, x=x)


def cases():
    out = []
    for w in BENCH["workloads"]:
        batch = json.load(open(os.path.join(
            run.HERE, "traffic", w["traffic"] + ".json")))["entry"] == "batch"
        faults = [unchanged, altered]
        if batch:
            faults.append(half_batch)
        if w["chips"] > 1:
            faults.append(exchange)
        out += [pytest.param(w["name"], f, id=f"{w['name']}-{f.__name__}")
                for f in faults]
    return out


@pytest.mark.parametrize("name,fault", cases())
def test_broken_timed_path_is_not_correct(name, fault, tiny):
    import jax
    cell = tiny(run.load_cell(name))
    chips = cell["workload"]["chips"]
    devices = jax.devices()[:chips]
    prob, pool, items, fn = run.prepare(cell, 2 ** 31 + 3, devices)
    window = run.run_window(lambda qp: fault(fn(qp), chips), items,
                            pool["order"], 0.3, cell["traffic"]["check"], 9)
    worst = run.check_answers(prob, pool, window["kept"], cell["cfg"])
    correct, checks = run.decide(worst, cell["limits"])
    assert not correct, checks
