"""Readings that the limits of `correct` are set from, for one cell.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        --seeds 11,12,... --control-seeds 21,22,23

In one process, on the card(s): for each of --seeds, the cell's own
window (set-up, warm-up, closed loop for --seconds, the check of the
sampled answers) gives the program's reading of every number compared;
then the same for each of --control-seeds with the configuration's
`control` settings in place of its own (the solver's own lower-precision
path: everything in f32, no f64 refinement), which has to come out
not correct. Prints one JSON line per run and a summary: the largest
program reading (the lower end of a limit) and the smallest control
reading (its upper end). benchmark/limits/<workload>.json records them.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import run  # noqa: E402


def readings(cell: dict, seeds, seconds: float, devices, override=None):
    out = []
    for seed in seeds:
        prob, pool, items, fn = run.prepare(cell, seed, devices, override)
        window = run.run_window(fn, items, pool["order"], seconds,
                                int(cell["traffic"]["check"]), seed)
        del items, fn
        worst = run.check_answers(prob, pool, window["kept"], cell["cfg"])
        calls = window["calls"]
        row = {"seed": seed, "control": override is not None,
               "calls": len(calls),
               "failed": sum(c["lanes"] - c["solved"] for c in calls),
               **worst}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args(argv)
    cell = run.load_cell(args.workload)
    try:
        devices = run.require_devices(int(cell["workload"]["chips"]))
    except run.NoDevice as e:
        print(f"control.py: {e}", file=sys.stderr)
        return 3
    run.enable_compile_cache()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    prog = readings(cell, seeds, args.seconds, devices)
    ctrl = readings(cell, cseeds, args.seconds, devices,
                    cell["cfg"]["control"])
    names = list(cell["limits"]["numbers"])
    summary = {n: {"lower": max(r[n] for r in prog) if prog else None,
                   "upper": min(r[n] for r in ctrl) if ctrl else None}
               for n in names}
    print(json.dumps({"workload": args.workload, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
