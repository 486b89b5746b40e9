"""Benchmark runner: runs every config of `admm_library.bench.cli` and
prints the headline record as ONE JSON line, re-printed (same headline
fields, richer `detail`) after each group of configs completes.

Headline: lockstep ADMM iterations/s of the 128-lane horizon-50
rendezvous batch (`monte_carlo_128`); the full 1024-lane batch, the
horizon-partitioned alternates and the other BASELINE configs are
reported alongside in `detail`.

One process drives the card at a time: this parent never imports JAX,
and each group of configs runs in its own `python -m
admm_library.bench.cli` child, one after another. The device each
record ran on is named by the child (JAX's platform, device kind and
count) and, for the card, by `nvidia-smi` here.

Run: python bench.py
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))

# Groups, most important first; each is one child process.
GROUPS = [
    ["monte_carlo_128"],
    ["random_qp", "mpc_rendezvous", "cw_minfuel", "monte_carlo"],
    ["low_thrust_socp"],
    ["horizon_spike", "consensus_mc"],
    ["rowshard"],
]


def card_name_and_power_limit() -> str | None:
    """`nvidia-smi`'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def run_group(configs: list[str], out: dict) -> int:
    """Run one group of bench configs in a child; merge its per-config
    JSON lines into `out` and re-print the headline line."""
    proc = subprocess.run(
        [sys.executable, "-m", "admm_library.bench.cli", *configs],
        cwd=REPO, stdout=subprocess.PIPE, stderr=sys.stderr, text=True)
    detail = out.setdefault("detail", {})
    for line in proc.stdout.splitlines():
        if not line.startswith("{"):
            continue
        rep = json.loads(line)
        detail[rep["config"]] = rep
        out.setdefault("device", rep["device"])
        if rep["config"] == "monte_carlo_128":
            out.update({
                "metric": "admm_iters_per_s_mc_h50_batch128",
                "value": rep["iters_per_s"],
                "unit": "iters/s",
            })
    if proc.returncode != 0:
        detail[",".join(configs)] = {
            "error": f"bench.cli exited rc={proc.returncode}"}
    print(json.dumps(out), flush=True)
    return proc.returncode


def main() -> int:
    out = {"card": card_name_and_power_limit()}
    rc = 0
    for group in GROUPS:
        rc = run_group(group, out) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
