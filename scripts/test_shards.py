"""Sharded test runner (VERDICT r4 item 7): split the suite across N
parallel pytest processes.

Why: the full suite is execution-bound (~519 s warm in one process on
this 2-core box — measured round 5) and a single long pytest process was
also the trigger for the native stack-growth segfault that
tests/conftest.py works around. Sharding by measured per-FILE cost
bounds both: each process runs ~half the work and dies before
native-state accumulation matters.

Weights are the round-5 measured per-file seconds (pytest
--durations=40, warm cache). Unknown/new test files land on the
currently-lightest shard, so new tests never silently drop out of
`make test`.
"""
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Measured per-file wall-clock (s), round 5, warm compile cache.
WEIGHTS = {
    "test_backend_crossover.py": 35,
    "test_batch_shared.py": 66,
    "test_solver.py": 60,
    "test_consensus.py": 45,
    "test_multihost.py": 43,
    "test_rowshard.py": 39,
    "test_consensus_mc.py": 34,
    "test_models.py": 32,
    "test_restart.py": 27,
    "test_aux.py": 27,
    "test_kkt.py": 22,
    "test_horizon.py": 14,
    "test_spike.py": 11,
    "test_polish_soc.py": 9,
    "test_prox.py": 3,
    "test_soc_scale.py": 3,
}


def main(n_shards: int = 2) -> int:
    files = sorted(f for f in os.listdir(os.path.join(REPO, "tests"))
                   if f.startswith("test_") and f.endswith(".py"))
    shards = [[] for _ in range(n_shards)]
    loads = [0.0] * n_shards
    # Greedy longest-processing-time assignment.
    for f in sorted(files, key=lambda f: -WEIGHTS.get(f, 10)):
        i = loads.index(min(loads))
        shards[i].append(os.path.join("tests", f))
        loads[i] += WEIGHTS.get(f, 10)

    t0 = time.time()
    procs = []
    for i, shard in enumerate(shards):
        if not shard:
            continue
        cmd = [sys.executable, "-m", "pytest", "-q", *shard]
        procs.append((i, shard, subprocess.Popen(cmd, cwd=REPO)))
        print(f"[shard {i}] {' '.join(shard)}", flush=True)
    rc = 0
    for i, shard, p in procs:
        r = p.wait()
        print(f"[shard {i}] exit {r} at {time.time() - t0:.0f}s",
              flush=True)
        rc = rc or r
    print(f"total {time.time() - t0:.0f}s rc={rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
