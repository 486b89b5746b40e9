"""Multi-host runtime exercised for REAL: 2 localhost processes join via
jax.distributed.initialize and run the batch + consensus paths over
host-spanning meshes (P4 / aux-8; SURVEY.md §4.4).

Each worker forces the CPU backend with 4 virtual devices, so the pair
forms an 8-device 2-process global mesh. Assertions:
  * both processes see process_count=2 / 8 global devices,
  * every problem solves on the host-spanning mesh,
  * both processes print BITWISE-identical result lines (cross-host
    determinism — SURVEY.md §5.2 item (c)).
"""
import json
import os
import socket
import subprocess
import sys

import pytest

from admm_library.solution import Status

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        line = out.strip().splitlines()[-1]
        outs.append(line)

    # Cross-host determinism: identical result lines, bitwise.
    assert outs[0] == outs[1], f"\n{outs[0]}\n!=\n{outs[1]}"

    r = json.loads(outs[0])
    assert r["process_count"] == 2
    assert r["global_devices"] == 8
    assert all(s == int(Status.SOLVED) for s in r["batch_status"])
    assert r["consensus_status"] == int(Status.SOLVED)
    assert r["batch_max_rp"] < 1e-4      # f32 single-phase tolerance
    assert r["consensus_rp"] < 1e-4
    # Hybrid precision at eps 1e-6 on the host-spanning mesh — the path
    # the BASELINE metric names (VERDICT r2 item 7).
    assert all(s == int(Status.SOLVED) for s in r["hybrid_status"])
    assert r["hybrid_max_rp"] < 1e-5     # <= eps_abs + eps_rel * scale
    assert r["hybrid_max_rd"] < 1e-5


def test_multihost_bench_hook():
    """The host-count scaling bench (bench/multihost.py) runs as one
    command and reports the per-host/global rates. CPU rates are noise; the assertion is the REPORTED SHAPE
    and that the host-spanning hybrid solve actually solved."""
    out = subprocess.run(
        [sys.executable, "-m", "admm_library.bench.multihost",
         "--spawn", "2", "--batch", "16", "--horizon", "6",
         "--reps", "2"],
        capture_output=True, text=True, timeout=540,
        env={k: v for k, v in os.environ.items()
             if k not in ("XLA_FLAGS", "JAX_PLATFORMS")})
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["num_hosts"] == 2
    assert len(r["records"]) == 2
    assert all(rec["status_all_solved"] for rec in r["records"])
    assert all(rec["precision"] == "hybrid" for rec in r["records"])
    assert r["iters_per_s"] > 0
    assert r["problem_iters_per_s_global"] > 0
