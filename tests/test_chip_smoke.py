"""chip_smoke.py: its refusals on a machine without a GPU, and its phase
functions rehearsed on CPU at tiny sizes (the card runs them at the
bench sizes)."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run_script(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(out):
    return not any('"ok"' in line for line in out.stdout.splitlines())


def test_device_phase_refuses_cpu():
    with pytest.raises(cs.SmokeFailure, match="not 'gpu'"):
        cs.device_phase("gpu")


def test_script_exits_nonzero_without_gpu():
    out = _run_script(REPO)
    assert out.returncode != 0
    assert _no_result(out)
    phase = json.loads(out.stdout.splitlines()[0])
    assert phase["phase"] == "device" and phase["status"] == "FAILED"


def test_script_exits_nonzero_outside_repo(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run_script(tmp_path)
    assert out.returncode != 0
    assert _no_result(out)


def test_headline_phase_tiny():
    rec = cs.headline_phase(batch=8, N=6, dim=2)
    assert rec["lockstep_iters"] > 0
    assert rec["oracle_r_prim"] <= 1e-5 and rec["oracle_r_dual"] <= 1e-5
    assert rec["memory_analysis"]


def test_headline_cpu_phase_tiny():
    rec = cs.headline_cpu_phase(batch=8, N=6, dim=2)
    # On CPU both sides are the CPU backend: identical programs and data.
    for label in ("double", "hybrid"):
        assert rec[label]["gen_drift"] == 0.0
        assert rec[label]["x_drift"] == 0.0
        assert rec[label]["iters_device"] == rec[label]["iters_cpu"]


def test_single_qp_phase_small():
    rec = cs.single_qp_phase(small=True)
    assert set(rec) == {"random_qp", "mpc_rendezvous", "cw_minfuel",
                        "low_thrust_socp"}
    for name in ("random_qp", "mpc_rendezvous", "cw_minfuel"):
        assert rec[name]["x_drift_vs_cpu"] == 0.0


def test_partitioned_phase_tiny():
    rec = cs.partitioned_phase(batch=8, N=10, parts=5, n_row=64, m_row=128)
    assert set(rec) == {"horizon_spike", "consensus_mc", "rowshard"}


@pytest.mark.parametrize("fn,kw", [
    (cs.four_card_data_parallel, dict(batch=8, N=6)),
    (cs.four_card_horizon_spike, dict(batch=4, N=8)),
    (cs.four_card_consensus_mc, dict(batch=4, N=8, n_blocks=4)),
    (cs.four_card_rowshard, dict(n=32, m=64)),
])
def test_four_card_phases_on_virtual_devices(fn, kw):
    assert len(jax.devices()) >= 4
    rec = fn(4, **kw)
    assert rec["x_drift"] <= cs.X_TOL_MESH


def test_oracle_check_rejects_a_wrong_point():
    from admm_library.utils.oracle import qp_known_solution

    qp, x, y = qp_known_solution(0, n=10, m=20, n_active=4)
    z = qp.A @ x
    cs.oracle_check(qp, x, z, y, 1e-9, 0.0)
    with pytest.raises(cs.SmokeFailure, match="mixed"):
        cs.oracle_check(qp, x + 1e-3, z, y, 1e-6, 1e-6)


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    """The whole one-card smoke run, on the card."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
