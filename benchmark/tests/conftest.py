"""CPU tests of the benchmark's machinery, at tiny sizes.

    python -m pytest benchmark/tests -q

They run on the CPU backend with 4 virtual devices (for the 4-chip
cell's mesh), so they say nothing of speed: they check the data, the
window loop, the metric arithmetic, the trace reduction and that
`correct` comes out false for the control and for a broken timed path.
"""
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=4").strip()

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import copy  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def shrink(cell: dict) -> dict:
    """The cell at a size a CPU test holds: a short horizon for the
    rendezvous family, 8 lanes per batch, a pool of 4."""
    cell = copy.deepcopy(cell)
    t = cell["traffic"]
    if "batch" in t:
        t["batch"] = 8
    t["pool"], t["check"], t["warmup"] = 4, 3, 1
    cfg = cell["cfg"]
    if cfg["family"] == "double_integrator_mpc":
        cfg.update(N=10, n=90, m=96)
    return cell


@pytest.fixture
def tiny():
    return shrink
