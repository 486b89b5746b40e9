"""Test env: CPU backend with 8 virtual devices (SURVEY.md §4.4) + f64.

Must run before jax initialises its backend, hence top of conftest.
"""
import os

# Force CPU even where a GPU is present: the suite validates numerics in
# f64 and exercises an 8-device virtual mesh. Tests that need the card
# are marked `gpu` and run through the `gpu_device` fixture.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# Threads spawned after this (XLA:CPU compile + execution workers)
# inherit the larger stack. With the default 8 MB the full suite
# (~100 tests, each holding compiled executables) segfaulted
# intermittently in the LAST test module — inside backend_compile in
# one run, inside scan tracing in another (round 4, twice) — the
# signature of native stack/map exhaustion late in a long process,
# while any subset of the suite passed.
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _soft != resource.RLIM_INFINITY and _soft < 64 * 1024 * 1024:
    _new = 64 * 1024 * 1024 if _hard == resource.RLIM_INFINITY \
        else min(64 * 1024 * 1024, _hard)
    resource.setrlimit(resource.RLIMIT_STACK, (_new, _hard))

import jax  # noqa: E402
import pytest  # noqa: E402

from admm_library.utils.compile_cache import enable_compile_cache  # noqa: E402

# The config update is authoritative over an installed GPU plugin.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persist compiled executables across test runs (first-compile of the
# full solver is the dominant suite cost).
enable_compile_cache()


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop live compiled executables between test modules.

    Bounds the per-process accumulation described above; the persistent
    compilation cache (JAX_COMPILATION_CACHE_DIR) makes the re-loads
    cheap, so suite wall-clock is unaffected.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def gpu_card():
    """Skip unless an NVIDIA GPU is visible to a fresh JAX process.

    This process is forced onto the CPU (above), so tests that need the
    card run their work in a child with the platform left to JAX.
    """
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if out.returncode != 0 or out.stdout.strip() != "gpu":
        pytest.skip("JAX finds no GPU")
