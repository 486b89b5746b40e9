"""Per-platform choices (`api.device_profile`), the compile-cache helper
and Settings validation."""
import os

import jax
import pytest

from admm_library import Settings, device_profile, resolve_backend
from admm_library.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def keep_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_dir(from_env, tmp_path, monkeypatch, keep_cache_dir):
    """The variable wins when set; otherwise the fixed checkout path."""
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


# The per-platform choices (gpu: measured with scripts/bench_backends.py,
# PERF.md Findings). A change here is a change of measurement.
@pytest.mark.parametrize("platform,band_block,want", [
    ("cpu", 0, "chol"),
    ("cpu", 10, "banded"),
    ("gpu", 0, "inv"),
    ("gpu", 10, "inv"),
])
def test_auto_backend_per_platform(platform, band_block, want):
    s = Settings(band_block=band_block)
    assert resolve_backend(s, platform=platform) == want
    key = "banded" if band_block else "dense"
    assert device_profile(platform)[key] == want


def test_unmeasured_platform_raises():
    with pytest.raises(ValueError, match="no measured"):
        resolve_backend(Settings(), platform="rocm")


def test_explicit_backend_needs_no_profile():
    assert resolve_backend(Settings(backend="cg"), platform="rocm") == "cg"


def test_live_platform_resolves():
    """The suite's own platform (CPU) has a measured entry."""
    assert resolve_backend(Settings()) == device_profile("cpu")["dense"]


def test_settings_rejects_pallas_cg():
    with pytest.raises(ValueError, match="unknown backend"):
        Settings(backend="pallas_cg")


def test_settings_has_no_fused_switch():
    with pytest.raises(TypeError):
        Settings(fused="on")
