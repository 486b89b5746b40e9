"""Where JAX keeps its persistent compilation cache.

JAX reads JAX_COMPILATION_CACHE_DIR only when `jax` is first imported,
and this package imports jax in its own __init__, so an entry point that
sets the variable afterwards changes nothing. Every entry point calls
`enable_compile_cache()` instead: it honours the variable when it is
set, and otherwise uses one fixed directory in the checkout. The
directory is part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point the persistent compilation cache at JAX_COMPILATION_CACHE_DIR
    when it is set, else at `<repo>/.jax_cache`. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
