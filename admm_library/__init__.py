"""An accelerator-native ADMM (OSQP-style) solver framework for
astrodynamics optimal-control QPs and SOCPs.

Built from scratch in JAX/XLA against the capability spec of
SergioCdV/ADMM-library (an upstream repository that ships no code, so
the functional spec is BASELINE.json; see SURVEY.md).
"""
import os as _os

import jax as _jax

# The default 'hybrid' precision strategy checks and refines every solve
# in f64 — f64 types must exist for that. Opt out with ADMM_NO_X64=1 to
# keep JAX's default 32-bit-only mode; solves then silently degrade to
# precision='single'.
if not _os.environ.get("ADMM_NO_X64"):
    _jax.config.update("jax_enable_x64", True)

from .api import device_profile, resolve_backend, solve, solve_batch
from .problem import ConeSpec, QPData, make_qp, objective
from .settings import Settings
from .solution import Solution, Status

__version__ = "0.2.0"

__all__ = [
    "solve", "solve_batch", "resolve_backend", "device_profile",
    "ConeSpec", "QPData", "make_qp", "objective",
    "Settings", "Solution", "Status",
]
