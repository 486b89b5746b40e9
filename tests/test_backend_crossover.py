"""The banded-vs-inv trade behind `api.resolve_backend`'s per-platform
choice for MPC-structured problems.

Per ADMM iteration the banded solve costs O(N b^3) = O(n b^2) FLOPs in a
2N-step sequential block scan, while the explicit-inverse apply costs
O(n^2) in one matmul — so banded wins FLOPs-wise for n >> b^2, but its
sequential scan is latency-bound at batch 1. Which side a device lands
on is measured per platform (scripts/bench_backends.py, PERF.md).

This test pins the TREND on CPU (timings, generous slack — absolutes
are machine-dependent): the banded/inv per-iteration time ratio must
decrease as n grows at fixed block size, i.e. the banded scan becomes
RELATIVELY cheaper with n. It also asserts both backends agree on the
solution to f64 accuracy.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from admm_library.models.double_integrator import build_mpc_qp
from admm_library.ops import kkt


def _setup(N):
    s0 = np.array([1.0, -2.0, 0.5, 0.0, 0.1, -0.05])
    qp, spec = build_mpc_qp(s0, np.zeros(6), N=N, dim=3)
    qp = qp.astype(jnp.float64)   # agreement check is an f64 statement
    rho = jnp.full((qp.m,), 0.1, qp.dtype)
    rhs = jnp.sin(jnp.arange(qp.n, dtype=qp.dtype))
    return qp, spec, rho, rhs


def _solve_time(qp, spec, rho, rhs, backend, reps=20):
    band = spec.block if backend == "banded" else 0
    fac = kkt.factor_condensed(qp.P, qp.A, 1e-6, rho, backend, band)
    f = jax.jit(lambda fc, r: kkt.solve_condensed(fc, r, backend),
                static_argnames=())
    x = f(fac, rhs)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    for _ in range(reps):
        x = f(fac, rhs)
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / reps, x


@pytest.mark.parametrize("N", [56, 228])
def test_backends_agree(N):
    qp, spec, rho, rhs = _setup(N)
    _, x_inv = _solve_time(qp, spec, rho, rhs, "inv", reps=1)
    _, x_band = _solve_time(qp, spec, rho, rhs, "banded", reps=1)
    err = float(jnp.max(jnp.abs(x_inv - x_band)))
    scale = 1.0 + float(jnp.max(jnp.abs(x_band)))
    assert err <= 1e-8 * scale


def test_banded_inv_ratio_trend():
    """banded/inv per-iteration time ratio decreases with n (block size
    fixed): N=56 -> n=504 vs N=228 -> n=2052 (about the N=200
    low-thrust SOCP's size). Slack 0.9: the model ratio shrinks ~4x ((b^2/n)
    scaling), so even heavy CI noise keeps the ordering."""
    ratios = {}
    for N in (56, 228):
        qp, spec, rho, rhs = _setup(N)
        t_inv, _ = _solve_time(qp, spec, rho, rhs, "inv")
        t_band, _ = _solve_time(qp, spec, rho, rhs, "banded")
        ratios[N] = t_band / max(t_inv, 1e-9)
    assert ratios[228] < 0.9 * ratios[56], ratios
