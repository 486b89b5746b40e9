"""Multi-host runtime bring-up — P4 (SURVEY.md §3.5, §5.8).

The distributed "backend" is XLA collectives (NCCL on GPUs); all this
layer owns is process bootstrap (`jax.distributed.initialize`), mesh
construction with canonical axis names, and teardown. Every host runs
the identical jit'd program; XLA partitions it over the mesh (SPMD).

Canonical axes:
    'data'     — scenario batch (P1); gradient-free, embarrassingly
                 parallel, only the loop-predicate reduction crosses it.
    'horizon'  — time-partitioned consensus blocks (P2); neighbor
                 ppermute + scalar psum per iteration.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"
HORIZON_AXIS = "horizon"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up multi-host JAX. No-ops on a single process.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID) via
    jax.distributed's own resolution; safe to call unconditionally at
    program start on every host.
    """
    explicit = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if not explicit:
        return          # single-process run
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def shutdown() -> None:
    if jax.process_count() > 1:
        jax.distributed.shutdown()


def make_mesh(data: int | None = None, horizon: int = 1,
              devices=None) -> Mesh:
    """2-D (data, horizon) mesh over all (global) devices.

    `data` defaults to device_count // horizon. The cards of one host
    are joined all to all (NVLink), so the mesh follows the algorithm:
    the horizon axis, which carries the per-iteration neighbor
    exchange, is laid innermost so it stays within a host, and the data
    axis, whose only traffic is the loop-predicate and shared-rho
    reductions, is the one that may span hosts.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if data is None:
        if n % horizon != 0:
            raise ValueError(f"{n} devices not divisible by horizon="
                             f"{horizon}")
        data = n // horizon
    if data * horizon != n:
        raise ValueError(
            f"mesh {data}x{horizon} != {n} available devices")
    arr = np.asarray(devices).reshape(data, horizon)
    return Mesh(arr, (DATA_AXIS, HORIZON_AXIS))


def describe() -> dict:
    """Topology snapshot for logs/benchmark metadata."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": jax.device_count(),
        "backend": jax.default_backend(),
    }
