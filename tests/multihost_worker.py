"""Multi-host worker for test_multihost.py (P4, SURVEY.md §4.4 step 4).

Spawned twice (process_id 0/1) on localhost; each process owns 4 virtual
CPU devices, `jax.distributed.initialize` joins them into one 8-device
global mesh, and both run the IDENTICAL jit'd programs: the shared-matrix
batch solve over a host-spanning ('data',) mesh and the horizon-block
consensus solve over ('horizon',). Prints one JSON summary line; the
parent asserts both processes print the SAME line (cross-host
determinism, SURVEY.md §5.2).
"""
import json
import os
import sys

# CPU-forced BEFORE jax import.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def _load_runtime_standalone():
    """Load parallel/runtime.py WITHOUT importing the package: the
    package import builds module-level jnp constants, which initialises
    the XLA backend — and jax.distributed.initialize must run first."""
    import importlib.util
    path = os.path.join(_REPO, "admm_library", "parallel",
                        "runtime.py")
    spec = importlib.util.spec_from_file_location("_mh_runtime", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    port, pid = sys.argv[1], int(sys.argv[2])
    rt = _load_runtime_standalone()
    rt.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=2, process_id=pid)
    jax.config.update("jax_enable_x64", True)
    from admm_library.parallel import runtime

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from admm_library import Settings, Status
    from admm_library.utils.compile_cache import enable_compile_cache
    from admm_library.models import monte_carlo as mc
    from admm_library.models.partitioned import partition_mpc
    from admm_library.parallel.batch import (
        make_data_mesh, shard_batch, solve_batch_shared)
    from admm_library.parallel.consensus import consensus_solve

    enable_compile_cache()
    desc = runtime.describe()
    assert desc["process_count"] == 2, desc
    assert desc["global_devices"] == 8, desc
    assert desc["local_devices"] == 4, desc

    settings = Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=2000,
                        precision="single")

    # --- P1 over a host-spanning ('data',) mesh ---
    qp, spec, _ = mc.monte_carlo_mpc(
        jax.random.PRNGKey(0), batch=16, N=4, dim=2, dtype=jnp.float32)
    mesh = make_data_mesh(8)
    qp_s, *_ = shard_batch(qp, mesh)
    sol = solve_batch_shared(qp_s, settings)
    status = multihost_utils.process_allgather(sol.status, tiled=True)
    r_p = multihost_utils.process_allgather(sol.r_prim, tiled=True)

    # --- P1 hybrid precision at eps 1e-6 over the same mesh ---
    # The path the BASELINE metric names (wall-clock to 1e-6): f32
    # iterations + re-centered f32 refinement, executed host-spanning
    # under shard_map (VERDICT r2 item 7 second half).
    s_h = Settings(eps_abs=1e-6, eps_rel=1e-6, max_iter=4000,
                   precision="hybrid")
    sol_h = solve_batch_shared(qp_s, s_h)
    status_h = multihost_utils.process_allgather(sol_h.status, tiled=True)
    rp_h = multihost_utils.process_allgather(sol_h.r_prim, tiled=True)
    rd_h = multihost_utils.process_allgather(sol_h.r_dual, tiled=True)

    # --- P2 consensus over a host-spanning ('horizon',) mesh ---
    s0 = np.array([1.0, -2.0, 0.3, -0.1])
    qp_blk, cspec, _ = partition_mpc(
        s0, np.zeros(4), N=8, n_blocks=8, dim=2, dtype=jnp.float32)
    hmesh = make_data_mesh(8, axis="horizon")
    csol = consensus_solve(qp_blk, cspec, hmesh, settings)

    out = {
        "pid": pid,
        "process_count": desc["process_count"],
        "global_devices": desc["global_devices"],
        "batch_status": [int(v) for v in np.asarray(status)],
        "batch_max_rp": float(np.max(np.asarray(r_p))),
        "hybrid_status": [int(v) for v in np.asarray(status_h)],
        "hybrid_max_rp": float(np.max(np.asarray(rp_h))),
        "hybrid_max_rd": float(np.max(np.asarray(rd_h))),
        "consensus_status": int(csol.status),
        "consensus_rp": float(csol.r_prim),
        "consensus_rd": float(csol.r_dual),
    }
    # The determinism line excludes pid (must be bitwise-identical
    # across hosts); pid goes to stderr for debugging.
    print(json.dumps({k: v for k, v in out.items() if k != "pid"}),
          flush=True)
    runtime.shutdown()


if __name__ == "__main__":
    main()
