"""What a large plain f32 matmul, f64 matmul and copy reach on this card.

    python3 benchmark/calibrate.py

Prints one JSON line with the achieved rates beside the published peaks
of benchmark/peaks.json and the card's power limit, so that a roofline
share can be read against what the card delivers as well as against
its data sheet. f32 products run at HIGHEST precision (IEEE f32, as the
solver pins its dots), not TF32.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)


def _best_seconds(fn, *args, reps: int = 10) -> float:
    import jax
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main() -> int:
    import jax
    import jax.numpy as jnp
    import run

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("calibrate.py: JAX finds no GPU", file=sys.stderr)
        return 3
    jax.config.update("jax_enable_x64", True)
    out = {"kind": dev.device_kind, "peaks": run.device_peaks(
        dev.device_kind)}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["nvidia_smi"] = repr(e)
    key = jax.random.key(0)
    for dtype, nn in ((jnp.float32, 8192), (jnp.float64, 8192)):
        a = jax.random.normal(key, (nn, nn), dtype)
        mm = jax.jit(lambda x: jnp.matmul(
            x, x, precision=jax.lax.Precision.HIGHEST))
        t = _best_seconds(mm, a)
        out[f"matmul_{jnp.dtype(dtype).name}_flops"] = 2.0 * nn ** 3 / t
        del a
    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)   # 1 GiB
    cp = jax.jit(lambda v: v + 1.0)
    t = _best_seconds(cp, x)
    out["copy_bytes_per_s"] = 2.0 * x.nbytes / t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
