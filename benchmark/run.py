"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell is a configuration (`benchmark/configs/<config>.json`) under a
traffic mix (`benchmark/traffic/<traffic>.json`). Everything is found
by the names in BENCHMARK.json:

  configs/<config>.json      problem family, sizes, solver settings
  problems/<family>.py       build(cfg) and bounds(cfg, prob, s0), f64
  traffic/<traffic>.json     entry point, batch, dispersion, pool
  metrics/<metric>.py        read(run) -> number or None, per metric
  limits/<workload>.json     the limit of each number that decides
                             `correct`, with the readings it was set from

The run: problem data is made from the seed in numpy f64 and cast to
the configuration's dtype; a pool of dispersed problems is uploaded;
every program the window uses is warmed up; then a closed loop sends
the next solve when the last solution is on the host, for --seconds.
With --trace 1 the window (at most the mix's `trace_seconds`) runs
under jax.profiler and the per-layer metrics are read from the trace.
After the window the answers that were sampled from the seed are
checked against the KKT conditions in f64 (reference.py).

The last line of stdout is the result; numbers compared for `correct`
are also the last lines of stderr. Without a GPU, or with fewer GPUs
than the cell asks for, it exits 3 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# The benchmark's own modules, and the checkout's root for the system
# under test (the `admm_library` package).
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import reference  # noqa: E402
import trace_reduce  # noqa: E402

SPANS = ("draw", "dispatch", "result_to_host")


class NoDevice(RuntimeError):
    """JAX finds no GPU, or fewer than the cell asks for."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    name = "bench_" + os.path.relpath(path, HERE).replace(os.sep, "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The workload's entry, its configuration, traffic mix, metrics and
    limits, all found by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "workload": cell,
        "cfg": load_json(os.path.join(root, conf["file"])),
        "traffic": load_json(os.path.join(
            HERE, "traffic", cell["traffic"] + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
        "limits": load_json(os.path.join(HERE, "limits", workload + ".json")),
    }


def require_devices(chips: int):
    """The first `chips` GPUs, or NoDevice."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoDevice(f"JAX finds no GPU (platform {devs[0].platform})")
    if len(devs) < chips:
        raise NoDevice(f"{len(devs)} GPU(s), the cell needs {chips}")
    return devs[:chips]


def enable_compile_cache(root: str = ROOT) -> str:
    """JAX's persistent compilation cache: JAX_COMPILATION_CACHE_DIR if
    set, else a fixed directory in the checkout. Every program is kept,
    however short its compile, so that only a checkout's first run of a
    cell compiles."""
    import jax
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(root, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


# ---------------------------------------------------------------- data

def make_problem(cfg: dict) -> dict:
    """The configuration's problem in f64, rounded through its dtype:
    the data the solver is given, and the reference checks against."""
    fam = load_module(os.path.join(HERE, "problems", cfg["family"] + ".py"))
    prob = fam.build(cfg)
    dt = np.dtype(cfg["dtype"])
    posed = dict(prob)
    for k in ("P", "q", "A", "l", "u", "lam"):
        posed[k] = np.asarray(prob[k]).astype(dt).astype(np.float64)
    posed["bounds"] = fam.bounds
    return posed


def draw_states(cfg: dict, traffic: dict, rng, count: int) -> np.ndarray:
    """`count` initial states from the mix's dispersion."""
    d = traffic["draw"]
    dim = len(cfg["s0_nominal"])
    if d["kind"] == "normal":
        return (np.asarray(cfg["s0_nominal"], np.float64)
                + rng.standard_normal((count, dim)) * np.asarray(d["sigma"]))
    if d["kind"] == "uniform":
        return rng.uniform(d["low"], d["high"], (count, dim))
    raise ValueError(f"unknown draw {d['kind']!r}")


def draw_pool(cfg: dict, traffic: dict, prob: dict, seed: int) -> dict:
    """Bounds of the pool of distinct problems the window cycles through:
    l, u of shape (pool, batch, m) in the configuration's dtype (batch 1
    for single solves), and the order the window takes them in."""
    rng = np.random.default_rng([seed, 0])
    pool, batch = int(traffic["pool"]), int(traffic.get("batch", 1))
    s0 = draw_states(cfg, traffic, rng, pool * batch)
    l, u = prob["bounds"](cfg, prob, s0)
    dt = np.dtype(cfg["dtype"])
    m = l.shape[-1]
    return {"l": l.reshape(pool, batch, m).astype(dt),
            "u": u.reshape(pool, batch, m).astype(dt),
            "order": rng.permutation(pool)}


# ------------------------------------------------------- system under test

def settings_of(cfg: dict, override: dict | None = None):
    import admm_library as adm
    return adm.Settings(**{**cfg["settings"], **(override or {})})


def upload(cfg: dict, traffic: dict, prob: dict, pool: dict, devices):
    """Device problems of the pool, in the program's QPData container,
    laid over a ('data',) mesh when the cell spans several chips."""
    import jax
    import jax.numpy as jnp
    from admm_library.parallel.batch import make_data_mesh, shard_batch
    from admm_library.problem import ConeSpec, QPData

    dt = jnp.dtype(cfg["dtype"])
    cone = ConeSpec(m_box=prob["m_box"], m_l1=prob["m_l1"],
                    soc_dims=tuple(prob["soc_dims"]))
    dev0 = devices[0]
    shared = {k: jax.device_put(np.asarray(prob[k], dt), dev0)
              for k in ("P", "q", "A", "lam")}
    items = []
    for i in range(pool["l"].shape[0]):
        if traffic["entry"] == "single":
            l, u = pool["l"][i, 0], pool["u"][i, 0]
        else:
            l, u = pool["l"][i], pool["u"][i]
        qp = QPData(l=jax.device_put(l, dev0), u=jax.device_put(u, dev0),
                    cone=cone, **shared)
        if len(devices) > 1:
            qp = shard_batch(qp, make_data_mesh(devices=devices))[0]
        items.append(qp)
    jax.block_until_ready(items)
    return items


def entry_point(traffic: dict, settings):
    """The public entry the window drives, as a function of one problem."""
    if traffic["entry"] == "batch":
        from admm_library.parallel.batch import solve_batch_shared
        return lambda qp: solve_batch_shared(qp, settings)
    if traffic["entry"] == "single":
        from admm_library import solve
        return lambda qp: solve(qp, settings)
    raise ValueError(f"unknown entry {traffic['entry']!r}")


def fetch(sol) -> dict:
    """The answer on the host: final unscaled x, z, y, status, iters,
    with a leading lane axis."""
    import jax
    x, z, y, status, iters = jax.device_get(
        (sol.x, sol.z, sol.y, sol.status, sol.iters))
    return {"x": np.atleast_2d(x), "z": np.atleast_2d(z),
            "y": np.atleast_2d(y), "status": np.atleast_1d(status),
            "iters": np.atleast_1d(iters)}


# ---------------------------------------------------------------- window

class CompileCounter:
    """Counts compilations (traces, lowerings, backend compiles and
    persistent-cache loads) while `armed`."""

    MARKS = ("/jax/core/compile/", "/jax/compilation_cache/cache_retrieval")

    def __init__(self):
        import jax.monitoring as mon
        self.armed = False
        self.count = 0
        self.events = {}
        mon.register_event_duration_secs_listener(self._on_duration)

    def _on_duration(self, event, duration, **kw):
        if self.armed and event.startswith(self.MARKS):
            self.count += 1
            self.events[event] = self.events.get(event, 0) + 1


class AnswerSample:
    """A sample of `size` answers drawn from the seed (reservoir
    sampling, so that it needs no count in advance), plus the answer of
    the call with the most iterations."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 1])
        self.kept = []
        self.seen = 0
        self.slowest = None

    def add(self, ans: dict):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(ans)
        elif self.rng.random() < self.size / self.seen:
            self.kept[int(self.rng.integers(self.size))] = ans
        if (self.slowest is None
                or ans["iters"].max() > self.slowest["iters"].max()):
            self.slowest = ans

    def answers(self) -> list:
        if any(a is self.slowest for a in self.kept):
            return list(self.kept)
        return self.kept + [self.slowest]


def run_window(fn, items, order, seconds: float, check: int,
               seed: int) -> dict:
    """Closed loop over the pool for `seconds`: the next problem is sent
    when the last answer is on the host. The last call is the first one
    to end past the deadline, so every call counts whole. Keeps a sample
    of `check` answers drawn from the seed (AnswerSample)."""
    from jax.profiler import TraceAnnotation
    from admm_library.solution import Status

    solved_code = int(Status.SOLVED)
    sample = AnswerSample(check, seed)
    calls = []
    i = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        with TraceAnnotation("draw"):
            k = int(order[i % len(order)])
            qp = items[k]
        td = time.perf_counter()
        with TraceAnnotation("dispatch"):
            sol = fn(qp)
        with TraceAnnotation("result_to_host"):
            ans = fetch(sol)
        tr = time.perf_counter()
        ans["item"] = k
        calls.append({"t_dispatch": td, "t_done": tr,
                      "lanes": int(ans["status"].size),
                      "solved": int(np.sum(ans["status"] == solved_code)),
                      "iters_max": int(ans["iters"].max()),
                      "iters_sum": int(ans["iters"].sum())})
        sample.add(ans)
        i += 1
        if tr >= deadline:
            break
    return {"t0": t0, "t1": calls[-1]["t_done"], "calls": calls,
            "kept": sample.answers()}


def check_answers(prob: dict, pool: dict, kept, cfg: dict) -> dict:
    """Worst KKT ratio over the kept answers (reference.py), in f64."""
    s = cfg["settings"]
    worst = {"kkt_ratio": 0.0, "r_prim": 0.0, "r_dual": 0.0, "r_cone": 0.0}
    count = 0
    for ans in kept:
        l = pool["l"][ans["item"]].astype(np.float64)
        u = pool["u"][ans["item"]].astype(np.float64)
        r = reference.kkt_ratio(prob, l, u, ans["x"], ans["z"], ans["y"],
                                s["eps_abs"], s["eps_rel"])
        count += r["kkt_ratio"].size
        for k in worst:
            worst[k] = max(worst[k], float(np.max(r[k])))
    worst["answers"] = count
    return worst


def decide(worst: dict, limits: dict):
    """(correct, {number: {value, limit}}): every number compared at or
    under its limit, over at least one answer."""
    checks = {name: {"value": worst[name], "limit": lim["limit"]}
              for name, lim in limits["numbers"].items()}
    correct = worst["answers"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return bool(correct), checks


# -------------------------------------------------------------- readings

class PowerSampler:
    """Card clocks, power and temperature from nvidia-smi, sampled beside
    the window by a child process and a reader thread (neither uses
    JAX)."""

    QUERY = "index,clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self, period_ms: int = 250):
        self.rows = []
        self.proc = None
        self.thread = None
        if shutil.which("nvidia-smi") is None:
            return
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.QUERY}",
             "--format=csv,noheader,nounits", f"-lms={period_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) == 5:
                self.rows.append(parts)

    def stop(self) -> dict:
        if self.proc is None:
            return {}
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)
        out = {}
        for idx in sorted({r[0] for r in self.rows}):
            rows = [r for r in self.rows if r[0] == idx]

            def col(j):
                vals = []
                for r in rows:
                    try:
                        vals.append(float(r[j]))
                    except ValueError:
                        pass
                return ([min(vals), float(np.median(vals)), max(vals)]
                        if vals else None)
            out[idx] = {"samples": len(rows), "sm_mhz": col(1),
                        "power_w": col(2), "power_limit_w": col(3),
                        "temp_c": col(4)}
        return out


def memory_peak(devices) -> int:
    return max(int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
               for d in devices)


class Run:
    """What a metric reader sees: the configuration, the window's calls,
    set-up time, chips, the reduced trace (traced runs) and the card's
    peaks."""

    def __init__(self, cell, window, setup_s, chips, trace=None,
                 peaks=None):
        self.cfg = cell["cfg"]
        self.calls = window["calls"]
        self.window_s = window["t1"] - window["t0"]
        self.setup_s = setup_s
        self.chips = chips
        self.trace = trace
        self.peaks = peaks


def read_metrics(run: Run, entries) -> dict:
    out = {}
    for m in entries:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"))
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def device_peaks(kind: str) -> dict:
    table = load_json(os.path.join(HERE, "peaks.json"))
    if kind not in table["devices"]:
        raise KeyError(f"no peaks for device kind {kind!r} in peaks.json")
    return table["devices"][kind]


def trace_window(trace: dict):
    """[first dispatch start, last result_to_host end] in trace ns."""
    d = [s for n, s, _ in trace["spans"] if n == "dispatch"]
    r = [e for n, _, e in trace["spans"] if n == "result_to_host"]
    return min(d), max(r)


def start_trace(path: str):
    """jax.profiler trace into `path`, without the Python call tracer
    (it records every Python call of the loop and slows it) and without
    the programs' HLO; the benchmark's TraceAnnotation spans are kept."""
    import jax
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.enable_hlo_proto = False
    jax.profiler.start_trace(path, profiler_options=opts)


def info(**kw):
    print(json.dumps({"info": kw}), flush=True)


# ------------------------------------------------------------------ main

def prepare(cell: dict, seed: int, devices, override=None):
    """Set-up: data, pool, upload, entry point, warm-up."""
    cfg, traffic = cell["cfg"], cell["traffic"]
    prob = make_problem(cfg)
    pool = draw_pool(cfg, traffic, prob, seed)
    items = upload(cfg, traffic, prob, pool, devices)
    fn = entry_point(traffic, settings_of(cfg, override))
    # Warm-up: the window's own call and copy, on the first problems of
    # the pool, so that every program the window runs is compiled.
    for k in pool["order"][:int(traffic.get("warmup", 1))]:
        fetch(fn(items[int(k)]))
    return prob, pool, items, fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = load_cell(args.workload)
    chips = int(cell["workload"]["chips"])
    try:
        devices = require_devices(chips)
    except NoDevice as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    import jax
    cache_dir = enable_compile_cache()
    kind = devices[0].device_kind
    peaks = device_peaks(kind)
    counter = CompileCounter()

    prob, pool, items, fn = prepare(cell, args.seed, devices)
    traffic = cell["traffic"]
    seconds = args.seconds
    trace_dir = None
    if args.trace:
        seconds = min(seconds, float(traffic["trace_seconds"]))
        trace_dir = tempfile.mkdtemp(prefix="bench_trace_")
        start_trace(trace_dir)
    sampler = PowerSampler()
    try:
        counter.armed = True
        window = run_window(fn, items, pool["order"], seconds,
                            int(traffic["check"]), args.seed)
        counter.armed = False
    finally:
        power = sampler.stop()
    setup_s = window["t0"] - T_START
    if args.trace:
        jax.profiler.stop_trace()
    peak_bytes = memory_peak(devices)
    del items, fn
    calls = window["calls"]
    gaps = [b["t_dispatch"] - a["t_done"] for a, b in zip(calls, calls[1:])]
    lat = [c["t_done"] - c["t_dispatch"] for c in calls]
    info(card=kind, chips=chips, cache_dir=cache_dir, setup_s=setup_s,
         window_s=window["t1"] - window["t0"], calls=len(calls),
         iters_per_call=float(np.mean([c["iters_max"] for c in calls])),
         call_ms={"min": 1e3 * min(lat), "median": 1e3 * float(
             np.median(lat)), "max": 1e3 * max(lat)},
         compiles_in_window=counter.count,
         compile_events=counter.events, power=power,
         generator_gap_ms={"mean": 1e3 * float(np.mean(gaps)) if gaps
                           else 0.0,
                           "max": 1e3 * float(np.max(gaps)) if gaps
                           else 0.0},
         memory_peak_bytes=peak_bytes)

    reduced = None
    if args.trace:
        trace = trace_reduce.load(trace_reduce.find_xplane(trace_dir))
        shutil.rmtree(trace_dir, ignore_errors=True)
        t0, t1 = trace_window(trace)
        reduced = trace_reduce.reduce(trace, t0, t1, labels=SPANS)
        info(trace_window_s=reduced["window_s"], busy_s=reduced["busy_s"],
             collective_exposed_s=reduced["collective_exposed_s"])
    run = Run(cell, window, setup_s, chips, reduced, peaks)
    metrics = read_metrics(run, cell["per_layer"] if args.trace
                           else cell["end_to_end"])
    if hasattr(run, "roofline_bound"):
        info(roofline_bound=run.roofline_bound)

    worst = check_answers(prob, pool, window["kept"], cell["cfg"])
    correct, checks = decide(worst, cell["limits"])
    info(checked_answers=worst["answers"],
         worst={k: worst[k] for k in ("r_prim", "r_dual", "r_cone")})

    attempted = sum(c["lanes"] for c in calls)
    failed = attempted - sum(c["solved"] for c in calls)
    device = {"platform": devices[0].platform, "kind": kind,
              "count": len(jax.devices()), "memory_peak_bytes": peak_bytes}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if reduced is not None:
        busy = list(reduced["busy_s"].values())
        device["busy_s"] = float(np.mean(busy)) if busy else 0.0
        device["window_s"] = reduced["window_s"]
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
