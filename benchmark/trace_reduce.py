"""Reduce a jax.profiler trace (`.xplane.pb`) to device metrics.

Reads the file with `jax.profiler.ProfileData` and nothing else. On a
GPU the trace holds one plane per card, `/device:GPU:<i>`, whose
`Stream #...` lines carry the kernels and copies that ran on it; other
lines of that plane (`XLA Modules`, `XLA Ops`, ...) are views derived
from the same activity and are left out, so nothing is counted twice.
The host plane carries the benchmark's own `TraceAnnotation` spans
(`draw`, `dispatch`, `result_to_host`), on the same clock.

All intervals are clipped to the window [t0, t1] (ns, trace clock),
which the caller takes from its own spans: from the start of the first
timed dispatch to the end of the last result copy.
"""
from __future__ import annotations

import bisect
import glob
import os
from collections import defaultdict

DEVICE_PREFIX = "/device:GPU:"
HOST_PLANE = "/host:CPU"
# Collective kernels: NCCL's device kernels and XLA's own collective
# thunks, as they are named in a GPU trace.
COLLECTIVE_MARKS = ("nccl", "all-reduce", "allreduce", "all_reduce")


def find_xplane(trace_dir: str) -> str:
    """The newest `.xplane.pb` under `trace_dir`."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def _union(intervals):
    """Merge (start, end) intervals; returns a sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def _subtract(a, b):
    """Parts of disjoint sorted intervals `a` not covered by `b`."""
    out = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def _clip(s, e, t0, t1):
    s, e = max(s, t0), min(e, t1)
    return (s, e) if e > s else None


def load(path: str) -> dict:
    """Device events and host spans of one trace file.

    Returns {"devices": {index: [(name, start_ns, end_ns), ...]},
             "spans": [(name, start_ns, end_ns), ...]}.
    """
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    devices = {}
    spans = []
    for plane in data.planes:
        if plane.name.startswith(DEVICE_PREFIX):
            idx = int(plane.name[len(DEVICE_PREFIX):])
            evs = devices.setdefault(idx, [])
            for line in plane.lines:
                if not line.name.startswith("Stream"):
                    continue
                for ev in line.events:
                    if ev.duration_ns > 0:
                        evs.append((ev.name, int(ev.start_ns),
                                    int(ev.start_ns + ev.duration_ns)))
        elif plane.name == HOST_PLANE:
            for line in plane.lines:
                for ev in line.events:
                    spans.append((ev.name, int(ev.start_ns),
                                  int(ev.start_ns + ev.duration_ns)))
    return {"devices": devices, "spans": spans}


def reduce(trace: dict, t0: int, t1: int,
           labels=("draw", "dispatch", "result_to_host"),
           top: int = 10) -> dict:
    """Window metrics of a loaded trace.

    busy_s        per device, the union of its op intervals in the window
    idle_gaps     idle stretches of device 0 (the gaps between its busy
                  intervals), summed by the benchmark span that overlaps
                  each gap most ("none" when no span does)
    op_seconds    device time by op name, summed over devices
    collective_exposed_s  per device, time in collective ops during
                  which no other op ran on that device
    """
    window_ns = t1 - t0
    busy = {}
    exposed = {}
    op_ns = defaultdict(int)
    busy_iv = {}
    for idx, evs in sorted(trace["devices"].items()):
        coll, comp = [], []
        for name, s, e in evs:
            iv = _clip(s, e, t0, t1)
            if iv is None:
                continue
            op_ns[name] += iv[1] - iv[0]
            low = name.lower()
            (coll if any(k in low for k in COLLECTIVE_MARKS)
             else comp).append(iv)
        all_iv = _union(coll + comp)
        busy_iv[idx] = all_iv
        busy[idx] = _length(all_iv) / 1e9
        exposed[idx] = _length(_subtract(_union(coll), _union(comp))) / 1e9

    gaps = defaultdict(lambda: [0, 0, 0])  # label -> [ns, count, max]
    dev0 = busy_iv.get(min(busy_iv)) if busy_iv else []
    # The benchmark's spans run one after another on one thread, so
    # those overlapping a gap are the few that start before its end.
    host = sorted((s, e, n) for n, s, e in trace["spans"] if n in labels)
    starts = [s for s, _, _ in host]
    longest = max((e - s for s, e, _ in host), default=0)
    edges = [t0] + [x for iv in dev0 for x in iv] + [t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        best, best_ov = "none", 0
        k = bisect.bisect_left(starts, e) - 1
        while k >= 0 and host[k][0] > s - longest:
            hs, he, n = host[k]
            ov = min(e, he) - max(s, hs)
            if ov > best_ov:
                best, best_ov = n, ov
            k -= 1
        g = gaps[best]
        g[0] += e - s
        g[1] += 1
        g[2] = max(g[2], e - s)

    ops = sorted(op_ns.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_s": window_ns / 1e9,
        "busy_s": busy,
        "collective_exposed_s": exposed,
        "device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
        "idle_gaps": [[f"{n} (gaps {c}, longest {mx / 1e6} ms)", ns / 1e9]
                      for n, (ns, c, mx) in idle],
    }


def describe(path: str, top: int = 6) -> list:
    """Every plane and line of a trace file, with its event count and
    the names that take most time: for reading a trace by hand."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(path).planes:
        for line in plane.lines:
            by = defaultdict(int)
            count = 0
            for ev in line.events:
                by[ev.name[:100]] += int(ev.duration_ns)
                count += 1
            names = sorted(by.items(), key=lambda kv: -kv[1])[:top]
            out.append([plane.name, line.name, count, names])
    return out


if __name__ == "__main__":
    import json
    import sys

    for row in describe(find_xplane(sys.argv[1])):
        print(json.dumps(row))
