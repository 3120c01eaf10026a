"""The traced window: a profiler run over a few steps, and the reading
of its trace.

The device's busy time is the union of the kernel, copy and set
intervals inside the window, which runs from the start of the first
``portbench.step`` span to the end of the last.  Each idle gap between
device intervals is named by the benchmark's span around it and by what
the host was in at the gap's middle: the CUDA API call, else the
innermost operator.  The reading keeps the ten device operations of the
most time and the ten gap names of the most idle time.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SPAN_PREFIX = "portbench."


def run_traced(step, n_steps: int, sync):
    """Run ``step`` ``n_steps`` times under the profiler, each in a
    ``portbench.step`` span; returns ``(units, host seconds, reading)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    units = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            with record_function("portbench.step"):
                units += step()
        sync()
        host_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return units, host_s, read_events(events)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_events(events: list) -> dict:
    """busy_s, window_s, device_ops and idle_gaps from chrome-trace
    events (times in microseconds)."""
    dev, host, steps = [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s, d = float(ev["ts"]), float(ev["dur"])
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, s + d, ev.get("name", "?")))
        elif cat in HOST_CATS:
            name = ev.get("name", "?")
            host.append((s, s + d, name, cat))
            if cat == "user_annotation" and name == "portbench.step":
                steps.append((s, s + d))
    if not steps:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [],
                "idle_gaps": []}
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    ops = defaultdict(float)
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            ops[name] += e - s
            clipped.append((s, e))
    busy = _union(clipped)
    busy_us = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    names = _name_gaps(gaps, host)
    idle = defaultdict(float)
    for (s, e), name in zip(gaps, names):
        idle[name] += e - s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n[:96], v * 1e-6] for n, v in top],
        "idle_gaps": [[n, v * 1e-6] for n, v in top_gaps],
    }


def _name_gaps(gaps, host):
    """``span/what`` for each gap: the innermost benchmark span and the
    CUDA call (else the innermost operator) covering its middle."""
    mine = sorted((h for h in host if h[3] == "user_annotation"
                   and h[2].startswith(SPAN_PREFIX)),
                  key=lambda h: (h[0], -h[1]))
    host = sorted((h for h in host if h[3] != "user_annotation"),
                  key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    out = []
    for s, e in gaps:
        t = 0.5 * (s + e)
        span = None
        for hs, he, name, _ in mine:
            if hs <= t <= he:
                span = name      # the innermost: the latest start
            elif hs > t:
                break
        what = "host"
        # events that start before t, latest first: the innermost
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 2000, -1), -1):
            if host[j][1] >= t:
                what = host[j][2]
                break
        out.append(f"{span or 'outside'}/{what}")
    return out


def idle_pct(ctx, kind: str):
    """The device's idle share of the traced window, in percent, in a
    cell of ``kind``; None elsewhere or without device time."""
    t = ctx["trace"]
    if ctx["kind"] != kind or not t or t["window_s"] <= 0:
        return None
    if t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
