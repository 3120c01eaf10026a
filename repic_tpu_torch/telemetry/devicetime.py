"""Device-time attribution: where does device time go?  (The port's
counterpart of ``repic_tpu.telemetry.devicetime``.)

Two host-only sources (``report`` reads them without touching a
device):

* **Span sync stats** (``--device-time``): spans bracket their
  sections with device syncs
  (:func:`repic_tpu_torch.telemetry.probes.sync_device`), so each span
  record carries ``host_s`` (host wall time until span end) and
  ``device_tail_s`` (device work still executing then).
  :func:`span_device_time` aggregates them per stage and, for the
  ``consensus_dispatch`` / ``consensus_chunk`` spans, which carry a
  ``capacity``, per padded capacity bucket, and derives a dispatch-gap
  estimate.
* **Profiler traces** (``--profile`` / ``--trace-dir``):
  :func:`parse_trace_dir` summarises the Chrome-trace JSON that
  ``torch.profiler``'s TensorBoard handler writes
  (``*.pt.trace.json``), giving device busy time against trace wall
  time.  A missing or unreadable file degrades to ``{}``: ``report``
  runs where the trace may not be.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re


def _acc(table: dict, key, rec: dict) -> None:
    slot = table.setdefault(
        key, {"count": 0, "host_s": 0.0, "device_tail_s": 0.0}
    )
    slot["count"] += 1
    slot["host_s"] += float(rec.get("host_s", 0.0))
    slot["device_tail_s"] += float(rec.get("device_tail_s", 0.0))


def _finalize(slot: dict) -> dict:
    total = slot["host_s"] + slot["device_tail_s"]
    return {
        "count": slot["count"],
        "host_s": round(slot["host_s"], 6),
        "device_tail_s": round(slot["device_tail_s"], 6),
        "device_frac": round(
            slot["device_tail_s"] / total if total > 0 else 0.0, 4
        ),
    }


def span_device_time(records) -> dict:
    """Aggregate the ``--device-time`` span fields of an event stream.

    Returns ``{}`` when no span carries the device-time fields (the
    run was not device-timed).  Otherwise::

        {"stages": {name: {count, host_s, device_tail_s,
                           device_frac}},
         "by_capacity": {capacity: {...}},   # consensus_chunk spans
         "dispatch_gap_s": float}            # see below

    ``dispatch_gap_s`` estimates host-side stall while the device
    program is being driven, accumulated PER SPAN (``max(host_s -
    device_tail_s, 0)`` each) so a device-saturated span cannot
    cancel out a dispatch-bound span's stall.  It is computed from
    the ``consensus_dispatch`` spans, which close right after the
    async dispatch — their ``host_s`` is pure host trace/dispatch
    work and their ``device_tail_s`` the batch's device execution
    (the ``consensus_chunk`` span would be useless here: it contains
    the blocking result fetch, which drains the device before span
    exit, so its tail is ~0 by construction).  Saturated device ->
    every term ~0; dispatch/RTT-bound -> terms approach the dispatch
    wall times.  An upper bound — host work overlapping device
    execution counts toward it — refined by the profiler-trace
    numbers when ``--trace-dir`` was also used.  Streams without
    dispatch spans fall back to the chunk spans.
    """
    stages: dict = {}
    by_cap: dict = {"consensus_dispatch": {}, "consensus_chunk": {}}
    gaps = {"consensus_dispatch": None, "consensus_chunk": None}
    timed = False
    for rec in records:
        if rec.get("ev") != "span" or "device_tail_s" not in rec:
            continue
        timed = True
        name = rec.get("name", "?")
        _acc(stages, name, rec)
        if name in gaps:
            gaps[name] = (gaps[name] or 0.0) + max(
                float(rec.get("host_s", 0.0))
                - float(rec.get("device_tail_s", 0.0)),
                0.0,
            )
            cap = rec.get("capacity")
            if cap is not None:
                _acc(by_cap[name], int(cap), rec)
    if not timed:
        return {}
    out = {
        "stages": {
            name: _finalize(slot)
            for name, slot in sorted(stages.items())
        },
    }
    by_capacity = (
        by_cap["consensus_dispatch"] or by_cap["consensus_chunk"]
    )
    if by_capacity:
        out["by_capacity"] = {
            cap: _finalize(slot)
            for cap, slot in sorted(by_capacity.items())
        }
    gap = (
        gaps["consensus_dispatch"]
        if gaps["consensus_dispatch"] is not None
        else gaps["consensus_chunk"]
    )
    if gap is not None:
        out["dispatch_gap_s"] = round(gap, 6)
    return out


# Device lanes, by the Chrome trace's process metadata: Kineto names
# every lane after the program ("python3") and labels a GPU lane
# "GPU 0" (``process_labels``); the reference's traces name theirs
# "/device:TPU:0" / "TPU:0".  Word-boundary match on tpu/gpu: a host
# lane whose name merely contains the letters (a "repic_tpu worker"
# pool) is not a device lane.
_DEVICE_LANE_RE = re.compile(
    r"/device:|(?<![a-z0-9_])(tpu|gpu)(?![a-z0-9_])"
)


def device_lanes(trace_events) -> set:
    """The pids of a Chrome trace's device lanes: those whose
    ``process_name`` or ``process_labels`` matches the device pattern."""
    text: dict = {}
    for e in trace_events:
        if e.get("ph") == "M" and e.get("name") in ("process_name",
                                                    "process_labels"):
            args = e.get("args") or {}
            value = args.get("name", args.get("labels", ""))
            text[e.get("pid")] = f"{text.get(e.get('pid'), '')} {value}"
    return {pid for pid, t in text.items()
            if _DEVICE_LANE_RE.search(t.lower())}

# What counts as device work on a device lane.  Kineto also draws the
# ``record_function`` ranges (``gpu_user_annotation``) there, over the
# kernels they enclose: counting them would count that time twice.
# An event without a category (the reference's traces) counts.
DEVICE_WORK_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))


def _union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def parse_trace_dir(trace_dir: str) -> dict:
    """Summary of a profiler trace directory.

    Finds every Chrome-trace JSON (``*.trace.json[.gz]``, Kineto's
    ``*.pt.trace.json`` included) under ``trace_dir``, classifies
    lanes into device and host (:func:`device_lanes`), and returns::

        {"wall_s", "device_busy_s", "host_busy_s", "device_ops",
         "dispatch_gap_s", "files"}

    ``device_busy_s`` is the union of the intervals of the device work
    on device lanes (kernels, copies, memsets: :data:`DEVICE_WORK_CATS`),
    so overlapping streams and annotation ranges count once;
    ``device_ops`` counts those events; ``dispatch_gap_s = wall_s -
    device_busy_s`` (floored at 0) is the idle-device estimate.  A
    missing or unparseable artifact gives ``{}``.
    """
    pattern = os.path.join(trace_dir, "**", "*.trace.json*")
    paths = [
        p
        for p in sorted(glob.glob(pattern, recursive=True))
        if p.endswith((".trace.json", ".trace.json.gz"))
    ]
    trace_events: list[dict] = []
    used_files = []
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        try:
            with opener(path, "rt") as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(data, dict):
            evs = data.get("traceEvents", [])
        elif isinstance(data, list):  # bare event-array variant
            evs = data
        else:
            continue
        if evs:
            trace_events.extend(e for e in evs if isinstance(e, dict))
            used_files.append(os.path.relpath(path, trace_dir))
    if not trace_events:
        return {}

    lanes = device_lanes(trace_events)
    t_min, t_max = None, None
    device: list[tuple[float, float]] = []
    host_us = 0.0
    for e in trace_events:
        if e.get("ph") != "X":
            continue
        try:
            ts = float(e.get("ts", 0.0))
            dur = float(e.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = ts + dur if t_max is None else max(t_max, ts + dur)
        if e.get("pid") not in lanes:
            host_us += dur
        elif e.get("cat") is None or e.get("cat") in DEVICE_WORK_CATS:
            device.append((ts, ts + dur))
    if t_min is None:
        return {}
    wall_s = (t_max - t_min) / 1e6
    device_busy_s = _union_us(device) / 1e6
    return {
        "wall_s": round(wall_s, 6),
        "device_busy_s": round(device_busy_s, 6),
        "host_busy_s": round(host_us / 1e6, 6),
        "device_ops": len(device),
        "dispatch_gap_s": round(max(wall_s - device_busy_s, 0.0), 6),
        "files": used_files,
    }
