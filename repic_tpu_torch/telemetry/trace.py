"""Request-scoped tracing: one trace id from the start of a run (or
a served request) to its last emit (the port's copy of
``repic_tpu.telemetry.trace``).

* **Trace context** -- a ``contextvars``-based :class:`TraceContext`
  (:func:`start` / :func:`activate` / :func:`scope`) carrying the
  ``trace_id``.  While one is active, every span, event and log record
  (:mod:`repic_tpu_torch.telemetry.events`) and every run-journal
  record (:mod:`repic_tpu_torch.runtime.journal`) carries a ``trace``
  field.  ``threading.Thread`` does not inherit contextvars, so a
  thread that emits records is started through :func:`thread_target`.
  A CLI run opens a synthetic root trace.
* **Trace artifact** -- ``_trace.jsonl`` next to the run journal: one
  root record plus one record per *segment* (``load`` / ``compile`` /
  ``execute`` / ``emit``), flushed per record, so a crash tears at
  most the last line, which :func:`read_trace` skips.  The compile
  segment carries the program-cache hit and miss deltas.
* **Rendering** -- :func:`summarize` / :func:`render_waterfall` build
  the waterfall and critical path that ``trace`` prints, with the
  device tail of the ``consensus_dispatch`` spans joined by trace id.

Record shapes (one JSON object per line)::

    {"ev":"trace","trace":...,"t":...,"kind":"cli","run_id":...}
    {"ev":"segment","trace":...,"seg":"execute","t":...,"dur_s":...}

Stdlib only: ``trace`` and ``report`` read the artifact without torch
doing anything.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import time
import uuid

TRACE_NAME = "_trace.jsonl"


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class TraceWriter:
    """Append-only JSONL sink for one request's trace artifact.

    Single-writer by construction: exactly one thread drives a job
    (the serve worker / the CLI main thread), so appends need no lock
    — the flush-per-record is the durability contract, mirroring the
    run journal.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "at")

    def write(self, record: dict) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(record, default=str) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TraceContext:
    """One request's trace identity plus (optionally) its artifact."""

    __slots__ = ("trace_id", "writer")

    def __init__(self, trace_id: str, writer: TraceWriter | None):
        self.trace_id = trace_id
        self.writer = writer

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


_CTX: contextvars.ContextVar[TraceContext | None] = (
    contextvars.ContextVar("repic_tpu_trace_ctx", default=None)
)


def current() -> TraceContext | None:
    return _CTX.get()


def current_trace_id() -> str | None:
    """The active trace id, or None.  One contextvar load — cheap
    enough for every span exit and journal append to call."""
    ctx = _CTX.get()
    return ctx.trace_id if ctx is not None else None


def start(
    out_dir: str | None,
    trace_id: str | None = None,
    host: str | None = None,
    **attrs,
) -> TraceContext:
    """Open a trace context (and its ``_trace.jsonl`` when ``out_dir``
    is given), writing the root record.  Does NOT activate it — pair
    with :func:`activate`/:func:`deactivate`, or use :func:`scope`.

    ``host`` switches to the per-host artifact name
    (``_trace.<host>.jsonl``) — cluster runs share ``out_dir``, so N
    processes appending the plain name would interleave records; the
    per-host scheme mirrors the journal's (single writer per file,
    merged on read).
    """
    tid = trace_id or new_trace_id()
    writer = None
    if out_dir is not None:
        writer = TraceWriter(trace_path(out_dir, host=host))
        rec = {
            "ev": "trace",
            "trace": tid,
            "t": round(time.time(), 6),
        }
        if host is not None:
            rec["host"] = host
        rec.update(attrs)
        writer.write(rec)
    return TraceContext(tid, writer)


def activate(ctx: TraceContext | None):
    """Install ``ctx`` as the active trace for this thread/context;
    returns the token :func:`deactivate` restores from."""
    return _CTX.set(ctx)


def deactivate(token) -> None:
    _CTX.reset(token)


@contextlib.contextmanager
def scope(
    out_dir: str | None = None,
    trace_id: str | None = None,
    **attrs,
):
    """``start`` + ``activate`` + close, as one context manager."""
    ctx = start(out_dir, trace_id=trace_id, **attrs)
    token = activate(ctx)
    try:
        yield ctx
    finally:
        deactivate(token)
        ctx.close()


def thread_target(fn, *args, **kwargs):
    """Bind ``fn`` to the caller's context (trace id and span stack
    included) for use as a ``threading.Thread`` target: a thread does
    not inherit contextvars on its own."""
    captured = contextvars.copy_context()

    def run():
        return captured.run(fn, *args, **kwargs)

    return run


def add_segment(
    name: str, start_ts: float, dur_s: float, **attrs
) -> None:
    """Record one timed segment on the active trace artifact.

    No-op without an active context carrying a writer — segment call
    sites (daemon, pipeline) never need to guard.
    """
    ctx = _CTX.get()
    if ctx is None or ctx.writer is None:
        return
    rec = {
        "ev": "segment",
        "trace": ctx.trace_id,
        "seg": name,
        "t": round(float(start_ts), 6),
        "dur_s": round(max(float(dur_s), 0.0), 6),
    }
    rec.update(attrs)
    ctx.writer.write(rec)


@contextlib.contextmanager
def segment(name: str, **attrs):
    """Measure a block as one segment (wall clock)."""
    t0 = time.time()
    try:
        yield
    finally:
        add_segment(name, t0, time.time() - t0, **attrs)


# -- reading / rendering ----------------------------------------------


def trace_path(out_dir: str, host: str | None = None) -> str:
    if host is None:
        return os.path.join(out_dir, TRACE_NAME)
    # one sanitization rule for every per-host artifact name
    from repic_tpu_torch.runtime.journal import sanitize_host_id

    stem, ext = os.path.splitext(TRACE_NAME)
    return os.path.join(
        out_dir, f"{stem}.{sanitize_host_id(host)}{ext}"
    )


def read_trace(path_or_dir: str) -> list[dict]:
    """All records of a trace artifact (torn-trailing-line tolerant —
    the post-crash artifact is exactly what ``repic-tpu trace`` gets
    pointed at).  Accepts the run directory — merging any per-host
    ``_trace.<host>.jsonl`` files a cluster run left — or one file.
    """
    # the journal's reader IS the torn-tail/OSError tolerance
    # contract (and host_artifact_paths the per-host discovery) —
    # share them rather than keeping copies that can drift
    from repic_tpu_torch.runtime.journal import (
        _read_entries,
        host_artifact_paths,
    )

    path = path_or_dir
    if os.path.isdir(path):
        out: list[dict] = []
        for _host, p in host_artifact_paths(path, TRACE_NAME):
            out.extend(_read_entries(p))
        return out
    return _read_entries(path)


def summarize(records: list[dict]) -> dict:
    """Fold one artifact's records into per-trace summaries.

    Returns ``{trace_id: {"t0", "kind", "job", "segments": [...],
    "segment_totals": {name: s}, "span_s", "cache": {...}}}`` —
    ``span_s`` is first-segment-start to last-segment-end (the
    waterfall extent), ``segments`` keeps record order.
    """
    out: dict[str, dict] = {}
    for rec in records:
        tid = rec.get("trace")
        if not tid:
            continue
        tr = out.setdefault(
            tid,
            {
                "t0": None,
                "kind": None,
                "job": None,
                "segments": [],
                "segment_totals": {},
                "span_s": 0.0,
            },
        )
        if rec.get("ev") == "trace":
            tr["t0"] = rec.get("t")
            tr["kind"] = rec.get("kind")
            tr["job"] = rec.get("job")
        elif rec.get("ev") == "segment":
            seg = dict(rec)
            seg.pop("ev", None)
            seg.pop("trace", None)
            tr["segments"].append(seg)
            name = seg.get("seg", "?")
            tr["segment_totals"][name] = round(
                tr["segment_totals"].get(name, 0.0)
                + float(seg.get("dur_s", 0.0)),
                6,
            )
            hits = seg.get("cache_hits")
            misses = seg.get("cache_misses")
            if hits is not None or misses is not None:
                cache = tr.setdefault(
                    "cache", {"hits": 0, "misses": 0}
                )
                cache["hits"] += int(hits or 0)
                cache["misses"] += int(misses or 0)
    for tr in out.values():
        segs = tr["segments"]
        if segs:
            start = min(float(s.get("t", 0.0)) for s in segs)
            end = max(
                float(s.get("t", 0.0)) + float(s.get("dur_s", 0.0))
                for s in segs
            )
            if tr["t0"] is None:
                tr["t0"] = start
            tr["span_s"] = round(end - min(start, float(tr["t0"])), 6)
        tr["total_s"] = round(
            sum(tr["segment_totals"].values()), 6
        )
    return out


def critical_path(segments: list[dict]) -> list[dict]:
    """The chain of segments covering the trace's makespan.

    Interval sweep: starting at the earliest segment, repeatedly pick
    the segment that begins at (or before, with the largest overlap
    into) the frontier and extends it furthest.  For the serial
    request pipeline this degenerates to "the segments in order", but
    it stays correct when segments overlap (device tail vs emit) —
    the path then names the ones that actually bound the wall time.
    """
    segs = [
        s for s in segments
        if float(s.get("dur_s", 0.0)) > 0.0
    ]
    if not segs:
        return []
    segs = sorted(
        segs,
        key=lambda s: (float(s.get("t", 0.0)),
                       -float(s.get("dur_s", 0.0))),
    )
    end_of = lambda s: float(s.get("t", 0.0)) + float(  # noqa: E731
        s.get("dur_s", 0.0)
    )
    path = [segs[0]]
    frontier = end_of(segs[0])
    eps = 1e-6
    while True:
        # candidates touching the frontier (tiny gaps tolerated: the
        # artifact's timestamps are rounded to microseconds and real
        # pipelines have sub-ms bookkeeping gaps between segments)
        best = None
        for s in segs:
            t = float(s.get("t", 0.0))
            e = end_of(s)
            if e <= frontier + eps:
                continue
            if t <= frontier + 0.005:
                if best is None or e > end_of(best):
                    best = s
        if best is None:
            # a real gap: jump to the next segment after the frontier
            nxt = [
                s for s in segs
                if float(s.get("t", 0.0)) >= frontier - eps
                and end_of(s) > frontier + eps
            ]
            if not nxt:
                break
            best = min(nxt, key=lambda s: float(s.get("t", 0.0)))
        path.append(best)
        frontier = end_of(best)
    return path


def _seg_label(seg: dict) -> str:
    name = seg.get("seg", "?")
    if "chunk" in seg:
        name += f"[{seg['chunk']}]"
    return name


def render_waterfall(
    tid: str, tr: dict, width: int = 32, events: list | None = None
) -> str:
    """Human-readable waterfall + critical path for one trace.

    ``events`` (optional, the run's ``_events.jsonl`` records) adds
    the device-time join: ``consensus_dispatch`` spans carrying this
    trace id contribute a device-tail line when the run was
    device-timed (``--device-time``).
    """
    lines = [
        f"trace {tid}"
        + (f" (job {tr['job']})" if tr.get("job") else "")
        + (f" kind={tr['kind']}" if tr.get("kind") else "")
    ]
    segs = tr.get("segments", [])
    if not segs:
        lines.append("  (no segments recorded)")
        return "\n".join(lines)
    t0 = min(float(s.get("t", 0.0)) for s in segs)
    end = max(
        float(s.get("t", 0.0)) + float(s.get("dur_s", 0.0))
        for s in segs
    )
    span = max(end - t0, 1e-9)
    total = sum(float(s.get("dur_s", 0.0)) for s in segs)
    lines.append(
        f"  wall (first->last segment): {span:.3f}s, "
        f"segment sum: {total:.3f}s"
    )
    name_w = max(len(_seg_label(s)) for s in segs)
    for s in segs:
        t = float(s.get("t", 0.0))
        d = float(s.get("dur_s", 0.0))
        lo = int((t - t0) / span * width)
        hi = max(int((t - t0 + d) / span * width), lo + 1)
        hi = min(hi, width)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        extra = ""
        hits, misses = s.get("cache_hits"), s.get("cache_misses")
        if hits is not None or misses is not None:
            extra += f"  cache_hits={hits or 0}"
            extra += f" cache_misses={misses or 0}"
        if "micrographs" in s:
            extra += f"  micrographs={s['micrographs']}"
        if "capacity" in s:
            extra += f" capacity={s['capacity']}"
        lines.append(
            f"  {_seg_label(s).ljust(name_w)} |{bar}| "
            f"{d:8.3f}s ({d / span * 100.0:5.1f}%){extra}"
        )
    path = critical_path(segs)
    if path:
        lines.append(
            "  critical path: "
            + " -> ".join(
                f"{_seg_label(s)} "
                f"({float(s.get('dur_s', 0.0)):.3f}s)"
                for s in path
            )
        )
    if events:
        tail = 0.0
        n = 0
        for rec in events:
            if (
                rec.get("ev") == "span"
                and rec.get("trace") == tid
                and rec.get("name") == "consensus_dispatch"
                and "device_tail_s" in rec
            ):
                tail += float(rec.get("device_tail_s", 0.0))
                n += 1
        if n:
            lines.append(
                f"  device tail (from {n} dispatch span(s), "
                f"--device-time): {tail:.3f}s"
            )
    return "\n".join(lines)
