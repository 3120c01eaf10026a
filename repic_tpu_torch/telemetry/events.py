"""Structured JSONL event log: run ids, nested spans, leveled logs
(the port's copy of ``repic_tpu_torch.telemetry.events``).

* **Spans** (:func:`span`) -- named, attribute-carrying wall-clock
  sections with process-unique ids and parent links (nesting tracked
  per thread and context via ``contextvars``).  Every span exit
  observes the ``repic_span_seconds`` histogram, attaches the build
  and transfer deltas that happened inside it
  (:mod:`repic_tpu_torch.telemetry.probes`), and, while a run log is
  active, appends one JSONL record.  Under ``--device-time`` a span
  syncs the device on entry and exit and records ``host_s`` and
  ``device_tail_s``.  While a profiler records, a span is also a
  named range in its trace (:func:`~repic_tpu_torch.utils.tracing.
  annotate`); the event log and the registry see nothing of that.
* **Events** (:func:`event`) -- point-in-time records (a capacity
  escalation, the profiler's trace directory) in the same stream.
* **Leveled structured logger** (:func:`get_logger`) -- messages keep
  their text behind a level/logger prefix and are mirrored into the
  active run log as ``ev=log`` records.  Logging stays live when
  telemetry is disabled.

Record shapes (one JSON object per line, ``run`` = run id)::

    {"ev":"span","name":...,"span":7,"parent":3,"t":...,"dur_s":...}
    {"ev":"event","name":...,"t":...}
    {"ev":"log","level":"info","logger":...,"msg":...,"t":...}
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
import uuid

from repic_tpu_torch.telemetry import metrics, probes
from repic_tpu_torch.telemetry import trace as _trace
from repic_tpu_torch.utils import tracing as _tracing

EVENTS_NAME = "_events.jsonl"


def host_events_name(host: str) -> str:
    """Per-host event log file name (cluster runs): each host appends
    to its OWN ``_events.<host>.jsonl`` — the same single-writer
    scheme as the per-host journals, so concurrent hosts sharing one
    run directory never interleave (or clobber) each other's
    records."""
    from repic_tpu_torch.runtime.journal import sanitize_host_id

    return f"_events.{sanitize_host_id(host)}.jsonl"


def events_paths(out_dir: str) -> list[str]:
    """Every event log of a run: the single-process ``_events.jsonl``
    plus any per-host ``_events.<host>.jsonl``, in sorted order."""
    from repic_tpu_torch.runtime.journal import host_artifact_paths

    return [
        path
        for _, path in host_artifact_paths(out_dir, EVENTS_NAME)
    ]

# per-thread/ctx stack of open span ids (parent linkage)
_SPAN_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repic_tpu_span_stack", default=()
)
_SPAN_IDS = itertools.count(1)
_CURRENT_LOG: "EventLog | None" = None

_SPAN_SECONDS = metrics.histogram(
    "repic_span_seconds", "wall-clock duration of telemetry spans"
)


def new_run_id() -> str:
    return uuid.uuid4().hex[:12]


class EventLog:
    """Append-only JSONL sink for one run (flushed per record)."""

    def __init__(self, path: str, run_id: str | None = None):
        self.path = path
        self.run_id = run_id or new_run_id()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "at")
        # spans close from both the chunk-prefetch worker and the
        # consumer thread: writes must be line-atomic on one handle
        self._wlock = threading.Lock()

    def write(self, record: dict) -> None:
        record.setdefault("run", self.run_id)
        line = json.dumps(record, default=str) + "\n"
        # serializing the write+flush IS this lock's purpose: span
        # records arrive from the prefetch worker and the consumer on
        # one shared handle, and flushing outside the lock could
        # interleave two half-written lines
        with self._wlock:  # repic: noqa[RT303]
            if self._fh is None:
                return
            self._fh.write(line)
            self._fh.flush()

    def close(self) -> None:
        with self._wlock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def current_log() -> EventLog | None:
    return _CURRENT_LOG


def set_current_log(log: EventLog | None) -> EventLog | None:
    """Install ``log`` as the process-wide run log; returns the
    previous one (callers restore it, so sequential runs — e.g.
    iterative rounds — nest correctly)."""
    global _CURRENT_LOG
    prev = _CURRENT_LOG
    _CURRENT_LOG = log
    return prev


class _Span:
    """Context manager measuring one named section.

    A plain class (not ``@contextmanager``), so span entry is a few
    attribute writes and one ``perf_counter`` call: spans sit around
    per-chunk and per-micrograph work.
    """

    __slots__ = (
        "name", "attrs", "span_id", "parent_id",
        "_t0", "_wall0", "_c0", "_token", "_range", "_stopped",
    )

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _SPAN_STACK.get()
        self.parent_id = stack[-1] if stack else None
        self.span_id = next(_SPAN_IDS)
        self._token = _SPAN_STACK.set(stack + (self.span_id,))
        if probes.device_time_enabled():
            # drain device work queued BEFORE this span so an earlier
            # stage's async tail is not attributed to this one
            probes.sync_device()
        self._stopped = None
        self._range = _tracing.annotate(self.name)
        self._range.__enter__()
        self._c0 = probes.counters()
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def _measure(self) -> tuple:
        host_dur = time.perf_counter() - self._t0
        # Device-time attribution (opt-in, --device-time): block until
        # the device drained, splitting the span into the host-side
        # wall time and the device tail still executing when the host
        # reached span end.  Serializes stages by design — attribution
        # mode trades overlap for an exact split.
        tail = (
            probes.sync_device()
            if probes.device_time_enabled()
            else None
        )
        return host_dur, tail, probes.counters()

    def stop(self) -> None:
        """End the span's measurement here: its duration, device-time
        split and counter deltas.  The rest of the block still nests
        in the span (its profiler range, its children's parent)."""
        if self._stopped is None:
            self._stopped = self._measure()

    def __exit__(self, exc_type, exc, tb):
        host_dur, tail, c1 = self._stopped or self._measure()
        dur = host_dur if tail is None else host_dur + tail
        _SPAN_STACK.reset(self._token)
        _SPAN_SECONDS.observe(dur, name=self.name)
        log = _CURRENT_LOG
        if log is not None:
            rec = {
                "ev": "span",
                "name": self.name,
                "span": self.span_id,
                "t": round(self._wall0, 6),
                "dur_s": round(dur, 6),
            }
            if self.parent_id is not None:
                rec["parent"] = self.parent_id
            if c1[0] != self._c0[0]:
                rec["recompiles"] = c1[0] - self._c0[0]
            if c1[1] != self._c0[1]:
                rec["transfer_bytes"] = c1[1] - self._c0[1]
                rec["transfer_fetches"] = c1[2] - self._c0[2]
            if tail is not None:
                rec["host_s"] = round(host_dur, 6)
                rec["device_tail_s"] = round(tail, 6)
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            tid = _trace.current_trace_id()
            if tid is not None:
                rec["trace"] = tid
            rec.update(self.attrs)
            log.write(rec)
        self._range.__exit__(exc_type, exc, tb)
        return False  # never swallow


class _NullSpan:
    """The span of a disabled registry: nothing measured or drawn."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def stop(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """A telemetry span; a shared no-op context when disabled."""
    if not metrics.enabled():
        return _NULL_SPAN
    return _Span(name, attrs)


def event(name: str, **fields) -> None:
    """Point-in-time record into the active run log (no-op without
    one; the metrics registry is the durable aggregate surface)."""
    log = _CURRENT_LOG
    if log is None or not metrics.enabled():
        return
    rec = {"ev": "event", "name": name, "t": round(time.time(), 6)}
    stack = _SPAN_STACK.get()
    if stack:
        rec["span"] = stack[-1]
    tid = _trace.current_trace_id()
    if tid is not None:
        rec["trace"] = tid
    rec.update(fields)
    log.write(rec)


# -- leveled structured logger ---------------------------------------

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _threshold() -> int:
    name = os.environ.get("REPIC_TPU_LOG_LEVEL", "info").lower()
    return _LEVELS.get(name, 20)


class StructuredLogger:
    """Leveled logger keeping historical message text greppable.

    ``log.info("msg", key=value)`` prints
    ``repic-tpu INFO [name] msg key=value`` — the message text itself
    is unchanged from the ``print`` it replaced, so existing log
    forensics (grep for "exhausted device memory", "particles") keep
    matching — and mirrors the record into the active run log.
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _log(self, level: str, msg: str, **fields) -> None:
        if _LEVELS[level] < _threshold():
            return
        suffix = "".join(
            f" {k}={v}" for k, v in fields.items()
        )
        stream = (
            sys.stderr if _LEVELS[level] >= 30 else sys.stdout
        )
        print(
            f"repic-tpu {level.upper()} [{self.name}] {msg}{suffix}",
            file=stream,
        )
        log = _CURRENT_LOG
        if log is not None and metrics.enabled():
            rec = {
                "ev": "log",
                "level": level,
                "logger": self.name,
                "msg": msg,
                "t": round(time.time(), 6),
            }
            tid = _trace.current_trace_id()
            if tid is not None:
                rec["trace"] = tid
            rec.update(fields)
            log.write(rec)

    def debug(self, msg: str, **fields) -> None:
        self._log("debug", msg, **fields)

    def info(self, msg: str, **fields) -> None:
        self._log("info", msg, **fields)

    def warning(self, msg: str, **fields) -> None:
        self._log("warning", msg, **fields)

    def error(self, msg: str, **fields) -> None:
        self._log("error", msg, **fields)


_LOGGERS: dict[str, StructuredLogger] = {}


def get_logger(name: str) -> StructuredLogger:
    logger = _LOGGERS.get(name)
    if logger is None:
        logger = _LOGGERS[name] = StructuredLogger(name)
    return logger


def read_events(path_or_dir: str) -> list[dict]:
    """All records of a run's event log(s).

    Given a directory, merges the single-process ``_events.jsonl``
    with every per-host ``_events.<host>.jsonl`` (cluster runs) in
    wall-clock order; given a file path, reads just that file.

    As the journal's reader: a torn last line (a crash mid-append) and
    a file deleted between glob and open are tolerated, because the
    post-crash run directory is what ``report`` gets pointed at.
    """
    if os.path.isdir(path_or_dir):
        per_file = [
            _read_event_file(p) for p in events_paths(path_or_dir)
        ]
        if len(per_file) <= 1:
            return per_file[0] if per_file else []
        records = [rec for recs in per_file for rec in recs]
        # stable sort: records with equal stamps keep per-file
        # (append) order
        records.sort(key=lambda r: float(r.get("t", 0.0)))
        return records
    return _read_event_file(path_or_dir)


def _read_event_file(path: str) -> list[dict]:
    from repic_tpu_torch.runtime.journal import _read_entries

    return _read_entries(path)
