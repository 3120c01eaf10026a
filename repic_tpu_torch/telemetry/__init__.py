"""Telemetry: metrics, event spans, device probes, sinks, traces
(the port's copy of ``repic_tpu.telemetry``).

* :mod:`~repic_tpu_torch.telemetry.metrics` -- the process-wide
  registry (``REPIC_TPU_TELEMETRY=0`` turns it off);
* :mod:`~repic_tpu_torch.telemetry.events` -- the JSONL event log and
  the leveled logger;
* :mod:`~repic_tpu_torch.telemetry.probes` -- builds, transfers,
  dispatches and CUDA allocator statistics;
* :mod:`~repic_tpu_torch.telemetry.sinks` -- JSON snapshot,
  Prometheus textfile, runtime TSV;
* :mod:`~repic_tpu_torch.telemetry.trace` -- the request trace and
  ``_trace.jsonl``;
* :mod:`~repic_tpu_torch.telemetry.devicetime`,
  :mod:`~repic_tpu_torch.telemetry.report`,
  :mod:`~repic_tpu_torch.telemetry.server` -- the device-time split,
  ``report`` and the status server.

Run lifecycle (used by ``run_consensus_dir``)::

    rt = telemetry.start_run(out_dir)     # _events.jsonl + baselines
    ... spans / counters fire ...
    telemetry.flush_run(rt)               # per chunk: streaming sinks
    telemetry.finish_run(rt)              # _metrics.json / .prom

A background flusher also rewrites the metric snapshots every
``REPIC_TPU_FLUSH_S`` seconds (default 10; 0 disables it).  ``host=``
switches to the per-host names ``_events.<host>.jsonl`` /
``_metrics.<host>.json``, which ``report`` merges on read.
"""

from __future__ import annotations

import os
import threading

from repic_tpu_torch.telemetry import events, metrics, probes, sinks
from repic_tpu_torch.telemetry.events import (  # noqa: F401
    EVENTS_NAME,
    event,
    get_logger,
    span,
)
from repic_tpu_torch.telemetry.metrics import (  # noqa: F401
    counter,
    enabled,
    gauge,
    get_registry,
    histogram,
    set_enabled,
)
from repic_tpu_torch.telemetry.probes import (  # noqa: F401
    note_dispatch,
    record_transfer,
)
from repic_tpu_torch.telemetry.sinks import (  # noqa: F401
    METRICS_JSON_NAME,
    METRICS_PROM_NAME,
)


#: streaming-flush period (seconds); 0 disables the background thread
DEFAULT_FLUSH_INTERVAL_S = 10.0


def _flush_interval() -> float:
    try:
        return float(
            os.environ.get(
                "REPIC_TPU_FLUSH_S", DEFAULT_FLUSH_INTERVAL_S
            )
        )
    except ValueError:
        return DEFAULT_FLUSH_INTERVAL_S


class RunTelemetry:
    """Handle pairing :func:`start_run` with :func:`finish_run`."""

    __slots__ = (
        "out_dir", "log", "prev", "finished", "probes0", "registry0",
        "host", "json_path", "prom_path", "_lock", "_flush_stop",
        "_flusher",
    )

    def __init__(self, out_dir, log, prev, probes0=None,
                 registry0=None, host=None):
        self.out_dir = out_dir
        self.log = log
        self.prev = prev
        self.probes0 = probes0
        self.registry0 = registry0
        self.host = host
        self.json_path = os.path.join(
            out_dir,
            sinks.host_metrics_json_name(host)
            if host
            else sinks.METRICS_JSON_NAME,
        )
        self.prom_path = os.path.join(
            out_dir,
            sinks.host_metrics_prom_name(host)
            if host
            else sinks.METRICS_PROM_NAME,
        )
        self.finished = False
        self._lock = threading.Lock()
        self._flush_stop: threading.Event | None = None
        self._flusher: threading.Thread | None = None


def start_run(
    out_dir: str,
    run_id: str | None = None,
    host: str | None = None,
    flush_interval_s: float | None = None,
) -> RunTelemetry:
    """Open the per-run event log in ``out_dir`` and baseline the
    probes.

    Inert (no files, no threads) when telemetry is disabled: the run
    then leaves only the journal (and its trace) behind, and
    ``report`` degrades to journal-only tallies.  Probe
    counters and the registry are baselined here so the run's sinks
    report THIS run's numbers even when many runs share one process
    (iterative rounds).

    ``host`` switches to the per-host artifact names
    (``_events.<host>.jsonl`` / ``_metrics.<host>.json``).
    ``flush_interval_s`` overrides the streaming-flush period (env
    ``REPIC_TPU_FLUSH_S``, default 10 s; <= 0 disables the background
    flusher -- :func:`flush_run` still works).
    """
    if not metrics.enabled():
        return RunTelemetry(out_dir, None, None, host=host)
    ev_name = events.host_events_name(host) if host else events.EVENTS_NAME
    log = events.EventLog(
        os.path.join(out_dir, ev_name), run_id=run_id
    )
    prev = events.set_current_log(log)
    rt = RunTelemetry(
        out_dir,
        log,
        prev,
        probes0=probes.snapshot(sample_memory=False),
        registry0=metrics.get_registry().as_dict(),
        host=host,
    )
    # breadcrumb for report's device-time section: the CLI opens the
    # profiler before the run log exists
    from repic_tpu_torch.utils import tracing as _tracing

    trace_dir = _tracing.active_trace_dir()
    if trace_dir:
        events.event("trace_dir", path=trace_dir)
    interval = (
        _flush_interval()
        if flush_interval_s is None
        else flush_interval_s
    )
    if interval and interval > 0:
        rt._flush_stop = threading.Event()

        def _flush_loop():
            while not rt._flush_stop.wait(interval):
                try:
                    flush_run(rt)
                except Exception:  # noqa: BLE001 - never kill the run
                    pass

        rt._flusher = threading.Thread(
            target=_flush_loop,
            daemon=True,
            name="repic-tpu-telemetry-flush",
        )
        rt._flusher.start()
    return rt


def _write_sinks(rt: RunTelemetry, sample_memory: bool) -> None:
    """Publish probe deltas and atomically (re)write both snapshots.

    Streaming flushes pass ``sample_memory=False``: only the final
    ``finish_run`` samples the allocator.
    """
    probes.publish(baseline=rt.probes0, sample_memory=sample_memory)
    reg = metrics.get_registry()
    per_run = metrics.diff_snapshots(reg.as_dict(), rt.registry0 or {})
    sinks.write_metrics_json(rt.json_path, data=per_run)
    sinks.write_prometheus_textfile(rt.prom_path, data=per_run)


def flush_run(rt: RunTelemetry | None) -> None:
    """Streaming flush: rewrite the metric sinks mid-run.

    Called by the background flusher on its interval and by the
    consensus pipeline at every chunk boundary, so a scrape (or an
    operator ``cat``) during a long run sees current numbers.  Writes
    are atomic — a reader gets the previous complete snapshot or the
    new one, never a torn file.  No-op once the run finished (or when
    telemetry is disabled).
    """
    if rt is None or rt.log is None or rt.finished:
        return
    with rt._lock:
        if rt.finished:
            return
        _write_sinks(rt, sample_memory=False)


def finish_run(rt: RunTelemetry | None) -> None:
    """Publish probe deltas and write the metric sinks (idempotent).

    Safe to call from a ``finally``: a run that raised still restores
    the previous event log, closes the file, stops the streaming
    flusher, and writes the sinks (its partial numbers are exactly
    what post-mortem triage wants).
    """
    if rt is None or rt.finished:
        return
    if rt._flush_stop is not None:
        rt._flush_stop.set()
    if rt._flusher is not None:
        rt._flusher.join(timeout=5.0)
    with rt._lock:
        if rt.finished:
            return
        rt.finished = True
        if rt.log is None:
            return
        # restore only if this run's log is still the installed one:
        # two runs overlapping in one process finish out of order, and
        # restoring `prev` blindly would clobber the other's live log
        # or resurrect a closed one
        if events.current_log() is rt.log:
            prev = rt.prev
            if prev is not None and getattr(
                prev, "_fh", None
            ) is None:
                prev = None  # outer run already finished (overlap)
            events.set_current_log(prev)
        rt.log.close()
        _write_sinks(rt, sample_memory=True)
