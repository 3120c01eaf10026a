"""Stage timing and profiling (the port's counterpart of
``repic_tpu.utils.tracing``).

:class:`StageTimer` keeps named wall-clock stages and writes them as
the reference's ``stage<TAB>seconds`` rows (``consensus_runtime.tsv``);
each :meth:`StageTimer.stage` is also a telemetry span.
:func:`trace_session` records a ``torch.profiler`` trace of host and
CUDA activity into a directory (``--profile``), in the TensorBoard
layout that ``report`` parses into its device-time section;
:func:`annotate` names a range in that trace, and costs one flag check
when no profiler records.  A ``timed`` range inside a chunk's
:func:`stage_clock` also measures itself on the device's clock (CUDA
events; the host clock on the CPU): the chunk program's stage split.

Usage::

    with trace_session("/tmp/prof"):          # host + device trace
        ...

    timer = StageTimer()
    with timer.stage("load"):
        ...
    timer.write_tsv(out_dir)                  # stage\\tseconds rows
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.profiler

#: whether a profiler records on the calling thread.  Its callbacks are
#: per thread, so a range opened on a thread it does not record would
#: not be drawn anyway.
profiling = torch._C._autograd._profiler_enabled

# the directory of the profiler trace being recorded, if any:
# telemetry.start_run drops a ``trace_dir`` event into the run log so
# ``report`` can find the trace afterwards
_ACTIVE_TRACE_DIR: str | None = None


def active_trace_dir() -> str | None:
    return _ACTIVE_TRACE_DIR


@contextlib.contextmanager
def trace_session(trace_dir: str | None):
    """A ``torch.profiler`` trace of the CPU and (where there is a
    card) CUDA activity under ``trace_dir``, written as
    ``*.pt.trace.json`` when the block ends; a no-op for None."""
    global _ACTIVE_TRACE_DIR
    if not trace_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    os.makedirs(trace_dir, exist_ok=True)
    prev = _ACTIVE_TRACE_DIR
    _ACTIVE_TRACE_DIR = os.path.abspath(trace_dir)
    from repic_tpu_torch.telemetry import events

    # a no-op until a run log is open; start_run records it then
    events.event("trace_dir", path=_ACTIVE_TRACE_DIR)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(
            activities=activities,
            on_trace_ready=tensorboard_trace_handler(trace_dir),
        ):
            yield
    finally:
        _ACTIVE_TRACE_DIR = prev


@dataclass
class StageTimer:
    """Named ``(label, seconds)`` stages, in run order."""

    stages: list = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, label: str):
        """Time a block (``perf_counter``) as one stage and one span."""
        from repic_tpu_torch.telemetry import events

        t0 = time.perf_counter()
        try:
            with events.span(label, kind="stage"):
                yield
        finally:
            self.stages.append((label, time.perf_counter() - t0))

    def as_dict(self) -> dict:
        """Per-label total seconds (a repeated label sums)."""
        out: dict = {}
        for label, secs in self.stages:
            out[label] = out.get(label, 0.0) + secs
        return out

    def write_tsv(self, out_dir: str, name: str = "runtime.tsv") -> str:
        from repic_tpu_torch.telemetry.sinks import write_runtime_tsv

        return write_runtime_tsv(out_dir, self.stages, name=name)


class StageClock:
    """The timed ranges of one chunk: each range's entry and exit marks,
    CUDA events on the current stream of ``device`` (the host clock
    for a CPU device), summed per label into :attr:`ms` by
    :meth:`resolve`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.ms: dict = {}
        self._marks: list = []

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def add(self, label: str, start, end) -> None:
        self._marks.append((label, start, end))

    def resolve(self) -> None:
        """Fold the marks taken so far into :attr:`ms`.  Call it after
        a blocking read has drained the stream (the chunk's packed
        fetch): then only the last range's closing event, recorded
        after that read, can still be pending, and waiting for it
        waits for no work."""
        for label, start, end in self._marks:
            if self.cuda:
                end.synchronize()
                dt = start.elapsed_time(end)
            else:
                dt = (end - start) * 1e3
            self.ms[label] = self.ms.get(label, 0.0) + dt
        self._marks.clear()


_CLOCK = threading.local()
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def stage_clock(device):
    """A chunk's :class:`StageClock`, open on this thread for the
    block while a profiler records; None otherwise, and for ``device``
    None (a chunk split over several devices, whose ranges no single
    stream orders).  The ``timed`` ranges entered inside take their
    marks there."""
    if device is None or not profiling():
        yield None
        return
    prev = getattr(_CLOCK, "clock", None)
    _CLOCK.clock = clock = StageClock(torch.device(device))
    try:
        yield clock
    finally:
        _CLOCK.clock = prev


class _Range:
    """A ``record_function`` range, and with ``timed`` the marks of
    the open :class:`StageClock` (if any) around it."""

    __slots__ = ("label", "timed", "_rf", "_clock", "_t0")

    def __init__(self, label: str, timed: bool):
        self.label = label
        self.timed = timed

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.label)
        self._rf.__enter__()
        self._clock = getattr(_CLOCK, "clock", None) if self.timed else None
        if self._clock is not None:
            self._t0 = self._clock.mark()
        return self

    def __exit__(self, *exc):
        if self._clock is not None:
            self._clock.add(self.label, self._t0, self._clock.mark())
        self._rf.__exit__(*exc)
        return False


def annotate(label: str, *, timed: bool = False):
    """A named range in the profiler trace (``record_function``), on
    the profiler's clock over the kernels it encloses; when no profiler
    records, a shared no-op context, for the cost of one flag check.
    ``timed`` also times the range on the device inside an open
    :func:`stage_clock`."""
    if not profiling():
        return _NULL
    return _Range(label, timed)
