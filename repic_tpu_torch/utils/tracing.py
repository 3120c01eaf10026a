"""Stage timing and profiling (the port's counterpart of
``repic_tpu.utils.tracing``).

:class:`StageTimer` keeps named wall-clock stages and writes them as
the reference's ``stage<TAB>seconds`` rows (``consensus_runtime.tsv``);
each :meth:`StageTimer.stage` is also a telemetry span.
:func:`trace_session` records a ``torch.profiler`` trace of host and
CUDA activity into a directory (``--profile``), in the TensorBoard
layout that ``report`` parses into its device-time section;
:func:`annotate` names a range in that trace.

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
import time
from dataclasses import dataclass, field

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
    import torch
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


def annotate(label: str):
    """A named range in the profiler trace (``record_function``); costs
    next to nothing outside a trace."""
    from torch.profiler import record_function

    return record_function(label)
