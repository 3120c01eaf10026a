"""The observability flags of a runnable command: ``--profile`` /
``--trace-dir`` and ``--device-time``, as one argparse block and one
scoped runtime wiring (the port's copy of
``repic_tpu.commands._observability``)."""

from __future__ import annotations

import contextlib


def add_observability_arguments(
    parser,
    *,
    trace_flags: tuple = ("--trace-dir",),
    trace_dest: str = "trace_dir",
) -> None:
    """Register the profiler-trace flag(s) and ``--device-time``.

    ``consensus`` passes ``trace_flags=("--profile", "--trace-dir")``
    with ``trace_dest="profile"``, as the reference does.
    """
    parser.add_argument(
        *trace_flags,
        dest=trace_dest,
        metavar="DIR",
        help="write a torch.profiler trace of host and CUDA activity "
        "to DIR (TensorBoard layout; `report` parses it into the "
        "device-time section).  The trace shows every telemetry span "
        "as a range and, inside each consensus_dispatch, the chunk "
        "program's six stages: consensus_neighbors, consensus_join, "
        "consensus_compact, consensus_ascent, consensus_rounding, "
        "consensus_fetch.  The profiler records only its own thread: "
        "set REPIC_TPU_NO_PREFETCH=1 to run the chunks there.  Each "
        "stage's time on the device (a chunk's stage_ms) is measured "
        "only while a profiler records",
    )
    parser.add_argument(
        "--device-time",
        action="store_true",
        help="device-time attribution: bracket every telemetry span "
        "with a device sync so the event stream (and `report`) splits "
        "each stage into host time and device tail.  Serializes "
        "stages: a measurement mode, not a fast path",
    )


@contextlib.contextmanager
def observability_scope(args, trace_dir):
    """Scoped ``--device-time`` and profiler trace: the attribution
    latch comes back to its previous value on exit, and the trace is
    written when the scope closes.  Enter it inside the command's run,
    so a failing trace directory still finishes the run's telemetry."""
    from repic_tpu_torch.telemetry import probes
    from repic_tpu_torch.utils.tracing import trace_session

    with probes.device_time(args.device_time), trace_session(trace_dir):
        yield
