"""The program's dispatch reports of the traced window's chunks, read
by the per-layer metrics of the chunk program's stages and counts.

``run_consensus_batch`` leaves one report per accepted chunk
(``repic_tpu_torch.pipeline.consensus.recent_dispatch_reports``):
``attempts``, ``host_syncs``, ``ascent_steps``, ``micrographs`` and,
while a profiler records, ``stage_ms`` (milliseconds on the device's
clock per stage range).  A program without that history, or a report
without the key, reads as nothing.
"""

from __future__ import annotations


def traced(ctx) -> list | None:
    """The reports of a consensus cell's traced chunks, oldest first;
    None outside a consensus cell with a traced window, or where the
    program keeps no reports of them all."""
    t = ctx.get("trace")
    if ctx.get("kind") != "consensus" or not t or not t.get("steps"):
        return None
    try:
        from repic_tpu_torch.pipeline.consensus import (
            recent_dispatch_reports,
        )
    except ImportError:
        return None
    n = int(t["steps"])
    reports = recent_dispatch_reports(n)
    return reports if len(reports) == n else None


def stage_ms_per_mic(ctx, stage: str) -> float | None:
    """Milliseconds of ``stage`` per micrograph over the traced chunks;
    None if any chunk lacks it."""
    reports = traced(ctx)
    if not reports:
        return None
    ms = [r.get("stage_ms", {}).get(stage) for r in reports]
    mics = sum(r["micrographs"] for r in reports)
    if any(v is None for v in ms) or mics <= 0:
        return None
    return sum(ms) / mics


def mean_per_chunk(ctx, key: str) -> float | None:
    """The mean of ``key`` over the traced chunks; None if any chunk
    lacks it."""
    reports = traced(ctx)
    if not reports or any(key not in r for r in reports):
        return None
    return sum(r[key] for r in reports) / len(reports)
