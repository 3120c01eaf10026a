"""``trace`` -- per-request waterfall and critical path.

Renders the trace artifact (``_trace.jsonl``) a consensus run leaves
next to its journal: one waterfall per trace with its ``load`` /
``compile`` / ``execute`` / ``emit`` segments, the program-cache
hit/miss counts on the compile segments, the critical path and, for a
``--device-time`` run, the device tail of its dispatch spans (joined
by trace id from the event stream).

Usage::

    python -m repic_tpu_torch trace RUN_DIR            # a consensus run
    python -m repic_tpu_torch trace WORK_DIR JOB_ID    # one served job
    python -m repic_tpu_torch trace WORK_DIR           # lists traced jobs

Reads files only; a torn last line (a crashed run) still renders.
"""

from __future__ import annotations

import argparse
import json
import os

name = "trace"


def add_arguments(parser) -> None:
    parser.add_argument(
        "run_dir",
        help="a run directory holding _trace.jsonl (a consensus "
        "output dir or a serve jobs/<id>/ dir), or a serve work_dir "
        "when a job id is given",
    )
    parser.add_argument(
        "job_id",
        nargs="?",
        default=None,
        help="serve job id: renders <run_dir>/jobs/<job_id>; "
        "omitted, <run_dir> itself must hold the trace artifact",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the machine-readable per-trace summary instead "
        "of the waterfall",
    )


def _resolve_dir(run_dir: str, job_id: str | None) -> str:
    if job_id is None:
        return run_dir
    for cand in (
        os.path.join(run_dir, "jobs", job_id),
        os.path.join(run_dir, job_id),
    ):
        if os.path.isdir(cand):
            return cand
    raise SystemExit(
        f"trace: no job directory for {job_id!r} under "
        f"{run_dir}"
    )


def _list_jobs(run_dir: str) -> list[str]:
    """Serve-work-dir fallback: job ids that carry a trace artifact
    (the plain ``_trace.jsonl`` or any fleet-replica
    ``_trace.<replica>.jsonl`` — a failed-over job has only the
    latter)."""
    from repic_tpu_torch.runtime.journal import host_artifact_paths
    from repic_tpu_torch.telemetry.trace import TRACE_NAME

    jobs_dir = os.path.join(run_dir, "jobs")
    if not os.path.isdir(jobs_dir):
        return []
    return sorted(
        j
        for j in os.listdir(jobs_dir)
        if host_artifact_paths(os.path.join(jobs_dir, j), TRACE_NAME)
    )


def main(args) -> None:
    from repic_tpu_torch.telemetry import events as tlm_events
    from repic_tpu_torch.telemetry import trace as tlm_trace

    run_dir = _resolve_dir(args.run_dir, args.job_id)
    records = tlm_trace.read_trace(run_dir)
    if not records:
        jobs = _list_jobs(run_dir)
        if jobs:
            print(f"jobs with traces under {run_dir}:")
            for j in jobs:
                print(f"  {j}")
            print("render one with: python -m repic_tpu_torch trace "
                  f"{args.run_dir} <job_id>")
            return
        raise SystemExit(
            "trace: no trace artifact "
            f"({tlm_trace.TRACE_NAME}) in {run_dir}"
        )
    summaries = tlm_trace.summarize(records)
    if args.json:
        print(
            json.dumps(
                {
                    "run_dir": os.path.abspath(run_dir),
                    "traces": summaries,
                },
                indent=2,
                sort_keys=True,
            )
        )
        return
    # device-time join: dispatch spans in the same directory's event
    # stream carry the trace id (and, under --device-time, the
    # host/device split)
    events = tlm_events.read_events(run_dir)
    first = True
    for tid, tr in summaries.items():
        if not first:
            print()
        first = False
        print(tlm_trace.render_waterfall(tid, tr, events=events))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
