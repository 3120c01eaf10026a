"""``report`` -- one summary of a journaled run directory.

Joins a run's ``_journal.jsonl`` with its event stream, metrics
snapshot, request trace and profiler trace
(:mod:`repic_tpu_torch.telemetry.report`): per-stage latency
percentiles, retry/quarantine/solver-rung tallies, build and transfer
totals, the device-time split.  Reads files only: it runs where the
run's directory is, with or without a card.
"""

from __future__ import annotations

import argparse
import json

name = "report"


def add_arguments(parser) -> None:
    parser.add_argument(
        "run_dir",
        help="a consensus output directory (must hold the run's "
        "_journal.jsonl; _events.jsonl/_metrics.json enrich the "
        "summary when telemetry was enabled)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="emit the machine-readable summary instead of text",
    )


def main(args) -> None:
    from repic_tpu_torch.telemetry.report import build_report, format_report

    report = build_report(args.run_dir)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_report(report))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
