"""``python -m repic_tpu_torch check``: the contract checker (the port
of ``repic_tpu.analysis.check_cli``).

Follows the CLI's subcommand protocol (``add_arguments(parser)`` /
``main(args)``, see :mod:`repic_tpu_torch.main`).  Unlike ``lint`` this
command DOES import torch and the target modules: it runs every
``@checked`` entry against its contract and every kernel against its
reference, on ``--device`` -- the card unless the caller asks for the
CPU, like every entry point of the port.  A module that fails to import
is a structured skip; a contract or kernel finding fails the gate, and
so does a missing card when the card was asked for (the kernel probes
never run quietly on the CPU in its place).
"""

from __future__ import annotations

import argparse
import json
import sys

name = "check"


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.description = (
        "Contract checker (rules RT101/RT102: each @checked entry run "
        "on meta tensors -- or, where it reads values, on seeded "
        "inputs at the contract's dims on --device -- against its "
        "declared shapes and dtypes, and its declared mesh axes "
        "against parallel/mesh.py; plus the kernel probes RT423/RT425: "
        "each hand-written kernel's output structure and its values "
        "over every rung of its ladder against the contract's "
        "reference, on --device).  Entry points register via "
        "@repic_tpu_torch.analysis.contracts.checked.  Exits non-zero "
        "on findings; import failures are structured skips.  The "
        "reference's RT103 and RT105 (donation, recompile variants) and "
        "RT421/RT422/RT424 (Pallas BlockSpec plans) have no subject in "
        "the port: --select of one exits non-zero with its reason."
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["repic_tpu_torch"],
        help="files or directories to check (default: repic_tpu_torch)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="where the value-reading entries and the kernel probes run "
        "(default: cuda; --device cpu holds each kernel's plain "
        "version against the contract's reference)",
    )
    parser.add_argument(
        "--select",
        default=None,
        metavar="RULES",
        help="comma-separated RT1xx/RT42x rule IDs to run "
        "(default: all)",
    )
    parser.add_argument(
        "--format",
        choices=["text", "json"],
        default="text",
        help="report format (json: {findings, checked, skipped})",
    )
    parser.add_argument(
        "--hints",
        action="store_true",
        help="append each rule's fix-hint to its findings",
    )
    parser.add_argument(
        "--list-entries",
        action="store_true",
        help="import targets, print the registered entry points, exit",
    )


def main(args: argparse.Namespace) -> None:
    from repic_tpu_torch.analysis.cost import COST_RULES
    from repic_tpu_torch.analysis.engine import (
        parse_select,
        unported_selection,
    )
    from repic_tpu_torch.analysis.kernels import KERNEL_RULES
    from repic_tpu_torch.analysis.semantic import SEMANTIC_RULES, run_check

    select = parse_select(args.select)
    if select:
        gone = unported_selection(select)
        if gone:
            sys.exit(f"check --select: {gone}")
        unknown = (
            select
            - set(SEMANTIC_RULES)
            - set(KERNEL_RULES)
            - set(COST_RULES)
        )
        if unknown:
            sys.exit(f"unknown rule id(s): {', '.join(sorted(unknown))}")
        cost_only = select & set(COST_RULES)
        if cost_only:
            # RT5xx live in the static pass, not the contract checker
            print(
                f"note: {', '.join(sorted(cost_only))} are static "
                f"device-cost rules; run `python -m repic_tpu_torch "
                f"lint --cost --select {','.join(sorted(cost_only))}`",
                file=sys.stderr,
            )
    report = run_check(
        args.paths, select=select, collect_only=args.list_entries,
        device=args.device,
    )
    if args.format == "json":
        json.dump(report.to_json(), sys.stdout, indent=2)
        sys.stdout.write("\n")
    else:
        if args.list_entries:
            for e in report.checked:
                print(f"{e['entry']}  ({e['path']}:{e['line']})")
        for f in report.findings:
            print(f.format(show_hint=args.hints))
        for s in report.skipped:
            target = s.get("entry") or s.get("path")
            print(f"skip: {target}: {s['reason']}")
        print(
            f"checked {len(report.checked)} entry point(s) on "
            f"{report.device}, skipped {len(report.skipped)}, "
            f"found {len(report.findings)} issue(s)"
        )
    if report.findings:
        sys.exit(1)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog=f"python -m repic_tpu_torch {name}")
    add_arguments(parser)
    main(parser.parse_args())
