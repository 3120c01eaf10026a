"""``python -m repic_tpu_torch lint``: the port's static-analysis
subcommand (the port of ``repic_tpu.analysis.cli``).

Follows the CLI's subcommand protocol (``add_arguments(parser)`` /
``main(args)``, see :mod:`repic_tpu_torch.main`) and is also runnable
standalone via ``python -m repic_tpu_torch.analysis``.  Imports NO
torch: linting runs, fast, where there is no card and no CUDA runtime
(``--deep`` alone imports torch, for the contract checker).
"""

from __future__ import annotations

import argparse
import sys

name = "lint"


def add_arguments(parser: argparse.ArgumentParser) -> None:
    parser.description = (
        "AST-based torch/CUDA hygiene linter (rule RT004: host syncs "
        "on launch outputs or CUDA tensors in a hot loop) plus the "
        "RT201-RT204 project-contract pack (atomic writes, span "
        "balance, journal outcome enum, no bare print). Exits non-zero "
        "on any finding; suppress a line with `# repic: noqa[RTxxx]`. "
        "With --concurrency, additionally runs the whole-program "
        "RT301-RT305 concurrency pass (unguarded shared writes, "
        "lock-order cycles, blocking under a lock, thread lifecycle, "
        "signal-handler safety); with --spmd, additionally runs the "
        "whole-program RT401/RT402/RT404 pass over torch.distributed "
        "(rank-divergent branches guarding collectives, mismatched "
        "collective order, untagged gang journal writes); with --cost, "
        "additionally runs the whole-program RT502/RT512 device-cost "
        "pass (loop fetches feeding a kernel launch, declared dispatch "
        "budgets); with --deep, runs the contract checker (`check`, "
        "rules RT101/RT102 plus the RT423/RT425 kernel probes, on "
        "--device) AND the concurrency AND spmd AND cost passes over "
        "the same paths.  The reference's RT001-RT003, RT005, RT006, "
        "RT103, RT105, RT403, RT421, RT422, RT424, RT501, RT503 and "
        "RT511 have no subject in the port: --select of one exits "
        "non-zero with its reason."
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["repic_tpu_torch"],
        help="files or directories to lint (default: repic_tpu_torch)",
    )
    parser.add_argument(
        "--select",
        default=None,
        metavar="RULES",
        help="comma-separated rule IDs to run (default: all)",
    )
    parser.add_argument(
        "--format",
        choices=["text", "json", "sarif"],
        default="text",
        help="report format (sarif: SARIF 2.1.0 for GitHub code "
        "scanning ingestion)",
    )
    parser.add_argument(
        "--concurrency",
        action="store_true",
        help="also run the whole-program RT3xx concurrency pass "
        "(stdlib-only, like lint itself; auto-enabled when --select "
        "names an RT3xx rule)",
    )
    parser.add_argument(
        "--spmd",
        action="store_true",
        help="also run the whole-program RT40x pass over the gang's "
        "collectives (stdlib-only, like lint itself; auto-enabled when "
        "--select names an RT40x rule)",
    )
    parser.add_argument(
        "--cost",
        action="store_true",
        help="also run the whole-program RT5xx device-cost & "
        "transfer-discipline pass (stdlib-only, like lint itself; "
        "auto-enabled when --select names an RT5xx rule)",
    )
    parser.add_argument(
        "--hints",
        action="store_true",
        help="append each rule's fix-hint to its findings",
    )
    parser.add_argument(
        "--statistics",
        action="store_true",
        help="append a per-rule finding count to the text report",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule pack (ID, severity, title) and exit",
    )
    parser.add_argument(
        "--deep",
        action="store_true",
        help="also run the contract checker on --device (imports "
        "torch and the target modules; see `check`)",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="with --deep: where the value-reading entries and the "
        "kernel probes run (default: cuda; with no card the probes are "
        "findings that name --device cpu, which holds each kernel's "
        "plain version against the contract's reference)",
    )


def main(args: argparse.Namespace) -> None:
    from repic_tpu_torch.analysis.concurrency import CONCURRENCY_RULES
    from repic_tpu_torch.analysis.cost import COST_RULES
    from repic_tpu_torch.analysis.engine import (
        dedupe_findings,
        format_report,
        parse_select,
        run_paths,
        unported_selection,
    )
    from repic_tpu_torch.analysis.kernels import KERNEL_RULES
    from repic_tpu_torch.analysis.rules import ALL_RULES
    from repic_tpu_torch.analysis.semantic import SEMANTIC_RULES
    from repic_tpu_torch.analysis.spmd import SPMD_RULES

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.rule_id} [{rule.severity}] {rule.title}")
        for pack in (CONCURRENCY_RULES, SPMD_RULES, COST_RULES):
            for rule in pack.values():
                print(f"{rule.rule_id} [{rule.severity}] {rule.title}")
        for rule_id, (severity, _hint) in sorted(SEMANTIC_RULES.items()):
            print(f"{rule_id} [{severity}] contract checker (check)")
        for rule_id, (severity, title, _hint) in sorted(
            KERNEL_RULES.items()
        ):
            print(f"{rule_id} [{severity}] {title}")
        return
    select = parse_select(args.select)
    if select:
        gone = unported_selection(select)
        if gone:
            sys.exit(f"lint --select: {gone}")
        known = {r.rule_id for r in ALL_RULES}
        known |= set(CONCURRENCY_RULES)
        known |= set(SPMD_RULES)
        known |= set(COST_RULES)
        if args.deep:
            known |= set(SEMANTIC_RULES)
            known |= set(KERNEL_RULES)
        unknown = select - known
        if unknown:
            sys.exit(f"unknown rule id(s): {', '.join(sorted(unknown))}")
        if select & set(CONCURRENCY_RULES):
            args.concurrency = True
        if select & set(SPMD_RULES):
            args.spmd = True
        if select & set(COST_RULES):
            args.cost = True
    findings = run_paths(args.paths, select=select)
    passes = []
    if args.concurrency or args.deep:
        from repic_tpu_torch.analysis.concurrency import run_concurrency

        passes.append(run_concurrency)
    if args.spmd or args.deep:
        from repic_tpu_torch.analysis.spmd import run_spmd

        passes.append(run_spmd)
    if args.cost or args.deep:
        from repic_tpu_torch.analysis.cost import run_cost

        passes.append(run_cost)
    if passes:
        # the whole-program passes (still pure stdlib ast) parse ALL the
        # paths into one program, once, and share it
        from repic_tpu_torch.analysis.concurrency import build_program

        built = build_program(args.paths)
        for run in passes:
            findings.extend(run(args.paths, select=select, built=built))
    if args.deep:
        # the contract checker imports torch + the targets; lint alone
        # must stay import-free, so this lives behind the flag
        from repic_tpu_torch.analysis.semantic import run_check

        report = run_check(args.paths, select=select, device=args.device)
        findings.extend(report.findings)
        print(f"check: {len(report.checked)} entry point(s) on "
              f"{report.device}, skipped {len(report.skipped)}",
              file=sys.stderr)
        for s in report.skipped:
            target = s.get("entry") or s.get("path")
            print(f"skip: {target}: {s['reason']}", file=sys.stderr)
    findings = dedupe_findings(findings)
    code = format_report(
        findings,
        fmt=args.format,
        show_hints=args.hints,
        statistics=args.statistics,
    )
    if code:
        sys.exit(code)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog=f"python -m repic_tpu_torch {name}")
    add_arguments(parser)
    main(parser.parse_args())
