"""``python -m repic_tpu_torch`` CLI dispatcher.

Each command module exposes ``add_arguments(parser)`` and
``main(args)``, as in ``repic_tpu``: ``consensus`` (the one-pass
directory consensus), the two-phase pair ``get_cliques`` +
``run_ilp``, ``report`` / ``trace`` over a run's directory, the
``serve`` daemon and its ``fleet supervise`` autoscaler, the CNN
picker's ``pick`` and ``fit``, the
iterative ensemble loop's ``iter_config`` and ``iter_pick``, the
host utilities ``convert``, ``score``, ``build_subsets`` and
``get_examples``, and the analysis layer's ``lint`` (static, no torch)
and ``check`` (the contracts and the kernel probes).

Dispatch is two-phase, as in ``repic_tpu``: the subcommand token is
found first and only its module is imported, so ``lint``, ``--help``
and ``--version`` start without torch.

``REPIC_TPU_KERNELCHECK=1``, ``REPIC_TPU_DISPATCHCHECK=1`` and
``REPIC_TPU_LOCKCHECK=1`` arm the runtime sanitizers
(:mod:`repic_tpu_torch.analysis`) for the command: their reports go to
stderr, and a violation makes the exit status 1.
"""

import argparse
import ast
import importlib
import importlib.util
import sys

import repic_tpu_torch

COMMANDS = {
    "consensus": "repic_tpu_torch.commands.consensus",
    "get_cliques": "repic_tpu_torch.commands.get_cliques",
    "run_ilp": "repic_tpu_torch.commands.run_ilp",
    "report": "repic_tpu_torch.commands.report",
    "trace": "repic_tpu_torch.commands.trace",
    "serve": "repic_tpu_torch.commands.serve",
    "fleet": "repic_tpu_torch.commands.fleet",
    "pick": "repic_tpu_torch.commands.pick",
    "fit": "repic_tpu_torch.commands.fit",
    "iter_config": "repic_tpu_torch.commands.iter_config",
    "iter_pick": "repic_tpu_torch.commands.iter_pick",
    "convert": "repic_tpu_torch.utils.coords",
    "score": "repic_tpu_torch.utils.scoring",
    "build_subsets": "repic_tpu_torch.utils.subsets",
    "get_examples": "repic_tpu_torch.commands.get_examples",
    "lint": "repic_tpu_torch.analysis.cli",
    "check": "repic_tpu_torch.analysis.check_cli",
}

# build_parser(only=STUBS_ONLY): register every subcommand name but
# import no command module (--help / --version / usage errors)
STUBS_ONLY = object()


def _summary(module: str) -> str:
    """First docstring line of a command module, read from its source
    without importing it."""
    spec = importlib.util.find_spec(module)
    with open(spec.origin, encoding="utf-8") as f:
        doc = ast.get_docstring(ast.parse(f.read())) or ""
    return doc.splitlines()[0] if doc else ""


def build_parser(only=None):
    """Parser with all (default), one, or no subcommands materialized."""
    parser = argparse.ArgumentParser(prog="python -m repic_tpu_torch")
    parser.add_argument(
        "--version",
        action="version",
        version=f"repic-tpu-torch {repic_tpu_torch.__version__}",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd, module in COMMANDS.items():
        if only is STUBS_ONLY or (only is not None and cmd != only):
            # visible in help, parseable, but the module is not imported
            sub.add_parser(cmd, help=_summary(module))
            continue
        mod = importlib.import_module(module)
        p = sub.add_parser(cmd, help=(mod.__doc__ or "").splitlines()[0])
        mod.add_arguments(p)
        p.set_defaults(_module=mod)
    return parser


def _arm_sanitizers(args) -> list:
    """The runtime sanitizers their environment variables ask for:
    LOCKCHECK and DISPATCHCHECK armed for the command (``python -m
    repic_tpu_torch`` armed LOCKCHECK already, before its imports),
    KERNELCHECK run now on the command's device: ``--device``, else the
    card, so that a missing card is a violation and never a probe of
    the plain versions against each other."""
    from repic_tpu_torch.analysis import dispatchcheck, kernelcheck, lockcheck

    armed = [m for m in (lockcheck, dispatchcheck)
             if m.maybe_install_from_env()]
    if kernelcheck.enabled():
        kernelcheck.maybe_install_from_env(
            device=getattr(args, "device", None) or "cuda")
        armed.append(kernelcheck)
    return armed


def main(argv=None):
    from repic_tpu_torch.runtime import faults

    argv = sys.argv[1:] if argv is None else list(argv)
    chosen = next((a for a in argv if a in COMMANDS), None)
    args = build_parser(
        only=chosen if chosen is not None else STUBS_ONLY
    ).parse_args(argv)
    # REPIC_TPU_FAULTS plants deterministic failures at the runtime's
    # fault sites, so the retry / quarantine / resume ladder can be
    # rehearsed on a real run
    faults.install_from_env()
    armed = _arm_sanitizers(args)
    args._module.main(args)
    # an armed sanitizer's report goes to stderr; a violation fails the
    # run even when the command itself succeeded
    for sanitizer in armed:
        print(sanitizer.report_text(), file=sys.stderr)
    return 1 if any(s.violations() for s in armed) else 0


if __name__ == "__main__":
    sys.exit(main())
