"""``python -m repic_tpu_torch`` CLI dispatcher.

Each command module exposes ``add_arguments(parser)`` and
``main(args)``, as in ``repic_tpu``: ``consensus`` (the one-pass
directory consensus), the two-phase pair ``get_cliques`` +
``run_ilp``, ``report`` / ``trace`` over a run's directory, the
``serve`` daemon, the CNN picker's ``pick`` and ``fit``, the
iterative ensemble loop's ``iter_config`` and ``iter_pick``, and the
host utilities ``convert``, ``score``, ``build_subsets`` and
``get_examples``.
"""

import argparse
import importlib
import sys

import repic_tpu_torch

COMMANDS = {
    "consensus": "repic_tpu_torch.commands.consensus",
    "get_cliques": "repic_tpu_torch.commands.get_cliques",
    "run_ilp": "repic_tpu_torch.commands.run_ilp",
    "report": "repic_tpu_torch.commands.report",
    "trace": "repic_tpu_torch.commands.trace",
    "serve": "repic_tpu_torch.commands.serve",
    "pick": "repic_tpu_torch.commands.pick",
    "fit": "repic_tpu_torch.commands.fit",
    "iter_config": "repic_tpu_torch.commands.iter_config",
    "iter_pick": "repic_tpu_torch.commands.iter_pick",
    "convert": "repic_tpu_torch.utils.coords",
    "score": "repic_tpu_torch.utils.scoring",
    "build_subsets": "repic_tpu_torch.utils.subsets",
    "get_examples": "repic_tpu_torch.commands.get_examples",
}


def build_parser():
    parser = argparse.ArgumentParser(prog="python -m repic_tpu_torch")
    parser.add_argument(
        "--version",
        action="version",
        version=f"repic-tpu-torch {repic_tpu_torch.__version__}",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for cmd, module in COMMANDS.items():
        mod = importlib.import_module(module)
        p = sub.add_parser(cmd, help=(mod.__doc__ or "").splitlines()[0])
        mod.add_arguments(p)
        p.set_defaults(_module=mod)
    return parser


def main(argv=None):
    from repic_tpu_torch.runtime import faults

    args = build_parser().parse_args(argv)
    # REPIC_TPU_FAULTS plants deterministic failures at the runtime's
    # fault sites, so the retry / quarantine / resume ladder can be
    # rehearsed on a real run
    faults.install_from_env()
    args._module.main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
