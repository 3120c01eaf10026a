"""``python -m repic_tpu_torch`` CLI dispatcher.

Each command module exposes ``add_arguments(parser)`` and
``main(args)``, as in ``repic_tpu``.  This slice of the port has one
subcommand, ``consensus``.
"""

import argparse
import importlib
import sys

import repic_tpu_torch

COMMANDS = {
    "consensus": "repic_tpu_torch.commands.consensus",
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
    args = build_parser().parse_args(argv)
    args._module.main(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
