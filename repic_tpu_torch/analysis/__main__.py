"""``python -m repic_tpu_torch.analysis``: the standalone linter entry
point (``python -m repic_tpu_torch lint``)."""

import argparse

from repic_tpu_torch.analysis import cli

parser = argparse.ArgumentParser(prog="python -m repic_tpu_torch.analysis")
cli.add_arguments(parser)
cli.main(parser.parse_args())
