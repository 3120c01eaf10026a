"""Run the iterative ensemble picking loop from an ``iter_config.json``.

The orchestration is :func:`repic_tpu_torch.pipeline.iterative.
run_iterative` in this process: the builtin pickers train and pick, and
the consensus runs, on ``--device`` (``cuda`` unless ``--device cpu``
is given); the log is ``OUT_DIR/iter_pick.log`` and each completed
round is recorded in ``OUT_DIR/state.json``, which a rerun resumes
from.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

name = "iter_pick"


def add_arguments(parser) -> None:
    parser.add_argument(
        "config_file", help="iter_config.json from `iter_config`"
    )
    parser.add_argument(
        "num_iter",
        type=int,
        help="number of retraining rounds",
    )
    parser.add_argument(
        "train_size",
        type=int,
        choices=[1, 25, 50, 100],
        help="training-subset percentage",
    )
    parser.add_argument(
        "--out_dir",
        default=None,
        help="output directory (default: <data_dir>/iterative_picking)",
    )
    parser.add_argument(
        "--semi_auto",
        action="store_true",
        help="seed round 0 from sampled manual labels instead of "
        "pre-trained pickers",
    )
    parser.add_argument(
        "--manual_label_dir",
        default=None,
        help="BOX labels for --semi_auto seeding",
    )
    parser.add_argument(
        "--score",
        default=None,
        metavar="GT_DIR",
        help="score each consensus stage against these ground-truth "
        "BOX files",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--no_resume",
        action="store_true",
        help="restart from round 0 even if a compatible state.json "
        "from a previous run exists in the output directory "
        "(by default completed rounds are not re-run)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the builtin pickers and the consensus (default "
        "cuda; fails when there is none)",
    )


def main(args) -> None:
    from repic_tpu_torch.pipeline.consensus import resolve_device
    from repic_tpu_torch.pipeline.iterative import run_iterative
    from repic_tpu_torch.pipeline.pickers import PickerError

    device = resolve_device(args.device)
    if not os.path.isfile(args.config_file):
        sys.exit(f"error: config file not found: {args.config_file}")
    with open(args.config_file) as f:
        config = json.load(f)
    for key in ("data_dir", "box_size"):
        if key not in config:
            sys.exit(
                f"error: config file missing required key {key!r} "
                "(generate one with `iter_config`)"
            )

    out_dir = args.out_dir or os.path.join(
        config["data_dir"], "iterative_picking"
    )
    try:
        run_iterative(
            config,
            args.num_iter,
            args.train_size,
            out_dir,
            semi_auto=args.semi_auto,
            manual_label_dir=args.manual_label_dir,
            score_gt_dir=args.score,
            seed=args.seed,
            resume=not args.no_resume,
            device=device,
        )
    except (ValueError, FileNotFoundError, PickerError) as e:
        sys.exit(f"error: {e}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
