"""Train the CNN picker and save its best-validation checkpoint.

Given micrographs plus labels for a training and a validation split,
trains the patch classifier (:func:`repic_tpu_torch.models.train.fit`)
and writes the checkpoint in the reference's file format and tree
layout, so either package's ``pick`` reads it.  ``--retrain_from``
warm-starts from an earlier checkpoint (each round of the iterative
loop retrains from the previous round's model).  Runs on ``cuda``
unless ``--device cpu`` is given; the run's telemetry
(``_events.jsonl``, ``_metrics.json``, ``_metrics.prom``) lands beside
the checkpoint.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

name = "fit"


def add_arguments(parser) -> None:
    parser.add_argument(
        "train_mrc_dir",
        help="training micrographs (.mrc); with --source extracted "
        "this is instead the base directory that the ';'-separated "
        "patch-pickle paths are resolved against",
    )
    parser.add_argument(
        "train_label_dir",
        help="training labels: a BOX/STAR directory (--source labels),"
        " a RELION particle .star (--source relion_star), "
        "';'-separated patch pickles (--source extracted), or a "
        "pre-picked results pickle (--source prepicked)",
    )
    parser.add_argument("model_out", help="output checkpoint path")
    parser.add_argument(
        "--source",
        choices=["labels", "relion_star", "extracted", "prepicked"],
        default="labels",
        help="training-data source, the reference DataLoader's four "
        "train_type variants",
    )
    parser.add_argument(
        "--val_mrc_dir",
        default=None,
        help="validation micrographs (default: train_mrc_dir)",
    )
    parser.add_argument(
        "--val_label_dir",
        default=None,
        help="validation labels (.box); required for --source labels, "
        "otherwise --val_ratio splits",
    )
    parser.add_argument(
        "--val_ratio",
        type=float,
        default=0.1,
        help="validation fraction for sources without a validation "
        "directory",
    )
    parser.add_argument(
        "--select",
        type=float,
        default=0.5,
        help="--source prepicked selection: (0,1] score threshold, "
        "(1,100] top percent, >100 top count",
    )
    parser.add_argument(
        "--particle_size",
        type=int,
        required=True,
        help="particle edge length in pixels; --source extracted "
        "consumes pre-cut patches so the value is not used for "
        "patch cutting there, but it is still recorded in the "
        "checkpoint metadata for inference",
    )
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--max_epochs", type=int, default=200)
    parser.add_argument(
        "--patch_norm",
        choices=["reference", "global"],
        default="reference",
        help="per-patch normalization chain; 'global' enables exact "
        "fcn-mode picking",
    )
    parser.add_argument(
        "--retrain_from",
        default=None,
        help="warm-start from an existing checkpoint",
    )
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument(
        "--arch",
        choices=["deep", "wide", "slim"],
        default="deep",
        help="filter pyramid (cnn.ARCHS); 'deep' is the "
        "reference-parity DeepPicker stack",
    )
    parser.add_argument(
        "--bf16",
        action="store_true",
        help="bfloat16 conv/matmul compute; parameters, loss, and "
        "optimizer state stay float32",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; fails when there is none)",
    )
    from repic_tpu_torch.commands._observability import (
        add_observability_arguments,
    )

    add_observability_arguments(parser)


def _load(args, device):
    """(train_data, train_labels, val_data, val_labels) of the chosen
    source; exits with the reference's messages."""
    from repic_tpu_torch.models import data as data_mod

    source = args.source
    if source == "labels":
        if not args.val_label_dir:
            sys.exit(
                "error: --val_label_dir is required with --source labels"
            )
        train = data_mod.load_dataset(
            args.train_mrc_dir, args.train_label_dir, args.particle_size,
            seed=args.seed, patch_norm=args.patch_norm, device=device,
        )
        val = data_mod.load_dataset(
            args.val_mrc_dir or args.train_mrc_dir, args.val_label_dir,
            args.particle_size, seed=args.seed + 1,
            patch_norm=args.patch_norm, device=device,
        )
        return (*train, *val)
    if args.val_label_dir or args.val_mrc_dir:
        sys.exit(
            "error: --val_label_dir/--val_mrc_dir apply to "
            f"--source labels only; the {source!r} source validates on "
            "a --val_ratio split of the training data"
        )
    if source == "relion_star":
        data, labels = data_mod.load_dataset_relion_star(
            args.train_label_dir, args.train_mrc_dir, args.particle_size,
            seed=args.seed, patch_norm=args.patch_norm, device=device,
        )
    elif source == "extracted":
        data, labels = data_mod.load_dataset_extracted(
            args.train_mrc_dir, args.train_label_dir,
            patch_norm=args.patch_norm, device=device,
        )
    else:  # prepicked
        data, labels = data_mod.load_dataset_prepicked(
            args.train_mrc_dir, args.train_label_dir, args.particle_size,
            select=args.select, seed=args.seed,
            patch_norm=args.patch_norm, device=device,
        )
    # validation split by ratio
    rng = np.random.default_rng(args.seed)
    data, labels = data_mod.shuffle_in_unison(data, labels, rng)
    n_val = max(int(len(data) * args.val_ratio), 2)
    if len(data) - n_val < 2:
        sys.exit(
            f"error: dataset too small to split ({len(data)} patches, "
            f"{n_val} requested for validation) — lower --val_ratio or "
            "provide more training data"
        )
    return data[n_val:], labels[n_val:], data[:n_val], labels[:n_val]


def main(args) -> None:
    from repic_tpu_torch import telemetry
    from repic_tpu_torch.commands._observability import observability_scope
    from repic_tpu_torch.models.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from repic_tpu_torch.models.train import TrainConfig, fit
    from repic_tpu_torch.pipeline.consensus import resolve_device

    device = resolve_device(args.device)
    try:
        train_data, train_labels, val_data, val_labels = _load(args, device)
    except (FileNotFoundError, ValueError) as e:
        sys.exit(f"error: {e}")

    print(
        f"train: {len(train_data)} patches "
        f"({int(train_labels.sum())} positive), "
        f"val: {len(val_data)} patches"
    )

    init_params = None
    if args.retrain_from:
        init_params, prev_meta = load_checkpoint(args.retrain_from)
        if prev_meta.get("patch_norm", "reference") != args.patch_norm:
            sys.exit(
                "error: --patch_norm differs from the warm-start "
                f"checkpoint's ({prev_meta.get('patch_norm')!r})"
            )

    config = TrainConfig(
        batch_size=args.batch_size,
        max_epochs=args.max_epochs,
        seed=args.seed,
        compute_dtype="bfloat16" if args.bf16 else "float32",
    )
    # the run's telemetry beside the checkpoint: train_epoch events,
    # the steps/sec gauge, the loss-fetch cadence
    run_tlm = telemetry.start_run(
        os.path.dirname(os.path.abspath(args.model_out))
    )
    try:
        # scoped inside the try: a failing trace directory still
        # finishes the run's telemetry
        with observability_scope(args, args.trace_dir):
            result = fit(
                train_data, train_labels, val_data, val_labels, config,
                init_params=init_params, arch=args.arch, device=device,
            )
    finally:
        telemetry.finish_run(run_tlm)
    save_checkpoint(
        args.model_out,
        result.params,
        {
            "particle_size": args.particle_size,
            "patch_norm": args.patch_norm,
            "arch": args.arch,
            "best_val_error": result.best_val_error,
            "epochs": result.epochs_run,
            "seed": args.seed,
        },
    )
    print(
        f"saved {args.model_out} "
        f"(best val error {result.best_val_error:.2f}%)"
    )


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
