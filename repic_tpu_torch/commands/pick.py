"""Run the CNN picker over a directory of MRC micrographs.

Scores every micrograph in ``MRC_DIR`` with a checkpoint written by the
reference's ``fit`` (or :func:`repic_tpu_torch.models.checkpoint.
save_checkpoint`) and writes one coordinate file per micrograph into
``OUT_DIR``: BOX (lower-left corners, the consensus input) or STAR
(centres).  Runs on ``cuda`` unless ``--device cpu`` is given.  The run
leaves its telemetry (``_events.jsonl``, ``_metrics.json``,
``_metrics.prom``) beside the coordinate files, with one
``pick_micrograph`` span per micrograph.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

from repic_tpu_torch.telemetry import events as tlm_events

_log = tlm_events.get_logger("pick")


def add_arguments(parser) -> None:
    parser.add_argument(
        "model", help="picker checkpoint (from `repic-tpu fit`)"
    )
    parser.add_argument(
        "mrc_dir", help="directory of .mrc micrographs"
    )
    parser.add_argument("out_dir", help="output coordinate directory")
    parser.add_argument(
        "--particle_size",
        type=int,
        default=None,
        help="particle box size in px (default: from the checkpoint)",
    )
    parser.add_argument(
        "--threshold",
        type=float,
        default=0.0,
        help="min classifier score to keep (reference applies 0.0)",
    )
    parser.add_argument(
        "--mode",
        choices=["patch", "fcn"],
        default="patch",
        help="patch = reference-parity dense windows; fcn = "
        "fully-convolutional fast path",
    )
    parser.add_argument(
        "--format",
        choices=["box", "star"],
        default="box",
        help="output coordinate format",
    )
    parser.add_argument(
        "--bf16",
        action="store_true",
        help="bfloat16 conv compute for scoring; score maps match "
        "float32 to ~1e-2",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; fails when there is none)",
    )
    from repic_tpu_torch.commands._observability import (
        add_observability_arguments,
    )

    add_observability_arguments(parser)


def _write_star(path: str, coords: np.ndarray) -> None:
    """RELION particle STAR with centres + score."""
    from repic_tpu_torch.runtime.atomic import atomic_write

    with atomic_write(path) as f:
        f.write("\ndata_\n\nloop_\n")
        f.write("_rlnCoordinateX #1\n_rlnCoordinateY #2\n")
        f.write("_rlnAutopickFigureOfMerit #3\n")
        for x, y, s in coords:
            f.write(f"{x:.6f}\t{y:.6f}\t{s:.6f}\n")


def main(args) -> None:
    from repic_tpu_torch import telemetry
    from repic_tpu_torch.commands._observability import observability_scope
    from repic_tpu_torch.models.checkpoint import load_checkpoint
    from repic_tpu_torch.models.infer import pick_micrograph
    from repic_tpu_torch.pipeline.consensus import resolve_device
    from repic_tpu_torch.utils import mrc
    from repic_tpu_torch.utils.box_io import write_box

    device = resolve_device(args.device)
    params, meta = load_checkpoint(args.model)
    particle_size = args.particle_size or meta.get("particle_size")
    if not particle_size:
        sys.exit(
            "error: checkpoint has no particle_size; pass --particle_size"
        )
    norm = meta.get("patch_norm", "reference")
    if args.mode == "fcn" and norm != "global":
        _log.warning(
            "fcn mode assumes global patch normalization but "
            f"the checkpoint was trained with {norm!r}; scores will "
            "be approximate"
        )

    mrcs = sorted(glob.glob(os.path.join(args.mrc_dir, "*.mrc")))
    if not mrcs:
        sys.exit(f"error: no .mrc files in {args.mrc_dir}")
    os.makedirs(args.out_dir, exist_ok=True)

    run_tlm = telemetry.start_run(args.out_dir)
    try:
        # scoped inside the try: a failing trace directory still
        # finishes the run's telemetry
        with observability_scope(args, args.trace_dir):
            for path in mrcs:
                t0 = time.perf_counter()
                stem = os.path.splitext(os.path.basename(path))[0]
                with tlm_events.span("pick_micrograph", micrograph=stem):
                    raw = mrc.read_mrc(path).astype(np.float32)
                    if raw.ndim == 3:  # single-frame stack
                        raw = raw[0]
                    coords = pick_micrograph(
                        params,
                        raw,
                        int(particle_size),
                        mode=args.mode,
                        norm=norm,
                        arch=meta.get("arch", "deep"),
                        dtype="bfloat16" if args.bf16 else "float32",
                        device=device,
                    )
                coords = coords[coords[:, 2] >= args.threshold]
                if args.format == "star":
                    _write_star(
                        os.path.join(args.out_dir, stem + ".star"), coords
                    )
                else:
                    # BOX rows are lower-left corners (center - size/2)
                    write_box(
                        os.path.join(args.out_dir, stem + ".box"),
                        coords[:, :2] - particle_size / 2,
                        coords[:, 2],
                        int(particle_size),
                    )
                _log.info(
                    f"{stem}: {len(coords)} particles "
                    f"({time.perf_counter() - t0:.1f}s)"
                )
    finally:
        telemetry.finish_run(run_tlm)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
