"""Directory consensus on one device.

Reads ``IN_DIR/<picker>/*.box``, writes one consensus BOX file per
micrograph into ``OUT_DIR`` (deleted first if it exists) and prints
the run statistics as one JSON line.  Runs on ``cuda`` unless
``--device cpu`` is given.
"""

import json


def add_arguments(parser):
    parser.add_argument("in_dir", help="directory of picker subdirectories")
    parser.add_argument(
        "out_dir",
        help="output directory for BOX files (WARNING - deleted if it "
        "exists)",
    )
    parser.add_argument("box_size", type=int, help="box size (pixels)")
    parser.add_argument(
        "--solver",
        choices=["lp_device", "lp_device_fused", "greedy"],
        default="lp_device",
        help="packing solver: dual-decomposition LP (default), the "
        "fused CUDA chunk program, or parallel greedy",
    )
    parser.add_argument(
        "--pallas",
        action="store_true",
        help="staged neighbour search through the fused top-D kernel",
    )
    parser.add_argument(
        "--threshold", type=float, default=0.3, help="IoU edge threshold"
    )
    parser.add_argument(
        "--max_neighbors", type=int, default=16,
        help="initial neighbour capacity of the clique enumerator",
    )
    parser.add_argument(
        "--num_particles", type=int, help="top-N particle cutoff"
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; fails when there is none)",
    )


def main(args):
    from repic_tpu_torch.ops import iou_pallas, megakernel
    from repic_tpu_torch.pipeline.consensus import run_consensus_dir

    stats = run_consensus_dir(
        args.in_dir,
        args.out_dir,
        args.box_size,
        threshold=args.threshold,
        max_neighbors=args.max_neighbors,
        num_particles=args.num_particles,
        solver=args.solver,
        use_pallas=args.pallas,
        device=args.device,
    )
    stats["launches"] = {
        "topk_neighbors": iou_pallas.LAUNCHES,
        **megakernel.LAUNCHES,
    }
    stats["demotions"] = megakernel.DEMOTIONS
    print(json.dumps(stats, default=str))
    return stats
