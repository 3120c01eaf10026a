"""Directory consensus on one device.

Reads ``IN_DIR/<picker>/*.box``, writes one consensus BOX file per
micrograph into ``OUT_DIR`` (deleted first unless ``--resume``) — or,
with ``--multi_out``, one per-picker TSV — with ``_journal.jsonl``,
``_manifest.json`` and ``consensus_runtime.tsv`` beside them, and
prints the run statistics as one JSON line.  Runs on ``cuda`` unless
``--device cpu`` is given.  With telemetry on (the default;
``REPIC_TPU_TELEMETRY=0`` turns it off) the run also leaves
``_events.jsonl``, ``_metrics.json`` and ``_metrics.prom``;
``--profile DIR`` records a profiler trace, ``--device-time`` splits
every stage into host time and device tail, and ``--status-port PORT``
serves ``/metrics``, ``/status`` and ``/healthz`` while the run lasts.
"""

import argparse
import json


def _stripes_arg(value):
    if value == "auto":
        return value
    try:
        return int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {value!r}"
        ) from None


def add_arguments(parser):
    parser.add_argument("in_dir", help="directory of picker subdirectories")
    parser.add_argument(
        "out_dir",
        help="output directory for BOX files (WARNING - deleted if it "
        "exists, unless --resume)",
    )
    parser.add_argument("box_size", type=int, help="box size (pixels)")
    parser.add_argument(
        "--multi_out",
        action="store_true",
        help="write per-picker TSVs (clique members in picker columns, "
        "then the unchosen particles as confidence-0 rows) instead of "
        "BOX files, as get_cliques --multi_out + run_ilp do",
    )
    parser.add_argument(
        "--get_cc",
        action="store_true",
        help="keep only cliques in the largest connected component",
    )
    parser.add_argument(
        "--solver",
        choices=["greedy", "lp", "lp_device", "lp_device_fused", "exact"],
        default="lp_device",
        help="packing solver: dual-decomposition LP on the device "
        "(default), the fused CUDA chunk program, parallel greedy, LP "
        "relaxation + rounding, or the exact host branch-and-bound "
        "(degrading exact -> lp -> greedy under --solver_budget)",
    )
    parser.add_argument(
        "--solver_budget",
        type=float,
        metavar="SECONDS",
        help="wall-clock budget per exact solve; on exhaustion the "
        "solver ladder degrades to LP rounding, then greedy (requires "
        "--solver exact)",
    )
    parser.add_argument(
        "--stripes",
        type=_stripes_arg,
        metavar="S",
        help="split each micrograph into S x-stripes with a box-size "
        "halo, enumerate them as one batch and solve globally (same "
        "output as unstriped); 'auto' stripes only with fewer "
        "micrographs than devices, which never holds on one card",
    )
    parser.add_argument(
        "--resume",
        action="store_true",
        help="continue an interrupted run: keep out_dir, skip "
        "micrographs already completed per its _journal.jsonl, and "
        "re-process only quarantined/missing entries (the run "
        "configuration must match _manifest.json, else the run "
        "restarts from scratch)",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="fail fast on the first bad input or unrecoverable "
        "error instead of the default lenient mode (retry ladder + "
        "quarantine of failing micrographs)",
    )
    parser.add_argument(
        "--retries",
        type=int,
        default=None,
        metavar="N",
        help="transient-failure retries per rung of the runtime "
        "ladder (default 2, bounded exponential backoff)",
    )
    parser.add_argument(
        "--no_mesh",
        action="store_true",
        help="accepted for compatibility; the port runs on one device",
    )
    parser.add_argument(
        "--pallas",
        action="store_true",
        help="dense neighbour search through the fused top-D kernel; "
        "ignored with a warning when the spatial (bucketed) search is "
        "selected (--spatial on, or auto above 4096 particles)",
    )
    parser.add_argument(
        "--spatial",
        choices=["auto", "on", "off"],
        default="auto",
        help="bucketed neighbor search for dense micrographs "
        "(auto: by particle count)",
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
    from repic_tpu_torch.commands._observability import (
        add_observability_arguments,
    )

    add_observability_arguments(
        parser, trace_flags=("--profile", "--trace-dir"),
        trace_dest="profile",
    )
    parser.add_argument(
        "--status-port",
        type=int,
        default=None,
        metavar="PORT",
        help="serve live observability on 127.0.0.1:PORT while the "
        "run executes: /metrics (Prometheus exposition of the live "
        "registry), /status (run id, chunk progress, ladder/"
        "quarantine tallies), /healthz.  PORT 0 binds an ephemeral "
        "port (printed on stderr).  Off by default",
    )


def main(args):
    import sys

    from repic_tpu_torch.commands._observability import observability_scope
    from repic_tpu_torch.ops import iou_pallas, megakernel
    from repic_tpu_torch.pipeline.consensus import run_consensus_dir
    from repic_tpu_torch.runtime.ladder import RetryPolicy
    from repic_tpu_torch.telemetry.server import maybe_status_server

    if args.solver_budget is not None and args.solver != "exact":
        raise SystemExit(
            "consensus: error: --solver_budget requires --solver exact "
            "(the device greedy/lp packers take no budget)"
        )

    with maybe_status_server(args.status_port) as srv:
        if srv is not None:
            print(f"status server: http://127.0.0.1:{srv.port} "
                  "(/metrics /status /healthz)", file=sys.stderr)
        with observability_scope(args, args.profile):
            stats = run_consensus_dir(
                args.in_dir,
                args.out_dir,
                args.box_size,
                threshold=args.threshold,
                max_neighbors=args.max_neighbors,
                num_particles=args.num_particles,
                spatial={"auto": None, "on": True, "off": False}[
                    args.spatial],
                solver=args.solver,
                use_pallas=args.pallas,
                multi_out=args.multi_out,
                get_cc=args.get_cc,
                stripes=args.stripes,
                resume=args.resume,
                strict=args.strict,
                retry_policy=(RetryPolicy(max_retries=args.retries)
                              if args.retries is not None else None),
                solver_budget_s=args.solver_budget,
                device=args.device,
            )
    stats["launches"] = {
        "topk_neighbors": iou_pallas.LAUNCHES,
        **megakernel.LAUNCHES,
    }
    stats["demotions"] = megakernel.DEMOTIONS
    stats["fallbacks"] = dict(megakernel.FALLBACKS)
    print(json.dumps(stats, default=str))
    return stats
