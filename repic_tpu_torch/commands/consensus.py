"""Directory consensus on this process's cards, on one host of a
cluster that shares the output directory (``--coordination-dir``), or
as one process of a gang (``--gang``).

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
        "output as unstriped); 'auto' stripes over the cards only "
        "with fewer micrographs than cards and dense fields",
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
        help="run every chunk on one card instead of splitting it over "
        "all the cards of the process (same output)",
    )
    parser.add_argument(
        "--coordination-dir",
        metavar="DIR",
        help="enable cluster mode: coordinate N hosts sharing this "
        "directory (heartbeats, micrograph leases, fences) and the "
        "same out_dir.  Each host processes a deterministic shard, "
        "journals to its own _journal.<host>.jsonl, and takes over "
        "work orphaned by hosts whose heartbeat exceeds "
        "--host-timeout.  Host identity comes from REPIC_TPU_HOST_ID/"
        "REPIC_TPU_HOST_RANK/REPIC_TPU_NUM_HOSTS or a torch.distributed "
        "launch (RANK/WORLD_SIZE).  Implies --resume semantics "
        "(out_dir is shared and never deleted).  Pass the out_dir "
        "itself to keep coordination files next to the journals",
    )
    parser.add_argument(
        "--heartbeat-interval",
        type=float,
        default=None,
        metavar="S",
        help="cluster heartbeat renewal period in seconds "
        "(default 2.0; requires --coordination-dir)",
    )
    parser.add_argument(
        "--host-timeout",
        type=float,
        default=None,
        metavar="S",
        help="seconds without a heartbeat before a host is marked "
        "suspect, fenced, and its unfinished micrographs reassigned "
        "(default 10.0; requires --coordination-dir).  --strict "
        "fails fast on the first suspect host instead",
    )
    parser.add_argument(
        "--gang",
        action="store_true",
        help="gang-schedule the chunks across processes: every chunk "
        "runs as one job over the gang, each process on its own rows "
        "and its own card (identity from torchrun's MASTER_ADDR/"
        "MASTER_PORT/WORLD_SIZE/RANK/LOCAL_RANK; a single process "
        "forms a gang of one), the processes agreeing on capacities "
        "and escalations through all-reduces on a gloo group.  Every "
        "dispatch runs under a collective watchdog; a peer lost "
        "mid-collective aborts the chunk, and survivors re-form a "
        "smaller gang over the remaining work or degrade to "
        "independent per-host execution.  Implies cluster semantics "
        "over --coordination-dir (default: out_dir)",
    )
    parser.add_argument(
        "--gang-min-world",
        type=int,
        default=None,
        metavar="N",
        help="below this surviving world size re-formation gives up "
        "and survivors degrade to independent execution (default 1; "
        "requires --gang)",
    )
    parser.add_argument(
        "--gang-watchdog-factor",
        type=float,
        default=None,
        metavar="F",
        help="collective watchdog deadline = max(floor, F x decayed "
        "per-chunk service time) (default 4.0; requires --gang)",
    )
    parser.add_argument(
        "--gang-watchdog-floor",
        type=float,
        default=None,
        metavar="S",
        help="minimum watchdog deadline in seconds (default 10.0; "
        "requires --gang)",
    )
    parser.add_argument(
        "--gang-first-deadline",
        type=float,
        default=None,
        metavar="S",
        help="watchdog deadline for dispatches with no service-time "
        "estimate yet or a program signature's first run ahead of "
        "them (default 600.0; requires --gang)",
    )
    parser.add_argument(
        "--gang-reform-timeout",
        type=float,
        default=None,
        metavar="S",
        help="seconds a survivor waits for the new epoch record and "
        "its peers during gang re-formation, and the gang group's "
        "collective timeout (default 60.0; requires --gang)",
    )
    parser.add_argument(
        "--gang-no-degrade",
        action="store_true",
        help="fail the run when gang re-formation fails instead of "
        "degrading to independent per-host execution (requires "
        "--gang)",
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
    from repic_tpu_torch.ops import megakernel
    from repic_tpu_torch.pipeline.consensus import (
        launch_counts,
        run_consensus_dir,
    )
    from repic_tpu_torch.runtime.ladder import RetryPolicy
    from repic_tpu_torch.telemetry.server import maybe_status_server

    if args.solver_budget is not None and args.solver != "exact":
        raise SystemExit(
            "consensus: error: --solver_budget requires --solver exact "
            "(the device greedy/lp packers take no budget)"
        )

    gang_flags = (args.gang_min_world, args.gang_watchdog_factor,
                  args.gang_watchdog_floor, args.gang_first_deadline,
                  args.gang_reform_timeout, args.gang_no_degrade or None)
    gang = None
    if args.gang:
        from repic_tpu_torch.parallel.gang import GangConfig

        kwargs = {}
        if args.gang_min_world is not None:
            kwargs["min_world"] = args.gang_min_world
        if args.gang_watchdog_factor is not None:
            kwargs["watchdog_factor"] = args.gang_watchdog_factor
        if args.gang_watchdog_floor is not None:
            kwargs["watchdog_floor_s"] = args.gang_watchdog_floor
        if args.gang_first_deadline is not None:
            kwargs["first_deadline_s"] = args.gang_first_deadline
        if args.gang_reform_timeout is not None:
            kwargs["reform_timeout_s"] = args.gang_reform_timeout
        if args.gang_no_degrade:
            kwargs["allow_degrade"] = False
        gang = GangConfig(**kwargs)
    elif any(v is not None for v in gang_flags):
        raise SystemExit(
            "repic-tpu consensus: error: --gang-min-world/"
            "--gang-watchdog-factor/--gang-watchdog-floor/"
            "--gang-first-deadline/--gang-reform-timeout/"
            "--gang-no-degrade require --gang (gang-scheduled "
            "SPMD execution)"
        )
    cluster = None
    if args.coordination_dir:
        from repic_tpu_torch.runtime.cluster import ClusterConfig

        kwargs = {}
        if args.heartbeat_interval is not None:
            kwargs["heartbeat_interval_s"] = args.heartbeat_interval
        if args.host_timeout is not None:
            kwargs["host_timeout_s"] = args.host_timeout
        cluster = ClusterConfig(
            coordination_dir=args.coordination_dir, **kwargs
        )
    elif (
        args.heartbeat_interval is not None
        or args.host_timeout is not None
    ):
        raise SystemExit(
            "repic-tpu consensus: error: --heartbeat-interval/"
            "--host-timeout require --coordination-dir (cluster mode)"
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
                use_mesh=not args.no_mesh,
                cluster=cluster,
                gang=gang,
            )
    stats["launches"] = launch_counts()
    stats["demotions"] = megakernel.DEMOTIONS
    stats["fallbacks"] = dict(megakernel.FALLBACKS)
    print(json.dumps(stats, default=str))
    return stats
