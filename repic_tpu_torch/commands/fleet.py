"""``fleet`` -- fleet-level operations (the reference's flags and
messages).

``fleet supervise FLEET_DIR`` runs the SLO-budget autoscaler
(:class:`repic_tpu_torch.serve.autoscale.Supervisor`): it spawns and
retires ``python -m repic_tpu_torch serve --fleet-dir`` replicas from
error-budget burn and fleet queue depth, publishes the brownout
posture the replicas' admission queues enforce, and journals every
scale decision with its signals.  Replicas run on the card unless
``--serve-arg --device --serve-arg cpu`` is given.
"""

name = "fleet"


def add_arguments(parser):
    sub = parser.add_subparsers(dest="fleet_cmd", required=True)
    sup = sub.add_parser(
        "supervise",
        help="run the SLO-budget autoscaler over a serving fleet",
        description="Spawn/retire serve replicas from error-budget "
        "burn and queue depth; publish brownout posture; journal "
        "every decision to <fleet_dir>/_autoscale.jsonl.  "
        "$REPIC_TPU_AUTOSCALE_DISABLE=1 holds all actions (decisions "
        "still journaled); $REPIC_TPU_TARGET_REPLICAS=N pins the "
        "replica count (clamped to [min, max]).",
    )
    sup.add_argument(
        "fleet_dir",
        help="the fleet's shared directory (same --fleet-dir the "
        "replicas join); the supervisor founds it if missing and "
        "writes _autoscale_state.json + _autoscale.jsonl there",
    )
    sup.add_argument(
        "--min-replicas",
        type=int,
        default=1,
        metavar="N",
        help="floor the fleet never scales below (default 1)",
    )
    sup.add_argument(
        "--max-replicas",
        type=int,
        default=4,
        metavar="N",
        help="ceiling the fleet never scales above (default 4)",
    )
    sup.add_argument(
        "--interval",
        type=float,
        default=2.0,
        metavar="S",
        help="control-loop tick period (default 2.0)",
    )
    sup.add_argument(
        "--cooldown",
        type=float,
        default=10.0,
        metavar="S",
        help="minimum seconds between scale actions — the anti-flap "
        "hold-down; replacing a DEAD replica is exempt (default 10)",
    )
    sup.add_argument(
        "--burn-up",
        type=float,
        default=2.0,
        metavar="B",
        help="job error-budget burn rate above which the fleet "
        "scales up; scale-down additionally requires burn at or "
        "below half this (hysteresis) AND a drained queue "
        "(default 2.0)",
    )
    sup.add_argument(
        "--depth-high",
        type=float,
        default=4.0,
        metavar="J",
        help="queued jobs per live replica above which the fleet "
        "scales up (default 4.0)",
    )
    sup.add_argument(
        "--brownout-burn",
        default=None,
        metavar="B1,B2,B3",
        help="staged burn thresholds for brownout levels 1..3 "
        "(default 2,6,14): level 1 sheds low-priority admission, "
        "level 2 also sheds normal, level 3 additionally halves the "
        "queue limit.  Must be positive and non-decreasing",
    )
    sup.add_argument(
        "--replica-timeout",
        type=float,
        default=10.0,
        metavar="S",
        help="passed through to spawned replicas and used for the "
        "supervisor's own liveness reads (default 10.0)",
    )
    sup.add_argument(
        "--work-root",
        default=None,
        metavar="DIR",
        help="parent directory for spawned replicas' work_dirs "
        "(default <fleet_dir>/_replicas)",
    )
    sup.add_argument(
        "--serve-arg",
        action="append",
        default=None,
        metavar="ARG",
        help="extra argument appended to every spawned replica's "
        "``serve`` command line, repeatable (e.g. --serve-arg "
        "--tenants --serve-arg keys.json --serve-arg "
        "--slo-target --serve-arg job=30)",
    )


def main(args):
    import sys

    from repic_tpu_torch.serve.autoscale import Supervisor

    if args.fleet_cmd != "supervise":  # pragma: no cover - argparse
        raise SystemExit(f"repic-tpu fleet: unknown {args.fleet_cmd}")
    thresholds = None
    if args.brownout_burn is not None:
        try:
            thresholds = tuple(
                float(part)
                for part in args.brownout_burn.split(",")
                if part.strip()
            )
        except ValueError as e:
            raise SystemExit(
                "repic-tpu fleet: --brownout-burn wants "
                f"comma-separated numbers, got {args.brownout_burn!r}"
            ) from e
    kwargs = dict(
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        interval_s=args.interval,
        cooldown_s=args.cooldown,
        burn_up=args.burn_up,
        depth_high=args.depth_high,
        replica_timeout_s=args.replica_timeout,
        serve_args=tuple(args.serve_arg or ()),
        work_root=args.work_root,
    )
    if thresholds is not None:
        kwargs["brownout_thresholds"] = thresholds
    try:
        supervisor = Supervisor(args.fleet_dir, **kwargs)
    except ValueError as e:
        raise SystemExit(f"repic-tpu fleet: {e}") from e
    print(
        f"fleet supervise: {supervisor.fleet_dir} "
        f"[replicas {supervisor.min_replicas}.."
        f"{supervisor.max_replicas}, tick {supervisor.interval_s}s] "
        f"decisions -> {supervisor.fleet_dir}/_autoscale.jsonl",
        file=sys.stderr,
    )
    supervisor.install_signal_handlers()
    supervisor.run()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
