"""``serve`` subcommand: the long-lived consensus daemon on one host.

A daemon takes consensus jobs over HTTP and runs them on its device
through the engine, with admission control, per-request deadlines, a
circuit breaker, graceful drain and a crash-safe request journal (the
reference's ``repic-tpu serve`` contract).  With ``--fleet-dir`` it
is one replica of a serving fleet over a shared durable queue
(:mod:`repic_tpu_torch.serve.fleet`; ``--replica-id``,
``--heartbeat-interval``, ``--replica-timeout``).
"""

name = "serve"


def add_arguments(parser):
    parser.add_argument(
        "work_dir",
        help="daemon state directory: the request journal "
        "(_serve_journal.jsonl), the discovery file (_serve.json "
        "with the bound port), and one jobs/<id>/ output directory "
        "per request.  Reusing it across restarts is what makes "
        "accepted jobs crash-safe",
    )
    parser.add_argument(
        "--port",
        type=int,
        default=0,
        help="listen port on 127.0.0.1 (default 0: ephemeral — read "
        "the bound port from <work_dir>/_serve.json or stderr). "
        "Exposure beyond the host is a deployment concern (SSH "
        "tunnel, sidecar proxy), deliberately not a flag",
    )
    parser.add_argument(
        "--queue-limit",
        type=int,
        default=8,
        metavar="N",
        help="bounded backlog (queued + running) before admission "
        "returns 429 with Retry-After (default 8)",
    )
    parser.add_argument(
        "--default-deadline",
        type=float,
        default=None,
        metavar="S",
        help="deadline applied to requests that do not set "
        "deadline_s themselves (default: none — jobs run to "
        "completion)",
    )
    parser.add_argument(
        "--drain-grace",
        type=float,
        default=30.0,
        metavar="S",
        help="on SIGTERM, seconds the in-flight job may keep "
        "running before a cooperative cancel at its next chunk "
        "boundary (default 30; the job is journaled and resumes "
        "on the next start either way)",
    )
    parser.add_argument(
        "--breaker-threshold",
        type=int,
        default=3,
        metavar="N",
        help="consecutive job FAILURES that open the circuit "
        "breaker (default 3; deadline/cancel outcomes never count)",
    )
    parser.add_argument(
        "--breaker-cooldown",
        type=float,
        default=30.0,
        metavar="S",
        help="seconds the open breaker rejects submissions (503) "
        "before a half-open probe (default 30)",
    )
    parser.add_argument(
        "--no-warmup",
        action="store_true",
        help="skip the startup warmup (on a card: the kernel build and "
        "load and a probe chunk); readiness goes green immediately "
        "and the first request pays it",
    )
    parser.add_argument(
        "--scheduler",
        choices=("batch", "single"),
        default="batch",
        help="'batch' (default): the continuous batcher coalesces "
        "queued micrographs from DIFFERENT requests into one padded "
        "capacity-bucket chunk at every chunk boundary, with "
        "fair-share interleaving so small jobs ride along with a "
        "large one.  'single' restores the one-job-at-a-time worker "
        "(the bench_serve.py comparison baseline)",
    )
    parser.add_argument(
        "--max-open",
        type=int,
        default=4,
        metavar="N",
        help="jobs the batch scheduler holds open at once — the "
        "coalescing window (default 4; scheduler=batch only)",
    )
    parser.add_argument(
        "--compile-cache",
        default="auto",
        metavar="DIR",
        help="program-signature sidecar (programs.json), replayed at "
        "startup so a restarted daemon serves its first request on a "
        "previously served bucket as a program-cache hit.  Default "
        "'auto': <fleet_dir>/_compile_cache in fleet mode, else "
        "<work_dir>/_compile_cache; $REPIC_TPU_COMPILE_CACHE "
        "overrides; 'off' disables.  The kernel libraries persist in "
        "build/repic_tpu_torch/ regardless",
    )
    parser.add_argument(
        "--warmup-bucket",
        action="append",
        default=None,
        metavar="K:N",
        help="ahead-of-time warm a declared capacity bucket (K "
        "pickers, N particle capacity) during startup warmup; "
        "repeatable.  Buckets previously served are replayed "
        "automatically from the compile-cache sidecar",
    )
    parser.add_argument(
        "--tenants",
        default=None,
        metavar="FILE",
        help="enable per-tenant auth + quotas from a JSON keyfile "
        '({"tenants": [{"name", "keys", "rate", "burst", '
        '"max_open_jobs", "max_queued_micrographs", "priority"}, '
        "...]}).  priority is the brownout shed class "
        "(high|normal|low, default normal): under error-budget "
        "pressure the fleet sheds low first, then normal, and "
        "high-priority admission survives every brownout stage.  "
        "Requests then need 'Authorization: Bearer <key>' (401 "
        "missing, 403 unknown); a tenant literally named "
        "'anonymous' (no keys) admits keyless requests under its "
        "limits.  Without this flag the daemon stays open exactly "
        "as before (docs/serving.md \"Multi-tenancy\")",
    )
    parser.add_argument(
        "--fleet-dir",
        default=None,
        metavar="DIR",
        help="join (or found) a serving FLEET: a shared directory "
        "holding the durable job queue (per-replica request "
        "journals merged on read), per-job leases, completion "
        "tokens, replica heartbeats/fences, and the shared jobs/ "
        "output tree.  Start N replicas with the same --fleet-dir "
        "(distinct work_dirs) and any of them accepts, runs, or "
        "answers for any job; a replica that dies mid-job is "
        "fenced and its job finishes on a survivor with resume "
        "semantics",
    )
    parser.add_argument(
        "--replica-id",
        default=None,
        metavar="ID",
        help="stable fleet identity for this replica (default: "
        "$REPIC_TPU_REPLICA_ID, else a pid-derived id).  Restarting "
        "under the SAME id reclaims the replica's journaled jobs "
        "and clears its stale fence",
    )
    parser.add_argument(
        "--heartbeat-interval",
        type=float,
        default=2.0,
        metavar="S",
        help="fleet heartbeat renewal period (default 2.0; fleet "
        "mode only)",
    )
    parser.add_argument(
        "--replica-timeout",
        type=float,
        default=10.0,
        metavar="S",
        help="heartbeat age past which peers may fence this replica "
        "and steal its job leases (default 10.0; must exceed the "
        "heartbeat interval)",
    )
    parser.add_argument(
        "--reassign-budget",
        type=int,
        default=2,
        metavar="N",
        help="per-job retry budget: a job may be (re)started at "
        "most N+1 times across crashes/failovers before it is "
        "QUARANTINED (terminal, never re-run) instead of taking "
        "down the next worker — the poison-pill blast-radius bound "
        "(default 2; docs/serving.md \"quarantine\")",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        choices=("cuda", "cpu"),
        help="where the daemon runs every job (default cuda; fails "
        "at startup where there is no card)",
    )
    parser.add_argument(
        "--slo-target",
        action="append",
        default=None,
        metavar="EP=S[@GOAL]",
        help="latency objective, repeatable: endpoint=seconds with "
        "an optional @goal fraction (default 0.95). Endpoints: "
        "'job' (accept->terminal), 'queue_wait', 'http:<route>'. "
        "Example: --slo-target job=60@0.95 --slo-target "
        "queue_wait=10. /status then reports compliance and "
        "error-budget burn per endpoint (docs/serving.md)",
    )


def main(args):
    import sys

    from repic_tpu_torch.serve.daemon import ConsensusDaemon
    from repic_tpu_torch.telemetry.server import parse_slo_targets

    try:
        slo_targets = parse_slo_targets(args.slo_target)
    except ValueError as e:
        raise SystemExit(f"repic-tpu-torch serve: {e}") from e
    try:
        from repic_tpu_torch.pipeline.engine import parse_warmup_buckets

        warmup_buckets = parse_warmup_buckets(args.warmup_bucket)
    except ValueError as e:
        raise SystemExit(f"repic-tpu-torch serve: {e}") from e
    try:
        daemon = ConsensusDaemon(
            args.work_dir,
            port=args.port,
            queue_limit=args.queue_limit,
            default_deadline_s=args.default_deadline,
            drain_grace_s=args.drain_grace,
            breaker_threshold=args.breaker_threshold,
            breaker_cooldown_s=args.breaker_cooldown,
            warmup=not args.no_warmup,
            slo_targets=slo_targets,
            fleet_dir=args.fleet_dir,
            replica_id=args.replica_id,
            heartbeat_interval_s=args.heartbeat_interval,
            replica_timeout_s=args.replica_timeout,
            scheduler=args.scheduler,
            max_open=args.max_open,
            compile_cache=args.compile_cache,
            warmup_buckets=warmup_buckets,
            tenants=args.tenants,
            reassign_budget=args.reassign_budget,
            device=args.device,
        )
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"repic-tpu-torch serve: {e}") from e
    try:
        daemon.start()
    except OSError as e:
        raise SystemExit(
            f"repic-tpu-torch serve: cannot bind port {args.port}: {e}"
        ) from e
    fleet_note = (
        f" [fleet {daemon.fleet.fleet_dir} "
        f"replica {daemon.fleet.replica}]"
        if daemon.fleet is not None
        else ""
    )
    print(
        f"serve: http://127.0.0.1:{daemon.server.port} "
        "(POST /v1/jobs; /metrics /status /healthz/ready) "
        f"[work_dir {daemon.work_dir}] [device {daemon.device}]"
        f"{fleet_note}",
        file=sys.stderr,
    )
    daemon.install_signal_handlers()
    daemon.run_until_signalled()


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser()
    add_arguments(parser)
    main(parser.parse_args())
