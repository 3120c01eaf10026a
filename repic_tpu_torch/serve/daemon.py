"""The ``serve`` daemon: HTTP surface, worker and recovery (the port of
``repic_tpu.serve.daemon``; with ``fleet_dir`` one replica of a
serving fleet, :mod:`repic_tpu_torch.serve.fleet`).

Extends the status server (:mod:`repic_tpu_torch.telemetry.server`)
with the job API, and runs one worker thread that drives accepted jobs
through the engine (:mod:`repic_tpu_torch.pipeline.engine`) on the
daemon's device.  One worker is deliberate: the device is a serial
resource, and sequential jobs reuse warm programs; concurrency lives
in the HTTP threads and on the device.  The HTTP threads never touch a
tensor: device work happens on the worker thread (and the chunk
prefetch worker it starts).

Endpoint surface (all JSON unless noted)::

    POST   /v1/jobs                submit; 202 | 400 | 429 | 503
    GET    /v1/jobs                job summaries
    GET    /v1/jobs/<id>           full job document
    DELETE /v1/jobs/<id>           cancel (cooperative when running)
    GET    /v1/jobs/<id>/artifacts           artifact name list
    GET    /v1/jobs/<id>/artifacts/<name>    one BOX file (text)
    GET    /metrics /status /healthz[/live|/ready]   (inherited)

Failure semantics are the reference's (docs/serving.md): overload is
429 + ``Retry-After``; repeated job failures open the circuit breaker
(503); deadlines cancel cooperatively at chunk boundaries; SIGTERM
drains; and a crash at any point loses no accepted job -- the request
journal replays them on the next start, in-flight jobs resuming past
their completed micrographs.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import torch

from repic_tpu_torch import telemetry
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.atomic import atomic_write
from repic_tpu_torch.pipeline import consensus as consensus_mod
from repic_tpu_torch.pipeline.consensus import resolve_device
from repic_tpu_torch.serve import autoscale
from repic_tpu_torch.serve import jobs as jobs_mod
from repic_tpu_torch.serve import tenancy
from repic_tpu_torch.serve.jobs import (
    DEFAULT_REASSIGN_BUDGET,
    JOB_CANCELLED,
    JOB_DEADLINE_EXCEEDED,
    JOB_FAILED,
    JOB_FINISHED,
    JOB_QUARANTINED,
    JOB_QUEUED,
    _QUARANTINED,
    AdmissionError,
    CircuitBreaker,
    Job,
    JobQueue,
    ServeJournal,
    crash_point,
    poison_point,
)
from repic_tpu_torch.telemetry import events as tlm_events
from repic_tpu_torch.telemetry import server as tlm_server
from repic_tpu_torch.telemetry import trace as tlm_trace

SERVE_INFO_NAME = "_serve.json"

_log = tlm_events.get_logger("serve")

_REQUESTS = telemetry.counter(
    "repic_serve_requests_total",
    "HTTP requests handled by the serve job API (by route)",
)
_JOB_SECONDS = telemetry.histogram(
    "repic_serve_job_seconds",
    "wall-clock seconds per executed serve job (by capacity bucket)",
)


#: request-body hard cap: the whole submission document is a few
#: hundred bytes of paths and knobs — anything near a megabyte is a
#: client bug or an attack, and must cost a 400, not daemon memory
MAX_BODY_BYTES = 1 << 20
MAX_IDEMPOTENCY_KEY = 200
MAX_IN_DIR = 4096
MAX_BOX_SIZES = 64


def estimate_micrographs(request: dict) -> int | None:
    """Admission-time micrograph count for the validated request —
    the unit the 429 ``Retry-After`` estimate is priced in (queued
    MICROGRAPHS x per-micrograph service time, not whole jobs).
    One directory listing; best-effort (None when unreadable)."""
    try:
        from repic_tpu_torch.utils import box_io

        in_dir = request["in_dir"]
        pickers = box_io.discover_picker_dirs(in_dir)
        if not pickers:
            return None
        return len(
            box_io.micrograph_names(os.path.join(in_dir, pickers[0]))
        )
    except Exception:  # noqa: BLE001 - estimate only, never a 5xx
        return None


def validate_submission(body: bytes):
    """Parse + validate a POST /v1/jobs body.

    Returns ``(request, options, deadline_s, bucket_hint,
    idempotency_key)`` or raises ``ValueError`` with a
    client-readable message (mapped to 400 — a malformed request is
    the client's bug, never a 5xx and NEVER a worker crash: the
    fuzz suite in tests/test_serve_fuzz.py holds this function to
    "ValueError or a valid tuple, nothing else").
    """
    import math

    from repic_tpu_torch.pipeline.engine import ConsensusOptions

    if len(body) > MAX_BODY_BYTES:
        raise ValueError(
            f"request body exceeds {MAX_BODY_BYTES} bytes"
        )
    try:
        data = json.loads(body.decode("utf-8") or "{}")
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(f"invalid JSON body: {e}") from None
    if not isinstance(data, dict):
        raise ValueError("request body must be a JSON object")
    known = {
        "in_dir", "box_size", "options", "deadline_s",
        "bucket_hint", "idempotency_key",
    }
    unknown = sorted(str(k)[:80] for k in set(data) - known)
    if unknown:
        raise ValueError(
            f"unknown field(s) {unknown}; known: {sorted(known)}"
        )
    in_dir = data.get("in_dir")
    if not isinstance(in_dir, str) or not in_dir:
        raise ValueError("in_dir (string) is required")
    if len(in_dir) > MAX_IN_DIR:
        raise ValueError(f"in_dir exceeds {MAX_IN_DIR} chars")
    if not os.path.isdir(in_dir):
        raise ValueError(f"in_dir {in_dir!r} is not a directory")
    box_size = data.get("box_size")
    sizes = (
        box_size if isinstance(box_size, list) else [box_size]
    )
    if len(sizes) > MAX_BOX_SIZES:
        raise ValueError(
            f"box_size lists more than {MAX_BOX_SIZES} pickers"
        )
    if not sizes or not all(
        isinstance(b, (int, float))
        and not isinstance(b, bool)
        and math.isfinite(b)
        and 0 < b <= 1e6
        for b in sizes
    ):
        raise ValueError("box_size must be a positive finite number "
                         "(or a per-picker list of them)")
    # None means "defaults", but a falsy WRONG type ([], 0, false,
    # "") must still be a 400 — `or {}` would silently accept it
    opts_raw = data.get("options")
    if opts_raw is None:
        opts_raw = {}
    options = ConsensusOptions.from_dict(opts_raw)
    deadline_s = data.get("deadline_s")
    if deadline_s is not None:
        if (
            not isinstance(deadline_s, (int, float))
            or isinstance(deadline_s, bool)
            or not math.isfinite(deadline_s)
            or deadline_s <= 0
        ):
            raise ValueError(
                "deadline_s must be a positive finite number"
            )
        deadline_s = float(deadline_s)
    bucket_hint = data.get("bucket_hint")
    if bucket_hint is not None:
        if (
            not isinstance(bucket_hint, int)
            or isinstance(bucket_hint, bool)
            or not 1 <= bucket_hint <= 10**7
        ):
            raise ValueError("bucket_hint must be a positive int")
    idempotency_key = data.get("idempotency_key")
    if idempotency_key is not None:
        if (
            not isinstance(idempotency_key, str)
            or not idempotency_key
            or len(idempotency_key) > MAX_IDEMPOTENCY_KEY
        ):
            raise ValueError(
                "idempotency_key must be a non-empty string of at "
                f"most {MAX_IDEMPOTENCY_KEY} chars"
            )
    request = {
        "in_dir": os.path.abspath(in_dir),
        "box_size": box_size,
        "options": opts_raw,
    }
    return request, options, deadline_s, bucket_hint, idempotency_key


class ServeServer(tlm_server.StatusServer):
    """StatusServer + the ``/v1/jobs`` API (one override point)."""

    def __init__(self, daemon: "ConsensusDaemon", port: int,
                 host: str):
        super().__init__(port=port, host=host)
        self.daemon = daemon

    # one handler thread per request (ThreadingHTTPServer); every
    # mutation goes through the queue's lock + journal
    def handle_request(self, handler, method, path, body) -> bool:
        if not path.startswith("/v1/jobs"):
            return False
        parts = [p for p in path.split("/") if p][2:]  # after v1/jobs
        try:
            # identity gate for the whole job API (observability
            # endpoints stay open — they bind 127.0.0.1 and carry
            # no tenant data): with no --tenants file this resolves
            # to None and the API behaves exactly as before
            try:
                tenant = self._resolve_tenant(handler)
            except tenancy.AuthError as e:
                tenancy.note_auth_failure(e.http_status)
                hdrs = (
                    {"WWW-Authenticate": "Bearer"}
                    if e.http_status == 401
                    else None
                )
                self._json(
                    handler, e.http_status,
                    {"error": e.reason}, hdrs,
                )
                return True
            if method == "POST" and not parts:
                self._submit(handler, body, tenant)
            elif method == "GET" and not parts:
                _REQUESTS.inc(route="jobs_list")
                docs = sorted(
                    (
                        j.doc()
                        for j in self.daemon.queue.jobs()
                        if self._owned(j, tenant)
                    ),
                    key=lambda d: d["accepted_ts"],
                )
                self._json(handler, 200, {"jobs": docs})
            elif len(parts) == 1:
                self._one_job(handler, method, parts[0], tenant)
            elif len(parts) >= 2 and parts[1] == "artifacts":
                self._artifacts(handler, method, parts, tenant)
            else:
                self._json(handler, 404, {"error": "not found"})
        except BrokenPipeError:
            pass  # client vanished mid-response; nothing to clean
        return True

    def _resolve_tenant(self, handler) -> str | None:
        """The request's authenticated tenant, or None when tenancy
        is not configured (today's open single-tenant behavior)."""
        registry = self.daemon.tenancy
        if registry is None:
            return None
        return registry.resolve(
            handler.headers.get("Authorization")
        )

    @staticmethod
    def _owned(job, tenant: str | None) -> bool:
        """Tenant isolation on the read/cancel surface: with tenancy
        configured, a job is visible only to the tenant that
        submitted it (pre-tenancy jobs — tenant None — stay visible
        to everyone, so enabling auth does not orphan history)."""
        return (
            tenant is None
            or job.tenant is None
            or job.tenant == tenant
        )

    def _json(self, handler, code: int, doc: dict,
              headers: dict | None = None):
        handler._send(
            code, "application/json",
            json.dumps(doc, default=str, sort_keys=True) + "\n",
            headers,
        )

    def _submit(self, handler, body: bytes,
                tenant: str | None = None):
        _REQUESTS.inc(route="jobs_submit")
        try:
            (request, options, deadline_s, hint,
             idempotency_key) = validate_submission(body)
        except ValueError as e:
            self._json(handler, 400, {"error": str(e)})
            return
        if deadline_s is None:
            deadline_s = self.daemon.default_deadline_s
        try:
            job, deduped = self.daemon.queue.submit_idempotent(
                request,
                deadline_s=deadline_s,
                bucket_hint=hint,
                idempotency_key=idempotency_key,
                tenant=tenant,
                # lazy: the queue resolves this only past the
                # draining/breaker rejections — load shedding must
                # not pay directory listings per refused request
                micrographs=lambda: estimate_micrographs(request),
            )
        except AdmissionError as e:
            self._json(
                handler,
                e.http_status,
                {"error": e.reason,
                 "retry_after_s": e.retry_after_s},
                {"Retry-After": e.retry_after_s},
            )
            return
        self.daemon.publish_status()
        if deduped:
            # a retry of an accepted request: same job, and a 200 —
            # the 202 durability promise was already made once
            self._json(
                handler, 200, dict(job.doc(), deduped=True)
            )
            return
        self._json(handler, 202, job.doc())

    def _one_job(self, handler, method, job_id,
                 tenant: str | None = None):
        job = self.daemon.queue.get(job_id)
        if job is None:
            _REQUESTS.inc(route="jobs_get")
            self._json(handler, 404, {"error": f"no job {job_id}"})
        elif not self._owned(job, tenant):
            _REQUESTS.inc(route="jobs_get")
            tenancy.note_auth_failure(403, cause="ownership")
            self._json(
                handler, 403,
                {"error": "job belongs to another tenant"},
            )
        elif method == "DELETE":
            _REQUESTS.inc(route="jobs_cancel")
            got = self.daemon.queue.cancel(job_id)
            self.daemon.publish_status()
            self._json(handler, 202, (got or job).doc())
        elif method == "GET":
            _REQUESTS.inc(route="jobs_get")
            self._json(handler, 200, job.doc())
        else:
            self._json(handler, 405, {"error": "method not allowed"})

    def _artifacts(self, handler, method, parts,
                   tenant: str | None = None):
        _REQUESTS.inc(route="artifacts")
        job = self.daemon.queue.get(parts[0])
        if job is None or method != "GET":
            code = 404 if job is None else 405
            self._json(handler, code, {"error": "not found"})
            return
        if not self._owned(job, tenant):
            tenancy.note_auth_failure(403, cause="ownership")
            self._json(
                handler, 403,
                {"error": "job belongs to another tenant"},
            )
            return
        out_dir = self.daemon.job_dir(job.id)
        names = sorted(
            f for f in (
                os.listdir(out_dir)
                if os.path.isdir(out_dir)
                else ()
            )
            if f.endswith(".box")
        )
        if len(parts) == 2:
            self._json(
                handler, 200,
                {"job": job.id, "artifacts": names},
            )
            return
        name = parts[2]
        if name not in names:  # also forecloses path traversal
            self._json(handler, 404, {"error": f"no artifact {name}"})
            return
        with open(os.path.join(out_dir, name)) as f:
            content = f.read()
        if faults.check("slow_client", f"{job.id}:{name}"):
            # the deterministic slow/vanished client: promise the
            # full payload, deliver half, drop the connection.  The
            # daemon must shrug (this handler thread only) — the
            # job, its artifacts, and every other connection are
            # untouched, and the client simply retries.
            data = content.encode("utf-8")
            handler.send_response(200)
            handler.send_header("Content-Type", "text/plain")
            handler.send_header("Content-Length", str(len(data)))
            handler.end_headers()
            handler.wfile.write(data[: len(data) // 2])
            handler.wfile.flush()
            handler.connection.close()
            return
        handler._send(200, "text/plain; charset=utf-8", content)


class ConsensusDaemon:
    """One serve instance: queue + journal + worker + HTTP server."""

    def __init__(
        self,
        work_dir: str,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        queue_limit: int = 8,
        default_deadline_s: float | None = None,
        drain_grace_s: float = 30.0,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        warmup: bool = True,
        slo_targets: dict | None = None,
        fleet_dir: str | None = None,
        replica_id: str | None = None,
        heartbeat_interval_s: float = 2.0,
        replica_timeout_s: float = 10.0,
        scheduler: str = "batch",
        max_open: int = 4,
        compile_cache: str | None = None,
        warmup_buckets: list | None = None,
        tenants=None,
        reassign_budget: int = DEFAULT_REASSIGN_BUDGET,
        device=None,
        clock=time.time,
    ):
        # the daemon's device: ``cuda`` unless the caller asks for the
        # CPU; a missing card raises here, before a port is bound.  A
        # card gets its index, which the worker thread selects.
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if scheduler not in ("batch", "single"):
            raise ValueError(
                f"scheduler must be 'batch' or 'single', "
                f"got {scheduler!r}"
            )
        if int(max_open) < 1:
            # validated HERE, not first inside the worker thread: a
            # worker that dies after readiness goes green leaves a
            # live front end 202-ing jobs into a queue nothing
            # drains
            raise ValueError(
                f"max_open must be >= 1, got {max_open}"
            )
        self.work_dir = os.path.abspath(work_dir)
        self.default_deadline_s = default_deadline_s
        self.drain_grace_s = drain_grace_s
        self.do_warmup = warmup
        self.scheduler = scheduler
        self.max_open = int(max_open)
        self.warmup_bucket_list = list(warmup_buckets or ())
        self.batcher = None
        self._clock = clock
        if int(reassign_budget) < 0:
            raise ValueError(
                f"reassign budget must be >= 0, "
                f"got {reassign_budget}"
            )
        self.reassign_budget = int(reassign_budget)
        # tenancy: a keyfile path, a ready TenantRegistry (tests),
        # or None — None keeps the open single-tenant behavior
        # (docs/serving.md "Multi-tenancy"); a bad keyfile is a
        # startup ValueError, never a silently-unauthenticated port
        if tenants is None or isinstance(
            tenants, tenancy.TenantRegistry
        ):
            self.tenancy = tenants
        else:
            self.tenancy = tenancy.TenantRegistry.load(
                tenants, clock=clock
            )
        # rolling SLO view for /status (always on — without
        # --slo-target objectives it still reports p50/p95/p99)
        self.slo = tlm_server.SLOTracker(objectives=slo_targets)
        os.makedirs(self.work_dir, exist_ok=True)
        breaker = CircuitBreaker(
            threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
            clock=clock,
        )
        self.fleet = None
        if fleet_dir is not None:
            # fleet mode: the durable queue and jobs/ live in
            # FLEET_DIR, shared by every replica; this replica's
            # work_dir keeps only its discovery file
            from repic_tpu_torch.serve.fleet import FleetMember, FleetQueue

            self.fleet = FleetMember(
                fleet_dir,
                replica_id,
                heartbeat_interval_s=heartbeat_interval_s,
                replica_timeout_s=replica_timeout_s,
                reassign_budget=self.reassign_budget,
                clock=clock,
            )
            self.journal = ServeJournal(
                self.fleet.fleet_dir, replica=self.fleet.replica
            )
            self.queue = FleetQueue(
                queue_limit,
                self.journal,
                self.fleet,
                breaker,
                tenants=self.tenancy,
                clock=clock,
            )
        else:
            self.journal = ServeJournal(self.work_dir)
            self.queue = JobQueue(
                queue_limit,
                self.journal,
                breaker,
                tenants=self.tenancy,
                clock=clock,
            )
        self.server = ServeServer(self, port, host)
        # the compile-cache sidecar (runtime.compilecache): "auto"
        # puts it in <fleet_dir>/_compile_cache (shared: a replacement
        # replica starts warm) or <work_dir>/_compile_cache; None (the
        # direct construction default) leaves it off
        self.compile_cache_dir = None
        if compile_cache is not None:
            from repic_tpu_torch.runtime import compilecache

            root = (self.fleet.fleet_dir if self.fleet is not None
                    else self.work_dir)
            self.compile_cache_dir = compilecache.resolve_dir(
                None if compile_cache == "auto" else compile_cache,
                os.path.join(root, "_compile_cache"),
            )
            if self.compile_cache_dir is not None:
                compilecache.enable(self.compile_cache_dir)
        self._stop = threading.Event()
        self._drain_deadline: float | None = None
        self._worker: threading.Thread | None = None

    # -- lifecycle ----------------------------------------------------

    def job_dir(self, job_id: str) -> str:
        root = (self.fleet.fleet_dir if self.fleet is not None
                else self.work_dir)
        return os.path.join(root, "jobs", job_id)

    def start(self) -> "ConsensusDaemon":
        self._compact_journal()
        if self.fleet is not None:
            # membership first: the heartbeat must be fresh (and a
            # stale fence of this replica cleared) before peers read
            # this replica's journal
            self.fleet.start()
            recovered = self.queue.recover_own()
        else:
            recovered = self.journal.recover()
        self.server.start()
        tlm_server.set_slo_tracker(self.slo)
        self.journal.record_event(
            "server_started",
            pid=os.getpid(),
            port=self.server.port,
            recovered=[j.id for j in recovered],
            # journal the objectives too: `repic-tpu report` rebuilds
            # SLO compliance from the journal post-mortem, and the
            # targets it judges against must be the ones this run
            # actually served under, not whatever the CLI defaults
            # to at report time
            slo_targets={
                ep: [t, g]
                for ep, (t, g) in sorted(self.slo.objectives.items())
            },
        )
        if self.fleet is None:
            runnable = []
            for job in recovered:
                # the single-replica half of the poison-pill budget:
                # a journaled in-flight job that already crashed
                # budget + 1 daemon generations is quarantined here
                # instead of re-crashing this one (the fleet's
                # recover_own applies it itself)
                if job.attempts > self.reassign_budget:
                    self.queue.adopt(job, runnable=False)
                    job.reason = jobs_mod.quarantine_reason(
                        job.attempts, self.reassign_budget
                    )
                    self._finish_job(
                        job, JOB_QUARANTINED,
                        reason=job.reason,
                        attempts=job.attempts,
                    )
                    _QUARANTINED.inc(path="recover")
                    _log.error(
                        f"quarantined job {job.id}: {job.reason}"
                    )
                else:
                    self.queue.adopt(job)
                    runnable.append(job)
            recovered = runnable
        if recovered:
            _log.info(
                f"recovered {len(recovered)} journaled job(s) "
                "from the previous generation"
            )
        # discovery file: ephemeral-port consumers (CI, operators)
        # read the bound port from here instead of parsing stderr
        info = {
            "pid": os.getpid(),
            "host": self.server.host,
            "port": self.server.port,
            "started_ts": self._clock(),
        }
        if self.fleet is not None:
            info["replica"] = self.fleet.replica
            info["fleet_dir"] = self.fleet.fleet_dir
        with atomic_write(
            os.path.join(self.work_dir, SERVE_INFO_NAME)
        ) as f:
            json.dump(info, f)
        self.publish_status()
        self._worker = threading.Thread(
            target=self._worker_loop,
            name="repic-serve-worker",
            daemon=True,
        )
        self._worker.start()
        return self

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (main-thread only)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self._stop.set())

    def run_until_signalled(self) -> None:
        while not self._stop.wait(0.2):
            pass
        self.drain()

    def request_stop(self) -> None:
        self._stop.set()

    def begin_drain(self) -> int:
        """Phase 1 of the graceful shutdown: readiness goes red,
        admission closes (503 ``draining``), the in-flight job gets
        ``drain_grace_s`` before a cooperative cancel at its next
        chunk boundary.  Queued jobs stay journaled for the next
        generation.  The HTTP server keeps answering — health
        checkers and pollers must see the drain, not a dead port."""
        tlm_server.set_ready(False)
        self._drain_deadline = self._clock() + self.drain_grace_s
        left = self.queue.begin_drain()
        self.journal.record_event("drain_begin", queued=left)
        _log.info(f"draining: {left} queued job(s) journaled for "
                  "the next start")
        return left

    def _compact_journal(self) -> None:
        """Bound request-journal growth (ServeJournal.compact) at
        the two safe moments — startup before recovery, clean drain
        after close — and never let a compaction problem take the
        daemon down: the journal's append path works regardless."""
        try:
            terminal_ids = None
            if self.fleet is not None:
                # a job accepted here usually finishes on a peer, so
                # this replica's own file never holds its terminal
                # record: classify against the merged view and the
                # completion tokens, or the journal would grow forever
                view = self.queue.fleet_view()
                terminal_ids = {
                    jid
                    for jid, info in view.items()
                    if info["state"] in jobs_mod.TERMINAL_STATES
                    or self.fleet.read_done(jid) is not None
                }
            stats = self.journal.compact(
                max_terminal=JobQueue.MAX_TERMINAL,
                terminal_ids=terminal_ids,
            )
        except Exception as e:  # noqa: BLE001 - never fatal
            _log.error(f"journal compaction failed: {e}")
            return
        if stats:
            _log.info(
                f"compacted request journal: {stats['folded']} "
                f"terminal job(s) folded, "
                f"{stats['dropped_events']} old event(s) dropped"
            )

    def finish_drain(self) -> None:
        """Phase 2: wait out the worker, then stop serving."""
        if self._worker is not None:
            self._worker.join(timeout=self.drain_grace_s + 30.0)
        self.journal.record_event("drain_complete")
        if self.fleet is not None:
            # the final heartbeat records `stopped`, so peers may take
            # over at once whatever is left (a clean drain leaves no
            # lease behind)
            self.fleet.stop(clean=True)
        if tlm_server.get_slo_tracker() is self.slo:
            tlm_server.set_slo_tracker(None)
        self.server.stop()
        self.journal.close()
        # clean drain is the other safe single-writer moment: the
        # next generation starts against an already-bounded journal
        self._compact_journal()

    def drain(self) -> None:
        self.begin_drain()
        self.finish_drain()

    def publish_status(self) -> None:
        by_state: dict[str, int] = {}
        for j in self.queue.jobs():
            by_state[j.state] = by_state.get(j.state, 0) + 1
        fields = dict(
            service="serve",
            work_dir=self.work_dir,
            jobs=by_state,
            draining=self.queue.draining,
            # full breaker visibility (state + consecutive-failure
            # count + cooldown) — a tripped breaker must be readable
            # off /status, not inferred from 503s
            breaker=self.queue.breaker.describe(),
            scheduler=(
                self.batcher.status()
                if self.batcher is not None
                else {"mode": self.scheduler}
            ),
        )
        if self.tenancy is not None:
            fields["tenants"] = self._tenant_status()
        # this process's kernel launches (the wrappers' counters): a
        # replica's card work is readable off /status
        fields["launches"] = consensus_mod.launch_counts()
        if self.fleet is not None:
            fields["fleet"] = self.queue.fleet_status()
            # the autoscale supervisor's last published posture, when
            # one runs over this fleet_dir
            scale = autoscale.read_state(self.fleet.fleet_dir)
            if scale is not None:
                fields["autoscaler"] = scale
        tlm_server.set_status(**fields)

    def _tenant_status(self) -> dict:
        """The /status ``tenants`` section: per-tenant live load
        (open jobs, queued micrographs), configured limits + rate
        state, rejection tallies, and the tenant's breaker slot —
        pushing the same numbers onto the repic_tenant_* gauges."""
        tallies = self.queue.tenant_tallies()
        breaker = self.queue.breaker.describe().get("tenants", {})
        out = {}
        for name in self.tenancy.names():
            t = tallies.get(name, {})
            entry = {
                "open_jobs": t.get("open_jobs", 0),
                "queued_micrographs": t.get(
                    "queued_micrographs", 0
                ),
            }
            entry.update(self.tenancy.describe(name))
            if name in breaker:
                entry["breaker"] = breaker[name]
            tenancy.set_tenant_gauges(
                name,
                entry["open_jobs"],
                entry["queued_micrographs"],
            )
            out[name] = entry
        return out

    # -- worker -------------------------------------------------------

    def _warmup(self) -> None:
        """The readiness gate: the probe program (on a card, after
        the kernel libraries are built and loaded), every declared
        ``--warmup-bucket``, and -- with the compile-cache sidecar on
        -- a replay of every recorded program signature, so the first
        request on a previously served bucket is a program-cache
        hit."""
        try:
            from repic_tpu_torch.pipeline import engine

            info = engine.warmup(device=self.device)
            if self.warmup_bucket_list:
                info["buckets"] = engine.warmup_buckets(
                    self.warmup_bucket_list, device=self.device
                )
            if self.compile_cache_dir is not None:
                info.update(engine.warmup_from_cache(device=self.device))
                info["compile_cache"] = self.compile_cache_dir
            self.journal.record_event("warmup", **info)
            tlm_server.set_ready(True)
        except Exception as e:  # noqa: BLE001 - stay alive
            # liveness stays green (the operator can reach
            # /status); readiness stays red — the standard
            # "up but unservable" posture
            self.journal.record_event(
                "warmup_failed", error=self.queue.error_doc(e)
            )
            _log.error(f"warmup failed: {e}")

    def _worker_loop(self) -> None:
        # torch state is per thread: this thread (and the prefetch
        # worker, which copies it) runs without autograd on the
        # daemon's device and that device's current stream
        torch.set_grad_enabled(False)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        if self.do_warmup:
            self._warmup()
        else:
            tlm_server.set_ready(True)
        if self.scheduler == "batch":
            from repic_tpu_torch.serve.batcher import ContinuousBatcher

            self.batcher = ContinuousBatcher(
                self, max_open=self.max_open
            )
            self.batcher.run()
            return
        last_bucket = None
        while True:
            job = self.queue.next_job(0.2, last_bucket)
            if job is None:
                if self.queue.draining:
                    return
                continue
            try:
                last_bucket = self._run_job(job) or last_bucket
            except Exception as e:  # noqa: BLE001 - last resort
                # _run_job isolates job failures itself; anything
                # escaping it (journal write failing in
                # mark_running, a broken queue) must still not kill
                # the sole worker — a dead worker with a live HTTP
                # front end would 202 jobs into a queue nothing
                # drains, with every health probe green
                try:
                    job.error = self.queue.error_doc(e)
                    # through _finish_job, not queue.finish: the SLO
                    # plane must hear about THESE failures too —
                    # they are the worst case it exists to surface
                    self._finish_job(
                        job, JOB_FAILED, error=job.error
                    )
                except Exception:  # the journal itself may be down
                    self.queue.mark_failed(job)
                self.queue.breaker.record_failure(job.tenant)
                _log.error(f"worker error on job {job.id}: {e}")
            self.publish_status()

    def _cancel_check(self, job: Job):
        """The per-request cancel hook, polled at chunk boundaries."""

        def check():
            if faults.check("deadline_exceeded", job.id):
                job.cancel_reason = (
                    "deadline exceeded (injected fault)"
                )
            elif self.fleet is not None and self.fleet.is_fenced():
                # a survivor fenced this replica and took the job over:
                # stop at the chunk boundary without a terminal record
                job.cancel_reason = "fenced by a peer replica"
            elif job.cancel_requested:
                job.cancel_reason = "cancelled by client"
            elif self.fleet is not None and (
                self.queue.cancel_requested_remote(job.id)
            ):
                # a DELETE answered by another replica reaches the
                # runner through the merged fleet journal
                job.cancel_requested = True
                job.cancel_reason = "cancelled by client"
            elif (
                job.deadline_ts is not None
                and self._clock() > job.deadline_ts
            ):
                budget = job.deadline_ts - job.accepted_ts
                job.cancel_reason = (
                    f"deadline exceeded ({budget:.1f}s budget)"
                )
            elif (
                self._drain_deadline is not None
                and self._clock() > self._drain_deadline
            ):
                job.cancel_reason = "draining past grace"
            return job.cancel_reason

        return check

    def _finish_job(self, job: Job, state: str, **fields):
        """queue.finish + the job-latency SLO observation (accept ->
        terminal, the user-visible latency; deadline/cancel outcomes
        count as SLO violations only when an objective is set — they
        are recorded ``ok=False`` either way so the burn rate sees
        them)."""
        from repic_tpu_torch.serve.jobs import TERMINAL_STATES

        self.queue.finish(job, state, **fields)
        if state in TERMINAL_STATES:
            latency = max(
                (job.finished_ts or self._clock())
                - job.accepted_ts,
                0.0,
            )
            tlm_server.observe_slo(
                "job",
                latency,
                ok=state == JOB_FINISHED,
                bucket=job.progress.get("capacity"),
            )
            if job.tenant is not None:
                # the per-tenant SLO bucket: tenant B's
                # compliance is readable off /status independent of
                # tenant A's throttling or failures — objectives
                # inherit the `job` target (telemetry.server)
                tlm_server.observe_slo(
                    f"tenant:{job.tenant}",
                    latency,
                    ok=state == JOB_FINISHED,
                )

    def _run_job(self, job: Job):
        """Execute one job through the engine; returns the warmed
        bucket key (or None).  Every exit path records a journal
        state — crash points between them are what the recovery
        tests exercise.  The whole execution runs under the job's
        trace context (minted at HTTP accept), so every span and
        journal record joins back to the request, and the per-request
        ``_trace.jsonl`` in the job directory gains the
        queue_wait/plan/compile/execute/emit segments ``repic-tpu
        trace`` renders."""
        out_dir = self.job_dir(job.id)
        self.queue.mark_running(job)
        # everything from this real-time instant to the first chunk
        # is the "plan" segment (trace/journal open, load, planning)
        # — anchored HERE so the segment sum stays within a few ms
        # of the job's wall time even for sub-100ms warm jobs
        t_picked = time.time()
        self.publish_status()
        queue_wait = max(
            (job.started_ts or job.accepted_ts) - job.accepted_ts,
            0.0,
        )
        tlm_server.observe_slo("queue_wait", queue_wait)
        os.makedirs(out_dir, exist_ok=True)
        # fleet mode: a per-replica _trace.<replica>.jsonl under the
        # trace id minted at accept, so a job that fails over leaves
        # two files that merge into one waterfall
        replica = self.fleet.replica if self.fleet else None
        tctx = tlm_trace.start(
            out_dir,
            trace_id=job.trace_id,
            host=replica,
            kind="serve",
            job=job.id,
            accepted_ts=round(job.accepted_ts, 6),
            # tenant attribution rides the trace root: a waterfall
            # answers "whose request was this" without the journal
            **({"tenant": job.tenant} if job.tenant else {}),
        )
        # a job recovered from a pre-tracing journal gains an id here
        job.trace_id = tctx.trace_id
        token = tlm_trace.activate(tctx)
        try:
            tlm_trace.add_segment(
                "queue_wait", job.accepted_ts, queue_wait
            )
            return self._run_job_traced(job, out_dir, t_picked)
        finally:
            tlm_trace.deactivate(token)
            tctx.close()

    def _run_job_traced(
        self, job: Job, out_dir: str, t_picked: float
    ):
        import numpy as np

        from repic_tpu_torch.pipeline import engine
        from repic_tpu_torch.runtime.journal import RunJournal, error_info
        from repic_tpu_torch.runtime.ladder import ChunkOutcomes
        from repic_tpu_torch.telemetry import probes as tlm_probes
        from repic_tpu_torch.utils import box_io

        crash_point(f"run:{job.id}")
        replica = self.fleet.replica if self.fleet else None
        if self.fleet is not None:
            from repic_tpu_torch.serve import fleet as fleet_mod

            fleet_mod.crash_point(replica, f"run:{job.id}")
        t0 = self._clock()
        # a job that aged out while queued never touches the device
        if (
            job.deadline_ts is not None
            and self._clock() > job.deadline_ts
        ):
            job.reason = "deadline exceeded while queued"
            self._finish_job(
                job, JOB_DEADLINE_EXCEEDED, reason=job.reason
            )
            return None
        options = None
        bucket = None
        rt = None
        run_journal = None
        try:
            t_plan0 = t_picked
            options = engine.ConsensusOptions.from_dict(
                job.request.get("options") or {}
            )
            in_dir = job.request["in_dir"]
            # the poison pill fires HERE, after mark_running's
            # journal record (so every attempt is counted toward
            # the retry budget) and before any artifact lands
            poison_point(job.id, in_dir)
            box_size = job.request["box_size"]
            pickers = box_io.discover_picker_dirs(in_dir)
            if not pickers:
                raise ValueError(
                    f"no picker subdirectories in {in_dir}"
                )
            names = box_io.micrograph_names(
                os.path.join(in_dir, pickers[0])
            )
            run_config = {
                "in_dir": in_dir,
                "box_size": np.asarray(box_size).tolist(),
                "threshold": options.threshold,
                "num_particles": options.num_particles,
                "solver": options.solver,
                "pickers": pickers,
                "names": names,
            }
            # resume semantics give crash recovery its zero-loss
            # guarantee: a re-run of a journaled in-flight job skips
            # every micrograph whose outcome + artifact survived
            # a fleet replica opens the run journal in cluster shape:
            # each attempt appends to its own _journal.<replica>.jsonl
            # and resumes from the merged view, so a takeover skips
            # the lost replica's finished micrographs
            journal = run_journal = RunJournal.open(
                out_dir,
                run_config,
                resume=True,
                host=replica,
                cluster=replica is not None,
            )
            rt = telemetry.start_run(
                out_dir,
                run_id=f"serve-{job.id}",
                host=replica,
            )
            already = set()
            if journal.resumed:
                latest = journal.latest()
                for nm in journal.done_names():
                    out_name = latest[nm].get("out", nm + ".box")
                    if os.path.exists(
                        os.path.join(out_dir, out_name)
                    ):
                        already.add(nm)
            counts: dict[str, int] = {}
            quarantined: dict[str, dict] = {}
            loaded = []
            for nm in names:
                if nm in already:
                    continue
                try:
                    sets = box_io.load_micrograph_set(
                        in_dir, pickers, nm
                    )
                except (box_io.BoxParseError, OSError) as e:
                    if options.strict:
                        raise
                    info = error_info(
                        e, path=getattr(e, "path", None)
                    )
                    quarantined[nm] = info
                    journal.record(
                        nm, "quarantined", error=info, stage="load"
                    )
                    continue
                if sets is None:
                    box_io.write_empty_box(
                        os.path.join(out_dir, nm + ".box")
                    )
                    journal.record(
                        nm, "skipped", out=nm + ".box"
                    )
                    counts[nm] = 0
                    continue
                loaded.append((nm, sets))
            outcomes = ChunkOutcomes()
            if loaded:
                mesh = engine.request_mesh(options, self.device)
                plan = engine.plan_request(
                    loaded, box_size, options, n_dev=len(mesh)
                )
                # the warm-affinity handle handed back to next_job
                # must be the CAPACITY int (what clients declare as
                # bucket_hint) — the full bucket_key tuple would
                # never compare equal to a hint and silently turn
                # affinity scheduling into pure FIFO
                bucket = plan.capacity
                job.progress = {
                    "chunks_total": len(plan.chunks),
                    "chunks_done": 0,
                    "capacity": plan.capacity,
                    "micrographs_total": len(names),
                    "micrographs_done": len(already) + len(counts),
                }
                tlm_trace.add_segment(
                    "plan", t_plan0, time.time() - t_plan0,
                    micrographs=len(names),
                    chunks=len(plan.chunks),
                    capacity=plan.capacity,
                )

                def _sink(fname, content):
                    with atomic_write(
                        os.path.join(out_dir, fname)
                    ) as f:
                        f.write(content)

                chunks = engine.execute_request(
                    loaded,
                    box_size,
                    options,
                    device=mesh[0],
                    mesh=mesh,
                    cancel=self._cancel_check(job),
                    outcomes=outcomes,
                    journal=journal,
                )
                # compile-vs-execute split per chunk: the compile
                # probe delta inside the chunk window is the compile
                # segment, joined to the program-cache counter
                # deltas — a warm request shows cache_hits>0 and a
                # near-zero compile segment
                hits_c = telemetry.counter(
                    "repic_program_cache_hits_total"
                )
                miss_c = telemetry.counter(
                    "repic_program_cache_misses_total"
                )
                t_mark = time.time()
                comp_mark = tlm_probes.compile_seconds()
                hits_mark = hits_c.value()
                miss_mark = miss_c.value()
                for i, (part, cbatch, _res, packed, secs) in (
                    enumerate(chunks)
                ):
                    now = time.time()
                    chunk_wall = max(now - t_mark, float(secs), 0.0)
                    compile_s = min(
                        max(
                            tlm_probes.compile_seconds() - comp_mark,
                            0.0,
                        ),
                        chunk_wall,
                    )
                    hits_now = hits_c.value()
                    miss_now = miss_c.value()
                    # also on a pure cache delta: the marks advance
                    # every chunk, so a warm chunk's hit would
                    # otherwise be dropped and the trace undercount
                    if (
                        i == 0
                        or compile_s > 0.0
                        or hits_now > hits_mark
                        or miss_now > miss_mark
                    ):
                        tlm_trace.add_segment(
                            "compile", now - chunk_wall, compile_s,
                            chunk=i,
                            cache_hits=int(hits_now - hits_mark),
                            cache_misses=int(miss_now - miss_mark),
                        )
                    tlm_trace.add_segment(
                        "execute",
                        now - chunk_wall + compile_s,
                        chunk_wall - compile_s,
                        chunk=i,
                        micrographs=len(part),
                        capacity=cbatch.capacity,
                    )
                    # the emit segment covers the chunk's whole
                    # host-side tail — artifact rendering, journal
                    # records, AND the streaming sink flush — so the
                    # segments stay contiguous and their sum tracks
                    # the job wall time (the acceptance contract)
                    with tlm_trace.segment(
                        "emit", chunk=i, micrographs=len(part)
                    ):
                        counts.update(
                            engine.emit_box_chunk(
                                cbatch, packed, box_size,
                                num_particles=options.num_particles,
                                sink=_sink,
                            )
                        )
                        for nm, _sets in part:
                            journal.record(
                                nm,
                                outcomes.status.get(nm, "ok"),
                                wall_s=round(
                                    secs / max(len(part), 1), 6
                                ),
                                solver=options.solver,
                                particles=counts.get(nm),
                                out=nm + ".box",
                            )
                        job.progress["chunks_done"] = i + 1
                        job.progress["micrographs_done"] = (
                            len(already) + len(counts)
                        )
                        telemetry.flush_run(rt)
                    crash_point(f"run:{job.id}:chunk:{i}")
                    if self.fleet is not None:
                        fleet_mod.crash_point(
                            replica, f"chunk:{job.id}:{i}"
                        )
                    t_mark = time.time()
                    comp_mark = tlm_probes.compile_seconds()
                    hits_mark = hits_now
                    miss_mark = miss_now
            t_finish0 = time.time()
            quarantined.update(outcomes.quarantined)
            job.result = {
                "micrographs": len(names),
                "resumed_micrographs": len(already),
                "particles": int(sum(counts.values())),
                "quarantined": len(quarantined),
                "out_dir": out_dir,
                "journal": journal.summary(),
            }
            journal.close()
            crash_point(f"finish:{job.id}")
            tlm_trace.add_segment(
                "finish", t_finish0, time.time() - t_finish0
            )
            wall = self._clock() - t0
            _JOB_SECONDS.observe(
                wall,
                bucket=str(job.progress.get("capacity", "none")),
            )
            self._finish_job(
                job, JOB_FINISHED,
                wall_s=round(wall, 3),
                particles=job.result["particles"],
                quarantined=job.result["quarantined"],
            )
            self.queue.breaker.record_success(job.tenant)
            return bucket
        except engine.ConsensusCancelled:
            # cooperative stop at a chunk boundary: every completed
            # chunk's artifacts + journal records are already on
            # disk, so a later re-submission (or drain restart)
            # resumes instead of redoing
            reason = job.cancel_reason or "cancelled"
            job.reason = reason
            if reason.startswith("fenced"):
                # a survivor owns the job now: no terminal record and
                # no re-queue (the fence winner's commit is the job's
                # single completion)
                self.queue.abandon(job)
                return bucket
            if reason.startswith("deadline"):
                state = JOB_DEADLINE_EXCEEDED
            elif reason.startswith("draining"):
                # not terminal: back to queued, journaled for the
                # next generation to pick up where this one left off
                state = JOB_QUEUED
            else:
                state = JOB_CANCELLED
            self._finish_job(job, state, reason=reason)
            return bucket
        except Exception as e:  # noqa: BLE001 - isolation boundary
            # request isolation: a poisoned job FAILS (journaled,
            # visible to its client, counted by the breaker); the
            # daemon and every other job keep going
            job.error = self.queue.error_doc(e)
            self._finish_job(job, JOB_FAILED, error=job.error)
            self.queue.breaker.record_failure(job.tenant)
            _log.error(f"job {job.id} failed: {e}")
            return bucket
        finally:
            if run_journal is not None:
                run_journal.close()
            telemetry.finish_run(rt)
