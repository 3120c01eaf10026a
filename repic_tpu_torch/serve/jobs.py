"""Serve-side job model: journal, bounded queue, circuit breaker (the
port's own copy of ``repic_tpu.serve.jobs``).

Host-only stdlib, no torch: admission decisions stay cheap and
testable without a device.  The daemon's HTTP layer
(:mod:`repic_tpu_torch.serve.daemon`) owns the sockets and the worker
thread; this module owns the state machine

    queued -> running -> finished | failed | cancelled
                         | deadline_exceeded | quarantined

and the crash-safe request journal that carries it across process
death: append-only JSONL, flushed per record, a torn trailing line
tolerated on read -- the run journal's idioms.  The ``replica`` hooks
belong to the fleet (:mod:`repic_tpu_torch.serve.fleet`); a single
daemon runs with ``replica=None``.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from dataclasses import dataclass, field

from repic_tpu_torch import telemetry
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.journal import _read_entries, error_info
from repic_tpu_torch.serve import autoscale, tenancy
from repic_tpu_torch.telemetry import server as tlm_server
from repic_tpu_torch.telemetry import trace as tlm_trace

SERVE_JOURNAL_NAME = "_serve_journal.jsonl"

#: exit status of a ``server_crash`` fault firing — distinguishable
#: from the cluster's host_crash (23) in the chaos test harness
SERVE_CRASH_EXIT_CODE = 24
#: exit status of a ``poison_job`` fault firing: the deterministic
#: input-keyed worker crash the quarantine budget exists to contain
#: (distinct from 24/25 so the chaos harness can tell a generic
#: daemon loss from a poison-pill kill)
POISON_CRASH_EXIT_CODE = 26

JOB_QUEUED = "queued"
JOB_RUNNING = "running"
JOB_FINISHED = "finished"
JOB_FAILED = "failed"
JOB_CANCELLED = "cancelled"
JOB_DEADLINE_EXCEEDED = "deadline_exceeded"
#: terminal containment state: the job's input deterministically
#: kills its worker, and its retry budget is spent — never re-run,
#: full provenance in the journal (docs/serving.md "quarantine")
JOB_QUARANTINED = "quarantined"

TERMINAL_STATES = frozenset(
    (JOB_FINISHED, JOB_FAILED, JOB_CANCELLED, JOB_DEADLINE_EXCEEDED,
     JOB_QUARANTINED)
)

#: default per-job retry budget: a job may be (re)started at most
#: budget + 1 times across the fleet (lease steals after a replica
#: loss, and same-replica crash-recovery re-runs, both count)
DEFAULT_REASSIGN_BUDGET = 2

_REJECTED = telemetry.counter(
    "repic_serve_rejected_total",
    "serve submissions rejected at admission (by reason)",
)
_ADMITTED = telemetry.counter(
    "repic_serve_admitted_total",
    "serve submissions accepted into the bounded queue",
)
_DEPTH = telemetry.gauge(
    "repic_serve_queue_depth",
    "jobs waiting in the serve queue (excludes the running job)",
)
_JOBS = telemetry.counter(
    "repic_serve_jobs_total",
    "serve jobs reaching a terminal state (by state)",
)
_BREAKER_STATE = telemetry.gauge(
    "repic_serve_breaker_state",
    "circuit breaker state: 0 closed, 1 open, 2 half-open",
)
_BREAKER_TRIPS = telemetry.counter(
    "repic_serve_breaker_trips_total",
    "circuit breaker open transitions",
)
_BREAKER_FAILURES = telemetry.gauge(
    "repic_serve_breaker_failures",
    "consecutive job failures counted toward the breaker threshold",
)
_DEDUPED = telemetry.counter(
    "repic_serve_deduped_total",
    "submissions answered from an existing job via idempotency key",
)
# One admission-outcome surface for dashboards: every submission
# lands exactly once, labeled by outcome (accepted/rejected), the
# cause, and the HTTP code the client saw — the scrape-side join of
# the 202/429/503 contract (the per-reason _REJECTED counter above
# stays for backward compatibility).
_ADMISSION = telemetry.counter(
    "repic_serve_admission_total",
    "serve admission decisions (by outcome, cause, http code)",
)
_QUEUE_WAIT = telemetry.histogram(
    "repic_serve_queue_wait_seconds",
    "seconds an accepted job waited in the queue before running",
)
_QUARANTINED = telemetry.counter(
    "repic_serve_quarantined_jobs_total",
    "jobs quarantined over their retry budget (by decision path)",
)


def crash_point(point: str) -> None:
    """``server_crash`` fault site: kill THIS process abruptly
    (``os._exit`` — no journal close, no drain, no Python cleanup),
    the deterministic stand-in for a daemon loss.  Keys:
    ``accept:<job>``, ``run:<job>``, ``run:<job>:chunk:<i>``,
    ``finish:<job>``."""
    if faults.check("server_crash", point):
        os._exit(SERVE_CRASH_EXIT_CODE)


def quarantine_reason(attempts: int, budget: int) -> str:
    """The ONE wording of the quarantine verdict (journal records,
    job documents, logs) — three call sites, zero drift."""
    return (
        f"poison-job quarantine: {attempts} crashed attempt(s) "
        f"exceed the retry budget ({budget})"
    )


def poison_point(job_id: str, key: str = "") -> None:
    """``poison_job`` fault site: the deterministic poison pill.

    Polled by the worker right after it binds a job to its input —
    a firing kills the process (``os._exit(26)``, no lease release,
    no journal close) EVERY time any worker attempts the job, which
    is what makes the input a poison pill rather than a transient
    crash.  The call-site key is ``<job_id>:<in_dir>``, so plans key
    on the input directory (``poison_job:<dir-substring>:inf``) —
    the job id is minted server-side and unknown to the plan."""
    if faults.check("poison_job", f"{job_id}:{key}"):
        os._exit(POISON_CRASH_EXIT_CODE)


class AdmissionError(Exception):
    """A submission the daemon refuses to take, mapped to HTTP.

    ``http_status`` 429 (queue full) or 503 (circuit open /
    draining); ``retry_after_s`` becomes the ``Retry-After`` header
    so well-behaved clients back off instead of hammering."""

    def __init__(self, http_status: int, reason: str,
                 retry_after_s: float):
        super().__init__(reason)
        self.http_status = int(http_status)
        self.reason = reason
        self.retry_after_s = max(1, int(round(retry_after_s)))


@dataclass
class Job:
    """One accepted consensus request and its live state."""

    id: str
    request: dict                  # validated submission payload
    accepted_ts: float
    state: str = JOB_QUEUED
    tenant: str | None = None      # authenticated owner (tenancy.py)
    trace_id: str | None = None    # request-scoped tracing key
    idempotency_key: str | None = None  # client retry dedupe handle
    replica: str | None = None     # fleet: replica that ran/runs it
    attempts: int = 0              # journaled run starts (budget)
    deadline_ts: float | None = None
    bucket_hint: int | None = None
    micrographs: int | None = None  # admission-time size estimate
    started_ts: float | None = None
    finished_ts: float | None = None
    error: dict | None = None
    reason: str | None = None      # cancel/deadline detail
    resumed: bool = False          # re-queued across a daemon restart
    cancel_requested: bool = False
    cancel_reason: str | None = None
    skipped: int = 0               # affinity-scheduling fairness cap
    progress: dict = field(default_factory=dict)
    result: dict = field(default_factory=dict)

    def doc(self) -> dict:
        """The ``GET /v1/jobs/<id>`` document."""
        out = {
            "id": self.id,
            "state": self.state,
            "request": self.request,
            "accepted_ts": self.accepted_ts,
            "started_ts": self.started_ts,
            "finished_ts": self.finished_ts,
            "resumed": self.resumed,
        }
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.trace_id is not None:
            out["trace_id"] = self.trace_id
        if self.attempts:
            out["attempts"] = self.attempts
        if self.idempotency_key is not None:
            out["idempotency_key"] = self.idempotency_key
        if self.replica is not None:
            out["replica"] = self.replica
        if self.deadline_ts is not None:
            out["deadline_ts"] = self.deadline_ts
        if self.micrographs is not None:
            out["micrographs"] = self.micrographs
        if self.progress:
            out["progress"] = dict(self.progress)
        if self.result:
            out["result"] = dict(self.result)
        if self.error is not None:
            out["error"] = self.error
        if self.reason is not None:
            out["reason"] = self.reason
        return out


def new_job_id() -> str:
    return "job-" + uuid.uuid4().hex[:12]


class ServeJournal:
    """Append-only request journal (``_serve_journal.jsonl``).

    Single-writer by construction (the daemon is one process; the
    HTTP threads and the worker serialize on the queue lock before
    recording), flushed per record so a crash loses at most a torn
    trailing line — which :func:`recover` tolerates the same way the
    run journal does.

    Fleet mode (``replica=...``): each replica appends to its OWN
    ``_serve_journal.<replica>.jsonl`` in the shared fleet directory
    — the same single-writer-per-file / merge-on-read scheme the
    cluster run journal uses — and every record carries a
    ``replica`` field, so the merged view attributes each state
    transition to the replica that made it.
    """

    def __init__(self, work_dir: str, replica: str | None = None):
        from repic_tpu_torch.runtime.journal import sanitize_host_id

        self.work_dir = work_dir
        self.replica = (
            sanitize_host_id(replica) if replica else None
        )
        if self.replica is None:
            name = SERVE_JOURNAL_NAME
        else:
            stem, ext = os.path.splitext(SERVE_JOURNAL_NAME)
            name = f"{stem}.{self.replica}{ext}"
        self.path = os.path.join(work_dir, name)
        self._fh = None
        self._lock = threading.Lock()

    def record(self, job_id: str, state: str, **fields) -> dict:
        entry = {"job": job_id, "state": state, "ts": time.time()}
        if self.replica:
            entry["replica"] = self.replica
        entry.update(fields)
        self._append(entry)
        return entry

    def record_event(self, event: str, **fields) -> dict:
        entry = {"event": event, "ts": time.time()}
        if self.replica:
            entry["replica"] = self.replica
        entry.update(fields)
        self._append(entry)
        return entry

    def _append(self, entry: dict) -> None:
        import json

        with self._lock:
            if self._fh is None:
                os.makedirs(self.work_dir, exist_ok=True)
                self._fh = open(self.path, "at")
            self._fh.write(json.dumps(entry) + "\n")
            # flush-before-202 IS the durability promise, and
            # serializing exactly this append+flush is this lock's
            # purpose
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def recover(self) -> list[Job]:
        """Non-terminal jobs from a previous daemon generation.

        Folds the journal to the latest state per job id (acceptance
        order preserved) and rebuilds a :class:`Job` for every one
        that never reached a terminal state.  A job that was RUNNING
        when the process died comes back ``resumed=True``: its
        re-execution opens the per-job run journal with resume
        semantics, so completed micrographs are skipped, not redone.
        """
        latest: dict[str, dict] = {}
        payload: dict[str, dict] = {}
        cancel_req: set[str] = set()
        runs: dict[str, int] = {}
        order: list[str] = []
        for e in _read_entries(self.path):
            jid = e.get("job")
            if not jid:
                continue
            if jid not in latest:
                order.append(jid)
                payload[jid] = e
            if e.get("cancel_requested"):
                cancel_req.add(jid)
            if (
                "event" not in e
                and e.get("state") == JOB_RUNNING
                and not e.get("cancel_requested")
                and not e.get("rerun")
            ):
                # every journaled run START counts toward the
                # poison-job retry budget: one per generation that
                # crashed mid-job.  Cancel-flag and same-process
                # rerun records are bookkeeping, not new attempts
                # (same rule as the fleet view's `runs` fold).
                runs[jid] = runs.get(jid, 0) + 1
            latest[jid] = e
        out = []
        for jid in order:
            state = latest[jid].get("state")
            if state in TERMINAL_STATES:
                continue
            first = payload[jid]
            job = Job(
                id=jid,
                request=first.get("request", {}),
                accepted_ts=float(first.get("ts", time.time())),
                tenant=first.get("tenant"),
                # the original accept's trace id survives the crash:
                # the re-run's spans/segments join the same request
                trace_id=first.get("trace"),
                idempotency_key=first.get("idempotency_key"),
                deadline_ts=first.get("deadline_ts"),
                bucket_hint=first.get("bucket_hint"),
                micrographs=first.get("micrographs"),
                resumed=state == JOB_RUNNING,
                attempts=runs.get(jid, 0),
                # an acknowledged running-job cancel survives the
                # crash: the re-run stops at its first cancel poll
                cancel_requested=jid in cancel_req,
            )
            out.append(job)
        return out

    def compact(self, max_terminal: int = 512,
                max_events: int = 256,
                terminal_ids=None) -> dict | None:
        """Bound journal growth: fold old terminal jobs to one line.

        A long-lived daemon appends 3+ records per job forever; this
        rewrites the file (atomic tmp+replace) keeping

        * every record of every NON-terminal job verbatim — the
          journal-before-202 durability promise is untouchable;
        * every record of the newest ``max_terminal`` terminal jobs
          verbatim (the in-memory addressability window);
        * ONE folded record per older terminal job — its latest
          terminal record (state, ts, trace, reason/error/result
          tallies) plus the accept's ``idempotency_key``/``tenant``
          so fleet-wide retry dedupe and attribution survive the
          fold; the bulky ``request`` payload is dropped;
        * events referencing retained jobs, plus the newest
          ``max_events`` job-less events.

        Call only while the journal is closed (startup before
        recovery, or after a clean drain): the single-writer promise
        must hold across the replace.  Returns a stats dict, or
        ``None`` when there was nothing to fold (the file is left
        byte-identical — no rewrite per restart).  Torn trailing
        lines are dropped exactly as :func:`recover` drops them.

        ``terminal_ids``: extra job ids known terminal from OUTSIDE
        this file — fleet mode passes the merged-view terminal set,
        because a job accepted here routinely finishes on a peer
        (its terminal record lives in the peer's journal) and would
        otherwise never fold out of the acceptor's file.  Folding
        such a job keeps its LAST local record (ts intact), so the
        peer's terminal record still wins the merged fold.
        """
        import json

        from repic_tpu_torch.runtime.atomic import atomic_write

        with self._lock:
            if self._fh is not None:
                raise RuntimeError(
                    "compact() requires a closed journal"
                )
        entries = _read_entries(self.path)
        if not entries:
            return None
        per_job: dict[str, list[dict]] = {}
        events: list[dict] = []
        for e in entries:
            jid = e.get("job")
            if jid and "event" not in e:
                per_job.setdefault(jid, []).append(e)
            else:
                events.append(e)
        known_terminal = frozenset(terminal_ids or ())
        terminal = [
            (float(recs[-1].get("ts", 0.0)), jid)
            for jid, recs in per_job.items()
            if recs[-1].get("state") in TERMINAL_STATES
            or jid in known_terminal
        ]
        terminal.sort()
        fold = {jid for _, jid in terminal[:-max_terminal]} if (
            len(terminal) > max_terminal
        ) else set()
        # a job already reduced to its one folded record is done —
        # without this, every restart would re-count it as work and
        # rewrite an unchanged journal forever
        fold = {
            jid
            for jid in fold
            if not (
                len(per_job[jid]) == 1
                and per_job[jid][0].get("folded")
            )
        }
        job_events = [e for e in events if e.get("job")]
        bare_events = [e for e in events if not e.get("job")]
        dropped_events = (
            sum(1 for e in job_events if e["job"] in fold)
            + max(len(bare_events) - max_events, 0)
        )
        if not fold and not dropped_events:
            return None
        out: list[dict] = []
        folded = 0
        for jid, recs in per_job.items():
            if jid not in fold:
                out.extend(recs)
                continue
            last = {
                k: v for k, v in recs[-1].items() if k != "request"
            }
            first = recs[0]
            for carry in ("idempotency_key", "tenant"):
                if carry in first and carry not in last:
                    last[carry] = first[carry]
            last["folded"] = True
            out.append(last)
            folded += 1
        out.extend(
            e for e in job_events if e["job"] not in fold
        )
        kept_bare = bare_events[-max_events:] if max_events else []
        out.extend(kept_bare)
        stats = {
            "folded": folded,
            "kept_jobs": len(per_job) - folded,
            "dropped_events": dropped_events,
        }
        # the marker both journals the compaction in-band and
        # guarantees the rewritten file's SIZE changes, so peers'
        # size-keyed incremental readers re-parse it
        marker = {"event": "journal_compacted", "ts": time.time()}
        if self.replica:
            marker["replica"] = self.replica
        marker.update(stats)
        out.append(marker)
        out.sort(key=lambda e: float(e.get("ts", 0.0)))
        with atomic_write(self.path) as f:
            for e in out:
                f.write(json.dumps(e) + "\n")
        return stats


class CircuitBreaker:
    """Trip admission open after repeated job FAILURES.

    Failures mean the job itself errored (bad backend, poisoned
    shared state) — deadline/cancel outcomes are the client's
    business and never count.  ``threshold`` consecutive failures
    open the breaker: submissions are refused with 503 until
    ``cooldown_s`` elapses, after which the breaker goes half-open —
    admission resumes, and the FIRST job outcome decides: success
    closes it, failure re-opens it for another cooldown.  This is
    the standard overload-protection shape (release the retry storm
    against a broken dependency only gradually).

    **Tenant scoping (blast-radius containment).**  With tenancy
    configured, failures carry the owning tenant, and each named
    tenant gets its OWN streak + open/half-open state: a tenant
    whose jobs keep failing is 503'd (``tenant_circuit_open``)
    while everyone else submits freely.  The SHARED breaker — the
    one that refuses everybody — only trips when at least TWO
    tenants each reach the threshold on their own streak (a broken
    backend fails everyone quickly; a poisoned input fails one
    tenant, and a stray failure from a second tenant must not
    convert that one tenant's streak into a fleet-wide 503).
    Failures without a tenant (no ``--tenants`` file) keep today's
    single-tenant behavior exactly: every failure feeds the shared
    breaker.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock=time.time):
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.failures = 0
        self.opened_ts: float | None = None
        #: per-tenant state machines (lazily created on failure)
        self._tenant: dict[str, dict] = {}
        _BREAKER_STATE.set(0)
        _BREAKER_FAILURES.set(0)

    def _set_state(self, state: str) -> None:
        self.state = state
        _BREAKER_STATE.set(
            {self.CLOSED: 0, self.OPEN: 1, self.HALF_OPEN: 2}[state]
        )

    def _tenant_slot(self, tenant: str) -> dict:
        slot = self._tenant.get(tenant)
        if slot is None:
            slot = self._tenant[tenant] = {
                "state": self.CLOSED,
                "failures": 0,
                "opened_ts": 0.0,
            }
        return slot

    def check_admission(self, tenant: str | None = None) -> None:
        """Raise :class:`AdmissionError` (503) while open — the
        shared breaker first, then the submitting tenant's own."""
        with self._lock:
            if self.state == self.OPEN:
                elapsed = self._clock() - (self.opened_ts or 0.0)
                if elapsed < self.cooldown_s:
                    raise AdmissionError(
                        503,
                        "circuit_open",
                        self.cooldown_s - elapsed,
                    )
                self._set_state(self.HALF_OPEN)
            if tenant is None:
                return
            slot = self._tenant.get(tenant)
            if slot is None or slot["state"] != self.OPEN:
                return
            elapsed = self._clock() - slot["opened_ts"]
            if elapsed >= self.cooldown_s:
                slot["state"] = self.HALF_OPEN
                return
            raise AdmissionError(
                503,
                "tenant_circuit_open",
                self.cooldown_s - elapsed,
            )

    def record_success(self, tenant: str | None = None) -> None:
        with self._lock:
            self.failures = 0
            _BREAKER_FAILURES.set(0)
            self._set_state(self.CLOSED)
            if tenant is not None:
                self._tenant.pop(tenant, None)

    def record_failure(self, tenant: str | None = None) -> None:
        with self._lock:
            self.failures += 1
            _BREAKER_FAILURES.set(self.failures)
            if tenant is not None:
                slot = self._tenant_slot(tenant)
                slot["failures"] += 1
                if (
                    slot["state"] == self.HALF_OPEN
                    or slot["failures"] >= self.threshold
                ):
                    if slot["state"] != self.OPEN:
                        _BREAKER_TRIPS.inc()
                    slot["state"] = self.OPEN
                    slot["opened_ts"] = self._clock()
            if tenant is None:
                # legacy single-tenant mode: every failure feeds the
                # shared streak directly
                shared_eligible = self.failures >= self.threshold
            else:
                # the shared breaker needs TWO tenants each at the
                # threshold on their own — one stray failure from
                # tenant B must not convert tenant A's poison
                # streak into a fleet-wide 503 (A's 20 failures +
                # B's 1 is A's problem, not the backend's)
                at_threshold = sum(
                    1
                    for s in self._tenant.values()
                    if s["failures"] >= self.threshold
                )
                shared_eligible = at_threshold >= 2
            if self.state == self.HALF_OPEN or shared_eligible:
                if self.state != self.OPEN:
                    _BREAKER_TRIPS.inc()
                self._set_state(self.OPEN)
                self.opened_ts = self._clock()

    def describe(self) -> dict:
        """The /status view: state, consecutive failures, and — while
        open — how long until the half-open probe window.  The same
        numbers ride on /metrics (`repic_serve_breaker_state`,
        `repic_serve_breaker_failures`), so a tripped breaker is
        visible on both surfaces instead of silently eating jobs.
        With tenancy configured, a ``tenants`` sub-section carries
        every tenant with a live streak or an open breaker."""
        with self._lock:
            out = {
                "state": self.state,
                "consecutive_failures": self.failures,
                "threshold": self.threshold,
            }
            if self.state == self.OPEN:
                elapsed = self._clock() - (self.opened_ts or 0.0)
                out["cooldown_remaining_s"] = round(
                    max(self.cooldown_s - elapsed, 0.0), 3
                )
            tenants = {}
            for name, slot in sorted(self._tenant.items()):
                entry = {
                    "state": slot["state"],
                    "consecutive_failures": slot["failures"],
                }
                if slot["state"] == self.OPEN:
                    elapsed = self._clock() - slot["opened_ts"]
                    entry["cooldown_remaining_s"] = round(
                        max(self.cooldown_s - elapsed, 0.0), 3
                    )
                tenants[name] = entry
            if tenants:
                out["tenants"] = tenants
            return out


class JobQueue:
    """Bounded FIFO of accepted jobs with warm-bucket affinity.

    Admission control happens HERE, under one lock, in one place:
    draining -> 503, breaker open -> 503, queue full (or the
    ``request_storm`` fault) -> 429 + ``Retry-After``.  Accepted
    jobs are journaled BEFORE the caller returns 202 — the 202 is a
    durability promise.

    Scheduling is FIFO with a bounded warm-affinity twist: when the
    worker's last request warmed a padded capacity bucket, a queued
    job declaring the same ``bucket_hint`` may jump at most
    ``affinity_window`` positions, and a job skipped
    ``max_skips`` times must run next — warm-program reuse without
    cold-bucket starvation.
    """

    AFFINITY_WINDOW = 4
    MAX_SKIPS = 2
    #: terminal jobs kept addressable in memory (GET /v1/jobs/<id>).
    #: Older history is still durable — the journal has every state
    #: transition and jobs/<id>/ keeps the artifacts — so eviction
    #: only bounds what a long-lived daemon holds live: without it
    #: _jobs grows one dead Job (request payload, result, progress)
    #: per request, forever.
    MAX_TERMINAL = 512

    def __init__(
        self,
        limit: int,
        journal: ServeJournal,
        breaker: CircuitBreaker | None = None,
        *,
        tenants: "tenancy.TenantRegistry | None" = None,
        clock=time.time,
    ):
        if limit < 1:
            raise ValueError("queue limit must be >= 1")
        self.limit = limit
        self.journal = journal
        self.breaker = breaker or CircuitBreaker()
        self.tenants = tenants
        self._clock = clock
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._jobs: dict[str, Job] = {}
        self._pending: list[str] = []
        self._terminal: list[str] = []  # completion order (eviction)
        # (tenant, idempotency key) -> job id: keys are scoped PER
        # TENANT so one tenant's retry can never collide into (and
        # leak) another tenant's job
        self._idemp: dict[tuple, str] = {}
        # the continuous batcher holds several jobs open at once, so
        # "running" is a set, not a slot (the single-job scheduler is
        # simply the |set| <= 1 case)
        self._running: set[str] = set()
        self.draining = False
        # decayed PER-MICROGRAPH service time, the Retry-After
        # estimate's unit: whole-job averages over-estimate under
        # batching, where many small jobs clear in one coalesced
        # chunk (docs/serving.md "Overload")
        self._avg_mic_s = 2.0
        # brownout posture published by the fleet supervisor into
        # the queue's root directory (mtime-cached stat per submit;
        # no file -> level 0, today's behavior bit for bit)
        self._brownout = autoscale.BrownoutReader(journal.work_dir)

    # -- admission ----------------------------------------------------

    def submit(
        self,
        request: dict,
        *,
        deadline_s: float | None = None,
        bucket_hint: int | None = None,
        idempotency_key: str | None = None,
        micrographs: int | None = None,
        tenant: str | None = None,
    ) -> Job:
        """Admit one request or raise :class:`AdmissionError`."""
        return self.submit_idempotent(
            request,
            deadline_s=deadline_s,
            bucket_hint=bucket_hint,
            idempotency_key=idempotency_key,
            micrographs=micrographs,
            tenant=tenant,
        )[0]

    def _lookup_idempotent(self, tenant, key) -> Job | None:
        if not key:
            return None
        with self._lock:
            jid = self._idemp.get((tenant, key))
            return self._jobs.get(jid) if jid else None

    def submit_idempotent(
        self,
        request: dict,
        *,
        deadline_s: float | None = None,
        bucket_hint: int | None = None,
        idempotency_key: str | None = None,
        micrographs: int | None = None,
        tenant: str | None = None,
    ) -> tuple[Job, bool]:
        """:meth:`submit`, returning ``(job, deduped)``.

        A submission carrying an ``idempotency_key`` already bound to
        a known job returns THAT job with ``deduped=True`` — nothing
        journaled, no admission checks: a client retry of an accepted
        request (lost 202, timeout, fleet failover to another
        replica) must never create a second job, never be 429'd, and
        must work even mid-drain.

        ``micrographs`` may be a zero-arg callable (the daemon's
        directory-listing estimator): it is resolved only after the
        draining/breaker rejections, so a load-shedding daemon does
        not pay disk I/O per refused request.  (A queue-full 429
        still pays it — the backlog check needs the lock, and
        listing must not run under it.)
        """
        existing = self._lookup_idempotent(tenant, idempotency_key)
        if existing is not None:
            _DEDUPED.inc()
            return existing, True
        if self.draining:
            _REJECTED.inc(reason="draining")
            _ADMISSION.inc(
                outcome="rejected", cause="draining", code="503"
            )
            raise AdmissionError(503, "draining", 30.0)
        try:
            self.breaker.check_admission(tenant)
        except AdmissionError as e:
            _REJECTED.inc(reason=e.reason)
            _ADMISSION.inc(
                outcome="rejected", cause=e.reason, code="503"
            )
            raise
        if callable(micrographs):
            micrographs = micrographs()
        with self._lock:
            # re-check under the creation lock: two concurrent
            # retries with one key must still yield one job
            if idempotency_key:
                jid = self._idemp.get((tenant, idempotency_key))
                job = self._jobs.get(jid) if jid else None
                if job is not None:
                    _DEDUPED.inc()
                    return job, True
            # brownout shedding FIRST (ahead of the depth check):
            # staged degradation must refuse low-priority work
            # before the queue is full, not after — that is the
            # whole point of bending instead of cliffing
            state = self._brownout.state()
            level = self._brownout.level()
            shed = autoscale.shed_priorities(level)
            if shed and self._priority_of(tenant) in shed:
                self._reject_brownout(tenant, state, shed)
            backlog = len(self._pending) + len(self._running)
            stormed = faults.check("request_storm", "submit")
            limit = autoscale.effective_queue_limit(
                self.limit, level
            )
            if backlog >= limit or stormed:
                _REJECTED.inc(reason="queue_full")
                _ADMISSION.inc(
                    outcome="rejected", cause="queue_full",
                    code="429",
                )
                raise AdmissionError(
                    429,
                    "queue_full",
                    self._retry_after_s(max(backlog, 1)),
                )
            # tenant limits live in the SAME critical section as the
            # queue-full 429 (the admission decision must be atomic
            # with the insert), with their own cause labels so a
            # dashboard can tell fleet overload from tenant overage
            if self.tenants is not None and tenant is not None:
                open_jobs, queued_mics = (
                    self._tenant_tallies_locked(tenant)
                )
                refused = self.tenants.check_admission(
                    tenant,
                    micrographs=micrographs or 1,
                    open_jobs=open_jobs,
                    queued_micrographs=queued_mics,
                    per_mic_s=self._avg_mic_s,
                )
                if refused is not None:
                    cause, retry_after = refused
                    # a job intrinsically over the quota can NEVER
                    # be admitted: permanent 413, not a 429 a
                    # polite client would replay forever
                    code = (
                        413 if cause == "tenant_job_too_large"
                        else 429
                    )
                    _REJECTED.inc(reason=cause)
                    _ADMISSION.inc(
                        outcome="rejected", cause=cause,
                        code=str(code),
                    )
                    raise AdmissionError(code, cause, retry_after)
            now = self._clock()
            job = Job(
                id=new_job_id(),
                request=request,
                accepted_ts=now,
                tenant=tenant,
                # the trace id is minted AT ACCEPT: queue residency,
                # execution, and emit all join back to this moment
                trace_id=tlm_trace.new_trace_id(),
                idempotency_key=idempotency_key,
                deadline_ts=(
                    now + deadline_s
                    if deadline_s is not None
                    else None
                ),
                bucket_hint=bucket_hint,
                micrographs=micrographs,
            )
            # journal BEFORE the queue insert becomes visible: once
            # the caller sees 202 the job survives any crash
            extra = (
                {"idempotency_key": idempotency_key}
                if idempotency_key
                else {}
            )
            if micrographs is not None:
                extra["micrographs"] = micrographs
            if tenant is not None:
                extra["tenant"] = tenant
            self.journal.record(
                job.id,
                JOB_QUEUED,
                request=request,
                deadline_ts=job.deadline_ts,
                bucket_hint=bucket_hint,
                trace=job.trace_id,
                **extra,
            )
            self._jobs[job.id] = job
            self._pending.append(job.id)
            if idempotency_key:
                self._idemp[(tenant, idempotency_key)] = job.id
            _DEPTH.set(len(self._pending))
        _ADMITTED.inc()
        _ADMISSION.inc(
            outcome="accepted", cause="accepted", code="202"
        )
        if tenant is not None:
            tenancy.note_admitted(tenant)
        crash_point(f"accept:{job.id}")
        self._wake.set()
        return job, False

    def _priority_of(self, tenant: str | None) -> str:
        """The submitting tenant's brownout class — ``normal`` with
        tenancy off, so shedding still stages for an open daemon."""
        if self.tenants is None:
            return tenancy.DEFAULT_PRIORITY
        return self.tenants.priority(tenant)

    def _unshed_micrographs_locked(self, shed: tuple) -> int:
        """Queued micrographs belonging to classes still admitted —
        the backlog that drains AHEAD of a shed tenant (the honest
        half of its Retry-After).  Lock held."""
        total = 0
        for jid in self._pending:
            j = self._jobs.get(jid)
            if j is None:
                continue
            if self._priority_of(j.tenant) not in shed:
                total += j.micrographs or 1
        return total

    def _reject_brownout(
        self,
        tenant: str | None,
        state: dict | None,
        shed: tuple,
        live: int = 1,
    ):
        """Raise the brownout 429, priced from the shed class's
        expected un-shed horizon (supervisor interval + remaining
        cooldown + admitted-classes drain), NOT the global
        per-micrograph estimate — which under-advises in a storm
        (docs/serving.md "Autoscaling & brownout").  Lock held."""
        retry_after = autoscale.shed_horizon_s(
            state,
            self._unshed_micrographs_locked(shed),
            self._avg_mic_s,
            live=live,
        )
        _REJECTED.inc(reason="brownout")
        _ADMISSION.inc(
            outcome="rejected", cause="brownout", code="429"
        )
        if tenant is not None:
            tenancy.note_rejected(tenant, "brownout")
        raise AdmissionError(429, "brownout", retry_after)

    def _tenant_tallies_locked(self, tenant: str) -> tuple[int, int]:
        """(open jobs, queued micrographs) for one tenant — call
        with the queue lock held (quota inputs must be consistent
        with the insert that follows)."""
        open_jobs = 0
        queued_mics = 0
        for jid in self._pending:
            j = self._jobs.get(jid)
            if j is not None and j.tenant == tenant:
                open_jobs += 1
                queued_mics += j.micrographs or 1
        for jid in self._running:
            j = self._jobs.get(jid)
            if j is not None and j.tenant == tenant:
                open_jobs += 1
        return open_jobs, queued_mics

    def tenant_tallies(self) -> dict[str, dict]:
        """Per-tenant open-job / queued-micrograph tallies (the
        /status ``tenants`` section and the repic_tenant_* gauges)."""
        out: dict[str, dict] = {}
        with self._lock:
            live = [
                (self._jobs.get(jid), True)
                for jid in self._pending
            ] + [
                (self._jobs.get(jid), False)
                for jid in self._running
            ]
        for job, queued in live:
            if job is None or job.tenant is None:
                continue
            slot = out.setdefault(
                job.tenant,
                {"open_jobs": 0, "queued_micrographs": 0},
            )
            slot["open_jobs"] += 1
            if queued:
                slot["queued_micrographs"] += job.micrographs or 1
        return out

    def _queued_micrographs(self) -> int:
        """Backlog size in MICROGRAPHS (call with the lock held):
        each queued job contributes its admission-time estimate,
        defaulting to 1 when the daemon could not count its inputs."""
        return sum(
            (self._jobs[jid].micrographs or 1)
            for jid in self._pending
            if jid in self._jobs
        )

    def _retry_after_s(self, backlog: int) -> float:
        """429 backoff estimate: decayed per-MICROGRAPH service time
        x queued micrographs (single-replica daemon: one consumer).
        The old whole-job average over-estimated under continuous
        batching — many small jobs clear together in one coalesced
        chunk, so a queued job is NOT a unit of service time; its
        micrographs are.  FleetQueue computes its own fleet-wide
        variant inline (same pricing, depth summed over the merged
        view and divided by LIVE replicas)."""
        mics = max(self._queued_micrographs(), backlog, 1)
        return self._avg_mic_s * mics

    def adopt(self, job: Job, runnable: bool = True) -> None:
        """Re-queue a recovered job (daemon restart) — no admission
        checks and no re-journaling of the accept: the previous
        generation already made the durability promise.
        ``runnable=False`` registers the job as addressable (GET,
        idempotent retry) without scheduling it — the quarantine
        path, which marks it terminal immediately after."""
        with self._lock:
            self._jobs[job.id] = job
            if runnable:
                self._pending.append(job.id)
            if job.idempotency_key:
                self._idemp[(job.tenant, job.idempotency_key)] = (
                    job.id
                )
            _DEPTH.set(len(self._pending))
        if runnable:
            self._wake.set()

    # -- worker side --------------------------------------------------

    def next_job(
        self, timeout: float, last_bucket=None
    ) -> Job | None:
        """Pop the next job (warm-affinity FIFO); None on timeout or
        while draining (queued jobs stay journaled for restart)."""
        if self.draining:
            return None
        # only block when the queue LOOKS empty: the wake event is
        # edge-triggered (cleared per pop), so waiting on it with
        # jobs already pending burned the full poll timeout between
        # every two jobs of a burst — ~0.2 s of pure idle per job
        with self._lock:
            empty = not self._pending
        if empty:
            self._wake.wait(timeout)
        with self._lock:
            self._wake.clear()
            if self.draining or not self._pending:
                return None
            pick = 0
            head = self._jobs[self._pending[0]]
            if (
                last_bucket is not None
                and head.bucket_hint != last_bucket
                and head.skipped < self.MAX_SKIPS
            ):
                window = self._pending[: self.AFFINITY_WINDOW]
                for i, jid in enumerate(window):
                    if self._jobs[jid].bucket_hint == last_bucket:
                        pick = i
                        break
            if pick:
                head.skipped += 1
            jid = self._pending.pop(pick)
            self._running.add(jid)
            _DEPTH.set(len(self._pending))
            return self._jobs[jid]

    def finish(self, job: Job, state: str, **fields) -> None:
        """Record a terminal (or re-queued) state for the job the
        worker just ran and update the Retry-After estimate."""
        with self._lock:
            self._running.discard(job.id)
            job.state = state
            job.finished_ts = self._clock()
            if state in TERMINAL_STATES:
                if job.started_ts and state == JOB_FINISHED:
                    dur = max(
                        job.finished_ts - job.started_ts, 0.0
                    )
                    # per-micrograph decayed service time; under
                    # coalescing a job's wall includes peers' shares,
                    # so this stays an upper-bound estimate (safe
                    # direction for a backoff hint)
                    mics = max(
                        job.progress.get("micrographs_total")
                        or job.micrographs
                        or 1,
                        1,
                    )
                    self._avg_mic_s = (
                        0.7 * self._avg_mic_s + 0.3 * dur / mics
                    )
                self._note_terminal(job.id)
        self.journal.record(
            job.id, state, trace=job.trace_id, **fields
        )
        if state in TERMINAL_STATES:
            _JOBS.inc(state=state)
            if job.tenant is not None:
                tenancy.note_job(job.tenant, state)

    def _note_terminal(self, job_id: str) -> None:
        """Bound in-memory job history (call with the lock held)."""
        self._terminal.append(job_id)
        while len(self._terminal) > self.MAX_TERMINAL:
            evicted = self._jobs.pop(self._terminal.pop(0), None)
            if evicted is not None and evicted.idempotency_key:
                # a dangling index entry would alias a NEW submission
                # onto the evicted id; dedupe history is bounded by
                # the same cap as the job map
                self._idemp.pop(
                    (evicted.tenant, evicted.idempotency_key), None
                )

    def mark_failed(self, job: Job) -> None:
        """Last-resort state flip when :meth:`finish` itself failed
        (the journal may be down): the client-visible state must
        still change, under the same lock every other writer
        holds."""
        with self._lock:
            self._running.discard(job.id)
            job.state = JOB_FAILED

    def mark_running(self, job: Job) -> None:
        # job.state is lock-guarded shared state (finish/cancel and
        # the HTTP doc() readers): mutate under the lock,
        # journal outside it (the record is its own flush)
        with self._lock:
            # a SAME-PROCESS re-run (the batcher's fallback demotes
            # a job to the single-job path) keeps the original
            # started_ts and must not observe queue wait twice —
            # the failed batch's execution time is not queue wait
            rerun = job.started_ts is not None
            job.state = JOB_RUNNING
            if not rerun:
                job.started_ts = self._clock()
        if not rerun:
            _QUEUE_WAIT.observe(
                max(job.started_ts - job.accepted_ts, 0.0)
            )
        # the rerun flag ALSO rides the journal: a same-process
        # demotion is not a crashed generation, so the retry-budget
        # run counts (recover / fleet_view) must not bill it
        self.journal.record(
            job.id, JOB_RUNNING, resumed=job.resumed,
            trace=job.trace_id,
            **({"rerun": True} if rerun else {}),
        )

    # -- client side --------------------------------------------------

    def get(self, job_id: str) -> Job | None:
        with self._lock:
            return self._jobs.get(job_id)

    def jobs(self) -> list[Job]:
        with self._lock:
            return list(self._jobs.values())

    def cancel(self, job_id: str) -> Job | None:
        """Client cancellation: a queued job is cancelled outright;
        a running one gets the cooperative flag (next chunk
        boundary).  Terminal jobs are left untouched."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.state in TERMINAL_STATES:
                return job
            # membership check, not just state: between next_job's
            # pop and mark_running's state write the job reads as
            # QUEUED but is no longer in the queue — cancelling it
            # outright would ValueError on the remove and lose the
            # worker's copy; treat it as running (cooperative flag).
            # The branch is decided by THIS local, never by a
            # post-lock re-read of job.state: a concurrent finish()
            # could flip the state between the release and the
            # journal write, double-recording the cancel or
            # resurrecting a finished job on recover.
            outright = (
                job.state == JOB_QUEUED and job_id in self._pending
            )
            if outright:
                self._pending.remove(job_id)
                _DEPTH.set(len(self._pending))
                job.state = JOB_CANCELLED
                job.reason = "cancelled while queued"
                job.finished_ts = self._clock()
                self._note_terminal(job_id)
            else:
                job.cancel_requested = True
                # the acknowledged cancel of a RUNNING job must
                # survive a crash exactly like the submission's 202
                # did — a restarted daemon re-running the job to
                # completion would silently un-cancel it.  Recorded
                # UNDER the queue lock: finish() marks the job
                # terminal under this same lock before journaling,
                # so its terminal record always lands AFTER this
                # running-state record — journaled the other way
                # around, recover() would fold the finished job back
                # to running and resurrect it.
                self.journal.record(
                    job_id, JOB_RUNNING, cancel_requested=True,
                    trace=job.trace_id,
                )
        if outright:
            # terminal under the lock above, so no concurrent
            # finish()/cancel() can interleave; the record itself is
            # its own flush and needs no lock
            self.journal.record(
                job_id, JOB_CANCELLED,
                reason="cancelled while queued",
                trace=job.trace_id,
            )
            _JOBS.inc(state=JOB_CANCELLED)
            # a queued cancel is terminal WITHOUT passing through the
            # daemon's _finish_job, so the SLO plane must hear about
            # it here — docs/serving.md: cancelled jobs count as
            # violations (the client did not get a timely success)
            latency = max(job.finished_ts - job.accepted_ts, 0.0)
            tlm_server.observe_slo("job", latency, ok=False)
            if job.tenant is not None:
                tlm_server.observe_slo(
                    f"tenant:{job.tenant}", latency, ok=False
                )
                tenancy.note_job(job.tenant, JOB_CANCELLED)
        return job

    def begin_drain(self) -> int:
        """Stop admission; return the number of queued jobs left
        journaled for the next generation."""
        self.draining = True
        self._wake.set()
        with self._lock:
            return len(self._pending)

    def error_doc(self, exc: BaseException) -> dict:
        return error_info(exc)
