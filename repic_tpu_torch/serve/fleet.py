"""The serving fleet: N ``serve`` replicas over one durable queue (the
port of ``repic_tpu.serve.fleet``, same files and formats).

N replicas started with ``python -m repic_tpu_torch serve WORK_DIR
--fleet-dir FLEET`` share one job queue in ``FLEET``.  The engine is
untouched; this is the coordination layer, built from the cluster
runtime's files (heartbeats, ``O_CREAT|O_EXCL`` fences, single-writer
journals merged on read) rather than a service:

* **membership** -- each replica is a host of a
  :class:`~repic_tpu_torch.runtime.cluster.ClusterContext` whose
  coordination directory is the fleet directory: heartbeats, the
  clearing of its own stale fence on restart, and the liveness ladder
  (live / stopped / suspect / fenced).
* **durable queue** -- a submission is journaled ``queued`` in the
  accepting replica's ``_serve_journal.<replica>.jsonl`` before the
  client sees 202.  Every replica folds the merged journals into one
  fleet-wide job view, so any replica answers GET/DELETE for any job
  and a queued job survives the replica that accepted it.
* **per-job leases** -- a replica claims a queued job by creating
  ``_joblease.<job>.json`` (``O_CREAT|O_EXCL``): of N racing replicas
  one runs it.  A lease names its holder and an epoch.
* **fencing and lease steal** -- when a replica stops heartbeating
  past the timeout (or stopped uncleanly with leases outstanding), a
  survivor fences it and rewrites its job leases onto itself with a
  bumped epoch, journaling ``job_reassigned``.  The re-run opens the
  job's run journal in cluster shape (``_journal.<replica>.jsonl``
  inside ``jobs/<id>/``), so finished micrographs are skipped.
* **exactly-once completion** -- a job's terminal state commits
  through ``_done.<job>.json`` by
  :func:`repic_tpu_torch.runtime.atomic.commit_once` (write, then link
  once), behind a fence check.  A fenced straggler stops at its next
  chunk boundary; one racing past the check loses the link and adopts
  the winner's outcome, so the merged journal keeps one terminal
  record per job.
* **idempotent submit** -- a retry with the same ``idempotency_key``
  (to any replica) maps to the job already accepted: the key rides on
  the queued record, so the merged view dedupes fleet-wide.

Importing this module imports only the stdlib, as
:mod:`repic_tpu_torch.serve.jobs` does.
"""

from __future__ import annotations

import json
import os
import threading
import time

from repic_tpu_torch import telemetry
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.atomic import atomic_write, commit_once
from repic_tpu_torch.runtime.cluster import (
    ClusterConfig,
    ClusterContext,
    fence_path,
    try_claim as fence_claim,
)
from repic_tpu_torch.runtime.journal import (
    MergedJournalReader,
    sanitize_host_id,
)
from repic_tpu_torch.runtime.ladder import HOST_LIVE
from repic_tpu_torch.serve import autoscale, tenancy
from repic_tpu_torch.serve.jobs import (
    DEFAULT_REASSIGN_BUDGET,
    JOB_CANCELLED,
    JOB_FAILED,
    JOB_FINISHED,
    JOB_QUARANTINED,
    JOB_QUEUED,
    JOB_RUNNING,
    SERVE_JOURNAL_NAME,
    TERMINAL_STATES,
    AdmissionError,
    CircuitBreaker,
    Job,
    ServeJournal,
    crash_point as serve_crash_point,
    new_job_id,
)
from repic_tpu_torch.telemetry import trace as tlm_trace

JOB_LEASE_PREFIX = "_joblease."
DONE_PREFIX = "_done."

#: exit status of a ``replica_crash`` fault firing — distinguishable
#: from the cluster's host_crash (23) and the single daemon's
#: server_crash (24) in the chaos test harness
FLEET_CRASH_EXIT_CODE = 25

REPLICA_ENV = "REPIC_TPU_REPLICA_ID"

_REASSIGNED = telemetry.counter(
    "repic_fleet_reassigned_total",
    "job leases stolen from dead replicas by this replica",
)
_FENCES = telemetry.counter(
    "repic_fleet_fences_total",
    "dead replicas fenced by this replica",
)
_LIVE = telemetry.gauge(
    "repic_fleet_replicas_live",
    "replicas with a fresh heartbeat in the fleet directory",
)
_FLEET_DEPTH = telemetry.gauge(
    "repic_fleet_queue_depth",
    "fleet-wide queued (unleased) jobs in the shared queue",
)
_FLEET_QUARANTINED = telemetry.counter(
    "repic_fleet_quarantined_total",
    "jobs this replica quarantined over their retry budget",
)


def resolve_replica_id(environ=None) -> str:
    """This process's replica identity: ``REPIC_TPU_REPLICA_ID`` (the
    launcher's contract and what the chaos harness sets), else a
    hostname+pid default — pids alone collide across machines
    sharing one fleet dir over NFS, and two replicas under one id
    would interleave a single-writer journal and renew each other's
    heartbeat."""
    import socket

    env = os.environ if environ is None else environ
    rid = env.get(REPLICA_ENV)
    if rid:
        return sanitize_host_id(rid)
    return sanitize_host_id(
        f"{socket.gethostname()}-{os.getpid()}"
    )


def crash_point(replica: str, point: str) -> None:
    """``replica_crash`` fault site: kill THIS replica abruptly
    (``os._exit`` — no lease release, no heartbeat stop, no journal
    close), the deterministic stand-in for losing one fleet member
    mid-job.  Keys: ``<replica>:lease:<job>``, ``<replica>:run:
    <job>``, ``<replica>:chunk:<job>:<i>``, ``<replica>:emit:<job>``.
    """
    if faults.check("replica_crash", f"{replica}:{point}"):
        os._exit(FLEET_CRASH_EXIT_CODE)


def job_lease_path(fleet_dir: str, job_id: str) -> str:
    return os.path.join(fleet_dir, f"{JOB_LEASE_PREFIX}{job_id}.json")


def done_path(fleet_dir: str, job_id: str) -> str:
    return os.path.join(fleet_dir, f"{DONE_PREFIX}{job_id}.json")


def _read_json(path: str) -> dict | None:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


class FleetMember:
    """One replica's handle on the shared fleet directory.

    Owns the membership half (heartbeats / fence / liveness, via a
    :class:`ClusterContext` whose coordination dir is the fleet dir)
    and the per-job lease + completion-token protocol.  The queue
    semantics live in :class:`FleetQueue`.
    """

    def __init__(
        self,
        fleet_dir: str,
        replica_id: str | None = None,
        *,
        heartbeat_interval_s: float = 2.0,
        replica_timeout_s: float = 10.0,
        reassign_budget: int = DEFAULT_REASSIGN_BUDGET,
        clock=time.time,
    ):
        if int(reassign_budget) < 0:
            raise ValueError(
                f"reassign budget must be >= 0, "
                f"got {reassign_budget}"
            )
        #: per-job retry budget: a job whose journaled run attempts
        #: already reach budget + 1 is QUARANTINED at the next
        #: lease-steal (or restart-recovery) instead of re-run —
        #: the poison-pill blast-radius bound
        self.reassign_budget = int(reassign_budget)
        self.fleet_dir = os.path.abspath(fleet_dir)
        self.replica = sanitize_host_id(
            replica_id or resolve_replica_id()
        )
        self._clock = clock
        os.makedirs(self.fleet_dir, exist_ok=True)
        # rank/num_hosts are irrelevant here (the fleet leases whole
        # JOBS, never rank-partitioned shards); the context is reused
        # purely for heartbeat renewals, stale-fence clearing, and
        # the liveness ladder
        self.ctx = ClusterContext(
            ClusterConfig(
                coordination_dir=self.fleet_dir,
                host_id=self.replica,
                rank=0,
                num_hosts=1,
                heartbeat_interval_s=heartbeat_interval_s,
                host_timeout_s=replica_timeout_s,
            ),
            out_dir=self.fleet_dir,
            clock=clock,
        )
        self.timeout_s = replica_timeout_s
        #: job id -> replica it was stolen from (this process's view)
        self.reassigned: dict[str, str] = {}

    # -- membership ---------------------------------------------------

    def start(self) -> "FleetMember":
        self.ctx.start()
        return self

    def stop(self, clean: bool = True) -> None:
        self.ctx.stop(clean=clean)

    def is_fenced(self) -> bool:
        return os.path.exists(
            fence_path(self.fleet_dir, self.replica)
        )

    def liveness(self) -> dict:
        """Replica -> HostState over the fleet directory (the cluster
        ladder: live / stopped / suspect / fenced)."""
        view = self.ctx.liveness()
        _LIVE.set(
            sum(1 for s in view.values() if s.rung == HOST_LIVE)
        )
        return view

    def live_replicas(self, view=None) -> int:
        view = self.liveness() if view is None else view
        return max(
            sum(1 for s in view.values() if s.rung == HOST_LIVE), 1
        )

    # -- leases -------------------------------------------------------

    def lease_job(self, job_id: str) -> bool:
        """Claim a queued job (``O_CREAT|O_EXCL``): exactly one of N
        racing replicas wins."""
        crash_point(self.replica, f"lease:{job_id}")
        try:
            return commit_once(
                job_lease_path(self.fleet_dir, job_id),
                json.dumps(
                    {
                        "job": job_id,
                        "replica": self.replica,
                        "epoch": 1,
                        "ts": self._clock(),
                    }
                ),
            )
        except OSError:
            return False  # fleet dir vanished mid-claim

    def lease_info(self, job_id: str) -> dict | None:
        return _read_json(job_lease_path(self.fleet_dir, job_id))

    def release_lease(self, job_id: str) -> None:
        """Drop this replica's lease (terminal commit done, or the
        job was journaled back to queued at drain) — never another
        replica's."""
        info = self.lease_info(job_id)
        if info is not None and info.get("replica") == self.replica:
            import contextlib

            with contextlib.suppress(OSError):
                os.unlink(job_lease_path(self.fleet_dir, job_id))

    def steal_lease(
        self, job_id: str, from_replica: str, journal=None
    ) -> None:
        """Rewrite a fenced dead replica's job lease onto this one
        (bumped epoch).  Only call after :meth:`_fence_replica` won —
        the fence is what makes the single rewrite safe."""
        old = self.lease_info(job_id) or {}
        with atomic_write(
            job_lease_path(self.fleet_dir, job_id)
        ) as f:
            json.dump(
                {
                    "job": job_id,
                    "replica": self.replica,
                    "epoch": int(old.get("epoch", 0)) + 1,
                    "stolen_from": from_replica,
                    "ts": self._clock(),
                },
                f,
            )
        self.reassigned[job_id] = from_replica
        _REASSIGNED.inc()
        if journal is not None:
            journal.record_event(
                "job_reassigned",
                job=job_id,
                from_replica=from_replica,
                to_replica=self.replica,
            )

    def _fence_replica(self, replica: str, st, journal=None) -> bool:
        """Fence a dead/suspect replica before touching its leases.

        Returns True when THIS replica owns the takeover (it holds
        the fence, now or from an earlier harvest round).  The
        ``lease_steal`` fault site makes the claim report a lost
        race — the deterministic "another survivor got there first"
        branch.
        """
        if st is not None and st.fenced:
            return st.fenced_by == self.replica
        if faults.check(
            "lease_steal", f"{self.replica}->{replica}"
        ):
            return False
        if not fence_claim(
            fence_path(self.fleet_dir, replica),
            {
                "host": replica,
                "fenced_by": self.replica,
                "ts": self._clock(),
            },
        ):
            # lost the O_EXCL race; the winner steals
            info = _read_json(fence_path(self.fleet_dir, replica))
            return bool(
                info and info.get("fenced_by") == self.replica
            )
        _FENCES.inc()
        if journal is not None:
            journal.record_event(
                "replica_fenced", replica=replica, by=self.replica
            )
        return True

    def harvest(self, jobs_view: dict, journal=None) -> list[str]:
        """Steal leases of non-terminal jobs held by dead replicas.

        ``jobs_view`` is the folded fleet journal view
        (:meth:`FleetQueue.fleet_view`).  For every job whose lease
        names a replica that is suspect past the heartbeat timeout
        (or stopped with the lease still outstanding), the holder is
        fenced — exactly one survivor wins — and the winner rewrites
        the lease onto itself.  Returns the stolen job ids; the
        caller's next scheduling pass picks them up as its own.

        **Retry budget.**  The steal is where a poison
        pill would propagate: a job whose input deterministically
        kills its worker is fenced, stolen, and re-run by each
        survivor in turn, serially taking down the whole fleet.  So
        the budget is checked HERE: a job whose journaled run
        attempts already reach ``reassign_budget + 1`` is not stolen
        — the fence winner commits it terminal ``quarantined``
        through the exactly-once completion token instead, with full
        provenance (attempts, last holder) in the journal.
        """
        orphaned: dict[str, list[str]] = {}
        for jid, info in jobs_view.items():
            if info["state"] in TERMINAL_STATES or (
                self.read_done(jid) is not None
            ):
                continue
            lease = self.lease_info(jid)
            if lease is None:
                continue
            holder = lease.get("replica")
            if not holder or holder == self.replica:
                continue
            orphaned.setdefault(holder, []).append(jid)
        if not orphaned:
            return []
        view = self.liveness()
        stolen: list[str] = []
        for holder, jids in sorted(orphaned.items()):
            st = view.get(holder)
            if st is not None and st.rung == HOST_LIVE:
                continue  # alive (or merely slow): leave it alone
            if not self._fence_replica(holder, st, journal):
                continue  # another survivor owns this takeover
            for jid in sorted(jids):
                info = jobs_view.get(jid) or {}
                runs = int(info.get("runs", 0))
                if runs > self.reassign_budget:
                    self.quarantine(
                        jid,
                        info,
                        journal,
                        last_replica=holder,
                    )
                    continue
                self.steal_lease(jid, holder, journal)
                stolen.append(jid)
        return stolen

    def quarantine(self, jid: str, info: dict, journal=None,
                   last_replica: str | None = None,
                   path: str = "steal") -> bool:
        """Commit a job terminal ``quarantined`` exactly once.

        Goes through the same completion-token path as a normal
        finish (:meth:`commit_terminal`): of N replicas deciding the
        same budget overrun concurrently, exactly one link wins and
        exactly one terminal journal record lands — a quarantined
        job can never be re-run, and its provenance (attempt count,
        the replica that died holding it) reads straight off the
        journal.  Returns True when THIS replica's commit won."""
        from repic_tpu_torch.serve.jobs import quarantine_reason

        runs = int(info.get("runs", 0))
        first = info.get("first") or {}
        reason = quarantine_reason(runs, self.reassign_budget)
        winner = self.commit_terminal(
            jid,
            JOB_QUARANTINED,
            reason=reason,
            attempts=runs,
            last_replica=last_replica,
        )
        if winner is not None:
            return False
        if journal is not None:
            journal.record(
                jid,
                JOB_QUARANTINED,
                reason=reason,
                attempts=runs,
                last_replica=last_replica,
                trace=first.get("trace"),
            )
        _FLEET_QUARANTINED.inc()
        from repic_tpu_torch.serve.jobs import _JOBS, _QUARANTINED

        _QUARANTINED.inc(path=path)
        _JOBS.inc(state=JOB_QUARANTINED)
        tenant = first.get("tenant")
        if tenant:
            tenancy.note_job(tenant, JOB_QUARANTINED)
        from repic_tpu_torch.telemetry import server as tlm_server

        now = self._clock()
        latency = max(now - float(first.get("ts", now)), 0.0)
        tlm_server.observe_slo("job", latency, ok=False)
        if tenant:
            tlm_server.observe_slo(
                f"tenant:{tenant}", latency, ok=False
            )
        return True

    # -- exactly-once completion --------------------------------------

    def commit_terminal(
        self, job_id: str, state: str, **fields
    ) -> dict | None:
        """Commit a job's terminal state exactly once.

        Fence check first (a fenced replica's work was reassigned —
        it must not publish), then the create-once link of the
        complete ``_done.<job>.json``.  Returns ``None`` when this
        replica's commit won; otherwise the WINNER's token, whose
        recorded state the caller adopts instead of its own.
        """
        crash_point(self.replica, f"emit:{job_id}")
        token = {
            "job": job_id,
            "state": state,
            "replica": self.replica,
            "ts": self._clock(),
        }
        token.update(fields)
        path = done_path(self.fleet_dir, job_id)
        if self.is_fenced():
            return _read_json(path) or {
                "job": job_id,
                "state": None,
                "fenced": True,
            }
        if commit_once(path, json.dumps(token, default=str)):
            return None
        return _read_json(path)

    def read_done(self, job_id: str) -> dict | None:
        return _read_json(done_path(self.fleet_dir, job_id))

    def orphaned_leases(self, view=None) -> list[str]:
        """Leases of uncommitted jobs held by NON-live replicas.

        A live replica's in-flight lease is healthy; one held by a
        stopped/suspect/fenced replica (or by nobody the liveness
        view knows) is orphaned work.  The drain invariant — zero
        after a clean fleet drain — and the operator's first
        stuck-fleet question.
        """
        import glob

        view = self.liveness() if view is None else view
        out = []
        for path in glob.glob(
            os.path.join(self.fleet_dir, f"{JOB_LEASE_PREFIX}*.json")
        ):
            jid = os.path.basename(path)[
                len(JOB_LEASE_PREFIX) : -len(".json")
            ]
            if os.path.exists(done_path(self.fleet_dir, jid)):
                continue
            holder = (_read_json(path) or {}).get("replica")
            st = view.get(holder) if holder else None
            if st is None or st.rung != HOST_LIVE:
                out.append(jid)
        return sorted(out)


class FleetQueue:
    """The shared durable queue, surfaced with the JobQueue interface.

    The daemon's worker loop and HTTP layer drive
    submit / next_job / mark_running / finish / cancel / get exactly
    as they do the single-process :class:`~repic_tpu_torch.serve.jobs.
    JobQueue`; underneath, the pending set is the MERGED per-replica
    journal view and scheduling is lease acquisition instead of a
    local list pop.  Admission (draining 503, breaker 503, queue-full
    429) is unchanged in shape, but the 429's ``Retry-After`` is
    fleet-aware: fleet-wide queued depth spread over live replicas,
    not this replica's local backlog.
    """

    AFFINITY_WINDOW = 4
    MAX_TERMINAL = 512

    def __init__(
        self,
        limit: int,
        journal: ServeJournal,
        member: FleetMember,
        breaker: CircuitBreaker | None = None,
        *,
        tenants: "tenancy.TenantRegistry | None" = None,
        clock=time.time,
    ):
        if limit < 1:
            raise ValueError("queue limit must be >= 1")
        self.limit = limit
        self.journal = journal
        self.member = member
        self.breaker = breaker or CircuitBreaker()
        self.tenants = tenants
        self._clock = clock
        self._lock = threading.Lock()
        self._jobs: dict[str, Job] = {}   # jobs this replica touched
        self._terminal: list[str] = []
        # (tenant, key) -> job id: per-tenant scoping, like JobQueue
        self._idemp: dict[tuple, str] = {}
        # several leases may be held open at once (the continuous
        # batcher coalesces jobs), so "running" is a set
        self._running: set[str] = set()
        self.draining = False
        # decayed per-micrograph service time (Retry-After unit)
        self._avg_mic_s = 2.0
        # fleet supervisor posture (fleet_dir/_autoscale_state.json):
        # EVERY replica reads the same file, so brownout shedding is
        # fleet-uniform the moment the supervisor publishes it
        self._brownout = autoscale.BrownoutReader(member.fleet_dir)
        self._reader = MergedJournalReader(
            member.fleet_dir, base_name=SERVE_JOURNAL_NAME
        )
        self._view_cache: dict | None = None
        self._view_version = -1

    # -- the merged fleet view ----------------------------------------

    def fleet_view(self) -> dict[str, dict]:
        """Fold the merged per-replica journals into one job map:
        ``{job_id: {state, first, latest, cancel_requested}}`` in
        acceptance order.  Incremental twice over — files re-parse
        only on size change, and the FOLD itself is cached against
        the reader's version — so the chunk-boundary cancel poll and
        the idle scheduler loop cost only a stat per journal file.
        Callers must treat the returned map as read-only.
        """
        entries = self._reader.entries()
        if (
            self._view_cache is not None
            and self._view_version == self._reader.version
        ):
            return self._view_cache
        view: dict[str, dict] = {}
        cancels: set[str] = set()
        for e in entries:
            jid = e.get("job")
            if not jid:
                continue
            if "event" in e:
                # applied after the pass: cross-replica clock skew
                # must not drop a cancel that sorted before its
                # job's queued record
                if e.get("event") == "cancel_requested":
                    cancels.add(jid)
                continue
            slot = view.get(jid)
            if slot is None:
                slot = view[jid] = {
                    "first": e,
                    "latest": e,
                    "state": e.get("state"),
                    "cancel_requested": False,
                    "runs": 0,
                }
            elif (
                "request" in e and "request" not in slot["first"]
            ):
                # cross-replica clock skew can sort a peer's
                # `running` record ahead of the accept record; the
                # accept (it carries request/trace/idempotency_key)
                # is the authoritative "first" regardless of ts
                slot["first"] = e
            slot["latest"] = e
            slot["state"] = e.get("state")
            if (
                e.get("state") == JOB_RUNNING
                and not e.get("cancel_requested")
                and not e.get("rerun")
            ):
                # fleet-wide run-attempt count: every replica's
                # mark_running lands one — the retry budget's input
                # at steal/recovery time.  Cancel-flag records and
                # same-process rerun records (the batcher's
                # coalesce-fallback demotion) are bookkeeping, not
                # crashed generations, and must not bill the budget
                slot["runs"] += 1
            if e.get("cancel_requested"):
                slot["cancel_requested"] = True
        for jid in cancels:
            slot = view.get(jid)
            if slot is not None:
                slot["cancel_requested"] = True
        self._view_cache = view
        self._view_version = self._reader.version
        return view

    def _materialize(self, jid: str, info: dict) -> Job:
        """A :class:`Job` document rebuilt from journal records (for
        jobs another replica accepted or ran).  The completion token
        is the terminal authority: a job whose commit landed but
        whose terminal journal record was lost to a crash still
        reads as terminal here."""
        first, latest = info["first"], info["latest"]
        state = info["state"] or JOB_QUEUED
        if state not in TERMINAL_STATES:
            done = self.member.read_done(jid)
            if done is not None and done.get("state"):
                state = done["state"]
                latest = dict(latest, **done)
        job = Job(
            id=jid,
            request=first.get("request", {}),
            accepted_ts=float(first.get("ts", self._clock())),
            state=state,
            tenant=first.get("tenant"),
            trace_id=first.get("trace"),
            idempotency_key=first.get("idempotency_key"),
            replica=latest.get("replica"),
            deadline_ts=first.get("deadline_ts"),
            bucket_hint=first.get("bucket_hint"),
            micrographs=first.get("micrographs"),
            resumed=bool(latest.get("resumed", False)),
            attempts=int(info.get("runs", 0)),
            cancel_requested=info["cancel_requested"],
        )
        if state in TERMINAL_STATES:
            job.finished_ts = float(latest.get("ts", 0.0)) or None
            job.error = latest.get("error")
            job.reason = latest.get("reason")
            if latest.get("particles") is not None:
                job.result = {
                    k: latest[k]
                    for k in ("particles", "quarantined", "wall_s")
                    if k in latest
                }
        return job

    def _is_open(self, jid: str, info: dict) -> bool:
        """Still schedulable: no terminal journal record AND no
        completion token (the token is the exactly-once authority —
        a committed job must never be claimed or re-run, even if the
        committer crashed before its terminal journal append)."""
        if info["state"] in TERMINAL_STATES:
            return False
        return self.member.read_done(jid) is None

    # -- admission ----------------------------------------------------

    def submit(self, request, *, deadline_s=None, bucket_hint=None,
               idempotency_key=None, micrographs=None,
               tenant=None) -> Job:
        return self.submit_idempotent(
            request,
            deadline_s=deadline_s,
            bucket_hint=bucket_hint,
            idempotency_key=idempotency_key,
            micrographs=micrographs,
            tenant=tenant,
        )[0]

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
        """Admit one request (or dedupe a retry) fleet-wide.

        The idempotency check spans EVERY replica's journal: a client
        whose 202 was lost to a replica crash retries against any
        survivor and gets the original job id back, not a duplicate.
        Keys are scoped per tenant — one tenant's retry can never
        alias into another tenant's job.  Tenant quotas are
        fleet-wide too: open jobs and queued micrographs are counted
        over the merged journal view, so a tenant cannot multiply
        its budget by spraying submissions across replicas.
        """
        from repic_tpu_torch.serve.jobs import (
            _ADMISSION,
            _ADMITTED,
            _DEDUPED,
            _REJECTED,
        )

        if idempotency_key:
            with self._lock:
                jid = self._idemp.get((tenant, idempotency_key))
                local = self._jobs.get(jid) if jid else None
            if local is None:
                for jid, info in self.fleet_view().items():
                    if (
                        info["first"].get("idempotency_key")
                        == idempotency_key
                        and info["first"].get("tenant") == tenant
                    ):
                        local = self._jobs.get(jid) or (
                            self._materialize(jid, info)
                        )
                        break
            if local is not None:
                _DEDUPED.inc()
                return local, True
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
            # resolved after the cheap rejections (JobQueue contract)
            micrographs = micrographs()
        view = self.fleet_view()
        depth = self._fleet_depth(view)
        live = self.member.live_replicas()
        # brownout shedding FIRST (ahead of the depth check): staged
        # degradation refuses low-priority work before the queue is
        # full — bending, not cliffing
        state = self._brownout.state()
        level = self._brownout.level()
        shed = autoscale.shed_priorities(level)
        if shed and self._priority_of(tenant) in shed:
            self._reject_brownout(tenant, state, shed, view, live)
        stormed = faults.check("request_storm", "submit")
        limit = autoscale.effective_queue_limit(self.limit, level)
        if depth >= limit or stormed:
            _REJECTED.inc(reason="queue_full")
            _ADMISSION.inc(
                outcome="rejected", cause="queue_full", code="429"
            )
            # fleet-aware backoff in MICROGRAPHS: per-micrograph
            # service time x fleet-wide queued micrographs (each
            # queued record carries its admission-time estimate),
            # drained at the rate of every LIVE replica — whole-job
            # averages over-estimated under continuous batching
            mics = sum(
                (info["first"].get("micrographs") or 1)
                for jid, info in view.items()
                if info["state"] == JOB_QUEUED
                and self._is_open(jid, info)
                and self.member.lease_info(jid) is None
            )
            raise AdmissionError(
                429,
                "queue_full",
                self._avg_mic_s * max(mics, depth, 1) / live,
            )
        with self._lock:
            # re-check under the creation lock: two concurrent
            # retries of one key on THIS replica must still yield
            # one job (the same guard JobQueue.submit_idempotent
            # carries; peers racing the same key across replicas
            # are deduped best-effort by the pre-scan above)
            if idempotency_key:
                jid = self._idemp.get((tenant, idempotency_key))
                job = self._jobs.get(jid) if jid else None
                if job is not None:
                    _DEDUPED.inc()
                    return job, True
            # tenant limits INSIDE the creation lock, mirroring
            # JobQueue: two racing same-replica submissions must
            # serialize through the quota comparison + the insert
            # that changes its inputs (the view is refreshed here —
            # this replica's own just-journaled accepts are in it;
            # cross-replica admission stays best-effort, like the
            # fleet-wide depth check above).  In-lock cost is
            # bounded: the refresh is the incremental size-keyed
            # reader, and the tally's read_done/lease probes fire
            # only for NON-terminal jobs (the in-view state check
            # short-circuits the MAX_TERMINAL history), i.e. O(open
            # jobs), not O(journal)
            if self.tenants is not None and tenant is not None:
                open_jobs, queued_mics = (
                    self._tenant_view_tallies(
                        self.fleet_view(), tenant
                    )
                )
                refused = self.tenants.check_admission(
                    tenant,
                    micrographs=micrographs or 1,
                    open_jobs=open_jobs,
                    queued_micrographs=queued_mics,
                    per_mic_s=self._avg_mic_s / live,
                )
                if refused is not None:
                    cause, retry_after = refused
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
            extra = (
                {"idempotency_key": idempotency_key}
                if idempotency_key
                else {}
            )
            if micrographs is not None:
                extra["micrographs"] = micrographs
            if tenant is not None:
                extra["tenant"] = tenant
            # journal-before-202 (under the lock, like JobQueue):
            # the accepting replica's flushed record IS the durable
            # enqueue every peer can see and claim
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
            if idempotency_key:
                self._idemp[(tenant, idempotency_key)] = job.id
        _ADMITTED.inc()
        _ADMISSION.inc(
            outcome="accepted", cause="accepted", code="202"
        )
        if tenant is not None:
            tenancy.note_admitted(tenant)
        serve_crash_point(f"accept:{job.id}")
        return job, False

    def _priority_of(self, tenant: str | None) -> str:
        if self.tenants is None:
            return tenancy.DEFAULT_PRIORITY
        return self.tenants.priority(tenant)

    def _unshed_micrographs(self, view: dict, shed: tuple) -> int:
        """Fleet-wide queued micrographs of classes still admitted
        — the backlog that drains ahead of a shed tenant."""
        total = 0
        for jid, info in view.items():
            if (
                info["state"] != JOB_QUEUED
                or not self._is_open(jid, info)
                or self.member.lease_info(jid) is not None
            ):
                continue
            if self._priority_of(
                info["first"].get("tenant")
            ) not in shed:
                total += info["first"].get("micrographs") or 1
        return total

    def _reject_brownout(
        self,
        tenant: str | None,
        state: dict | None,
        shed: tuple,
        view: dict,
        live: int,
    ):
        """The fleet brownout 429, priced from the shed class's
        un-shed horizon: supervisor interval + remaining cooldown +
        the admitted classes' fleet-wide drain time spread over the
        LIVE replicas — not the global per-micrograph estimate."""
        from repic_tpu_torch.serve.jobs import _ADMISSION, _REJECTED

        retry_after = autoscale.shed_horizon_s(
            state,
            self._unshed_micrographs(view, shed),
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

    def _tenant_view_tallies(
        self, view: dict, tenant: str
    ) -> tuple[int, int]:
        """(open jobs, queued micrographs) for one tenant over the
        MERGED fleet view — quota inputs span every replica."""
        slot = self.tenant_tallies(view).get(tenant) or {}
        return (
            slot.get("open_jobs", 0),
            slot.get("queued_micrographs", 0),
        )

    def tenant_tallies(self, view: dict | None = None) -> dict:
        """Per-tenant open-job / queued-micrograph tallies over the
        merged view (fleet-wide, not this replica's) — the ONE
        accumulator behind both the admission quota inputs and the
        /status ``tenants`` section, so "what counts as queued
        work" cannot diverge between the two."""
        out: dict[str, dict] = {}
        view = self.fleet_view() if view is None else view
        for jid, info in view.items():
            tenant = info["first"].get("tenant")
            if tenant is None or not self._is_open(jid, info):
                continue
            slot = out.setdefault(
                tenant, {"open_jobs": 0, "queued_micrographs": 0}
            )
            slot["open_jobs"] += 1
            if (
                info["state"] == JOB_QUEUED
                and self.member.lease_info(jid) is None
            ):
                slot["queued_micrographs"] += (
                    info["first"].get("micrographs") or 1
                )
        return out

    def _fleet_depth(self, view: dict | None = None) -> int:
        """Fleet-wide queued (unleased) jobs — the shared backlog."""
        view = self.fleet_view() if view is None else view
        depth = sum(
            1
            for jid, info in view.items()
            if info["state"] == JOB_QUEUED
            and self._is_open(jid, info)
            and self.member.lease_info(jid) is None
        )
        _FLEET_DEPTH.set(depth)
        return depth

    # -- recovery -----------------------------------------------------

    def recover_own(self) -> list[Job]:
        """Jobs this replica still holds the lease for (a restart
        under the same replica id): adopt and re-run them with resume
        semantics.  Queued-but-unleased jobs need no adoption — the
        normal scheduling pass claims them.

        The retry budget applies here exactly as at lease-steal: a
        restarting replica whose own held job keeps crashing it
        (the single-replica poison-pill shape) quarantines the job
        instead of re-running into the same crash forever."""
        out = []
        for jid, info in self.fleet_view().items():
            if not self._is_open(jid, info):
                continue
            lease = self.member.lease_info(jid)
            if lease is None or lease.get("replica") != (
                self.member.replica
            ):
                continue
            if int(info.get("runs", 0)) > (
                self.member.reassign_budget
            ):
                self._quarantine_held(jid, info)
                continue
            job = self._materialize(jid, info)
            job.resumed = True
            job.replica = self.member.replica
            with self._lock:
                self._jobs[jid] = job
                if job.idempotency_key:
                    self._idemp[
                        (job.tenant, job.idempotency_key)
                    ] = jid
            out.append(job)
        return out

    def _quarantine_held(self, jid: str, info: dict) -> None:
        """Quarantine a job THIS replica holds the lease for (the
        restart-recovery budget branch): token-committed terminal,
        journaled once, lease released, local copy updated."""
        from repic_tpu_torch.serve.jobs import quarantine_reason

        if not self.member.quarantine(
            jid, info, self.journal, path="recover"
        ):
            # a peer's commit won the race: adopt nothing — but the
            # lease WE hold still points at a now-terminal job and
            # would sit in the fleet dir forever; release it (the
            # done token, not the lease, is the terminal authority)
            self.member.release_lease(jid)
            return
        with self._lock:
            job = self._jobs.get(jid)
            if job is None:
                job = self._materialize(jid, info)
                self._jobs[jid] = job
            job.state = JOB_QUARANTINED
            job.reason = quarantine_reason(
                int(info.get("runs", 0)),
                self.member.reassign_budget,
            )
            job.finished_ts = self._clock()
            self._note_terminal(jid)
        self.member.release_lease(jid)

    # -- worker side --------------------------------------------------

    def next_job(self, timeout: float, last_bucket=None) -> Job | None:
        """Claim the next runnable job (lease acquisition), stealing
        orphans from dead replicas when the queue looks empty.

        The poll deadline runs on the MONOTONIC wall clock, not the
        injectable one: the injected clock drives lease/heartbeat
        timestamps deterministically in tests, but this loop's
        timeout is real waiting and must elapse on its own.
        """
        from repic_tpu_torch.serve.jobs import _DEPTH

        deadline = time.monotonic() + timeout
        while True:
            if self.draining:
                return None
            view = self.fleet_view()
            mine = self._held_unfinished(view)
            if mine is not None:
                return mine
            claimable = [
                (jid, info)
                for jid, info in view.items()
                if info["state"] == JOB_QUEUED
                and self._is_open(jid, info)
                and self.member.lease_info(jid) is None
            ]
            _DEPTH.set(len(claimable))
            _FLEET_DEPTH.set(len(claimable))
            ordered = self._affinity_order(claimable, last_bucket)
            for jid, info in ordered:
                if self.member.lease_job(jid):
                    job = self._adopt_leased(jid, info)
                    return job
            # nothing claimable: look for orphaned leases to steal
            if self.member.harvest(view, self.journal):
                continue  # stolen leases surface via _held_unfinished
            if time.monotonic() >= deadline:
                return None
            time.sleep(min(0.05, max(timeout / 4, 0.01)))

    def _held_unfinished(self, view: dict) -> Job | None:
        """A job this replica already holds the lease for but is not
        running (restart recovery, or a freshly stolen lease)."""
        with self._lock:
            running = set(self._running)
        for jid, info in view.items():
            if jid in running or not self._is_open(jid, info):
                continue
            lease = self.member.lease_info(jid)
            if lease is None or lease.get("replica") != (
                self.member.replica
            ):
                continue
            if int(info.get("runs", 0)) > (
                self.member.reassign_budget
            ):
                # a held job already over its attempt budget (e.g.
                # freshly stolen leases race a peer's last running
                # record): quarantine, never run
                self._quarantine_held(jid, info)
                continue
            return self._adopt_leased(jid, info, resumed=(
                info["state"] == JOB_RUNNING
                or jid in self.member.reassigned
            ))
        return None

    def _adopt_leased(
        self, jid: str, info: dict, resumed: bool | None = None
    ) -> Job:
        with self._lock:
            job = self._jobs.get(jid)
            if job is None:
                job = self._materialize(jid, info)
                self._jobs[jid] = job
            if resumed is None:
                resumed = info["state"] == JOB_RUNNING
            job.resumed = bool(job.resumed or resumed)
            job.replica = self.member.replica
            self._running.add(jid)
        return job

    def _affinity_order(self, claimable, last_bucket):
        """FIFO with the bounded warm-bucket jump: a hint matching
        the just-warmed bucket may move to the front from within the
        window — the fleet analog of JobQueue's affinity (skip-count
        fairness degenerates to the window bound here: claims race
        across replicas, so per-job skip state cannot be local)."""
        ordered = sorted(
            claimable,
            key=lambda kv: float(kv[1]["first"].get("ts", 0.0)),
        )
        if last_bucket is None or not ordered:
            return ordered
        window = ordered[: self.AFFINITY_WINDOW]
        for i, (jid, info) in enumerate(window):
            if info["first"].get("bucket_hint") == last_bucket:
                if i:
                    ordered.insert(0, ordered.pop(i))
                break
        return ordered

    def mark_failed(self, job: Job) -> None:
        """Last-resort state flip when :meth:`finish` itself failed
        (journal down): mirror of JobQueue.mark_failed."""
        with self._lock:
            self._running.discard(job.id)
            job.state = JOB_FAILED

    def mark_running(self, job: Job) -> None:
        from repic_tpu_torch.serve.jobs import _QUEUE_WAIT

        with self._lock:
            # same-process re-run (batcher fallback): keep the
            # original started_ts, no second queue-wait observation
            rerun = job.started_ts is not None
            job.state = JOB_RUNNING
            if not rerun:
                job.started_ts = self._clock()
        if not rerun:
            _QUEUE_WAIT.observe(
                max(job.started_ts - job.accepted_ts, 0.0)
            )
        # rerun rides the journal exactly as in JobQueue: a
        # same-process demotion is not a crashed generation, and
        # the fleet_view `runs` fold must not bill the retry budget
        # for it — or a twice-fallen-back healthy job would read
        # over budget and be QUARANTINED at the next steal/claim
        self.journal.record(
            job.id, JOB_RUNNING, resumed=job.resumed,
            trace=job.trace_id,
            **({"rerun": True} if rerun else {}),
        )

    def finish(self, job: Job, state: str, **fields) -> None:
        """Terminal states commit exactly-once through the completion
        token; a drain re-queue journals ``queued`` and releases the
        lease so any replica (or the next generation) picks it up."""
        from repic_tpu_torch.serve.jobs import _JOBS

        with self._lock:
            self._running.discard(job.id)
        if state not in TERMINAL_STATES:
            # drain hand-back: queued for whoever runs next
            with self._lock:
                job.state = state
                job.finished_ts = self._clock()
            self.journal.record(
                job.id, state, trace=job.trace_id, **fields
            )
            self.member.release_lease(job.id)
            return
        # token FIRST, visible state after: an observer that reads
        # a terminal job state must always find the completion token
        # already on disk (the chaos test's ordering contract)
        winner = self.member.commit_terminal(
            job.id, state, **fields
        )
        if winner is None:
            with self._lock:
                # terminal under the lock BEFORE the journal append,
                # so a racing cancel() either sees the terminal state
                # (and skips) or journaled its running record first —
                # the terminal record is always last
                job.state = state
                job.finished_ts = self._clock()
                if job.started_ts and state == JOB_FINISHED:
                    dur = max(
                        job.finished_ts - job.started_ts, 0.0
                    )
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
            # our commit won: exactly one terminal journal record
            self.journal.record(
                job.id, state, trace=job.trace_id, **fields
            )
            _JOBS.inc(state=state)
            if job.tenant is not None:
                tenancy.note_job(job.tenant, state)
            self.member.release_lease(job.id)
            return
        # a fenced straggler losing the race: adopt the committed
        # outcome, journal only a non-state event (a state record
        # here could fold AFTER the winner's terminal record and
        # resurrect the job on a later merge)
        with self._lock:
            job.state = winner.get("state") or state
            job.finished_ts = self._clock()
        self.journal.record_event(
            "commit_lost",
            job=job.id,
            attempted_state=state,
            winner=winner.get("replica"),
        )

    def abandon(self, job: Job) -> None:
        """A fenced replica stopping mid-job: record nothing terminal
        (the survivor owns the job now); just note the stop."""
        with self._lock:
            self._running.discard(job.id)
        self.journal.record_event("fenced_stop", job=job.id)

    def _note_terminal(self, job_id: str) -> None:
        self._terminal.append(job_id)
        while len(self._terminal) > self.MAX_TERMINAL:
            evicted = self._jobs.pop(self._terminal.pop(0), None)
            if evicted is not None and evicted.idempotency_key:
                self._idemp.pop(
                    (evicted.tenant, evicted.idempotency_key), None
                )

    # -- client side --------------------------------------------------

    def get(self, job_id: str) -> Job | None:
        """Any replica answers for any job.

        A job this replica is RUNNING (or already finished locally)
        answers from its live copy; anything else is refreshed from
        the merged fleet view — the accepting replica's local copy
        goes stale the moment a peer claims the job, and a client
        polling the accepter must still see the runner's progress,
        the runner's identity, and the committed outcome.
        """
        with self._lock:
            job = self._jobs.get(job_id)
            running = job_id in self._running
        if job is not None and (
            running or job.state in TERMINAL_STATES
        ):
            return job
        info = self.fleet_view().get(job_id)
        if info is None:
            return job
        merged = self._materialize(job_id, info)
        if job is None:
            return merged
        with self._lock:
            job.state = merged.state
            job.replica = merged.replica or job.replica
            job.resumed = bool(job.resumed or merged.resumed)
            job.finished_ts = (
                merged.finished_ts or job.finished_ts
            )
            if merged.error is not None:
                job.error = merged.error
            if merged.reason is not None:
                job.reason = merged.reason
            if merged.result and not job.result:
                job.result = merged.result
            job.cancel_requested = bool(
                job.cancel_requested or merged.cancel_requested
            )
        return job

    def jobs(self) -> list[Job]:
        view = self.fleet_view()
        with self._lock:
            local = dict(self._jobs)
        out = []
        for jid, info in view.items():
            out.append(local.get(jid) or self._materialize(jid, info))
        for jid, job in local.items():
            if jid not in view:
                out.append(job)
        return out

    def cancel(self, job_id: str) -> Job | None:
        """Fleet-wide cancel: a queued unleased job is cancelled
        outright by claiming its lease first (so the cancel and a
        racing run cannot both win); a job leased elsewhere gets a
        journaled ``cancel_requested`` event its runner polls at
        chunk boundaries."""
        from repic_tpu_torch.serve.jobs import _JOBS

        with self._lock:
            local = self._jobs.get(job_id)
            locally_running = job_id in self._running
            if local is not None and locally_running:
                if local.state in TERMINAL_STATES:
                    return local
                local.cancel_requested = True
                # journaled UNDER the lock, mirroring JobQueue.cancel:
                # finish() marks the job terminal under this same lock
                # before journaling, so the terminal record always
                # lands after this running-state record — the other
                # order would resurrect a finished job on recovery
                self.journal.record(
                    job_id, JOB_RUNNING, cancel_requested=True,
                    trace=local.trace_id,
                )
                return local
        info = self.fleet_view().get(job_id)
        if info is None:
            return local
        if info["state"] in TERMINAL_STATES:
            return local or self._materialize(job_id, info)
        job = local or self._materialize(job_id, info)
        if (
            info["state"] == JOB_QUEUED
            and self.member.lease_info(job_id) is None
            and self.member.lease_job(job_id)
        ):
            winner = self.member.commit_terminal(
                job_id, JOB_CANCELLED,
                reason="cancelled while queued",
            )
            if winner is None:
                with self._lock:
                    job.state = JOB_CANCELLED
                    job.reason = "cancelled while queued"
                    job.finished_ts = self._clock()
                    self._jobs[job_id] = job
                    self._note_terminal(job_id)
                self.journal.record(
                    job_id, JOB_CANCELLED,
                    reason="cancelled while queued",
                    trace=job.trace_id,
                )
                _JOBS.inc(state=JOB_CANCELLED)
                self.member.release_lease(job_id)
                from repic_tpu_torch.telemetry import server as tlm_server

                latency = max(
                    job.finished_ts - job.accepted_ts, 0.0
                )
                tlm_server.observe_slo("job", latency, ok=False)
                if job.tenant is not None:
                    tlm_server.observe_slo(
                        f"tenant:{job.tenant}", latency, ok=False
                    )
                    tenancy.note_job(job.tenant, JOB_CANCELLED)
                return job
        # leased (or lost the claim race): cooperative, cross-replica
        with self._lock:
            job.cancel_requested = True
        self.journal.record_event(
            "cancel_requested", job=job_id, by=self.member.replica
        )
        return job

    def cancel_requested_remote(self, job_id: str) -> bool:
        """The runner's chunk-boundary poll: did ANY replica journal
        a cancel for this job?"""
        info = self.fleet_view().get(job_id)
        return bool(info and info["cancel_requested"])

    def begin_drain(self) -> int:
        self.draining = True
        return self._fleet_depth()

    def error_doc(self, exc: BaseException) -> dict:
        from repic_tpu_torch.runtime.journal import error_info

        return error_info(exc)

    # -- status -------------------------------------------------------

    def fleet_status(self) -> dict:
        """The /status ``fleet`` section: replica liveness, the
        fleet-wide queue, and this replica's reassignment tally."""
        view = self.fleet_view()
        by_state: dict[str, int] = {}
        for info in view.values():
            s = info["state"] or "unknown"
            by_state[s] = by_state.get(s, 0) + 1
        liveness = self.member.liveness()
        return {
            "fleet_dir": self.member.fleet_dir,
            "replica": self.member.replica,
            "replica_timeout_s": self.member.timeout_s,
            "queue_depth": self._fleet_depth(view),
            "jobs": by_state,
            "reassigned": len(self.member.reassigned),
            "orphaned_leases": len(self.member.orphaned_leases()),
            "replicas": {
                r: {
                    "rung": s.rung,
                    "age_s": (
                        None if s.age_s is None
                        else round(s.age_s, 3)
                    ),
                }
                for r, s in liveness.items()
            },
        }
