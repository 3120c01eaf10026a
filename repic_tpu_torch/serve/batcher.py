"""Continuous cross-request batching (the port of
``repic_tpu.serve.batcher``).

The single-job worker runs one job at a time: the device idles between
small jobs, and a large job blocks everything behind it.  This
scheduler holds several accepted jobs open at once and, at every chunk
boundary, coalesces queued micrographs from different requests into
one padded capacity-bucket chunk through
:func:`~repic_tpu_torch.pipeline.consensus.run_consensus_batch`.  The
chunk program never knows which request a row belongs to; this layer
does.

* **Coalescing** -- jobs group by :class:`CoalesceKey` (the
  ``RequestPlan.bucket_key`` plus box size and the knobs that select
  the program); one chunk takes micrographs from every open job of the
  chosen group.
* **Fair share** -- chunk slots are dealt round-robin across tenants,
  then jobs (rotating first pick); under a burning error budget or a
  brownout the first pick goes earliest-deadline-first.  A warm group
  keeps the device at most :attr:`ContinuousBatcher.MAX_BUCKET_STREAK`
  chunks while another waits.
* **Shapes** -- a chunk pads its micrograph axis onto a sparse ladder
  (4, 16, 64, ...), so arrival noise does not mint new program
  signatures.
* **Per-request everything** -- each job keeps its own run journal,
  trace (the ``execute`` segment carries the job's share of a
  coalesced chunk), cancel poll at every chunk boundary and SLO
  observation.
* **Isolation fallback** -- a coalesced chunk that fails hands its
  micrographs back and demotes every participant to the single-job
  path (:meth:`ConsensusDaemon._run_job`), whose ladder isolates the
  poisoned request.

Coalescing changes no output byte: each micrograph's rows are computed
independently of the other rows of its chunk.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

from repic_tpu_torch import telemetry
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.atomic import atomic_write
from repic_tpu_torch.serve.jobs import (
    JOB_CANCELLED,
    JOB_DEADLINE_EXCEEDED,
    JOB_FAILED,
    JOB_FINISHED,
    JOB_QUEUED,
    Job,
    crash_point,
    poison_point,
)
from repic_tpu_torch.telemetry import events as tlm_events
from repic_tpu_torch.telemetry import probes as tlm_probes
from repic_tpu_torch.telemetry import server as tlm_server
from repic_tpu_torch.telemetry import trace as tlm_trace

_log = tlm_events.get_logger("serve.batcher")

_BATCHES = telemetry.counter(
    "repic_serve_batches_total",
    "coalesced chunks executed by the continuous batcher",
)
_BATCHED_MICS = telemetry.counter(
    "repic_serve_batched_micrographs_total",
    "real micrographs executed through coalesced chunks",
)
_FALLBACKS = telemetry.counter(
    "repic_serve_batch_fallbacks_total",
    "coalesced chunks that failed and demoted their jobs to the "
    "isolated single-job path",
)
_OCCUPANCY = telemetry.histogram(
    "repic_serve_batch_occupancy",
    "real-micrograph fraction of each executed coalesced chunk "
    "(1.0 = no padding waste)",
    buckets=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0),
)
_COALESCED = telemetry.histogram(
    "repic_serve_coalesced_jobs",
    "distinct requests contributing micrographs to each executed "
    "coalesced chunk",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16),
)
_OPEN = telemetry.gauge(
    "repic_serve_open_jobs",
    "jobs the continuous batcher currently holds open",
)


@dataclass(frozen=True)
class CoalesceKey:
    """What must match for two requests' micrographs to share one
    executed chunk: the warm-affinity ``bucket_key`` (pickers,
    padded particle capacity, threshold, solver — micrograph count
    deliberately excluded) plus box size (a runtime input the whole
    batch shares) and the perf knobs that select the compiled
    program or its padding arithmetic."""

    bucket_key: tuple
    box_sizes: tuple
    max_neighbors: int
    use_mesh: bool
    spatial: bool | None
    use_pallas: bool
    n_dev: int

    @property
    def capacity(self) -> int:
        return self.bucket_key[1]


@dataclass
class OpenJob:
    """One admitted job's open execution state."""

    job: Job
    options: object
    out_dir: str
    box_size: object
    key: CoalesceKey | None
    journal: object                 # per-job RunJournal
    rt: object                      # per-job telemetry run handle
    tctx: object                    # per-request TraceContext
    names: list
    already: set
    num_pickers: int
    t0: float                       # daemon clock at pick
    cancel: object                  # the chunk-boundary cancel hook
    pending: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)
    quarantined: dict = field(default_factory=dict)
    outcomes: object = None
    chunk_i: int = 0

    def sink(self, fname: str, content: str) -> None:
        with atomic_write(os.path.join(self.out_dir, fname)) as f:
            f.write(content)


class ContinuousBatcher:
    """The serve worker's batch-mode scheduler loop."""

    #: consecutive chunks one coalesce group may keep the device
    #: while another group has work waiting
    MAX_BUCKET_STREAK = 4
    #: coalesced chunks pad their micrograph axis up to this grid
    #: minimum so small chunks of different sizes land on one
    #: compiled shape (bucket_key must not fragment the program
    #: cache across jobs differing only in micrograph count)
    MIN_CHUNK_PAD = 4
    #: ``job`` budget-burn rate at or above which dealing switches
    #: from round-robin to earliest-deadline-first — burn 1.0 is the
    #: break-even point where the error budget is spending exactly
    #: as fast as it accrues, so any sustained excess means jobs are
    #: already missing the latency objective and ordering by slack
    #: beats ordering by arrival
    EDF_BURN = 1.0

    def __init__(self, daemon, max_open: int = 4):
        if max_open < 1:
            raise ValueError("max_open must be >= 1")
        self.daemon = daemon
        self.queue = daemon.queue
        self.max_open = max_open
        self._open: list[OpenJob] = []
        self._last_key: CoalesceKey | None = None
        self._last_capacity: int | None = None
        self._streak = 0
        self._rr = -1  # first deal starts at the oldest open job
        self._dealing = "round_robin"  # last _select ordering mode

    # -- the loop -----------------------------------------------------

    def run(self) -> None:
        while True:
            try:
                self._admit()
                if not self._open:
                    if self.queue.draining:
                        return
                    continue
                self._poll_boundaries()
                self._finish_completed()
                sel = self._select()
                if sel:
                    self._execute(sel)
                    self._poll_boundaries()
                    self._finish_completed()
                self.daemon.publish_status()
            except Exception as e:  # noqa: BLE001 - last resort
                # nothing may kill the sole worker behind a live
                # front end; fail whatever was open (visible to its
                # client, counted by the breaker) and keep serving
                _log.error(f"batch scheduler error: {e}")
                for oj in list(self._open):
                    self._fail(oj, e)
                time.sleep(0.05)

    def status(self) -> dict:
        """The /status ``scheduler`` section."""
        return {
            "mode": "batch",
            "max_open": self.max_open,
            "open_jobs": len(self._open),
            "open_micrographs": sum(
                len(oj.pending) for oj in self._open
            ),
            "warm_capacity": self._last_capacity,
            "dealing": self._dealing,
        }

    # -- admission into the open set ----------------------------------

    def _admit(self) -> None:
        while len(self._open) < self.max_open:
            job = self.queue.next_job(
                0.0 if self._open else 0.2, self._last_capacity
            )
            if job is None:
                break
            oj = self._open_job(job)
            if oj is not None:
                self._open.append(oj)
            _OPEN.set(len(self._open))

    def _open_job(self, job: Job) -> OpenJob | None:
        daemon = self.daemon
        try:
            self.queue.mark_running(job)
        except Exception as e:  # noqa: BLE001 - journal may be down
            return self._fail_bare(job, e)
        t_picked = time.time()
        daemon.publish_status()
        queue_wait = max(
            (job.started_ts or job.accepted_ts) - job.accepted_ts,
            0.0,
        )
        tlm_server.observe_slo("queue_wait", queue_wait)
        out_dir = daemon.job_dir(job.id)
        os.makedirs(out_dir, exist_ok=True)
        replica = daemon.fleet.replica if daemon.fleet else None
        tctx = tlm_trace.start(
            out_dir,
            trace_id=job.trace_id,
            host=replica,
            kind="serve",
            job=job.id,
            accepted_ts=round(job.accepted_ts, 6),
            **({"tenant": job.tenant} if job.tenant else {}),
        )
        job.trace_id = tctx.trace_id
        token = tlm_trace.activate(tctx)
        try:
            tlm_trace.add_segment(
                "queue_wait", job.accepted_ts, queue_wait
            )
            return self._open_job_traced(
                job, out_dir, tctx, t_picked, replica
            )
        except Exception as e:  # noqa: BLE001 - isolation boundary
            tctx.close()
            return self._fail_bare(job, e)
        finally:
            tlm_trace.deactivate(token)

    def _open_job_traced(
        self, job, out_dir, tctx, t_picked, replica
    ) -> OpenJob | None:
        import numpy as np

        from repic_tpu_torch.pipeline import engine
        from repic_tpu_torch.runtime.journal import RunJournal, error_info
        from repic_tpu_torch.runtime.ladder import ChunkOutcomes
        from repic_tpu_torch.utils import box_io

        daemon = self.daemon
        crash_point(f"run:{job.id}")
        if daemon.fleet is not None:
            from repic_tpu_torch.serve import fleet as fleet_mod

            fleet_mod.crash_point(replica, f"run:{job.id}")
        t0 = daemon._clock()
        if (
            job.deadline_ts is not None
            and daemon._clock() > job.deadline_ts
        ):
            job.reason = "deadline exceeded while queued"
            daemon._finish_job(
                job, JOB_DEADLINE_EXCEEDED, reason=job.reason
            )
            tctx.close()
            return None
        options = engine.ConsensusOptions.from_dict(
            job.request.get("options") or {}
        )
        in_dir = job.request["in_dir"]
        # poison pill: fires after mark_running journaled the
        # attempt (the retry budget's unit) and before any artifact
        poison_point(job.id, in_dir)
        box_size = job.request["box_size"]
        pickers = box_io.discover_picker_dirs(in_dir)
        if not pickers:
            raise ValueError(f"no picker subdirectories in {in_dir}")
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
        journal = RunJournal.open(
            out_dir,
            run_config,
            resume=True,
            host=replica,
            cluster=replica is not None,
        )
        # the run scope is deliberately CROSS-FUNCTION: it stays
        # open while the job is open (chunks from many scheduler
        # passes write into it) and every exit path — _finalize,
        # _close via _cancelled/_fallback/_fail, and the except
        # below — calls finish_run exactly once
        rt = telemetry.start_run(
            out_dir,
            run_id=f"serve-{job.id}",
            host=replica,
        )
        try:
            already = set()
            if journal.resumed:
                latest = journal.latest()
                for nm in journal.done_names():
                    out_name = latest[nm].get("out", nm + ".box")
                    if os.path.exists(
                        os.path.join(out_dir, out_name)
                    ):
                        already.add(nm)
            counts: dict = {}
            quarantined: dict = {}
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
                    journal.record(nm, "skipped", out=nm + ".box")
                    counts[nm] = 0
                    continue
                loaded.append((nm, sets))
            key = None
            if loaded:
                n_dev = len(engine.request_mesh(options, daemon.device))
                plan = engine.plan_request(
                    loaded, box_size, options, n_dev=n_dev
                )
                key = CoalesceKey(
                    bucket_key=plan.bucket_key,
                    box_sizes=tuple(
                        np.asarray(box_size, np.float32)
                        .reshape(-1)
                        .tolist()
                    )
                    if np.asarray(box_size).ndim
                    else (float(box_size),),
                    max_neighbors=options.max_neighbors,
                    use_mesh=options.use_mesh,
                    spatial=options.spatial,
                    use_pallas=options.use_pallas,
                    n_dev=n_dev,
                )
                job.progress = {
                    "chunks_total": len(plan.chunks),
                    "chunks_done": 0,
                    "capacity": plan.capacity,
                    "micrographs_total": len(names),
                    "micrographs_done": len(already) + len(counts),
                }
                tlm_trace.add_segment(
                    "plan", t_picked, time.time() - t_picked,
                    micrographs=len(names),
                    chunks=len(plan.chunks),
                    capacity=plan.capacity,
                )
            oj = OpenJob(
                job=job,
                options=options,
                out_dir=out_dir,
                box_size=box_size,
                key=key,
                journal=journal,
                rt=rt,
                tctx=tctx,
                names=names,
                already=already,
                num_pickers=len(pickers),
                t0=t0,
                cancel=daemon._cancel_check(job),
                pending=loaded,
                counts=counts,
                quarantined=quarantined,
                outcomes=ChunkOutcomes(),
            )
            return oj
        except Exception:
            journal.close()
            telemetry.finish_run(rt)
            raise

    # -- scheduling ---------------------------------------------------

    def _select(self):
        """Pick a coalesce group (warm streak, bounded) and deal its
        chunk slots round-robin across the group's jobs.  Returns
        ``[(open_job, [(name, sets), ...]), ...]`` with each job's
        share CONTIGUOUS (the executed batch's row layout), or None.
        """
        from repic_tpu_torch.pipeline.engine import _auto_chunk

        groups: dict[CoalesceKey, list[OpenJob]] = {}
        for oj in self._open:
            if oj.pending and oj.key is not None:
                groups.setdefault(oj.key, []).append(oj)
        if not groups:
            return None
        if len(groups) == 1:
            key = next(iter(groups))
            self._streak = self._streak + 1 if (
                key == self._last_key
            ) else 0
        elif (
            self._last_key in groups
            and self._streak < self.MAX_BUCKET_STREAK
        ):
            key = self._last_key
            self._streak += 1
        else:
            # longest-waiting other group runs next; streak resets
            key = min(
                (k for k in groups if k != self._last_key),
                key=lambda k: min(
                    oj.job.accepted_ts for oj in groups[k]
                ),
            )
            self._streak = 0
        self._last_key = key
        self._last_capacity = key.capacity
        jobs = groups[key]
        total = sum(len(oj.pending) for oj in jobs)
        target = _auto_chunk(
            total, jobs[0].num_pickers, key.capacity, key.n_dev
        )
        # deal onto the shape ladder: either fill (>= 3/4) the next
        # ladder size up, or deal the ladder size below in full —
        # so arrival-pattern noise can never mint a new chunk shape
        # (every distinct shape is a new program signature) and padding
        # waste stays bounded at 1/4 of a chunk.  The PADDED size
        # must respect the memory-budget cap too: stepping up to
        # ``hi`` is only allowed when ``hi`` itself fits the cap
        # (a target of 8 dealt in full would pad to 16 — twice the
        # budget); otherwise deal the ladder size below, whose pad
        # is itself (the MIN_CHUNK_PAD floor is the one deliberate
        # exception, documented on _padded_micrographs)
        avail = min(total, target)
        lo, hi = self._ladder_around(avail)
        if hi <= target and avail >= max((3 * hi) // 4, lo + 1):
            target = min(avail, hi)
        else:
            target = min(avail, lo)
        # fair share: deal slots round-robin with a rotating first
        # pick, keyed by TENANT above the per-job rotation — a burst
        # of small jobs rides along with a large one, and one noisy
        # tenant's many open jobs cannot crowd a quiet tenant's one
        # job out of the chunk (each tenant gets one slot per round).
        # When the error budget is burning (or the fleet is in
        # brownout) the FIRST PICK stops rotating and goes earliest-
        # deadline-first instead: under pressure the leftover slots
        # of an uneven deal belong to the jobs closest to blowing
        # their deadline, not to whoever arrival order favors.  The
        # per-tenant one-slot-per-round deal is unchanged, so EDF
        # reorders urgency WITHIN fairness bounds rather than letting
        # one tight-deadline tenant starve the rest.
        if self._edf_active():
            self._dealing = "edf"
            order = sorted(
                jobs,
                key=lambda oj: (
                    oj.job.deadline_ts is None,
                    oj.job.deadline_ts
                    if oj.job.deadline_ts is not None
                    else 0.0,
                    oj.job.accepted_ts,
                ),
            )
        else:
            self._dealing = "round_robin"
            self._rr += 1
            start = self._rr % len(jobs)
            order = jobs[start:] + jobs[:start]
        alloc = self._deal(order, target)
        parts = []
        for oj in order:
            n = alloc[id(oj)]
            if n:
                parts.append((oj, oj.pending[:n]))
                del oj.pending[:n]
        return parts or None

    @staticmethod
    def _deal(order, target: int) -> dict:
        """Deal ``target`` chunk slots across the group's open jobs:
        one slot per TENANT per round (tenants rotate in ``order``'s
        rotation), and within a tenant one slot per job per ITS
        round.  With a single tenant (or no tenancy — tenant None)
        this degenerates to the original per-job round-robin; with
        several it is micrograph-level fair share per tenant.
        Returns ``{id(open_job): slots}``."""
        by_tenant: dict = {}
        tenant_order: list = []
        for oj in order:
            t = getattr(oj.job, "tenant", None)
            if t not in by_tenant:
                by_tenant[t] = []
                tenant_order.append(t)
            by_tenant[t].append(oj)
        alloc = {id(oj): 0 for oj in order}
        nxt = dict.fromkeys(tenant_order, 0)
        dealt = 0
        while dealt < target:
            progressed = False
            for t in tenant_order:
                if dealt >= target:
                    break
                tjobs = by_tenant[t]
                for k in range(len(tjobs)):
                    oj = tjobs[(nxt[t] + k) % len(tjobs)]
                    if alloc[id(oj)] < len(oj.pending):
                        alloc[id(oj)] += 1
                        dealt += 1
                        progressed = True
                        nxt[t] = (nxt[t] + k + 1) % len(tjobs)
                        break
            if not progressed:
                break
        return alloc

    def _edf_active(self) -> bool:
        """Deadline-first dealing engages while the ``job`` error
        budget burns at or above :data:`EDF_BURN`, or while the
        fleet is in any brownout stage (the autoscaler has already
        judged the budget tight — admission is shedding, so what IS
        admitted should finish by deadline).  Either signal absent
        (no tracker, no objective, no supervisor) reads as calm."""
        slo = getattr(getattr(self, "daemon", None), "slo", None)
        if slo is not None:
            burn = slo.budget_burn("job")
            if burn is not None and burn >= self.EDF_BURN:
                return True
        brownout = getattr(
            getattr(self, "queue", None), "_brownout", None
        )
        return brownout is not None and brownout.level() >= 1

    def _ladder_around(self, m: int) -> tuple:
        """The chunk-shape ladder values bracketing ``m``: powers of
        4 from ``MIN_CHUNK_PAD`` (4, 16, 64, ...).  Deliberately
        SPARSE — the micrograph axis takes whatever the deal
        produced, and on a fine grid every open-job mix would mint
        its own shape (a program-cache miss, and in the reference a
        full compile).  A mixed small-job burst runs ~2 shapes per
        capacity bucket where the single-job scheduler runs one per
        job size."""
        lo = self.MIN_CHUNK_PAD
        while lo * 4 <= m:
            lo *= 4
        return lo, lo * 4

    def _padded_micrographs(self, m_real: int, key: CoalesceKey):
        """Pad the dealt chunk up to its ladder shape (and to a
        multiple of the mesh)."""
        b = self.MIN_CHUNK_PAD
        while b < m_real:
            b *= 4
        return -(-b // key.n_dev) * key.n_dev

    # -- execution ----------------------------------------------------

    def _execute(self, parts) -> None:
        from repic_tpu_torch.parallel.batching import pad_batch
        from repic_tpu_torch.pipeline import engine
        from repic_tpu_torch.pipeline.consensus import run_consensus_batch

        key = parts[0][0].key
        flat = [item for _, items in parts for item in items]
        m_real = len(flat)
        m_pad = self._padded_micrographs(m_real, key)
        opt = parts[0][0].options
        box_size = parts[0][0].box_size
        hits_c = telemetry.counter("repic_program_cache_hits_total")
        miss_c = telemetry.counter(
            "repic_program_cache_misses_total"
        )
        t_mark = time.time()
        comp_mark = tlm_probes.compile_seconds()
        hits_mark = hits_c.value()
        miss_mark = miss_c.value()
        ckey = f"chunk:{flat[0][0]}:{m_real}"
        try:
            batch = pad_batch(
                flat,
                pad_micrographs_to=m_pad,
                capacity=key.capacity,
            )
            # the chunk's spans (consensus_chunk + the
            # consensus_dispatch inside) carry the LEAD participant's
            # trace id — one span cannot split across requests, so
            # the oldest job in the deal owns it; its per-job share
            # attribution happens at the trace-segment layer below
            lead = tlm_trace.activate(parts[0][0].tctx)
            try:
                with tlm_events.span(
                    "consensus_chunk",
                    micrographs=m_real,
                    capacity=key.capacity,
                    coalesced_jobs=len(parts),
                ):
                    faults.inject("oom", ckey)
                    faults.inject("io", ckey)
                    mesh = engine.request_mesh(opt, self.daemon.device)
                    _res, packed = run_consensus_batch(
                        batch,
                        box_size,
                        threshold=opt.threshold,
                        max_neighbors=opt.max_neighbors,
                        spatial=opt.spatial,
                        solver=opt.solver,
                        use_pallas=opt.use_pallas,
                        device=mesh[0],
                        mesh=mesh,
                    )
            finally:
                tlm_trace.deactivate(lead)
        except Exception as e:  # noqa: BLE001 — isolation fallback
            self._fallback(parts, e)
            return
        now = time.time()
        chunk_s = max(now - t_mark, 0.0)
        compile_s = min(
            max(tlm_probes.compile_seconds() - comp_mark, 0.0),
            chunk_s,
        )
        hits_d = int(hits_c.value() - hits_mark)
        miss_d = int(miss_c.value() - miss_mark)
        _BATCHES.inc()
        _BATCHED_MICS.inc(m_real)
        _OCCUPANCY.observe(m_real / max(batch.xy.shape[0], 1))
        _COALESCED.observe(len(parts))
        row = 0
        for oj, items in parts:
            rows = packed[row : row + len(items)]
            row += len(items)
            share = len(items) / m_real
            token = tlm_trace.activate(oj.tctx)
            try:
                # compile gates every participant (it is genuinely
                # shared), so each gets the full segment with the
                # cache-counter deltas — "was I served warm" stays
                # answerable per request; execute carries the job's
                # SHARE of the chunk (micrograph-proportional)
                if (
                    oj.chunk_i == 0
                    or compile_s > 0.0
                    or hits_d
                    or miss_d
                ):
                    tlm_trace.add_segment(
                        "compile", now - chunk_s, compile_s,
                        chunk=oj.chunk_i,
                        cache_hits=hits_d,
                        cache_misses=miss_d,
                        coalesced_jobs=len(parts),
                    )
                tlm_trace.add_segment(
                    "execute",
                    now - chunk_s + compile_s,
                    max(chunk_s - compile_s, 0.0) * share,
                    chunk=oj.chunk_i,
                    micrographs=len(items),
                    capacity=key.capacity,
                    coalesced_jobs=len(parts),
                    share=round(share, 4),
                )
                with tlm_trace.segment(
                    "emit", chunk=oj.chunk_i,
                    micrographs=len(items),
                ):
                    sub = SimpleNamespace(
                        names=tuple(nm for nm, _ in items)
                    )
                    oj.counts.update(
                        engine.emit_box_chunk(
                            sub, rows, oj.box_size,
                            num_particles=oj.options.num_particles,
                            sink=oj.sink,
                        )
                    )
                    for nm, _sets in items:
                        oj.journal.record(
                            nm,
                            oj.outcomes.status.get(nm, "ok"),
                            wall_s=round(
                                chunk_s / max(m_real, 1), 6
                            ),
                            solver=oj.options.solver,
                            particles=oj.counts.get(nm),
                            out=nm + ".box",
                        )
                    oj.job.progress["chunks_done"] = oj.chunk_i + 1
                    oj.job.progress["micrographs_done"] = (
                        len(oj.already) + len(oj.counts)
                    )
                    # no per-chunk flush_run here: a coalesced chunk
                    # touches up to max_open jobs and each flush is
                    # two atomic file writes — the background
                    # flusher (REPIC_TPU_FLUSH_S) keeps mid-job
                    # sinks fresh, finish_run writes the final ones
            finally:
                tlm_trace.deactivate(token)
            crash_point(f"run:{oj.job.id}:chunk:{oj.chunk_i}")
            if self.daemon.fleet is not None:
                from repic_tpu_torch.serve import fleet as fleet_mod

                fleet_mod.crash_point(
                    self.daemon.fleet.replica,
                    f"chunk:{oj.job.id}:{oj.chunk_i}",
                )
            oj.chunk_i += 1

    def _fallback(self, parts, exc: BaseException) -> None:
        """A failed coalesced chunk demotes every participant to the
        single-job path: micrographs already emitted stay on disk
        (journaled), so the solo re-run RESUMES rather than redoes —
        and its full ladder isolates whichever request poisoned the
        batch while the healthy ones complete."""
        _FALLBACKS.inc()
        _log.info(
            f"coalesced chunk failed ({exc}); demoting "
            f"{len(parts)} job(s) to the single-job path"
        )
        for oj, items in parts:
            oj.pending[:0] = items  # hand back, order preserved
        for oj, _items in parts:
            oj.journal.record_event(
                "coalesce_fallback", error=str(exc)[:200]
            )
            self._close(oj)
            try:
                self.daemon._run_job(oj.job)
            except Exception as e:  # noqa: BLE001 - last resort
                self._fail_bare(oj.job, e)
            self.daemon.publish_status()

    # -- boundaries ---------------------------------------------------

    def _poll_boundaries(self) -> None:
        for oj in list(self._open):
            try:
                reason = oj.cancel()
            except Exception:  # noqa: BLE001 - poll never kills
                continue
            if reason:
                self._cancelled(oj, reason)

    def _cancelled(self, oj: OpenJob, reason) -> None:
        job = oj.job
        reason = reason if isinstance(reason, str) else "cancelled"
        job.reason = reason
        try:
            if reason.startswith("fenced"):
                # a survivor owns the job now: stop without a terminal
                # record -- the winner's commit is the one
                self.queue.abandon(job)
                self._close(oj)
                return
            if reason.startswith("deadline"):
                state = JOB_DEADLINE_EXCEEDED
            elif reason.startswith("draining"):
                # back to queued, journaled for the next generation
                state = JOB_QUEUED
            else:
                state = JOB_CANCELLED
            self.daemon._finish_job(job, state, reason=reason)
            self._close(oj)
        except Exception as e:  # noqa: BLE001 - last resort
            self._fail(oj, e)

    def _finish_completed(self) -> None:
        for oj in list(self._open):
            if oj.pending:
                continue
            try:
                self._finalize(oj)
            except Exception as e:  # noqa: BLE001 - last resort
                self._fail(oj, e)

    def _finalize(self, oj: OpenJob) -> None:
        from repic_tpu_torch.serve.daemon import _JOB_SECONDS

        daemon = self.daemon
        job = oj.job
        t_finish0 = time.time()
        quarantined = dict(oj.quarantined)
        quarantined.update(oj.outcomes.quarantined)
        job.result = {
            "micrographs": len(oj.names),
            "resumed_micrographs": len(oj.already),
            "particles": int(sum(oj.counts.values())),
            "quarantined": len(quarantined),
            "out_dir": oj.out_dir,
            "journal": oj.journal.summary(),
        }
        oj.journal.close()
        crash_point(f"finish:{job.id}")
        token = tlm_trace.activate(oj.tctx)
        try:
            tlm_trace.add_segment(
                "finish", t_finish0, time.time() - t_finish0
            )
        finally:
            tlm_trace.deactivate(token)
        # terminal record FIRST, sink/trace teardown after: the
        # teardown writes files, and milliseconds of it inside the
        # accept->finished_ts wall would break the segment-sum ~=
        # wall contract for warm sub-100ms jobs
        wall = daemon._clock() - oj.t0
        _JOB_SECONDS.observe(
            wall,
            bucket=str(job.progress.get("capacity", "none")),
        )
        daemon._finish_job(
            job, JOB_FINISHED,
            wall_s=round(wall, 3),
            particles=job.result["particles"],
            quarantined=job.result["quarantined"],
        )
        self.queue.breaker.record_success(job.tenant)
        self._drop(oj)
        telemetry.finish_run(oj.rt)
        oj.tctx.close()

    # -- cleanup / failure --------------------------------------------

    def _drop(self, oj: OpenJob) -> None:
        if oj in self._open:
            self._open.remove(oj)
        _OPEN.set(len(self._open))

    def _close(self, oj: OpenJob) -> None:
        self._drop(oj)
        try:
            oj.journal.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass
        telemetry.finish_run(oj.rt)
        oj.tctx.close()

    def _fail_bare(self, job: Job, exc: BaseException) -> None:
        """The worker-loop last-resort shape: the job FAILS (visible
        to its client, counted by the breaker and the SLO plane) and
        the scheduler keeps running."""
        try:
            job.error = self.queue.error_doc(exc)
            self.daemon._finish_job(job, JOB_FAILED, error=job.error)
        except Exception:  # noqa: BLE001 - the journal may be down
            self.queue.mark_failed(job)
        self.queue.breaker.record_failure(job.tenant)
        _log.error(f"job {job.id} failed: {exc}")
        return None

    def _fail(self, oj: OpenJob, exc: BaseException) -> None:
        self._close(oj)
        self._fail_bare(oj.job, exc)
