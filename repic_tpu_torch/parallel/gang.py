"""Gang-scheduled multi-process consensus with elastic re-formation
(the port of ``repic_tpu.parallel.gang``, same files and formats).

The cluster runtime (:mod:`repic_tpu_torch.runtime.cluster`) makes N
*independent* hosts fault-tolerant: heartbeats, leases, fencing and
merged journals recover work when a host dies between chunks.  A gang
runs every chunk as one job across its processes, joined by a
*collective*: each process runs its own rows of the chunk, then the
processes agree on the chunk's escalation probes with an all-reduce
(and, before the first chunk, on the batch capacity and spatial
extent).  A dead or wedged peer leaves every survivor stuck in, or
failing out of, that collective, so heartbeats alone unblock no one.
This module supervises the gang and makes the loss of a process
mid-collective a recoverable event:

* **collective watchdog** -- every dispatch runs in a worker thread
  under a deadline derived from the decayed per-chunk service time
  (:class:`ServiceTimeEstimator`).  A dispatch that outlives it is
  *diagnosed*, not killed, from the same file-based liveness view the
  cluster runtime uses
  (:func:`repic_tpu_torch.runtime.cluster.read_liveness`): a stuck
  dispatch plus a heartbeat-dead peer is a **gang fault**; a stuck
  dispatch with every peer live is a slow chunk, whose deadline
  extends a bounded number of times before the stall itself is a
  fault.  Where XLA's collective hangs when a peer dies, gloo's may
  fail instead (a reset connection): such a failure
  (:class:`~repic_tpu_torch.parallel.distributed.CollectiveError`)
  is classified as the stuck dispatch it stands for.
* **coordinated abort + elastic re-formation** -- on a gang fault
  every survivor abandons the dispatch thread (it holds no locks),
  leaves the epoch's group, and re-forms a smaller gang: survivors
  elect the lowest-rank live host as leader, the leader publishes an
  **epoch record** (``_gang_epoch.<E>.json``, ``O_EXCL``: exactly one
  wins) naming the new coordinator -- a store the leader hosts at
  ``reform_port_base + E``, or 100 ports on while another program
  holds that one -- the world size, the members and the
  remaining todo re-derived from the merged journals, and every
  member joins the new group.  When re-formation cannot produce a
  viable gang (below ``min_world``, no record, a failed join) the
  survivors degrade to independent per-host execution over
  deterministic shares of the remainder.
* **epoch write-fencing** -- every gang-mode journal record carries
  ``gang_epoch``; merged journal folds order by (epoch, timestamp)
  (:func:`repic_tpu_torch.runtime.journal.merged_latest`), so a fenced
  straggler that unwedges after the survivors re-formed writes records
  that lose the fold, and survivors also fence dead members with the
  cluster fence files, so a merely wedged host stops at its next
  boundary.

The collectives travel on a ``gloo`` group over CPU tensors
(:func:`~repic_tpu_torch.parallel.distributed.init_gang_group`): the
vectors are host integers the chunk loop fetches anyway, and several
processes of a gang may share one card, where NCCL refuses two ranks.

Identity defaults from torchrun's environment (``MASTER_ADDR`` and
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a single process forms a
gang of one -- the same code path, no group.

Three fault sites (:mod:`repic_tpu_torch.runtime.faults`):
``gang_peer_crash`` (the process dies through ``os._exit`` right
before the collective -- the SIGKILL stand-in), ``gang_peer_stall``
(this host's dispatch wedges while its heartbeat keeps renewing) and
``coordinator_loss`` (the coordinator becomes unreachable mid-wait).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass

from repic_tpu_torch.parallel.distributed import CollectiveError
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.cluster import (
    fence_path,
    read_liveness,
    try_claim,
)
from repic_tpu_torch.runtime.ladder import HOST_LIVE

GANG_EPOCH_PREFIX = "_gang_epoch."
GANG_MEMBER_PREFIX = "_gang_member."

#: exit status of a ``gang_peer_crash`` firing — the multi-process
#: chaos harness tells an injected mid-collective death apart from
#: ordinary failures by this code (cluster/serve/fleet/poison
#: crashes already claim 23-26)
GANG_CRASH_EXIT_CODE = 27

#: how long a ``gang_peer_stall`` firing wedges the dispatch thread —
#: far past any watchdog deadline, so the stall is indistinguishable
#: from a real stuck collective to the supervisor
_STALL_S = 3600.0

_POLL_S = 0.05


class GangError(RuntimeError):
    """Base class for gang-supervision failures."""


class GangFenced(GangError):
    """The re-formed gang presumed THIS host dead (or a survivor
    fenced it) — stop processing; late writes lose by epoch."""


class GangFault(GangError):
    """A wedged or failed gang dispatch classified as a gang-level
    fault (never a slow chunk): carries the diagnosis the abort /
    re-formation path acts on."""

    def __init__(self, message: str, *, kind: str, dead=(),
                 oom: bool = False):
        super().__init__(message)
        self.kind = kind          # peer_dead | stall | coordinator_loss
        self.dead = tuple(dead)   # heartbeat-dead member host ids
        self.oom = oom


@dataclass(frozen=True)
class GangConfig:
    """Operator-facing knobs for gang execution (CLI: ``--gang`` and
    friends on ``repic-tpu consensus``).

    Identity fields default from torchrun's environment
    (``MASTER_ADDR:MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``); a
    single-process launch forms a degenerate gang of one — same code
    path, no group.
    """

    coordinator_address: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    #: below this surviving world size re-formation gives up and the
    #: survivors degrade to independent per-host execution
    min_world: int = 1
    #: watchdog deadline = max(floor, factor * decayed service time)
    watchdog_factor: float = 4.0
    watchdog_floor_s: float = 10.0
    #: deadline for dispatches with no service-time estimate yet or a
    #: first run of a program signature ahead of them (on the card a
    #: kernel library may still be built or loaded then)
    first_deadline_s: float = 600.0
    #: deadline extensions granted while every peer is still live
    #: before the stall itself is declared a gang fault
    max_extensions: int = 2
    #: how long a survivor waits for the new epoch record / re-init
    reform_timeout_s: float = 60.0
    #: bounded re-formation attempts before degrading
    reform_attempts: int = 2
    #: total gang faults tolerated before the run degrades to
    #: independent execution outright (a poison chunk must not
    #: re-form the gang forever)
    max_faults: int = 8
    #: re-formation coordinator port = reform_port_base + epoch
    #: (default: the epoch-1 coordinator port + 101, else 7711)
    reform_port_base: int | None = None
    #: address peers can reach THIS host on for a re-formation
    #: coordinator (the simulated harness stays on localhost)
    advertise_host: str = "127.0.0.1"
    #: heartbeat age that marks a gang member dead; None = adopt the
    #: cluster context's host_timeout_s at bind time
    host_timeout_s: float | None = None
    allow_degrade: bool = True

    def __post_init__(self):
        if self.watchdog_factor <= 1.0:
            raise ValueError(
                "watchdog_factor must exceed 1.0 (a deadline under "
                "one service time declares every chunk stuck)"
            )
        if self.min_world < 1:
            raise ValueError("min_world must be >= 1")


class ServiceTimeEstimator:
    """Decayed per-chunk service time -> watchdog deadline.

    An exponentially-decayed mean (not a max): the deadline must
    follow the workload both up (denser directories) and down, and a
    single slow outlier must not permanently inflate the fault
    horizon.  Only SUCCESSFUL dispatches are observed — a wedged
    chunk's wall time is the failure being measured, not a sample.
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.ema: float | None = None

    def observe(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        self.ema = (
            s if self.ema is None
            else self.alpha * s + (1.0 - self.alpha) * self.ema
        )

    def deadline(self, cfg: GangConfig,
                 fresh_compile: bool = False) -> float:
        if self.ema is None or fresh_compile:
            return float(cfg.first_deadline_s)
        return max(
            float(cfg.watchdog_floor_s),
            cfg.watchdog_factor * self.ema,
        )


def epoch_record_path(coord_dir: str, epoch: int) -> str:
    return os.path.join(
        coord_dir, f"{GANG_EPOCH_PREFIX}{int(epoch)}.json"
    )


def member_path(coord_dir: str, host: str) -> str:
    return os.path.join(
        coord_dir, f"{GANG_MEMBER_PREFIX}{host}.json"
    )


def read_epoch_record(coord_dir: str, epoch: int) -> dict | None:
    try:
        with open(epoch_record_path(coord_dir, epoch)) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None


def latest_epoch(coord_dir: str) -> int:
    """Highest epoch with a published record (0 = none yet)."""
    import glob as _glob

    best = 0
    for path in _glob.glob(
        os.path.join(coord_dir, f"{GANG_EPOCH_PREFIX}*.json")
    ):
        stem = os.path.basename(path)[
            len(GANG_EPOCH_PREFIX):-len(".json")
        ]
        try:
            best = max(best, int(stem))
        except ValueError:
            continue
    return best


def _default_init_runtime(coordinator, world, rank, timeout_s):
    """The epoch's ``torch.distributed`` gang group (a store at
    ``coordinator``, a gloo group over it)."""
    from repic_tpu_torch.parallel import distributed

    distributed.init_gang_group(coordinator, world, rank, timeout_s)


def _default_shutdown_runtime() -> bool:
    from repic_tpu_torch.parallel import distributed

    return distributed.shutdown()


class GangSupervisor:
    """This host's handle on gang execution: formation, the dispatch
    watchdog, fault classification, and abort / re-formation.

    The ``torch.distributed`` operations are injectable
    (``init_runtime`` / ``shutdown_runtime``) so the protocol — census, election, epoch
    records, fencing, degrade — is unit-testable against a tmp
    coordination directory with no distributed backend at all.
    """

    def __init__(
        self,
        cfg: GangConfig,
        coord_dir: str,
        *,
        clock=time.time,
        init_runtime=_default_init_runtime,
        shutdown_runtime=_default_shutdown_runtime,
    ):
        self.cfg = cfg
        self.coord_dir = coord_dir
        self._clock = clock
        self._init_runtime = init_runtime
        self._shutdown_runtime = shutdown_runtime
        from repic_tpu_torch.parallel.distributed import _env_int

        self.estimator = ServiceTimeEstimator()
        self.epoch = 0
        self._formation_epoch = 1
        self.mode = "forming"      # forming | gang | independent
        # launch env parses share distributed._env_int: a garbage
        # WORLD_SIZE must fail naming the variable+value here too
        # (the supervisor constructs BEFORE the group forms)
        self.world = int(
            cfg.num_processes
            if cfg.num_processes is not None
            else (_env_int("WORLD_SIZE") or 1)
        )
        self.rank = int(
            cfg.process_id
            if cfg.process_id is not None
            else (_env_int("RANK") or 0)
        )
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        self.coordinator = cfg.coordinator_address or (
            f"{addr}:{port}" if addr and port else None
        )
        self.host: str | None = None       # bound after cluster start
        self.journal = None
        self.cluster_ctx = None
        self._host_timeout = cfg.host_timeout_s or 10.0
        self.faults_seen = 0
        self.reformations = 0

    # -- formation ----------------------------------------------------

    def form_runtime(self) -> bool:
        """The formation epoch's group (the store at the launch's
        coordinator and a gloo group; the constructors are the
        formation barrier, waiting ``reform_timeout_s`` for the
        peers).  Returns True for a real multi-process gang.

        The formation epoch is ``latest_epoch + 1`` over the
        coordination directory, scanned BEFORE the formation
        barrier: a relaunched run over a directory holding a dead
        generation's ``_gang_epoch.<E>.json`` records must outrank
        them (its journal records would otherwise lose the merged
        fold, and a re-formation would adopt a stale record).  The
        pre-barrier scan is race-free — new records are only written
        after every member passed the barrier — so all members
        derive the same epoch."""
        self.epoch = latest_epoch(self.coord_dir) + 1
        #: records below this are a previous generation's leftovers
        self._formation_epoch = self.epoch
        if self.world > 1:
            if not self.coordinator:
                raise ValueError(
                    "repic_tpu_torch.parallel.gang: "
                    f"{self.world} processes but no coordinator "
                    "address (set MASTER_ADDR and MASTER_PORT, or "
                    "pass coordinator_address)"
                )
            _default_init_runtime(
                self.coordinator, self.world, self.rank,
                self.cfg.reform_timeout_s,
            )
        self.mode = "gang"
        return self.world > 1

    def bind(self, journal, cluster_ctx) -> None:
        """Attach the run's journal + cluster context (identity and
        liveness), publish this member, and journal ``gang_formed``.
        Called once the run directory exists — after
        :meth:`form_runtime`."""
        from repic_tpu_torch.runtime.atomic import atomic_write

        self.journal = journal
        self.cluster_ctx = cluster_ctx
        self.host = cluster_ctx.host
        if self.cfg.host_timeout_s is None:
            self._host_timeout = cluster_ctx.cfg.host_timeout_s
        with atomic_write(
            member_path(self.coord_dir, self.host)
        ) as f:
            json.dump(
                {
                    "host": self.host,
                    "rank": self.rank,
                    "address": self.cfg.advertise_host,
                    "epoch": self.epoch,
                    "ts": self._clock(),
                },
                f,
            )
        if self.rank == 0:
            try_claim(
                epoch_record_path(self.coord_dir, self.epoch),
                {
                    "epoch": self.epoch,
                    "world": self.world,
                    "coordinator": self.coordinator,
                    "members": None,  # launch ranks 0..world-1
                    "todo": None,     # derived from merged journals
                    "chunk": None,
                    "ts": self._clock(),
                },
            )
        if self.journal is not None:
            self.journal.record_event(
                "gang_formed",
                gang_epoch=self.epoch,
                world=self.world,
                rank=self.rank,
                coordinator=self.coordinator,
            )
        self._publish_state()

    # -- telemetry ----------------------------------------------------

    def _publish_state(self) -> None:
        _gauge(
            "repic_gang_epoch",
            "current gang epoch (bumped at every re-formation)",
        ).set(self.epoch)
        _gauge(
            "repic_gang_world_size",
            "processes in the current gang (0 once degraded to "
            "independent execution)",
        ).set(self.world if self.mode == "gang" else 0)
        _gauge(
            "repic_gang_degraded",
            "1 when gang execution degraded to independent per-host "
            "mode",
        ).set(1 if self.mode == "independent" else 0)
        try:
            from repic_tpu_torch.telemetry import server as tlm_server

            tlm_server.set_status(
                gang={
                    "epoch": self.epoch,
                    "mode": self.mode,
                    "world": self.world,
                    "rank": self.rank,
                    "faults": self.faults_seen,
                    "reformations": self.reformations,
                    "coordination_dir": os.path.abspath(
                        self.coord_dir
                    ),
                    "host_timeout_s": self._host_timeout,
                }
            )
        except Exception:  # pragma: no cover - status is best-effort
            pass

    # -- liveness (cluster machinery, verbatim) -----------------------

    def members(self) -> dict[str, dict]:
        """Published gang member records (host -> record).

        Records whose epoch predates THIS run's formation epoch are
        a previous generation's leftovers (a relaunch over the same
        coordination directory) — excluded, or their phantom hosts
        would read as heartbeat-dead peers and fault every dispatch.
        """
        import glob as _glob

        out: dict[str, dict] = {}
        for path in _glob.glob(
            os.path.join(
                self.coord_dir, f"{GANG_MEMBER_PREFIX}*.json"
            )
        ):
            try:
                with open(path) as f:
                    rec = json.load(f)
            except (OSError, ValueError):
                continue
            if not (isinstance(rec, dict) and rec.get("host")):
                continue
            try:
                rec_epoch = int(rec.get("epoch", 0) or 0)
            except (TypeError, ValueError):
                rec_epoch = 0
            if rec_epoch < self._formation_epoch:
                continue
            out[rec["host"]] = rec
        return out

    def dead_peers(self) -> list[str]:
        """Gang members whose heartbeat rung is no longer live — the
        classification input that turns a stuck dispatch into a gang
        fault.  Reuses the cluster liveness view verbatim."""
        view = read_liveness(
            self.coord_dir, self._host_timeout, now=self._clock()
        )
        dead = []
        for host in self.members():
            if host == self.host:
                continue
            st = view.get(host)
            if st is None or st.rung != HOST_LIVE:
                dead.append(host)
        return sorted(dead)

    def survivors(self) -> list[tuple[int, str]]:
        """``(rank, host)`` of live, unfenced members (self always
        included), sorted by original rank — the census every
        survivor derives the SAME new gang from."""
        view = read_liveness(
            self.coord_dir, self._host_timeout, now=self._clock()
        )
        out = []
        for host, rec in self.members().items():
            if host == self.host:
                out.append((int(rec.get("rank", 0)), host))
                continue
            st = view.get(host)
            if st is not None and st.rung == HOST_LIVE:
                out.append((int(rec.get("rank", 0)), host))
        return sorted(out)

    # -- the collective watchdog --------------------------------------

    def dispatch(self, fn, *, key: str, fresh_compile: bool = False):
        """Run one gang dispatch under the watchdog.

        ``fn`` executes in a daemon worker thread (a wedged
        collective must be abandonable — it cannot be interrupted).
        Ordinary exceptions from ``fn`` propagate unchanged (the
        caller's retry/escalation ladders own those); a deadline
        overrun is classified here: heartbeat-dead peer ->
        :class:`GangFault` (``peer_dead``), everyone live -> bounded
        deadline extensions, then :class:`GangFault` (``stall``).  A
        :class:`~repic_tpu_torch.parallel.distributed.CollectiveError`
        from ``fn`` (a peer's connection gone) is the same wedged
        dispatch: it raises ``peer_dead`` as soon as the liveness view
        shows the dead peer, and a ``stall`` no earlier than two host
        timeouts after the failure, so the view has time to settle.
        The loop makes no torch call.
        """
        ckey = f"{self.host}:{key}"
        if faults.check("gang_peer_crash", ckey):
            os._exit(GANG_CRASH_EXIT_CODE)
        box: dict = {}
        done = threading.Event()

        def _run():
            try:
                if faults.check("gang_peer_stall", ckey):
                    time.sleep(_STALL_S)
                box["result"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised
                box["error"] = e
            finally:
                done.set()

        th = threading.Thread(
            target=_run,
            name=f"repic-gang-dispatch-{key}",
            daemon=True,
        )
        t0 = time.monotonic()
        base_deadline = self.estimator.deadline(
            self.cfg, fresh_compile=fresh_compile
        )
        _gauge(
            "repic_gang_dispatch_deadline_seconds",
            "watchdog deadline applied to the current SPMD dispatch",
        ).set(base_deadline)
        deadline = base_deadline
        extensions = 0
        broken = False
        th.start()
        while True:
            if broken:
                time.sleep(_POLL_S)
            else:
                done.wait(timeout=_POLL_S)
            if done.is_set() and not broken:
                err = box.get("error")
                if err is None:
                    self.estimator.observe(time.monotonic() - t0)
                    return box["result"]
                if not isinstance(err, CollectiveError):
                    raise err
                broken = True
                deadline = max(
                    deadline,
                    time.monotonic() - t0 + 2.0 * self._host_timeout,
                )
            if faults.check("coordinator_loss", ckey):
                self.faults_seen += 1
                _counter(
                    "repic_gang_faults_total",
                    "SPMD dispatches classified as gang faults",
                ).inc()
                raise GangFault(
                    f"distributed coordinator unreachable during "
                    f"{key}",
                    kind="coordinator_loss",
                    dead=self.dead_peers(),
                )
            if self.cluster_ctx is not None:
                self.cluster_ctx.ensure_not_fenced()
            if broken:
                dead = self.dead_peers()
                if dead:
                    self.faults_seen += 1
                    _counter(
                        "repic_gang_faults_total",
                        "SPMD dispatches classified as gang faults",
                    ).inc()
                    raise GangFault(
                        f"collective of {key} failed with "
                        f"heartbeat-dead peer(s) {dead} — peer lost "
                        "mid-collective",
                        kind="peer_dead",
                        dead=dead,
                    )
            if time.monotonic() - t0 < deadline:
                continue
            _counter(
                "repic_gang_watchdog_timeouts_total",
                "watchdog deadline overruns observed on SPMD "
                "dispatches",
            ).inc()
            dead = self.dead_peers()
            if dead:
                self.faults_seen += 1
                _counter(
                    "repic_gang_faults_total",
                    "SPMD dispatches classified as gang faults",
                ).inc()
                raise GangFault(
                    f"dispatch {key} exceeded its "
                    f"{deadline:.1f}s deadline with heartbeat-dead "
                    f"peer(s) {dead} — peer lost mid-collective",
                    kind="peer_dead",
                    dead=dead,
                )
            if extensions >= self.cfg.max_extensions:
                self.faults_seen += 1
                _counter(
                    "repic_gang_faults_total",
                    "SPMD dispatches classified as gang faults",
                ).inc()
                raise GangFault(
                    f"dispatch {key} still running after "
                    f"{extensions} deadline extension(s) with every "
                    "peer live — collective wedged",
                    kind="stall",
                )
            extensions += 1
            deadline += base_deadline
            _counter(
                "repic_gang_watchdog_extensions_total",
                "deadline extensions granted while every peer was "
                "live",
            ).inc()

    # -- abort and elastic re-formation -------------------------------

    def record_fault(self, fault: GangFault, *, chunk: int,
                     context: str) -> None:
        """Journal the classified fault (epoch-tagged) — the caller's
        half of the abort; the leader's re-formation scan reads these
        events back for OOM chunk suggestions."""
        if self.journal is not None:
            self.journal.record_event(
                "gang_fault",
                gang_epoch=self.epoch,
                kind=fault.kind,
                dead=list(fault.dead),
                oom=bool(fault.oom),
                chunk=int(chunk),
                context=context,
            )

    def _fence_dead(self, dead) -> None:
        for host in dead:
            if try_claim(
                fence_path(self.coord_dir, host),
                {
                    "host": host,
                    "fenced_by": self.host,
                    "gang_epoch": self.epoch,
                    "ts": self._clock(),
                },
            ) and self.journal is not None:
                self.journal.record_event(
                    "host_fenced", suspect=host, by=self.host,
                    gang_epoch=self.epoch,
                )

    def _reform_port(self, epoch: int) -> int:
        base = self.cfg.reform_port_base
        if base is None:
            try:
                base = int(
                    str(self.coordinator).rsplit(":", 1)[1]
                ) + 101
            except (IndexError, ValueError, TypeError):
                base = 7711
        return int(base) + int(epoch)

    def _free_reform_port(self, epoch: int) -> int:
        """:meth:`_reform_port`, or 100 ports on (up to 9 times) while
        this host cannot bind it: a store that cannot bind its port
        leaves every follower waiting out its connect timeout on a
        port another program holds."""
        port = self._reform_port(epoch)
        for _ in range(9):
            with socket.socket() as sock:
                try:
                    sock.bind(("", port))
                    break
                except OSError:
                    port += 100
        return port

    def _oom_suggested(self) -> bool:
        """Any member journaled an OOM-flagged gang fault for the
        current epoch?  (Leader-side scan of the merged journals —
        the chunk size is part of the epoch record, so halving must
        be a gang-wide decision, never a local one.)"""
        from repic_tpu_torch.runtime.journal import read_all_journals

        if self.journal is None:
            return False
        for e in read_all_journals(self.journal.out_dir):
            if (
                e.get("event") == "gang_fault"
                and int(e.get("gang_epoch", 0) or 0) == self.epoch
                and e.get("oom")
            ):
                return True
        return False

    def reform(self, remaining_todo, *, chunk: int,
               oom: bool = False) -> str:
        """Coordinated abort + elastic re-formation.

        Returns the resulting mode: ``"gang"`` (a smaller gang
        formed; ``epoch``/``world``/``rank`` updated and
        ``gang_reformed`` journaled) or ``"independent"`` (degraded;
        ``gang_degraded`` journaled).  Raises :class:`GangFenced`
        when the new gang presumed this host dead, or
        :class:`GangError` when re-formation failed and degrading is
        disabled.
        """
        reason = "reform-exhausted"
        for attempt in range(max(self.cfg.reform_attempts, 1)):
            self._shutdown_runtime()
            cur = self.survivors()
            if len(cur) < self.cfg.min_world:
                reason = (
                    f"{len(cur)} survivor(s) < min_world="
                    f"{self.cfg.min_world}"
                )
                break
            dead = [
                h for h in self.members()
                if h not in {host for _r, host in cur}
            ]
            self._fence_dead(dead)
            # attempt a targets epoch E+1+a: a record another
            # survivor already published for that epoch is ADOPTED
            # (the try_claim below loses, _wait_for_record reads it);
            # a failed attempt leaves its record behind and everyone
            # advances to the next epoch together
            new_epoch = self.epoch + 1 + attempt
            leader_host = cur[0][1]
            members = {host: i for i, (_r, host) in enumerate(cur)}
            if leader_host == self.host:
                leader_addr = self.cfg.advertise_host
                halve = oom or self._oom_suggested()
                # chunk <= 0 means the fault hit before chunk sizing
                # (the capacity exchange): publish None so the
                # re-formed gang re-derives instead of collapsing to
                # one device-row per host
                if int(chunk) <= 0:
                    new_chunk = None
                elif halve:
                    new_chunk = max(int(chunk) // 2, 1)
                else:
                    new_chunk = int(chunk)
                try_claim(
                    epoch_record_path(self.coord_dir, new_epoch),
                    {
                        "epoch": new_epoch,
                        "world": len(cur),
                        "coordinator": (
                            f"{leader_addr}:"
                            f"{self._free_reform_port(new_epoch)}"
                        ),
                        "members": members,
                        "todo": list(remaining_todo),
                        "chunk": new_chunk,
                        "ts": self._clock(),
                    },
                )
            rec = self._wait_for_record(new_epoch)
            if rec is None:
                reason = (
                    f"epoch {new_epoch} record never appeared "
                    f"within {self.cfg.reform_timeout_s}s"
                )
                continue
            rec_members = rec.get("members") or {}
            if self.host not in rec_members:
                raise GangFenced(
                    f"re-formed gang (epoch {rec['epoch']}) presumed "
                    f"host {self.host} dead; stopping — late writes "
                    "lose by epoch"
                )
            new_world = int(rec.get("world", len(rec_members)))
            new_rank = int(rec_members[self.host])
            if new_world > 1:
                try:
                    self._init_runtime(
                        rec.get("coordinator"),
                        new_world,
                        new_rank,
                        self.cfg.reform_timeout_s,
                    )
                except Exception as e:  # noqa: BLE001 — retry rung
                    reason = (
                        "distributed re-init failed: "
                        f"{type(e).__name__}: {str(e)[:160]}"
                    )
                    continue
            self.epoch = int(rec["epoch"])
            self.world = new_world
            self.rank = new_rank
            self.reformations += 1
            _counter(
                "repic_gang_reformations_total",
                "successful gang re-formations",
            ).inc()
            if self.journal is not None:
                self.journal.record_event(
                    "gang_reformed",
                    gang_epoch=self.epoch,
                    world=self.world,
                    rank=self.rank,
                    members=sorted(rec_members),
                    dead=sorted(dead),
                )
            self._refresh_member_record()
            self._publish_state()
            return "gang"
        return self._degrade(reason)

    def _refresh_member_record(self) -> None:
        from repic_tpu_torch.runtime.atomic import atomic_write

        with atomic_write(
            member_path(self.coord_dir, self.host)
        ) as f:
            json.dump(
                {
                    "host": self.host,
                    "rank": self.rank,
                    "address": self.cfg.advertise_host,
                    "epoch": self.epoch,
                    "ts": self._clock(),
                },
                f,
            )

    def _wait_for_record(self, epoch: int) -> dict | None:
        deadline = self._clock() + self.cfg.reform_timeout_s
        while True:
            rec = read_epoch_record(self.coord_dir, epoch)
            if rec is not None:
                return rec
            if self._clock() >= deadline:
                return None
            time.sleep(_POLL_S)

    def degrade(self, reason: str) -> str:
        """Give up on gang execution outright (the caller's fault
        budget spent): tears down the runtime and journals
        ``gang_degraded`` exactly like a failed re-formation."""
        return self._degrade(reason)

    def _degrade(self, reason: str) -> str:
        if not self.cfg.allow_degrade:
            raise GangError(
                f"gang re-formation failed ({reason}) and "
                "--gang-no-degrade is set"
            )
        self._shutdown_runtime()
        self.mode = "independent"
        self.epoch += 1  # degraded writes still outrank stragglers
        _counter(
            "repic_gang_degradations_total",
            "gangs degraded to independent per-host execution",
        ).inc()
        if self.journal is not None:
            self.journal.record_event(
                "gang_degraded",
                gang_epoch=self.epoch,
                reason=reason,
            )
        self._publish_state()
        return "independent"

    # -- post-reform work derivation ----------------------------------

    def current_todo(self) -> list | None:
        """The re-derived todo from the current epoch record (None
        for epoch 1 / degraded mode: the caller derives it from the
        merged journals instead)."""
        rec = read_epoch_record(self.coord_dir, self.epoch)
        if rec is None:
            return None
        return rec.get("todo")

    def current_chunk(self) -> int | None:
        rec = read_epoch_record(self.coord_dir, self.epoch)
        if rec is None:
            return None
        c = rec.get("chunk")
        return None if c is None else int(c)

    def independent_share(self, names) -> list:
        """Degraded mode: this host's deterministic share of the
        remaining names — survivors split by their census index, and
        cluster-journal merging keeps any double-processing benign
        (atomic, content-identical outputs)."""
        from repic_tpu_torch.runtime.cluster import shard_for_rank

        cur = self.survivors()
        hosts = [host for _r, host in cur]
        if self.host not in hosts:
            return list(names)
        return shard_for_rank(
            names, hosts.index(self.host), len(hosts)
        )


# -- lazy telemetry (parallel <-> telemetry stays acyclic) ------------


def _counter(name: str, help_text: str):
    from repic_tpu_torch import telemetry

    return telemetry.counter(name, help_text)


def _gauge(name: str, help_text: str):
    from repic_tpu_torch import telemetry

    return telemetry.gauge(name, help_text)
