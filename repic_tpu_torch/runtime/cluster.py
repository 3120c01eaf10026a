"""Cluster fault tolerance for directory consensus: heartbeats,
leases, fences and the reassignment of a lost host's work (the port of
``repic_tpu.runtime.cluster``, same files and formats).

The runtime of one host journals, retries and quarantines
*micrographs*; across hosts the failure that matters is a lost or
wedged *host*.  This module is that layer, built on files in a shared
coordination directory (NFS or any shared file system, no extra
service), and it works with or without a ``torch.distributed`` group:

* **heartbeats** -- each host atomically rewrites
  ``_heartbeat.<host>.json`` every ``heartbeat_interval_s`` from a
  daemon thread; :func:`read_liveness` turns the records into a
  per-host ladder rung (:func:`repic_tpu_torch.runtime.ladder.host_rung`):
  live / stopped (clean shutdown) / suspect (heartbeat older than
  ``host_timeout_s``) / fenced.
* **leases** -- a host's share of the micrograph list, in
  ``_lease.<host>.json``.  Shards are contiguous splits by
  (rank, num_hosts), so every peer can derive every other peer's work
  even before its lease lands.
* **fencing** -- before a survivor touches a dead host's work it
  creates ``_fence.<host>.json`` with an ``O_CREAT|O_EXCL`` claim
  (:func:`repic_tpu_torch.runtime.atomic.try_claim`): one survivor
  wins, and the fenced host, if it was only wedged, finds the fence at
  its next chunk boundary and stops (:class:`HostFenced`).
* **reassignment** -- the fence winner appends the orphaned
  micrographs to its own lease and processes them; the journal records
  ``host_suspect`` / ``host_fenced`` / ``work_reassigned`` events and a
  ``reassigned_from`` field on each recovered micrograph, which
  ``report`` tallies per host.

Per-host journals (``_journal.<host>.jsonl``) keep every file
single-writer; readers merge on read, last writer wins
(:func:`repic_tpu_torch.runtime.journal.read_all_journals`), so work
done twice during a liveness flap is harmless: outputs are atomic and
identical.

The serving fleet (:mod:`repic_tpu_torch.serve.fleet`) reuses the
heartbeat, fence and liveness machinery as its replica membership: a
:class:`ClusterContext` whose coordination directory is the fleet
directory, with per-job leases and completion tokens on top.

Fault sites (:mod:`repic_tpu_torch.runtime.faults`): ``host_crash``
(the process dies through ``os._exit`` at a chunk boundary),
``heartbeat_stall`` (renewals stop while the process lives) and
``lease_race`` (a fence claim loses to a phantom winner).  The
heartbeat thread makes no torch call, so a host's first CUDA context
or library load, which can hold the GIL for a while, cannot starve
its renewals for long.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
from dataclasses import dataclass

from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.atomic import (
    atomic_write,
    try_claim as _atomic_try_claim,
)
from repic_tpu_torch.runtime.journal import (
    DONE_STATUSES,
    STATUS_QUARANTINED,
    MergedJournalReader,
    sanitize_host_id,
)
from repic_tpu_torch.runtime.ladder import HOST_LIVE, HOST_SUSPECT, host_rung

HEARTBEAT_PREFIX = "_heartbeat."
LEASE_PREFIX = "_lease."
FENCE_PREFIX = "_fence."

#: exit status of a ``host_crash`` fault firing — distinguishable
#: from ordinary failures in the multi-process test harness
CRASH_EXIT_CODE = 23

DEFAULT_HEARTBEAT_INTERVAL_S = 2.0
DEFAULT_HOST_TIMEOUT_S = 10.0


class ClusterError(RuntimeError):
    """Base class for cluster-runtime failures."""


class HostFenced(ClusterError):
    """This host's lease was fenced by a survivor — stop processing."""


class HostLost(ClusterError):
    """Strict mode: a peer went suspect instead of finishing its lease."""


def resolve_identity(environ=None) -> tuple[str, int, int]:
    """``(host_id, rank, num_hosts)`` for this process.

    Precedence: explicit ``REPIC_TPU_HOST_ID`` / ``REPIC_TPU_HOST_RANK``
    / ``REPIC_TPU_NUM_HOSTS`` env vars (the launcher's contract, and
    what the simulated multi-process harness sets), then an
    initialised ``torch.distributed`` group or torchrun's environment
    (:func:`repic_tpu_torch.parallel.distributed.runtime_identity`),
    then the single-host default ``("host0", 0, 1)``.
    """
    env = os.environ if environ is None else environ
    host = env.get("REPIC_TPU_HOST_ID")
    rank = env.get("REPIC_TPU_HOST_RANK")
    num = env.get("REPIC_TPU_NUM_HOSTS")
    if host or rank or num:
        rank_i = int(rank) if rank else 0
        num_i = int(num) if num else max(rank_i + 1, 1)
        return (
            sanitize_host_id(host) if host else f"host{rank_i}",
            rank_i,
            num_i,
        )
    try:
        from repic_tpu_torch.parallel.distributed import runtime_identity

        ident = runtime_identity()
    except Exception:  # pragma: no cover - a torch without distributed
        ident = None
    if ident is not None:
        return (sanitize_host_id(ident[0]), ident[1], ident[2])
    return ("host0", 0, 1)


def shard_for_rank(items, rank: int, num_hosts: int) -> list:
    """Rank's contiguous share of a global work list — the same split
    :func:`repic_tpu_torch.parallel.distributed.shard_for_process` uses for
    data loading, so work ownership is derivable by every peer."""
    items = list(items)
    per = -(-len(items) // max(num_hosts, 1))
    return items[rank * per : (rank + 1) * per]


# -- coordination-file paths and readers ------------------------------


def heartbeat_path(coord_dir: str, host: str) -> str:
    return os.path.join(coord_dir, f"{HEARTBEAT_PREFIX}{host}.json")


def lease_path(coord_dir: str, host: str) -> str:
    return os.path.join(coord_dir, f"{LEASE_PREFIX}{host}.json")


def fence_path(coord_dir: str, host: str) -> str:
    return os.path.join(coord_dir, f"{FENCE_PREFIX}{host}.json")


def _read_json(path: str):
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        # mid-rewrite reads cannot happen (atomic_write), but a
        # file deleted between glob and open, or hand-edited, can
        return None


def try_claim(path: str, payload: dict) -> bool:
    """Create-once claim of ``path`` (cluster fences).

    The ``lease_race`` fault site makes the claim report a lost race
    without touching the filesystem — deterministically exercising
    the "another survivor won" branch.
    """
    if faults.check("lease_race", path):
        return False
    return _atomic_try_claim(path, json.dumps(payload))


@dataclass
class HostState:
    """One host's view in the liveness snapshot."""

    host: str
    rank: int | None = None
    ts: float | None = None
    age_s: float | None = None
    seq: int = 0
    stopped: bool = False
    fenced: bool = False
    fenced_by: str | None = None
    lease_names: tuple = ()
    lease_epoch: int = 0
    rung: str = HOST_SUSPECT


def read_liveness(
    coord_dir: str, timeout_s: float, now: float | None = None
) -> dict[str, HostState]:
    """Snapshot every known host's ladder rung from the coordination
    directory (union of heartbeat, lease, and fence records — a host
    that crashed before heartbeating still shows up via its lease)."""
    now = time.time() if now is None else now
    hosts: set[str] = set()
    for prefix in (HEARTBEAT_PREFIX, LEASE_PREFIX, FENCE_PREFIX):
        for path in glob.glob(
            os.path.join(coord_dir, f"{prefix}*.json")
        ):
            base = os.path.basename(path)
            hosts.add(base[len(prefix) : -len(".json")])
    view: dict[str, HostState] = {}
    for host in sorted(hosts):
        st = HostState(host=host)
        hb = _read_json(heartbeat_path(coord_dir, host))
        if hb is not None:
            st.rank = hb.get("rank")
            st.ts = hb.get("ts")
            st.seq = int(hb.get("seq", 0))
            st.stopped = bool(hb.get("stopped", False))
            if isinstance(st.ts, (int, float)):
                st.age_s = max(now - float(st.ts), 0.0)
        lease = _read_json(lease_path(coord_dir, host))
        if lease is not None:
            st.lease_names = tuple(lease.get("names", ()))
            st.lease_epoch = int(lease.get("epoch", 0))
        fence = _read_json(fence_path(coord_dir, host))
        if fence is None and os.path.exists(
            fence_path(coord_dir, host)
        ):
            # claim file exists but is unreadable/torn: treat as
            # fenced by an unknown peer — never reassign over it
            st.fenced, st.fenced_by = True, None
        elif fence is not None:
            st.fenced = True
            st.fenced_by = fence.get("fenced_by")
        st.rung = host_rung(
            st.age_s, timeout_s, stopped=st.stopped, fenced=st.fenced
        )
        view[host] = st
    return view


# -- run-scoped context ----------------------------------------------


@dataclass(frozen=True)
class ClusterConfig:
    """Operator-facing knobs for a cluster run (CLI:
    ``--coordination-dir`` / ``--heartbeat-interval`` /
    ``--host-timeout``).  Identity fields default from the
    environment / ``torch.distributed`` via :func:`resolve_identity`."""

    coordination_dir: str | None = None  # default: the run's out_dir
    host_id: str | None = None
    rank: int | None = None
    num_hosts: int | None = None
    heartbeat_interval_s: float = DEFAULT_HEARTBEAT_INTERVAL_S
    host_timeout_s: float = DEFAULT_HOST_TIMEOUT_S
    # how long a host that finished its own lease lingers, polling
    # for live-looking peers to either renew (proof of life) or go
    # suspect (claimable).  None = auto: host_timeout_s plus two
    # renewal periods — long enough to catch a peer that died just
    # as we finished, bounded so a fleet drains promptly.  0 claims
    # only already-suspect/stopped peers and exits immediately.
    takeover_wait_s: float | None = None

    def __post_init__(self):
        if self.heartbeat_interval_s <= 0:
            raise ValueError("heartbeat_interval_s must be > 0")
        if self.host_timeout_s <= self.heartbeat_interval_s:
            raise ValueError(
                "host_timeout_s must exceed heartbeat_interval_s "
                f"(got timeout={self.host_timeout_s}, "
                f"interval={self.heartbeat_interval_s}); a timeout "
                "under one renewal period declares every host dead"
            )


class ClusterContext:
    """This host's handle on a cluster run: heartbeat thread, lease,
    fence checks, and the orphan-harvest walk of the host ladder.

    Used by :func:`repic_tpu_torch.pipeline.consensus.run_consensus_dir`;
    unit-testable standalone against a tmp coordination directory.
    """

    def __init__(self, cfg: ClusterConfig, out_dir: str,
                 clock=time.time):
        ident = resolve_identity()
        self.cfg = cfg
        # injectable clock: every timestamp this context WRITES
        # (heartbeats, leases, fences) and every liveness/deadline
        # judgment it MAKES reads this instead of time.time, so
        # tests drive heartbeat aging and harvest windows
        # deterministically instead of sleeping against wall time
        # (a loaded machine starves a real renewal thread).  The default is
        # time.time; records stay comparable across hosts because
        # every host defaults to it.
        self._clock = clock
        self.host = sanitize_host_id(
            cfg.host_id if cfg.host_id else ident[0]
        )
        self.rank = cfg.rank if cfg.rank is not None else ident[1]
        self.num_hosts = (
            cfg.num_hosts if cfg.num_hosts is not None else ident[2]
        )
        if not (0 <= self.rank < self.num_hosts):
            raise ValueError(
                f"host rank {self.rank} outside [0, {self.num_hosts})"
            )
        self.out_dir = out_dir
        self.coord_dir = cfg.coordination_dir or out_dir
        os.makedirs(self.coord_dir, exist_ok=True)
        self.reassigned: dict[str, str | None] = {}
        self._lease_names: list = []
        self._lease_epoch = 0
        self._seq = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        # incremental merged-journal view for the harvest poll loop
        self._merged = MergedJournalReader(out_dir)
        # hosts this context already journaled host_suspect for — a
        # repeatedly-failing fence claim must not re-record the
        # suspicion every poll tick
        self._suspected: set = set()

    # -- heartbeats ---------------------------------------------------

    def beat(self, *, stopped: bool = False) -> None:
        """One heartbeat renewal (atomic rewrite of the host record).

        The ``heartbeat_stall`` fault site skips the renewal — the
        deterministic stand-in for a wedged-but-running host."""
        if not stopped and faults.check("heartbeat_stall", self.host):
            return
        self._seq += 1
        with atomic_write(heartbeat_path(self.coord_dir, self.host)) as f:
            json.dump(
                {
                    "host": self.host,
                    "rank": self.rank,
                    "pid": os.getpid(),
                    "seq": self._seq,
                    "ts": self._clock(),
                    "stopped": stopped,
                },
                f,
            )
        _counter(
            "repic_cluster_heartbeats_total",
            "heartbeat renewals written by this host",
        ).inc()

    def _beat_loop(self) -> None:
        while True:
            # interval timer OR an explicit request_beat() wake —
            # the wake lets tests force a renewal deterministically
            # instead of sleeping multiples of the interval
            self._wake.wait(self.cfg.heartbeat_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.beat()
            except Exception:  # pragma: no cover - best-effort renew
                # a failed renewal must not kill the thread: the next
                # tick retries, and a persistent failure surfaces as
                # this host going suspect (the safe direction)
                pass

    def request_beat(self) -> None:
        """Wake the renewal thread for an immediate heartbeat (the
        deterministic test hook; harmless no-op in production)."""
        self._wake.set()

    def start(self) -> "ClusterContext":
        """Write the first heartbeat and start the renewal thread.

        A fence left over for THIS host id is cleared first: the
        fence exists to stop the old wedged process that stopped
        heartbeating, and a fresh ``--resume`` invocation under the
        same identity is the operator's statement that that process
        is gone — without the clear, a relaunched host would lease a
        shard and then die on :class:`HostFenced` at its first chunk
        boundary, forever.
        """
        import contextlib

        with contextlib.suppress(OSError):
            os.unlink(fence_path(self.coord_dir, self.host))
        self.beat()
        self._thread = threading.Thread(
            target=self._beat_loop,
            name=f"repic-heartbeat-{self.host}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, clean: bool = True) -> None:
        """Stop renewals; a clean stop records ``stopped`` so peers
        may reassign any incomplete lease without a timeout wait."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if clean:
            try:
                self.beat(stopped=True)
            except OSError:  # pragma: no cover - dir vanished
                pass

    # -- fault hooks --------------------------------------------------

    def crash_point(self, point: str) -> None:
        """``host_crash`` fault site: terminate THIS process abruptly
        (``os._exit`` — no journal close, no heartbeat stop, no
        atexit), the deterministic stand-in for a host loss."""
        if faults.check("host_crash", f"{self.host}:{point}"):
            os._exit(CRASH_EXIT_CODE)

    # -- leases and fences --------------------------------------------

    def ensure_not_fenced(self) -> None:
        """Raise :class:`HostFenced` if a survivor fenced this host
        (checked at chunk boundaries — the wedged-host exit path)."""
        if os.path.exists(fence_path(self.coord_dir, self.host)):
            raise HostFenced(
                f"host {self.host} was fenced by a peer; its lease "
                "has been reassigned — stopping to avoid duplicate "
                "processing"
            )

    def _write_lease(self) -> None:
        with atomic_write(lease_path(self.coord_dir, self.host)) as f:
            json.dump(
                {
                    "host": self.host,
                    "names": list(self._lease_names),
                    "epoch": self._lease_epoch,
                    "ts": self._clock(),
                },
                f,
            )

    def liveness(self) -> dict[str, HostState]:
        view = read_liveness(
            self.coord_dir, self.cfg.host_timeout_s,
            now=self._clock(),
        )
        live = sum(1 for s in view.values() if s.rung == HOST_LIVE)
        suspect = sum(
            1 for s in view.values() if s.rung == HOST_SUSPECT
        )
        _gauge(
            "repic_cluster_live_hosts",
            "hosts with a fresh heartbeat in the coordination dir",
        ).set(live)
        _gauge(
            "repic_cluster_suspect_hosts",
            "hosts whose heartbeat exceeded the host timeout",
        ).set(suspect)
        return view

    # -- work assignment ----------------------------------------------

    def plan_shard(self, all_names: list, journal=None, *,
                   done=(), strict: bool = False) -> list:
        """Lease this host's share of the run's micrograph list.

        The shard is computed over the FULL input name list — never a
        done-filtered or otherwise host-local view — with the
        deterministic contiguous split by rank, so peers reach
        consistent disjoint covering partitions no matter how
        staggered their starts are (a later-starting host sees more
        completed work, and splitting the filtered remainder would
        shift every boundary).  Already-``done`` names and names a
        LIVE peer leases are then dropped from this host's slice.
        Names held by dead/stopped peers from a previous generation
        stay in the partition — the coordinated-resume half of the
        ladder — recorded as reassignments (plus a best-effort fence
        on the dead holder).  ``strict`` raises :class:`HostLost`
        instead of reassigning.
        """
        view = self.liveness()
        excluded: set = set(done)
        prior_owner: dict = {}
        for host, st in view.items():
            if host == self.host:
                continue
            if st.rung == HOST_LIVE:
                excluded.update(st.lease_names)
            else:
                for n in st.lease_names:
                    prior_owner.setdefault(n, host)
        mine = [
            n
            for n in shard_for_rank(
                all_names, self.rank, self.num_hosts
            )
            if n not in excluded
        ]
        taken_over: dict[str, list] = {}
        for n in mine:
            if n in prior_owner:
                taken_over.setdefault(prior_owner[n], []).append(n)
        if strict and taken_over:
            host, names = sorted(taken_over.items())[0]
            raise HostLost(
                f"host {host} left {len(names)} unfinished "
                "micrograph(s) from a previous generation (--strict: "
                "failing fast instead of reassigning)"
            )
        for host, names in sorted(taken_over.items()):
            self._record_reassignment(
                host, names, journal, view, require_fence=False
            )
        self._lease_names = list(mine)
        self._write_lease()
        return mine

    def _record_reassignment(
        self, host, names, journal, view, *, require_fence: bool
    ) -> bool:
        """Journal + fence + count one takeover of ``host``'s names.

        With ``require_fence`` (the harvest path, where several
        survivors may target the SAME whole lease) ownership is the
        fence: losing the ``try_claim`` race to another survivor
        aborts the takeover — False, nothing recorded.  Without it
        (the plan_shard resume path, where ownership is already the
        disjoint rank partition) the fence is best-effort exclusion
        of the dead process and never gates the reassignment.
        """
        st = view.get(host)
        fenced_by_me = st is not None and st.fenced and (
            st.fenced_by == self.host
        )
        if st is not None and not st.fenced:
            if journal is not None and host not in self._suspected:
                self._suspected.add(host)
                journal.record_event(
                    "host_suspect",
                    suspect=host,
                    age_s=(
                        None if st.age_s is None else round(st.age_s, 3)
                    ),
                    rung=st.rung,
                )
            if try_claim(
                fence_path(self.coord_dir, host),
                {
                    "host": host,
                    "fenced_by": self.host,
                    "ts": self._clock(),
                },
            ):
                fenced_by_me = True
                _counter(
                    "repic_cluster_fences_total",
                    "dead-host leases fenced by this host",
                ).inc()
                if journal is not None:
                    journal.record_event(
                        "host_fenced", suspect=host, by=self.host
                    )
        if require_fence and not fenced_by_me:
            return False  # another survivor won this takeover
        if journal is not None:
            journal.record_event(
                "work_reassigned",
                from_host=host,
                to_host=self.host,
                names=list(names),
                count=len(names),
            )
        self.reassigned.update({n: host for n in names})
        _counter(
            "repic_cluster_reassigned_total",
            "micrographs reassigned to this host from dead peers",
        ).inc(len(names))
        return True

    def harvest_orphans(
        self,
        journal,
        all_names,
        *,
        strict: bool = False,
    ) -> list:
        """After finishing its own lease, claim work orphaned by dead
        peers — the reassignment rung of the host ladder.

        Polls the merged journal and the liveness view: names that
        are not complete, not quarantined, and not this host's are
        attributed to their holding (or rank-derived) peer.  A peer
        that keeps renewing its heartbeat is alive — its work is left
        alone and the poll ends once every such peer has renewed at
        least once.  A peer past the timeout (or cleanly stopped with
        an unfinished lease) is fenced (one survivor wins the
        ``O_EXCL`` claim) and its incomplete names are returned for
        processing here.  ``strict`` raises :class:`HostLost` at the
        first suspect peer instead.  Returns ``[]`` when nothing is
        (or will become) claimable.
        """
        poll_s = min(max(self.cfg.heartbeat_interval_s / 2, 0.05), 1.0)
        wait_s = self.cfg.takeover_wait_s
        if wait_s is None:
            wait_s = (
                self.cfg.host_timeout_s
                + 2 * self.cfg.heartbeat_interval_s
            )
        deadline = self._clock() + wait_s
        baseline: dict[str, tuple] = {}
        confirmed_alive: set = set()
        while True:
            self.ensure_not_fenced()
            merged = self._merged.latest()
            done = {
                n
                for n, e in merged.items()
                if e.get("status") in DONE_STATUSES
            }
            mine = set(self._lease_names)
            remaining = [
                n
                for n in all_names
                if n not in done
                and n not in mine
                and merged.get(n, {}).get("status")
                != STATUS_QUARANTINED
            ]
            if not remaining:
                return []
            view = self.liveness()
            holder: dict = {}
            for host, st in view.items():
                if host == self.host:
                    continue
                held = set(st.lease_names)
                if not held and st.rank is not None:
                    # crashed before publishing a lease: its intended
                    # shard is derivable from the deterministic split
                    # over the FULL name list — the same list it
                    # would have passed to plan_shard, never the
                    # survivor-local `remaining` view
                    held = set(
                        shard_for_rank(
                            list(all_names), st.rank, self.num_hosts
                        )
                    )
                for n in held:
                    holder.setdefault(n, host)
            claim: list = []
            waiting: set = set()
            by_host: dict[str, list] = {}
            unheld: list = []
            for n in remaining:
                h = holder.get(n)
                if h is None:
                    # no coordination record at all — either a host
                    # that died before its first heartbeat, or one
                    # that has not STARTED yet (startup stagger).
                    # Claimable only once the wait window expires.
                    unheld.append(n)
                    continue
                by_host.setdefault(h, []).append(n)
            for h, names in sorted(by_host.items()):
                st = view[h]
                if st.rung == HOST_LIVE:
                    if h not in confirmed_alive:
                        key = (st.seq, st.ts)
                        if h in baseline and baseline[h] != key:
                            confirmed_alive.add(h)
                        else:
                            baseline.setdefault(h, key)
                            waiting.add(h)
                    continue
                if st.fenced and st.fenced_by != self.host:
                    continue  # another survivor owns this takeover
                if strict:
                    raise HostLost(
                        f"host {h} is {st.rung} with "
                        f"{len(names)} unfinished micrograph(s) "
                        "(--strict: failing fast instead of "
                        "reassigning)"
                    )
                if self._record_reassignment(
                    h, names, journal, view, require_fence=True
                ):
                    claim.extend(names)
            expired = self._clock() >= deadline
            if not claim and unheld and wait_s > 0 and expired:
                # the wait window gave an unstarted host every chance
                # to check in — adopt the ownerless work
                self.reassigned.update({n: None for n in unheld})
                if journal is not None:
                    journal.record_event(
                        "work_reassigned",
                        from_host=None,
                        to_host=self.host,
                        names=list(unheld),
                        count=len(unheld),
                    )
                claim.extend(unheld)
            if claim:
                self._lease_epoch += 1
                self._lease_names.extend(
                    n for n in claim if n not in mine
                )
                self._write_lease()
                order = {n: i for i, n in enumerate(all_names)}
                return sorted(claim, key=lambda n: order.get(n, 0))
            if (not waiting and not unheld) or expired:
                return []
            time.sleep(poll_s)

    # -- reporting ----------------------------------------------------

    def merged_latest(self) -> dict:
        """Latest entry per micrograph over ALL hosts' journals, via
        the incremental size-keyed reader — the run-wide truth that
        peers' in-flight completions land in.  Used by the orphan
        harvest and by /status cluster-wide progress."""
        return self._merged.latest()

    def stats(self) -> dict:
        """Summary block for the run's stats JSON."""
        return {
            "host": self.host,
            "rank": self.rank,
            "num_hosts": self.num_hosts,
            "coordination_dir": os.path.abspath(self.coord_dir),
            "lease": list(self._lease_names),
            "reassigned": dict(self.reassigned),
        }


# -- lazy telemetry (keeps the runtime <-> telemetry graph acyclic) --


def _counter(name: str, help_text: str):
    from repic_tpu_torch import telemetry

    return telemetry.counter(name, help_text)


def _gauge(name: str, help_text: str):
    from repic_tpu_torch import telemetry

    return telemetry.gauge(name, help_text)
