"""The fleet's autoscale supervisor and the brownout policy (the port
of ``repic_tpu.serve.autoscale``).

A supervisor process (``python -m repic_tpu_torch fleet supervise
FLEET_DIR``, :class:`Supervisor`) steers the number of ``serve``
replicas from error-budget burn and fleet queue depth, with
hysteresis, bounds and a cooldown; replaces managed replicas that
died; journals every decision with its signals into
``_autoscale.jsonl`` and publishes its posture to
``_autoscale_state.json`` (the ``repic_fleet_target_replicas`` gauge,
the ``/status`` ``autoscaler`` section).  As burn crosses thresholds
it stages brownout levels: level 1 sheds ``low``-priority admission,
level 2 also ``normal``, level 3 also halves the effective queue
limit; ``high`` is never admission-shed.  The admission queues
(:mod:`repic_tpu_torch.serve.jobs`, :mod:`repic_tpu_torch.serve.fleet`)
read the posture per submission through :class:`BrownoutReader`; no
file reads as level 0, and a dead supervisor leaves its last level.
``REPIC_TPU_AUTOSCALE_DISABLE`` holds every action (decisions are
still journaled); ``REPIC_TPU_TARGET_REPLICAS`` pins the target.

Free of serve imports: the queues import this module for the policy.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

from repic_tpu_torch import telemetry
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.atomic import atomic_write
from repic_tpu_torch.runtime.cluster import read_liveness
from repic_tpu_torch.runtime.journal import MergedJournalReader, _read_entries
from repic_tpu_torch.runtime.ladder import HOST_LIVE
from repic_tpu_torch.telemetry import events as tlm_events

#: the supervisor's posture, written atomically every tick -- the
#: admission queues' brownout input and the /status autoscaler section
STATE_NAME = "_autoscale_state.json"
#: append-only decision journal: one JSON record per scale/shed/stall
#: decision with its triggering signals
AUTOSCALE_JOURNAL_NAME = "_autoscale.jsonl"

#: operator kill switch: observe and journal held decisions, never act
DISABLE_ENV = "REPIC_TPU_AUTOSCALE_DISABLE"
#: operator override: pin the replica target (clamped to min/max)
TARGET_ENV = "REPIC_TPU_TARGET_REPLICAS"

#: serve.jobs.SERVE_JOURNAL_NAME and the fleet's token prefixes (not
#: imported: the queues import this module)
_SERVE_JOURNAL_NAME = "_serve_journal.jsonl"
_JOB_LEASE_PREFIX = "_joblease."
_DONE_PREFIX = "_done."

#: the saturated signals the ``storm`` fault substitutes: maximal burn
#: and a deep queue
STORM_BURN = 1e6
STORM_DEPTH = 10**6

_log = tlm_events.get_logger("autoscale")

_TARGET = telemetry.gauge(
    "repic_fleet_target_replicas",
    "replica count the fleet supervisor is currently steering to",
)
_LEVEL = telemetry.gauge(
    "repic_fleet_brownout_level",
    "active brownout stage (0 = none)",
)
_DECISIONS = telemetry.counter(
    "repic_fleet_scale_decisions_total",
    "supervisor scale decisions, by action",
)


# -- brownout policy (pure — shared with the admission queues) --------

#: default staged burn thresholds for brownout levels 1..3
DEFAULT_BROWNOUT_THRESHOLDS = (2.0, 6.0, 14.0)

#: leave a level only when burn falls below this fraction of the
#: threshold that admitted it — admission hysteresis, same idea as
#: the scale cooldown: flapping between "shed" and "admit" is worse
#: for clients than either state
EXIT_FRACTION = 0.5


def brownout_level(
    burn: float,
    thresholds=DEFAULT_BROWNOUT_THRESHOLDS,
    prev: int = 0,
) -> int:
    """The staged brownout level for ``burn``, with hysteresis
    against ``prev``: enter level L at ``thresholds[L-1]``, drop back
    only once burn falls below ``EXIT_FRACTION`` of that threshold."""
    level = 0
    for i, th in enumerate(thresholds):
        if burn >= th:
            level = i + 1
    if level < prev:
        keep = prev
        while keep > level and (
            keep > len(thresholds)
            or burn < EXIT_FRACTION * thresholds[keep - 1]
        ):
            keep -= 1
        level = keep
    return level


def shed_priorities(level: int) -> tuple:
    """Priority classes refused admission at ``level`` —
    blast-radius-ordered: ``low`` first, then ``normal``; ``high``
    is never admission-shed."""
    if level <= 0:
        return ()
    if level == 1:
        return ("low",)
    return ("low", "normal")


def effective_queue_limit(limit: int, level: int) -> int:
    """Level 3 is the global tightening stage: beyond shedding
    low+normal admission, the bounded backlog itself halves so the
    surviving high-priority work drains sooner."""
    if level >= 3:
        return max(1, int(limit) // 2)
    return int(limit)


def shed_horizon_s(
    state: dict | None,
    unshed_micrographs: int,
    per_mic_s: float,
    live: int = 1,
) -> float:
    """Honest ``Retry-After`` for a brownout 429.

    A shed tenant's horizon is NOT the global per-micrograph drain
    estimate (which under-advises during a storm): it is the time
    until its class can plausibly be admitted again — at least one
    control interval (the soonest the supervisor can change posture),
    plus any remaining scale cooldown, plus the drain time of the
    still-admitted classes' backlog that will run first.
    """
    state = state or {}
    interval = max(float(state.get("interval_s", 2.0)), 0.5)
    cooldown = max(float(state.get("cooldown_remaining_s", 0.0)), 0.0)
    drain = (
        max(int(unshed_micrographs), 0)
        * max(float(per_mic_s), 0.0)
        / max(int(live), 1)
    )
    return max(interval, interval + cooldown + drain)


# -- posture file -----------------------------------------------------


def state_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, STATE_NAME)


def journal_path(fleet_dir: str) -> str:
    return os.path.join(fleet_dir, AUTOSCALE_JOURNAL_NAME)


def read_state(fleet_dir: str) -> dict | None:
    """The last published posture, or ``None`` (no supervisor has
    ever run here).  Always-atomic on the writer side, so a bad read
    is an absent/denied file, not a torn one."""
    try:
        with open(state_path(fleet_dir)) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return None
    return data if isinstance(data, dict) else None


def read_decisions(fleet_dir: str) -> list[dict]:
    """Every journaled supervisor decision, append order, torn-tail
    tolerant (the journal reader's contract — a crashed supervisor's
    half-written last record is dropped, not fatal)."""
    return _read_entries(journal_path(fleet_dir))


class BrownoutReader:
    """Mtime-cached posture reads for the admission hot path.

    ``submit`` runs under the queue lock; this costs one ``stat``
    per call and re-parses only when the file changed.  No file (or
    an unreadable one) reads as level 0 — no supervisor means no
    brownout, today's behavior bit for bit."""

    def __init__(self, root_dir: str):
        self._path = os.path.join(root_dir, STATE_NAME)
        self._sig = None
        self._state: dict | None = None

    def state(self) -> dict | None:
        try:
            st = os.stat(self._path)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            self._sig, self._state = None, None
            return None
        if sig != self._sig:
            self._sig = sig
            try:
                with open(self._path) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                data = None
            self._state = data if isinstance(data, dict) else None
        return self._state

    def level(self) -> int:
        state = self.state()
        try:
            return int((state or {}).get("level", 0))
        except (TypeError, ValueError):
            return 0


class Supervisor:
    """The ``fleet supervise`` control loop.

    One process per fleet, OUTSIDE the replica set: it reads replica
    liveness from the fleet dir's heartbeat records (without joining
    the fleet — constructing a member would heartbeat and count
    itself), folds the merged per-replica request journals for queue
    depth, scrapes each managed replica's ``/status`` for budget
    burn, and steers the replica count.  ``spawn`` is injectable so
    unit tests drive the loop with fakes; the default spawns real
    ``python -m repic_tpu_torch serve --fleet-dir`` processes.
    """

    def __init__(
        self,
        fleet_dir: str,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 2.0,
        cooldown_s: float = 10.0,
        burn_up: float = 2.0,
        depth_high: float = 4.0,
        brownout_thresholds=DEFAULT_BROWNOUT_THRESHOLDS,
        replica_timeout_s: float = 10.0,
        serve_args: tuple = (),
        work_root: str | None = None,
        clock=time.time,
        spawn=None,
        env=None,
    ):
        if int(min_replicas) < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}"
            )
        if int(max_replicas) < int(min_replicas):
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= "
                f"min_replicas ({min_replicas})"
            )
        thresholds = tuple(float(t) for t in brownout_thresholds)
        if list(thresholds) != sorted(thresholds) or any(
            t <= 0 for t in thresholds
        ):
            raise ValueError(
                "brownout thresholds must be positive and "
                f"non-decreasing, got {thresholds}"
            )
        self.fleet_dir = os.path.abspath(fleet_dir)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.burn_up = float(burn_up)
        self.depth_high = float(depth_high)
        self.brownout_thresholds = thresholds
        self.replica_timeout_s = float(replica_timeout_s)
        self.serve_args = tuple(serve_args)
        self.work_root = os.path.abspath(
            work_root
            if work_root is not None
            else os.path.join(self.fleet_dir, "_replicas")
        )
        self._clock = clock
        self._spawn = spawn if spawn is not None else self._spawn_proc
        self._env = os.environ if env is None else env
        self._reader = MergedJournalReader(
            self.fleet_dir, base_name=_SERVE_JOURNAL_NAME
        )
        #: replica name -> handle (anything with .poll()/.terminate())
        self.managed: dict[str, object] = {}
        self._next_replica = 0
        self.target = self.min_replicas
        self.level = 0
        self.ticks = 0
        self._last_scale_ts: float | None = None
        self._stop = threading.Event()
        self._journal_fh = open(
            journal_path(self.fleet_dir), "at"
        )

    # -- signals ------------------------------------------------------

    def sample_signals(self) -> dict:
        """One control-loop input snapshot.  The ``storm`` fault
        substitutes saturated synthetics — the deterministic traffic
        storm — while keeping the real ``live`` count (the loop must
        still see replicas die mid-storm)."""
        live = self._live_replicas()
        if faults.check("storm", f"tick:{self.ticks}"):
            return {
                "live": live,
                "burn": STORM_BURN,
                "depth": STORM_DEPTH,
                "queued_micrographs": STORM_DEPTH,
                "leases": 0,
                "storm": True,
            }
        depth, mics, leases = self._queue_depth()
        return {
            "live": live,
            "burn": self._budget_burn(),
            "depth": depth,
            "queued_micrographs": mics,
            "leases": leases,
        }

    def _live_replicas(self) -> int:
        view = read_liveness(
            self.fleet_dir, self.replica_timeout_s,
            now=self._clock(),
        )
        return sum(
            1 for st in view.values() if st.rung == HOST_LIVE
        )

    def _queue_depth(self) -> tuple[int, int, int]:
        """(queued unleased jobs, their micrographs, outstanding
        leases) from the merged fleet journals + lease/done tokens —
        the same artifacts the replicas coordinate through, read
        without joining the fleet."""
        latest: dict[str, dict] = {}
        first: dict[str, dict] = {}
        for e in self._reader.entries():
            jid = e.get("job")
            if not jid or "event" in e:
                continue
            latest[jid] = e
            if jid not in first:
                first[jid] = e
        depth = mics = leases = 0
        for jid, e in latest.items():
            if os.path.exists(
                os.path.join(
                    self.fleet_dir, f"{_DONE_PREFIX}{jid}.json"
                )
            ):
                continue
            leased = os.path.exists(
                os.path.join(
                    self.fleet_dir, f"{_JOB_LEASE_PREFIX}{jid}.json"
                )
            )
            if leased:
                leases += 1
            elif e.get("state") == "queued":
                depth += 1
                try:
                    mics += int(
                        first[jid].get("micrographs") or 1
                    )
                except (TypeError, ValueError):
                    mics += 1
        return depth, mics, leases

    def _budget_burn(self) -> float:
        """Max ``job``-endpoint budget burn across the managed
        replicas' /status documents (the worst replica is the one
        the SLO is lost on).  Unreachable replicas contribute
        nothing — liveness is a separate signal."""
        burn = 0.0
        for name in list(self.managed):
            port = self._replica_port(name)
            if port is None:
                continue
            try:
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/status", timeout=2.0
                ) as resp:
                    doc = json.load(resp)
            except (OSError, ValueError):
                continue
            ep = (
                (doc.get("slo") or {}).get("endpoints") or {}
            ).get("job") or {}
            try:
                burn = max(burn, float(ep.get("budget_burn", 0.0)))
            except (TypeError, ValueError):
                continue
        return burn

    def _replica_port(self, name: str) -> int | None:
        try:
            with open(
                os.path.join(self.work_root, name, "_serve.json")
            ) as f:
                return int(json.load(f)["port"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    # -- decision -----------------------------------------------------

    def decide(self, signals: dict, now: float) -> tuple[str, dict]:
        """(action, reason) for this tick — pure over the signals
        and the supervisor's scalar state, so tests drive it
        directly.  Actions: ``up``, ``down``, ``hold``, ``pin``."""
        pinned = self._pinned_target()
        if pinned is not None:
            return "pin", {"pinned": pinned}
        live = max(int(signals["live"]), len(self.managed))
        burn = float(signals["burn"])
        depth_per_live = float(signals["depth"]) / max(live, 1)
        in_cooldown = (
            self._last_scale_ts is not None
            and now - self._last_scale_ts < self.cooldown_s
        )
        if burn > self.burn_up or depth_per_live > self.depth_high:
            if self.target >= self.max_replicas:
                return "hold", {"cause": "at_max"}
            if in_cooldown:
                return "hold", {"cause": "cooldown"}
            return "up", {
                "cause": (
                    "burn" if burn > self.burn_up else "depth"
                ),
            }
        if (
            int(signals["depth"]) == 0
            and int(signals["leases"]) == 0
            and burn <= self.burn_up * EXIT_FRACTION
            and self.target > self.min_replicas
        ):
            # scale-in only from a drained, healthy fleet: the
            # rolling burn window does not decay while idle, so an
            # empty queue (not a recovered burn) is the idle signal
            if in_cooldown:
                return "hold", {"cause": "cooldown"}
            return "down", {"cause": "idle"}
        return "hold", {"cause": "steady"}

    def _pinned_target(self) -> int | None:
        raw = self._env.get(TARGET_ENV, "").strip()
        if not raw:
            return None
        try:
            n = int(raw)
        except ValueError:
            return None
        return min(max(n, self.min_replicas), self.max_replicas)

    def disabled(self) -> bool:
        return bool(self._env.get(DISABLE_ENV, "").strip())

    # -- acting -------------------------------------------------------

    def tick(self) -> dict:
        """One control-loop pass: sample, decide, act, publish.
        Returns the journaled decision record (tests assert on it)."""
        now = self._clock()
        signals = self.sample_signals()
        self.level = brownout_level(
            signals["burn"], self.brownout_thresholds, self.level
        )
        action, reason = self.decide(signals, now)
        new_target = self.target
        if action == "pin":
            new_target = reason["pinned"]
        elif action == "up":
            new_target = min(self.target + 1, self.max_replicas)
        elif action == "down":
            new_target = max(self.target - 1, self.min_replicas)
        stalled = faults.check("scale_stall", f"tick:{self.ticks}")
        held = self.disabled()
        if stalled:
            action, new_target = "stall", self.target
        elif held and action in ("up", "down", "pin"):
            reason = dict(reason, held=True)
            action, new_target = "hold", self.target
        if new_target != self.target and action in (
            "up", "down",
        ):
            self._last_scale_ts = now
        self.target = new_target
        record = {
            "ev": "scale",
            "action": action,
            "target": self.target,
            "level": self.level,
            "tick": self.ticks,
            "ts": round(now, 6),
            "signals": {
                k: signals[k]
                for k in (
                    "live", "burn", "depth",
                    "queued_micrographs", "leases",
                )
            },
            **({"storm": True} if signals.get("storm") else {}),
            "reason": reason,
        }
        self._journal(record)
        _DECISIONS.inc(action=action)
        if not stalled and not held:
            self._reconcile()
        self._publish(signals, now)
        self.ticks += 1
        return record

    def _reconcile(self) -> None:
        """Make the managed replica set match the target: reap dead
        handles (journaled — the chaos SIGKILL shows up here), spawn
        the deficit, retire the newest surplus."""
        for name, proc in list(self.managed.items()):
            code = proc.poll()
            if code is not None:
                del self.managed[name]
                self._journal({
                    "ev": "replica_exit",
                    "replica": name,
                    "returncode": code,
                    "ts": round(self._clock(), 6),
                })
                _log.warning(
                    f"managed replica {name} exited", code=code
                )
        while len(self.managed) < self.target:
            name = f"auto{self._next_replica}"
            self._next_replica += 1
            wd = os.path.join(self.work_root, name)
            os.makedirs(wd, exist_ok=True)
            self.managed[name] = self._spawn(name, wd)
            self._journal({
                "ev": "replica_spawned",
                "replica": name,
                "work_dir": wd,
                "ts": round(self._clock(), 6),
            })
            _log.info(f"spawned replica {name}", work_dir=wd)
        while len(self.managed) > self.target:
            # newest first: the longest-lived replicas hold the
            # warmest compile caches and the most leases
            name = sorted(self.managed)[-1]
            proc = self.managed.pop(name)
            try:
                proc.terminate()  # SIGTERM -> graceful drain
            except OSError:
                pass
            self._journal({
                "ev": "replica_retired",
                "replica": name,
                "ts": round(self._clock(), 6),
            })
            _log.info(f"retired replica {name}")

    def _spawn_proc(self, name: str, work_dir: str):
        """``python -m repic_tpu_torch serve`` as a fleet replica (on
        the card unless ``serve_args`` carries ``--device cpu``)."""
        cmd = [
            sys.executable, "-m", "repic_tpu_torch", "serve",
            work_dir,
            "--fleet-dir", self.fleet_dir,
            "--replica-id", name,
            "--replica-timeout", str(self.replica_timeout_s),
            *self.serve_args,
        ]
        return subprocess.Popen(cmd, env=dict(os.environ))

    def _journal(self, record: dict) -> None:
        self._journal_fh.write(
            json.dumps(record, default=str) + "\n"
        )
        self._journal_fh.flush()

    def _publish(self, signals: dict, now: float) -> None:
        cooldown_remaining = 0.0
        if self._last_scale_ts is not None:
            cooldown_remaining = max(
                self.cooldown_s - (now - self._last_scale_ts), 0.0
            )
        doc = {
            "target": self.target,
            "level": self.level,
            "shed_priorities": list(shed_priorities(self.level)),
            "burn": signals["burn"],
            "depth": signals["depth"],
            "queued_micrographs": signals["queued_micrographs"],
            "leases": signals["leases"],
            "live": signals["live"],
            "managed": sorted(self.managed),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "interval_s": self.interval_s,
            "cooldown_s": self.cooldown_s,
            "cooldown_remaining_s": round(cooldown_remaining, 3),
            "burn_up": self.burn_up,
            "depth_high": self.depth_high,
            "brownout_thresholds": list(self.brownout_thresholds),
            "disabled": self.disabled(),
            "ticks": self.ticks,
            "ts": round(now, 6),
        }
        with atomic_write(state_path(self.fleet_dir)) as f:
            json.dump(doc, f)
        _TARGET.set(self.target)
        _LEVEL.set(self.level)

    # -- lifecycle ----------------------------------------------------

    def install_signal_handlers(self) -> None:
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: self._stop.set())

    def request_stop(self) -> None:
        self._stop.set()

    def run(self) -> None:
        """Tick until stopped, then retire every managed replica
        (SIGTERM — their drain keeps queued jobs journaled for the
        next generation)."""
        try:
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception as e:  # noqa: BLE001 - keep looping
                    # the controller must never die to a torn
                    # artifact or a scrape hiccup: a wedged tick is
                    # journaled and the fleet keeps its last posture
                    try:
                        self._journal({
                            "ev": "tick_error",
                            "error": f"{type(e).__name__}: {e}",
                            "ts": round(self._clock(), 6),
                        })
                    except Exception:  # noqa: BLE001
                        pass
                    _log.error(f"supervisor tick failed: {e}")
                self._stop.wait(self.interval_s)
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        for name, proc in sorted(self.managed.items()):
            try:
                proc.terminate()
            except OSError:
                pass
            self._journal({
                "ev": "replica_retired",
                "replica": name,
                "ts": round(self._clock(), 6),
                "reason": "supervisor_shutdown",
            })
        for proc in self.managed.values():
            try:
                proc.wait(timeout=60.0)
            except Exception:  # noqa: BLE001 - best-effort teardown
                try:
                    proc.kill()
                except OSError:
                    pass
        self.managed.clear()
        self._journal_fh.close()
