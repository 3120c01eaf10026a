"""Brownout policy for serve admission: the policy half of
``repic_tpu.serve.autoscale`` (the port's own copy).

A fleet supervisor publishes its posture to ``_autoscale_state.json``
in the queue's directory and journals its decisions to
``_autoscale.jsonl``; the admission queue (:mod:`repic_tpu_torch.serve.
jobs`) reads the posture per submission through :class:`BrownoutReader`
and sheds by priority class.  Level 1 sheds ``low``, level 2 also
``normal``, level 3 also halves the effective queue limit; ``high`` is
never admission-shed.  No file reads as level 0.

Host-only stdlib and free of serve imports (the queue imports this
module).  The supervisor itself (``Supervisor``, the replica liveness
it reads) belongs to the fleet and is not ported.
"""

from __future__ import annotations

import json
import os

from repic_tpu_torch.runtime.journal import _read_entries

#: the supervisor's posture, written atomically every tick -- the
#: admission queues' brownout input and the /status autoscaler section
STATE_NAME = "_autoscale_state.json"
#: append-only decision journal: one JSON record per scale/shed/stall
#: decision with its triggering signals
AUTOSCALE_JOURNAL_NAME = "_autoscale.jsonl"


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
