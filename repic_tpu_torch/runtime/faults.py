"""Deterministic fault injection for the consensus runtime (the port's
own copy of ``repic_tpu.runtime.faults``).

Tests and operators plant failures at named sites, so every rung of
the retry / quarantine / resume runtime can be exercised on purpose.
The port polls these sites, with the same keys as ``repic_tpu``, so
one plan fires at the same points in both packages:

======================= ============================================
site                    raised or polled at
======================= ============================================
``io``                  ``OSError`` at ``read_box`` (key: the BOX
                        path) and in the chunk loop (keys
                        ``chunk:{first name}:{len}``,
                        ``mic:{name}``)
``oom``                 ``RuntimeError`` that
                        :func:`~repic_tpu_torch.runtime.ladder.classify_error`
                        classes as ``oom``, in the chunk loop (same
                        keys)
``corrupt_box``         ``ValueError`` inside ``read_box`` (surfaces
                        as ``BoxParseError``; key: the BOX path)
``solver_budget``       no exception: the host solver ladder treats a
                        firing as budget exhaustion of the rung named
                        by the key
``solver_diverge``      no exception: the ladder's ``lp_device`` rung
                        (key ``lp_device``) and the directory run per
                        micrograph (key: its name) read a firing as a
                        dual ascent that did not converge
``megakernel_fallback`` no exception: the directory run, under
                        ``lp_device_fused``, re-solves the named
                        micrograph on the host ladder from the staged
                        ``lp_device`` rung
======================= ============================================

:data:`KNOWN_SITES` also names the reference's cluster, serve and
gang sites, so a plan written for either package parses in both; the
port does not poll them yet.

Injection counts calls and nothing else (no randomness, no clocks): a
:class:`Fault` fires at the first ``times`` calls of its site whose
key contains its ``key`` substring, then goes inert.  Plans install
through :func:`fault_plan` (tests) or from ``REPIC_TPU_FAULTS``
(:func:`install_from_env`, called by the CLI), as comma-separated
``site[:key[:times]]`` specs::

    REPIC_TPU_FAULTS='corrupt_box:mic_002,oom::1' \\
        python -m repic_tpu_torch consensus ...

With no plan installed every hook is one list read.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field

_UNLIMITED = ("inf", "*")

#: every site a plan may name (a typo'd site would never fire)
KNOWN_SITES = (
    "io",
    "oom",
    "corrupt_box",
    "solver_budget",
    "solver_diverge",
    "megakernel_fallback",
    "host_crash",
    "heartbeat_stall",
    "lease_race",
    "request_storm",
    "slow_client",
    "deadline_exceeded",
    "server_crash",
    "replica_crash",
    "lease_steal",
    "poison_job",
    "gang_peer_crash",
    "gang_peer_stall",
    "coordinator_loss",
    "scale_stall",
    "storm",
)


@dataclass
class Fault:
    """One planted failure: fires at the first ``times`` calls of
    ``site`` whose key contains ``key`` (None: any key; ``times``
    None: unlimited)."""

    site: str
    key: str | None = None
    times: int | None = 1
    fired: int = field(default=0, compare=False)

    def matches(self, site: str, key) -> bool:
        if self.site != site:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        return self.key is None or self.key in str(key)


_PLAN: list[Fault] = []
_FIRED: list[tuple[str, str]] = []  # (site, call key) in firing order
_LOCK = threading.Lock()


def parse_spec(spec: str) -> Fault:
    """``site[:key[:times]]`` -> :class:`Fault`.  An empty or ``*``
    key matches any call; ``times`` defaults to 1, ``inf``/``*`` is
    unlimited; a key may itself contain ``:``."""
    parts = spec.strip().split(":")
    if not parts[0]:
        raise ValueError(f"empty fault site in spec {spec!r}")
    site = parts[0]
    if len(parts) > 2:
        key_tok, times_tok = ":".join(parts[1:-1]), parts[-1]
    else:
        key_tok = parts[1] if len(parts) == 2 else ""
        times_tok = ""
    times: int | None = 1
    if times_tok:
        times = None if times_tok in _UNLIMITED else int(times_tok)
    key = None if key_tok in ("", "*") else key_tok
    return Fault(site=site, key=key, times=times)


def active() -> bool:
    """Is any fault plan installed?"""
    return bool(_PLAN)


def check(site: str, key=None) -> bool:
    """Consume one matching firing; True when a fault fired.  The
    first matching spec in installation order wins.  Thread-safe: the
    BOX files load in a thread pool and the chunk loop runs in the
    prefetch worker."""
    if not _PLAN:
        return False
    with _LOCK:
        for f in _PLAN:
            if f.matches(site, key):
                f.fired += 1
                _FIRED.append((site, str(key)))
                return True
    return False


def inject(site: str, key=None) -> None:
    """Raise the site's exception when a fault fires."""
    if not check(site, key):
        return
    if site == "oom":
        raise RuntimeError(
            f"RESOURCE_EXHAUSTED: out of memory (injected fault at {key})"
        )
    if site == "io":
        raise OSError(f"injected I/O fault at {key}")
    if site == "corrupt_box":
        raise ValueError(f"injected corrupt BOX content at {key}")
    raise RuntimeError(f"injected fault [{site}] at {key}")


def fired_log() -> tuple[tuple[str, str], ...]:
    """The ``(site, key)`` of every firing so far, in order."""
    with _LOCK:
        return tuple(_FIRED)


def install(*specs: "str | Fault") -> list[Fault]:
    """Replace the active plan and clear the fired log."""
    plan = [s if isinstance(s, Fault) else parse_spec(s) for s in specs]
    with _LOCK:
        _PLAN[:] = plan
        _FIRED.clear()
    return plan


def clear() -> None:
    with _LOCK:
        _PLAN.clear()
        _FIRED.clear()


@contextlib.contextmanager
def fault_plan(*specs: "str | Fault"):
    """Install a plan for a with-block; the previous plan and fired
    log come back on exit."""
    with _LOCK:
        prev_plan, prev_fired = list(_PLAN), list(_FIRED)
    try:
        yield install(*specs)
    finally:
        with _LOCK:
            _PLAN[:] = prev_plan
            _FIRED[:] = prev_fired


def install_from_env(environ=None) -> list[Fault]:
    """Install a process-wide plan from ``REPIC_TPU_FAULTS``; a no-op
    when it is unset or empty."""
    env = os.environ if environ is None else environ
    raw = env.get("REPIC_TPU_FAULTS", "")
    if not raw.strip():
        return []
    return install(*[s for s in raw.split(",") if s.strip()])
