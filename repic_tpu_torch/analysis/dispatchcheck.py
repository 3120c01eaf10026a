"""DISPATCHCHECK: the per-chunk dispatch-budget sanitizer (the port of
``repic_tpu.analysis.dispatchcheck``).

Opt in with ``REPIC_TPU_DISPATCHCHECK=1`` (or :func:`install`) and
every accepted consensus chunk reports its dispatch window -- its
kernel launches (the wrappers' counters) plus its device-to-host
fetches (:func:`repic_tpu_torch.telemetry.probes.counters`) -- against
the ``dispatch_budget=`` of the ``@checked`` entry it is attributed to
(:class:`repic_tpu_torch.analysis.contracts.Contract`): a fused chunk
(``ops.megakernel.fused_clique_candidates``) at most 3, a staged one
(``pipeline.consensus.consensus_one``) at most 5.  The window covers
the accepted attempt only: first-visit capacity probes and escalation
retries are outside it by construction (it re-marks at every
attempt).  On the CPU a chunk launches no kernel, so its window is its
one fetch.

Recording never raises into the instrumented path: violations
accumulate in a module-level list, and the caller's gate decides.  A
per-test scope (:func:`test_scope`) labels each violation with the
test that drove the chunk.  Under pytest the JAX package's
``tests/conftest.py`` arms the reference's sanitizer from the
environment variable; the port's tests arm this one through
:func:`scoped`.

Usage::

    from repic_tpu_torch.analysis import dispatchcheck
    dispatchcheck.install()
    ... run consensus ...
    assert not dispatchcheck.violations(), dispatchcheck.report_text()
"""

from __future__ import annotations

import contextlib
import os

#: opt-in switch, mirroring REPIC_TPU_LOCKCHECK / _KERNELCHECK
ENV_VAR = "REPIC_TPU_DISPATCHCHECK"

_installed = False
_violations: list[dict] = []
_windows: list[dict] = []     # every closed window, for tests/report
_current_test: str | None = None


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


def install() -> bool:
    """Arm the sanitizer.  Idempotent; returns True when active."""
    global _installed
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install_from_env() -> bool:
    """Install iff ``REPIC_TPU_DISPATCHCHECK=1``."""
    if enabled():
        install()
        return True
    return False


def _record(kind: str, entry: str, detail: str) -> None:
    _violations.append(
        {
            "kind": kind,
            "entry": entry,
            "detail": detail,
            "test": _current_test,
        }
    )


def budget_for(entry: str):
    """The ``dispatch_budget`` the registered ``@checked`` entry
    declares, or None (unregistered entry / no budget declared)."""
    from repic_tpu_torch.analysis import contracts

    got = contracts.registry().get(entry)
    if got is None:
        return None
    return getattr(got.contract, "dispatch_budget", None)


def note_chunk(entry: str, dispatches: int, **context) -> None:
    """Report one accepted chunk window of ``dispatches`` launches
    (instrumented dispatches + fetch round trips) attributed to the
    ``@checked`` entry ``entry`` (canonical dotted name).

    Called by the consensus chunk path when the sanitizer is armed;
    never raises.  A window over the entry's declared
    ``dispatch_budget`` records a violation; windows for entries with
    no budget are recorded but never violate.
    """
    if not _installed:
        return
    try:
        budget = budget_for(entry)
    except Exception:  # pragma: no cover - registry import failure
        budget = None
    _windows.append(
        {
            "entry": entry,
            "dispatches": int(dispatches),
            "budget": budget,
            "test": _current_test,
            **context,
        }
    )
    if budget is not None and dispatches > budget:
        _record(
            "dispatch-budget-exceeded",
            entry,
            f"chunk cost {dispatches} device dispatches+fetches, "
            f"budget is {budget}"
            + (f" ({context})" if context else ""),
        )


def windows() -> list[dict]:
    """Every window closed while armed (newest last)."""
    return list(_windows)


def violations() -> list[dict]:
    return list(_violations)


def reset() -> None:
    """Clear recorded windows + violations (test isolation)."""
    _violations.clear()
    _windows.clear()


@contextlib.contextmanager
def scoped():
    """Isolate violations/windows + installed flag (tests).
    Snapshots on entry, restores on exit."""
    global _installed
    snap_v, snap_w = list(_violations), list(_windows)
    was = _installed
    try:
        yield
    finally:
        _violations[:] = snap_v
        _windows[:] = snap_w
        _installed = was


@contextlib.contextmanager
def test_scope(label: str):
    """Tag windows/violations recorded inside with ``label`` (a
    pytest nodeid, a phase name), so each over-budget chunk names
    what drove it."""
    global _current_test
    prev = _current_test
    _current_test = label
    try:
        yield
    finally:
        _current_test = prev


def report_text() -> str:
    """Human-readable violation report."""
    out = []
    for v in violations():
        where = f" [{v['test']}]" if v.get("test") else ""
        out.append(
            f"DISPATCHCHECK {v['kind']} [{v['entry']}]{where}: "
            f"{v['detail']}"
        )
    if not out:
        n = len(_windows)
        return (
            f"DISPATCHCHECK: no violations "
            f"({n} chunk window(s) within budget)"
        )
    return "\n".join(out)
