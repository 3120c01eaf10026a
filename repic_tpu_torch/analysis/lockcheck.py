"""LOCKCHECK: the runtime lock-order sanitizer (the port of
``repic_tpu.analysis.lockcheck``).

Armed (``REPIC_TPU_LOCKCHECK=1`` with :func:`maybe_install_from_env`,
or :func:`install`), every ``threading.Lock`` / ``RLock`` allocated by
``repic_tpu_torch`` code or by the port's tests is a recording proxy.
A lock created before the sanitizer was armed stays raw, so
``python -m repic_tpu_torch`` arms it from the variable before it
imports any module of the package: the module-level locks are checked
too (:func:`sites` lists every checked lock's creation site).
Each acquisition appends the lock to a thread-local held stack and --
when other checked locks are already held -- adds held->acquired
edges to a process-wide order graph.  A cycle in that graph is a
real, witnessed inconsistent acquisition order between the serve,
telemetry, runtime and gang threads; :func:`note_write` witnesses an
unguarded write the same way, recording a violation when the named
guard lock is not held by the writing thread.

Violations are RECORDED, never raised: an exception inside
``acquire`` on an arbitrary daemon thread would vanish (or deadlock
the very code under test).  The caller's gate -- a test, or
``chip_smoke.py`` -- reads :func:`violations`.  Under pytest the JAX
package's ``tests/conftest.py`` arms the reference's sanitizer from
the environment variable; the port's tests arm this one through
:func:`scoped`.

Design constraints:

* **Scoped wrapping.**  Only allocations whose calling frame belongs
  to ``repic_tpu_torch`` or to the port's tests get a checked lock;
  the JAX package, ``torch`` and the standard library keep raw locks
  -- zero overhead and zero false edges from code this package does
  not own.  (Installed above the reference's sanitizer, the factories
  hand those frames raw locks too, not the reference's proxies.)
* **Cheap common case.**  With no other checked lock held, an acquire
  is one thread-local append; the global graph lock is touched only
  when a NEW edge appears (bounded by the square of the number of
  distinct lock sites, in practice a handful).
* **Reversible.**  :func:`uninstall` (and the end of :func:`scoped`)
  puts ``threading.Lock`` / ``threading.RLock`` back exactly as
  :func:`install` found them -- the reference's factories, when its
  sanitizer was armed first; already-created checked locks keep
  working (they delegate to real primitives).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import _thread

ENV_VAR = "REPIC_TPU_LOCKCHECK"

# the primitives themselves, not whatever ``threading.Lock`` / ``RLock``
# are at import time: the reference's sanitizer may have patched them
_ORIG_LOCK = _thread.allocate_lock
_ORIG_RLOCK = _thread.RLock
_RAW_ALLOCATE = _thread.allocate_lock

_installed = False
#: ``(threading.Lock, threading.RLock)`` as :func:`install` found them
_found = None
# raw (never-wrapped) lock guarding the edge graph + violation list
_graph_lock = _RAW_ALLOCATE()
_edges: dict[str, set] = {}          # site -> {site}
_edge_sites: dict[tuple, str] = {}   # (src, dst) -> "thread tb hint"
_violations: list[dict] = []
#: creation sites of every checked lock so far
_sites: set = set()
_tls = threading.local()


def enabled() -> bool:
    """True when the environment opts into the sanitizer."""
    return os.environ.get(ENV_VAR, "") == "1"


def _held_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


#: module-name prefixes of the port's tests: its test files and helpers
#: (``tests/test_torch_*.py``, ``tests/torch_*.py``, as top-level or
#: ``tests.`` modules) and the port's runs of the reference's test
#: files (``tests/torch_twin.py``)
_TEST_PREFIXES = ("test_torch", "tests.test_torch", "torch_",
                  "tests.torch_", "_twin_port_")


def _owned(mod: str) -> bool:
    """Is ``mod`` a module of this package or of its tests?"""
    if mod == "repic_tpu_torch" or mod.startswith("repic_tpu_torch."):
        return True
    return mod.startswith(_TEST_PREFIXES)


def _creation_site(depth: int) -> str | None:
    """``module:line`` of the allocating frame, or None for frames
    outside repic_tpu_torch / the port's tests (those get raw locks)."""
    try:
        frame = sys._getframe(depth)
    except ValueError:  # pragma: no cover - shallow stack
        return None
    mod = frame.f_globals.get("__name__", "") or ""
    if not _owned(mod):
        return None
    return f"{mod}:{frame.f_lineno}"


class CheckedLock:
    """Recording proxy around a real Lock/RLock."""

    __slots__ = ("_lock", "site", "kind")

    def __init__(self, site: str, kind: str = "lock"):
        self._lock = (
            _ORIG_RLOCK() if kind == "rlock" else _RAW_ALLOCATE()
        )
        self.site = site
        self.kind = kind
        with _graph_lock:
            _sites.add(site)

    # -- recording ----------------------------------------------------

    def _record_acquire(self) -> None:
        stack = _held_stack()
        for held in stack:
            if held is self or held.site == self.site:
                continue
            _note_edge(held.site, self.site)
        stack.append(self)

    def _record_release(self) -> None:
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                return

    def held_by_current_thread(self) -> bool:
        return any(h is self for h in _held_stack())

    # -- lock protocol ------------------------------------------------

    def acquire(self, blocking=True, timeout=-1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._record_acquire()
        return got

    def release(self):
        self._record_release()
        self._lock.release()

    def locked(self):
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):  # pragma: no cover - debug aid
        return f"<CheckedLock {self.kind} {self.site}>"


def _note_edge(src: str, dst: str) -> None:
    with _graph_lock:
        dsts = _edges.setdefault(src, set())
        if dst in dsts:
            return
        dsts.add(dst)
        _edges.setdefault(dst, set())
        _edge_sites[(src, dst)] = threading.current_thread().name
        cycle = _find_cycle(dst, src)
        if cycle is not None:
            _violations.append(
                {
                    "kind": "lock-order-cycle",
                    "cycle": [src] + cycle,
                    "detail": (
                        "acquired "
                        + " -> ".join([src, dst])
                        + " while the reverse path "
                        + " -> ".join(cycle)
                        + " was already witnessed"
                    ),
                }
            )


def _find_cycle(start: str, goal: str) -> list | None:
    """Path start -> ... -> goal in the edge graph (DFS), or None.

    Called with the graph lock held; the graph is tiny (one node per
    static lock allocation site)."""
    stack = [(start, [start])]
    seen = set()
    while stack:
        node, path = stack.pop()
        if node == goal:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in sorted(_edges.get(node, ())):
            stack.append((nxt, path + [nxt]))
    return None


def note_write(what: str, lock) -> bool:
    """Witness hook for RT301: record a violation unless ``lock`` is
    held by the calling thread.  Returns True when properly guarded.
    No-op (True) for raw locks and when the sanitizer is inactive."""
    if not isinstance(lock, CheckedLock):
        return True
    if lock.held_by_current_thread():
        return True
    with _graph_lock:
        _violations.append(
            {
                "kind": "unguarded-write",
                "what": what,
                "lock": lock.site,
                "thread": threading.current_thread().name,
                "detail": (
                    f"write to {what} without holding the checked "
                    f"lock created at {lock.site}"
                ),
            }
        )
    return False


# -- factories + install/uninstall ------------------------------------


def checked_lock(site: str | None = None, kind: str = "lock"):
    """Explicitly create a checked lock (unit tests; no install)."""
    return CheckedLock(site or _creation_site(2) or "<direct>", kind)


def _lock_factory():
    site = _creation_site(2)
    if site is None:
        return _RAW_ALLOCATE()
    return CheckedLock(site, "lock")


def _rlock_factory():
    site = _creation_site(2)
    if site is None:
        return _ORIG_RLOCK()
    return CheckedLock(site, "rlock")


def install() -> bool:
    """Patch ``threading.Lock``/``RLock`` with the scoped factories.

    Idempotent; returns True when the sanitizer is (now) active."""
    global _installed, _found
    if _installed:
        return True
    _found = (threading.Lock, threading.RLock)
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    _installed = True
    return True


def uninstall() -> None:
    """Put ``threading.Lock``/``RLock`` back as :func:`install` found
    them."""
    global _installed, _found
    if not _installed:
        return
    threading.Lock, threading.RLock = _found or (_ORIG_LOCK, _ORIG_RLOCK)
    _found = None
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install_from_env() -> bool:
    """Install iff ``REPIC_TPU_LOCKCHECK=1``."""
    if enabled():
        return install()
    return False


# -- reporting --------------------------------------------------------


def edges() -> dict:
    """Snapshot of the witnessed acquisition-order graph."""
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def violations() -> list[dict]:
    with _graph_lock:
        return list(_violations)


def sites() -> set:
    """Creation sites (``module:line``) of the checked locks so far."""
    with _graph_lock:
        return set(_sites)


def reset() -> None:
    """Clear the graph and violations (test isolation)."""
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()
        _violations.clear()
        _sites.clear()


@contextlib.contextmanager
def scoped():
    """Isolate graph/violation mutations and the armed state (tests,
    and a program's armed stretch).

    Snapshots on entry, restores on exit: the graph and violations --
    those recorded by OTHER code before the scope survive -- and
    whether the sanitizer is installed, with ``threading.Lock`` /
    ``threading.RLock`` exactly as found (the JAX package's sanitizer
    may have patched them first)."""
    global _installed, _found
    with _graph_lock:
        edges_snap = {k: set(v) for k, v in _edges.items()}
        sites_snap = dict(_edge_sites)
        violations_snap = list(_violations)
        checked_snap = set(_sites)
    state = (_installed, _found, threading.Lock, threading.RLock)
    try:
        yield
    finally:
        _installed, _found, threading.Lock, threading.RLock = state
        with _graph_lock:
            _edges.clear()
            _edges.update(edges_snap)
            _edge_sites.clear()
            _edge_sites.update(sites_snap)
            _violations[:] = violations_snap
            _sites.clear()
            _sites.update(checked_snap)


def report_text() -> str:
    """Human-readable violation report, then the checked lock sites."""
    out = [f"LOCKCHECK {v['kind']}: {v['detail']}" for v in violations()]
    if not out:
        out.append("LOCKCHECK: no violations")
    checked = sorted(sites())
    if checked:
        out.append(f"LOCKCHECK checked lock sites ({len(checked)}): "
                   + ", ".join(checked))
    return "\n".join(out)
