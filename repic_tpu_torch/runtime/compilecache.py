"""The program-signature sidecar of a serve deployment (the port's copy
of ``repic_tpu.runtime.compilecache``).

``programs.json`` in the cache directory lists the exact signatures
:func:`repic_tpu_torch.pipeline.consensus.run_consensus_batch` executed
(threshold, capacities, spatial/solver knobs, batch shape), in the
reference's format byte for byte.  The serve daemon's startup warmup
replays them (:func:`repic_tpu_torch.pipeline.engine.warmup_from_cache`),
so a restarted daemon has every capacity bucket it served before
registered as warm before readiness goes green.

The reference also points XLA's persistent executable cache at the
directory.  The port compiles no program per signature: its compiled
code is the kernel and host libraries that
:mod:`repic_tpu_torch._build` and :mod:`repic_tpu_torch.native` keep in
``build/repic_tpu_torch/``, which already persist across processes.  So
:func:`enable` only records the directory.

The sidecar is an optimisation, never a correctness dependency: a
missing or corrupt file warms nothing.
"""

from __future__ import annotations

import json
import os
import threading

PROGRAMS_NAME = "programs.json"
ENV_DIR = "REPIC_TPU_COMPILE_CACHE"
#: sidecar bound: one entry per distinct program signature
MAX_PROGRAMS = 128

_lock = threading.Lock()
_enabled_dir: str | None = None
_seen: set = set()


def resolve_dir(explicit: str | None, default: str) -> str | None:
    """The cache directory an entry point should use: an explicit
    path wins, then ``$REPIC_TPU_COMPILE_CACHE``, then ``default``.
    The explicit value ``"off"`` (or an env var of ``"off"``/``"0"``)
    disables persistence entirely (returns None)."""
    choice = explicit or os.environ.get(ENV_DIR) or default
    if not choice or str(choice).lower() in ("off", "0", "none"):
        return None
    return os.path.abspath(choice)


def enable(cache_dir: str) -> str:
    """Record ``cache_dir`` as the sidecar's directory (created);
    idempotent; returns the absolute directory."""
    global _enabled_dir
    path = os.path.abspath(cache_dir)
    os.makedirs(path, exist_ok=True)
    with _lock:
        _enabled_dir = path
    return path


def enabled_dir() -> str | None:
    return _enabled_dir


def _programs_path(cache_dir: str | None = None) -> str | None:
    d = cache_dir or _enabled_dir
    return None if d is None else os.path.join(d, PROGRAMS_NAME)


def _entry_key(entry: dict) -> tuple:
    return tuple(
        json.dumps(entry.get(k), sort_keys=True)
        for k in sorted(entry)
    )


def record_program(entry: dict) -> None:
    """Append one executed program signature to the sidecar.

    No-op unless :func:`enable` ran.  Deduped in memory first, then
    read-merge-replace under ``file_lock`` so processes sharing the
    directory never drop each other's entries.  Best-effort: any
    failure is swallowed.
    """
    path = _programs_path()
    if path is None:
        return
    key = _entry_key(entry)
    with _lock:
        if key in _seen:
            return
        _seen.add(key)
    from repic_tpu_torch.runtime.atomic import file_lock

    try:
        with file_lock(path):
            entries = []
            try:
                with open(path) as f:
                    loaded = json.load(f)
                if isinstance(loaded, list):
                    entries = [
                        e for e in loaded if isinstance(e, dict)
                    ]
            except (OSError, ValueError):
                pass
            entries = [
                e for e in entries if _entry_key(e) != key
            ]
            entries.append(entry)
            del entries[:-MAX_PROGRAMS]
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wt") as f:
                json.dump(entries, f)
            os.replace(tmp, path)
    except (OSError, ValueError, TypeError):
        pass


def load_programs(cache_dir: str | None = None) -> list[dict]:
    """The recorded program signatures (oldest first), or ``[]``;
    a corrupt or missing sidecar reads as empty."""
    path = _programs_path(cache_dir)
    if path is None:
        return []
    try:
        with open(path) as f:
            loaded = json.load(f)
    except (OSError, ValueError):
        return []
    if not isinstance(loaded, list):
        return []
    return [e for e in loaded if isinstance(e, dict)]
