"""Run journal and manifest: per-micrograph outcomes and ``--resume``
(the one-host part of ``repic_tpu.runtime.journal``).

A directory run appends one JSON line per micrograph to
``_journal.jsonl`` in its output directory: the outcome (``ok``,
``retried``, ``degraded``, ``quarantined``, ``skipped``), the solver
rung that ran, the output file and, for a quarantined input, a
structured error.  Run-level events (a halved chunk, a retry, a
solver demotion) are lines of their own.  ``_manifest.json`` pins the
run configuration (the flags that change output content, and the
input names), so ``--resume`` tells "the same run, continue" from "a
different run in the same directory".

Resume contract:

* a micrograph whose latest status is done (``ok``, ``retried``,
  ``degraded``, ``skipped``) and whose output file exists is not
  processed again;
* a quarantined micrograph, or one without an entry or an output, is;
* a manifest of another configuration discards the journal.

The journal is flushed per line, and a torn last line (a crash mid
append) is skipped on read.  A record written while a trace context
is active (:mod:`repic_tpu_torch.telemetry.trace`) carries its
``trace`` id.

Cluster runs (``RunJournal.open(..., host=, cluster=True)``): each
host appends to its own ``_journal.<host>.jsonl`` (one writer per
file; a crashed host tears at most its own last line) and every record
carries ``host``.  Readers merge on read: :func:`read_all_journals`
concatenates every journal file of the run sorted by timestamp and
:func:`merged_latest` folds it last-writer-wins per micrograph, the
view a cluster resume, the orphan harvest and ``report`` trust.  The
shared ``_manifest.json`` is created once under
:func:`~repic_tpu_torch.runtime.atomic.file_lock`; a cluster open of
another configuration raises :class:`ManifestMismatch` instead of
restarting, since deleting a directory under live peers is never
safe.
"""

from __future__ import annotations

import glob
import json
import os
import re
import threading
import time

from repic_tpu_torch.runtime.atomic import atomic_write, file_lock

JOURNAL_NAME = "_journal.jsonl"
MANIFEST_NAME = "_manifest.json"


def sanitize_host_id(host: str) -> str:
    """A host id as a file-name component: one alphabet, so the id in
    a record and the id in a file name never diverge."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(host))
    if not safe:
        raise ValueError(f"empty host id after sanitizing {host!r}")
    return safe


def host_journal_name(host: str) -> str:
    """Per-host journal file name."""
    return f"_journal.{sanitize_host_id(host)}.jsonl"


def host_artifact_paths(
    out_dir: str, base_name: str
) -> list[tuple[str | None, str]]:
    """``(host, path)`` for every instance of a per-run artifact: the
    single-process ``<stem><ext>`` (host ``None``) first, then every
    per-host ``<stem>.<host><ext>``, hosts sorted.  Shared by the
    journal, the event log, the metric snapshots and the trace."""
    stem, ext = os.path.splitext(base_name)
    out: list[tuple[str | None, str]] = []
    base = os.path.join(out_dir, base_name)
    if os.path.exists(base):
        out.append((None, base))
    for path in sorted(
        glob.glob(os.path.join(out_dir, f"{stem}.*{ext}"))
    ):
        host = os.path.basename(path)[len(stem) + 1 : -len(ext)]
        out.append((host, path))
    return out


def journal_paths(out_dir: str) -> list[str]:
    """Every journal file of a run, single-process one first."""
    return [
        path
        for _, path in host_artifact_paths(out_dir, JOURNAL_NAME)
    ]

STATUS_OK = "ok"
STATUS_RETRIED = "retried"        # succeeded after at least one retry
STATUS_DEGRADED = "degraded"      # succeeded on a fallback rung
STATUS_QUARANTINED = "quarantined"
STATUS_SKIPPED = "skipped"        # empty output (a picker has no input)
DONE_STATUSES = frozenset(
    (STATUS_OK, STATUS_RETRIED, STATUS_DEGRADED, STATUS_SKIPPED)
)


class ManifestMismatch(ValueError):
    """A cluster open found a manifest pinning a different run."""


def error_info(exc: BaseException, **extra) -> dict:
    """JSON-safe description of a failure for the journal."""
    info = {"type": type(exc).__name__, "message": str(exc)[:500]}
    info.update(extra)
    return info


class RunJournal:
    """Append-only JSONL journal with a configuration manifest."""

    def __init__(self, out_dir: str, host: str | None = None):
        self.out_dir = out_dir
        self.host = host
        self.path = os.path.join(
            out_dir, host_journal_name(host) if host else JOURNAL_NAME)
        self.manifest_path = os.path.join(out_dir, MANIFEST_NAME)
        self.resumed = False
        self._latest: dict[str, dict] = {}
        self._events: list[dict] = []
        self._fh = None
        # the prefetch worker records ladder events while the consumer
        # records outcomes: one line per write, under this lock
        self._wlock = threading.Lock()

    @classmethod
    def open(cls, out_dir: str, config: dict, *, resume: bool = False,
             host: str | None = None, cluster: bool = False):
        """Open the journal of a run configuration; with ``resume`` and
        a manifest of the same configuration, load its entries.

        ``config`` must be JSON-serialisable; it is compared after a
        JSON round trip, so a tuple and a list are the same.

        ``cluster`` (needs ``host``) appends to this host's
        ``_journal.<host>.jsonl`` and loads the merged view of every
        host's journal; the manifest is written once under a file lock
        and one of another configuration raises
        :class:`ManifestMismatch`."""
        if cluster and not host:
            raise ValueError("cluster journals require a host id")
        j = cls(out_dir, host=host)
        config = json.loads(json.dumps(config))
        os.makedirs(out_dir, exist_ok=True)
        if cluster:
            with file_lock(j.manifest_path):
                prev = j._read_manifest()
                if prev is None:
                    with atomic_write(j.manifest_path) as f:
                        json.dump({"config": config, "created": time.time()},
                                  f, indent=2)
                elif prev.get("config") != config:
                    raise ManifestMismatch(
                        f"manifest in {out_dir} pins a different run "
                        "configuration; cluster mode never restarts a "
                        "shared directory — point the run elsewhere "
                        "or fix the flags"
                    )
            entries = read_all_journals(out_dir)
            j._latest.update(fold_latest(entries))
            j._events.extend(e for e in entries if "event" in e)
            j.resumed = bool(j._latest or j._events)
            return j
        prev = j._read_manifest()
        if resume and prev is not None and prev.get("config") == config:
            j.resumed = True
            j._load_entries()
        elif os.path.exists(j.path):
            os.unlink(j.path)  # a stale journal of another run
        with atomic_write(j.manifest_path) as f:
            json.dump({"config": config, "created": time.time()}, f,
                      indent=2)
        return j

    def close(self) -> None:
        with self._wlock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def record(self, name: str, status: str, **fields) -> dict:
        """Append one micrograph's outcome."""
        entry = {"name": name, "status": status, "ts": time.time()}
        entry.update(fields)
        if self.host:
            entry["host"] = self.host
        self._append(entry)
        self._latest[name] = entry
        return entry

    def record_event(self, event: str, **fields) -> dict:
        """Append a run-level event (a retry, a halved chunk, ...)."""
        entry = {"event": event, "ts": time.time()}
        entry.update(fields)
        if self.host:
            entry["host"] = self.host
        self._append(entry)
        self._events.append(entry)
        return entry

    def _append(self, entry: dict) -> None:
        # lazy: the telemetry package imports this module
        from repic_tpu_torch.telemetry.trace import current_trace_id

        tid = current_trace_id()
        if tid is not None and "trace" not in entry:
            entry["trace"] = tid
        line = json.dumps(entry) + "\n"
        # serializing the write+flush IS this lock's purpose: the
        # prefetch worker and the emitting consumer share one append
        # handle, and a flush outside the lock could interleave two
        # half-written lines in the durability contract's file
        with self._wlock:  # repic: noqa[RT303]
            if self._fh is None:
                self._fh = open(self.path, "at")
            self._fh.write(line)
            self._fh.flush()

    def latest(self) -> dict[str, dict]:
        """The latest entry per micrograph name (events excluded)."""
        return dict(self._latest)

    def events(self) -> list[dict]:
        return list(self._events)

    def done_names(self) -> set[str]:
        """Names whose latest status is done (a quarantined entry is
        not: resume retries it)."""
        return {
            n for n, e in self._latest.items()
            if e.get("status") in DONE_STATUSES
        }

    def quarantined(self) -> dict[str, dict]:
        return {
            n: e for n, e in self._latest.items()
            if e.get("status") == STATUS_QUARANTINED
        }

    def summary(self) -> dict:
        """Status -> count over the latest entry of every micrograph."""
        out: dict[str, int] = {}
        for e in self._latest.values():
            s = e.get("status", "unknown")
            out[s] = out.get(s, 0) + 1
        return out

    def _read_manifest(self):
        try:
            with open(self.manifest_path) as f:
                data = json.load(f)
            return data if isinstance(data, dict) else None
        except (OSError, ValueError):
            return None

    def _load_entries(self) -> None:
        for entry in _read_entries(self.path):
            if "name" in entry:
                self._latest[entry["name"]] = entry
            elif "event" in entry:
                self._events.append(entry)


def read_journal(out_dir: str) -> list[dict]:
    """Every entry of a run's journal, a torn last line skipped."""
    return _read_entries(os.path.join(out_dir, JOURNAL_NAME))


def _read_entries(path: str) -> list[dict]:
    entries: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entries.append(json.loads(line))
                except ValueError:
                    continue  # torn trailing line from a crash
    except OSError:
        pass
    return entries


def _gang_epoch_of(entry: dict) -> "int | None":
    """The entry's ``gang_epoch``, or None for a record without one."""
    raw = entry.get("gang_epoch")
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        return None


def fold_latest(entries) -> dict[str, dict]:
    """Last-writer-wins fold of timestamp-sorted micrograph records,
    except that between two records with ``gang_epoch`` the one of the
    lower epoch loses (a fenced straggler's late write)."""
    latest: dict[str, dict] = {}
    for entry in entries:
        name = entry.get("name")
        if name is None:
            continue
        prev = latest.get(name)
        if prev is not None:
            pe, ce = _gang_epoch_of(prev), _gang_epoch_of(entry)
            if pe is not None and ce is not None and ce < pe:
                continue
        latest[name] = entry
    return latest


def read_all_journals(out_dir: str) -> list[dict]:
    """Every entry of every journal file of a run, stable-sorted by
    timestamp (each file's torn last line skipped)."""
    entries: list[dict] = []
    for path in journal_paths(out_dir):
        entries.extend(_read_entries(path))
    entries.sort(key=lambda e: float(e.get("ts", 0.0)))
    return entries


def merged_latest(out_dir: str) -> dict[str, dict]:
    """The latest entry per micrograph over all journal files."""
    return fold_latest(read_all_journals(out_dir))


class MergedJournalReader:
    """Incremental merge-on-read for pollers: re-parses only the files
    whose size changed since the last call (journals are append-only).
    ``base_name`` picks the artifact family (the run journal, or a
    serve journal keyed by ``job``, which callers fold themselves)."""

    def __init__(self, out_dir: str, base_name: str = JOURNAL_NAME):
        self.out_dir = out_dir
        self.base_name = base_name
        self._cache: dict[str, tuple[int, list[dict]]] = {}
        #: bumped whenever a file is (re)parsed or dropped
        self.version = 0

    def entries(self) -> list[dict]:
        """Every entry of the family, stable-sorted by timestamp."""
        entries: list[dict] = []
        for _host, path in host_artifact_paths(
            self.out_dir, self.base_name
        ):
            try:
                size = os.path.getsize(path)
            except OSError:
                if self._cache.pop(path, None) is not None:
                    self.version += 1
                continue
            cached = self._cache.get(path)
            if cached is None or cached[0] != size:
                self._cache[path] = (size, _read_entries(path))
                self.version += 1
            entries.extend(self._cache[path][1])
        entries.sort(key=lambda e: float(e.get("ts", 0.0)))
        return entries

    def latest(self) -> dict[str, dict]:
        return fold_latest(self.entries())
