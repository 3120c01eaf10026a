"""Run a test module of the JAX package against both packages.

A *twin* is the source of one of ``repic_tpu``'s test files, executed
twice: as written (``"jax"``), and with every ``repic_tpu`` module
name replaced by ``repic_tpu_torch`` plus a few listed substitutions
(``"port"``) -- the CLI's ``--device cpu``, a daemon's ``device``.
Each case then runs in a directory of its own per package, from the
same process state, with the same fixtures; the reference's assertions
hold for both, and :func:`tree_view` of the two directories -- the
file set and every journal, job ids canonicalised and clocks dropped
-- must be equal.
"""

from __future__ import annotations

import contextlib
import glob
import importlib
import inspect
import json
import os
import re
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("jax", "port")
_REF = re.compile(r"\brepic_tpu\b(?!_torch)")

#: journal keys that are clocks, process ids, ports or timings
VOLATILE = frozenset((
    "ts", "pid", "port", "trace", "trace_id", "accepted_ts",
    "started_ts", "finished_ts", "wall_s", "compile_s", "age_s",
    "created", "persistent_cache_hits", "persistent_hit_s",
    "fresh_compiles", "run_id", "work_dir", "host_pid",
))

_TWINS: dict = {}


def load_twin(test_file: str, pkg: str, subs=(),
              name: str | None = None) -> types.ModuleType:
    """The test module ``tests/<test_file>`` for ``pkg``: as written
    for ``"jax"``; for ``"port"`` with the package renamed and each
    ``(old, new)`` of ``subs`` replaced (each must occur).  ``name`` is
    the module's ``__name__`` (default ``_twin_<pkg>_<stem>``): a
    sanitizer that scopes by the allocating frame's module reads it."""
    key = (test_file, pkg, tuple(subs), name)
    if key in _TWINS:
        return _TWINS[key]
    path = os.path.join(REPO, "tests", test_file)
    with open(path) as f:
        src = f.read()
    if pkg == "port":
        src = _REF.sub("repic_tpu_torch", src)
        for old, new in subs:
            assert old in src, f"{test_file}: no {old!r} to replace"
            src = src.replace(old, new)
    if name is None:
        name = f"_twin_{pkg}_{os.path.splitext(test_file)[0]}"
    mod = types.ModuleType(name)
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)  # noqa: S102
    _TWINS[key] = mod
    return mod


def case_names(test_file: str, skip=()) -> list:
    """The ``test_*`` functions of a reference test file, in file
    order, as pytest params carrying the reference's marks."""
    mod = load_twin(test_file, "jax")
    out = []
    for name, fn in mod.__dict__.items():
        if not name.startswith("test_") or not callable(fn):
            continue
        if name in skip:
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name in ("faults",)]
        out.append(pytest.param(name, marks=marks, id=name))
    return out


def run_case(mod, name: str, root: str, capsys=None):
    """Call ``mod.<name>`` with its fixtures: ``tmp_path`` is ``root``
    (created), ``monkeypatch`` a fresh one undone afterwards,
    ``capsys`` the caller's (drained first), ``rng`` the conftest's
    seeded generator."""
    fn = getattr(mod, name)
    os.makedirs(root, exist_ok=True)
    kwargs = {}
    with contextlib.ExitStack() as stack:
        for param in inspect.signature(fn).parameters:
            if param == "tmp_path":
                import pathlib

                kwargs[param] = pathlib.Path(root)
            elif param == "monkeypatch":
                mp = pytest.MonkeyPatch()
                stack.callback(mp.undo)
                kwargs[param] = mp
            elif param == "capsys":
                capsys.readouterr()
                kwargs[param] = capsys
            elif param == "rng":
                kwargs[param] = np.random.default_rng(0)
            else:
                raise AssertionError(f"{name}: no fixture {param!r}")
        return fn(**kwargs)


def _job_ids(root: str) -> dict:
    """Job id -> ``job<i>`` by first appearance over the root's
    request journals (files sorted, records in order)."""
    ids: dict = {}
    paths = sorted(glob.glob(os.path.join(root, "**", "_serve_journal*"),
                             recursive=True))
    for path in paths:
        for rec in _read_lines(path):
            for key in ("job", "id"):
                v = rec.get(key)
                if isinstance(v, str) and v not in ids:
                    ids[v] = f"job{len(ids)}"
    for path in sorted(glob.glob(os.path.join(root, "**", "_joblease.*"),
                                 recursive=True)
                       + glob.glob(os.path.join(root, "**", "_done.*"),
                                   recursive=True)):
        v = os.path.basename(path).split(".")[1]
        ids.setdefault(v, f"job{len(ids)}")
    return ids


def _read_lines(path: str) -> list:
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # a torn last line
    return out


def _canon(value, ids: dict, root: str):
    if isinstance(value, dict):
        return {_canon(k, ids, root): _canon(v, ids, root)
                for k, v in value.items() if k not in VOLATILE}
    if isinstance(value, list):
        return [_canon(v, ids, root) for v in value]
    if isinstance(value, str):
        for jid, c in ids.items():
            value = value.replace(jid, c)
        value = value.replace(root, "<root>")
        return _REF.sub("<pkg>", value.replace("repic_tpu_torch",
                                               "<pkg>"))
    return value


def tree_view(root: str) -> dict:
    """What two packages' runs of one case are compared on: the set of
    files under ``root`` (job ids canonicalised; the ``.box`` files,
    journals and coordination records by name), and every JSONL
    journal's records in order with :data:`VOLATILE` keys dropped."""
    ids = _job_ids(root)
    files, journals = [], {}
    for dirpath, _dirs, names in os.walk(root):
        for nm in names:
            rel = os.path.relpath(os.path.join(dirpath, nm), root)
            if "__pycache__" in rel or rel.startswith("_replicas"):
                continue
            crel = _canon(rel, ids, root)
            files.append(crel)
            if nm.endswith(".jsonl") and (
                    nm.startswith("_journal") or
                    nm.startswith("_serve_journal") or
                    nm.startswith("_autoscale")):
                recs = _read_lines(os.path.join(dirpath, nm))
                journals[crel] = [
                    _canon(r, ids, root) for r in recs
                    if r.get("event") != "chunk_dispatches"
                ]
    return {"files": sorted(files), "journals": journals}


def fresh(pkg: str) -> None:
    """Process state a case must not inherit: the fault plan, the
    status server's pushed fields."""
    root = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    importlib.import_module(f"{root}.runtime.faults").clear()
    server = importlib.import_module(f"{root}.telemetry.server")
    with server._STATUS_LOCK:
        server._STATUS.clear()


def run_twins(test_file: str, name: str, tmp_path, subs=(), capsys=None,
              compare=True):
    """Run case ``name`` of ``test_file`` for both packages under
    ``tmp_path/<pkg>`` and hold the trees equal; returns the views."""
    views = {}
    for pkg in PKGS:
        fresh(pkg)
        mod = load_twin(test_file, pkg, subs if pkg == "port" else ())
        root = os.path.join(str(tmp_path), pkg)
        run_case(mod, name, root, capsys)
        fresh(pkg)
        views[pkg] = tree_view(root)
    if compare:
        assert views["port"] == views["jax"]
    return views
