"""Seeded synthetic inputs: picker directories at EMPIAR-10017
density, the project's dense-field stress field and k = 5 mixed-size
ensemble, packings whose rounding candidates nearly tie, 4096 x 4096
micrographs for the CNN picker and a ``build_subsets`` input.

Each micrograph holds true particles on a jittered grid (about 676 on
a 3,700-pixel field, spaced wider than an IoU of 0.3 reaches for box
180), seen by each of K pickers with probability 0.9 and a few pixels
of jitter, plus uniform false positives, so every picker file holds
600-950 boxes — the 10017 set's density (up to 908 boxes per file;
padded to N = 1024).  Files use the 5-column ``x y w h conf`` format.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from repic_tpu_torch.runtime.atomic import atomic_write

FIELD = 3700.0
GRID = 26

#: per-picker box sizes of the k = 5 mixed-size ensemble
MIXED_SIZES = (180.0, 200.0, 220.0, 160.0, 180.0)


def write_synthetic_dir(
    out_dir: str,
    *,
    n_micrographs: int = 256,
    pickers: int = 3,
    box_size: int = 180,
    seed: int = 0,
) -> list[str]:
    """Write ``out_dir/picker{p}/mic_{i:04d}.box``; returns the
    micrograph names."""
    rng = np.random.default_rng(seed)
    names = [f"mic_{i:04d}" for i in range(n_micrographs)]
    dirs = [os.path.join(out_dir, f"picker{p}") for p in range(pickers)]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    step = FIELD / GRID
    gx, gy = np.meshgrid(np.arange(GRID), np.arange(GRID))
    base = np.stack([gx.ravel(), gy.ravel()], -1) * step
    for name in names:
        true_xy = base + rng.uniform(-0.15, 0.15, base.shape) * step
        for d in dirs:
            seen = true_xy[rng.uniform(size=len(true_xy)) < 0.9]
            seen = seen + rng.normal(0.0, 8.0, seen.shape)
            n_total = int(rng.integers(600, 951))
            fp = rng.uniform(0.0, FIELD, (max(n_total - len(seen), 0), 2))
            xy = np.concatenate([seen, fp])
            conf = np.concatenate([
                rng.uniform(0.4, 1.0, len(seen)),
                rng.uniform(0.05, 0.6, len(fp)),
            ])
            order = rng.permutation(len(xy))
            lines = [
                f"{int(round(x))}\t{int(round(y))}\t{box_size}\t"
                f"{box_size}\t{c:.6f}\n"
                for (x, y), c in zip(xy[order], conf[order])
            ]
            with atomic_write(os.path.join(d, name + ".box"), "wt") as f:
                f.writelines(lines)
    return names


def near_tie_packings(
    n_packings: int, gadgets: int, background: int, seed: int = 0
):
    """Two-picker packings ``(member_vertex (B, C, 2) int32, w (B, C)
    float32, valid (B, C) bool, num_vertices)``, ``C = 3 * gadgets +
    background``, whose dual solve decides between candidates that
    nearly tie.

    Each gadget is a path of three cliques with weights ``p``, ``q``,
    ``r``: greedy by weight takes the middle one, the prices take the
    outer two, and ``q`` is ``p + r`` rounded to float32, mostly moved
    by one unit in the last place, so the two objectives differ by
    about one rounding.  Background cliques share no vertex.  Rows
    come in a seeded order.
    """
    rng = np.random.default_rng(seed)
    c = 3 * gadgets + background
    h = 2 * gadgets + background  # first vertex id of picker 1
    mv = np.zeros((n_packings, c, 2), np.int32)
    w = np.zeros((n_packings, c), np.float32)
    for b in range(n_packings):
        rows, ws = [], []
        for g in range(gadgets):
            p, r = (np.float32(x) for x in rng.uniform(0.3, 0.6, 2))
            q = np.float32(p + r)
            if rng.uniform() < 0.6:
                q = np.nextafter(q, np.float32(rng.choice([-1, 1]) * np.inf))
            a, v = 2 * g, h + 2 * g
            rows += [(a, v), (a + 1, v), (a + 1, v + 1)]
            ws += [p, q, r]
        for i in range(background):
            a = 2 * gadgets + i
            rows.append((a, h + a))
            ws.append(np.float32(rng.uniform(0.1, 1.0)))
        order = rng.permutation(c)
        mv[b] = np.asarray(rows, np.int32)[order]
        w[b] = np.asarray(ws, np.float32)[order]
    return mv, w, np.ones((n_packings, c), bool), 2 * h


def synthesize(m, k, n, seed=0, spacing=150.0, jitter=10.0):
    """Cluster-structured dense field (the stress configuration): ~n
    true particles on a grid ``spacing`` apart; each of k pickers
    reports each particle once with Gaussian jitter.  Returns ``xy (m,
    k, n, 2)``, ``conf (m, k, n)`` float32 and an all-True mask."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    base = (
        np.stack([gx, gy], -1).reshape(-1, 2)[:n].astype(np.float32)
        * spacing
        + spacing
    )
    xy = np.stack(
        [
            np.stack(
                [
                    base
                    + rng.normal(0, jitter, base.shape).astype(np.float32)
                    for _ in range(k)
                ]
            )
            for _ in range(m)
        ]
    )  # (m, k, n, 2)
    conf = rng.uniform(0.05, 1.0, size=(m, k, n)).astype(np.float32)
    mask = np.ones((m, k, n), bool)
    return xy, conf, mask


def _write_rows(path, xy, conf, box):
    """``x y box box conf`` rows, as ``f"{x:.2f}"`` etc. would write
    them, formatted in one ``%`` operation."""
    values = np.column_stack([xy, conf]).astype(np.float64).ravel()
    row = f"%.2f\t%.2f\t{box}\t{box}\t%.6f\n"
    with atomic_write(path, "wt") as f:
        f.write(row * len(conf) % tuple(values.tolist()))


def write_stress_dir(
    out_dir: str, m: int, *, k: int = 4, n: int = 50_000,
    box_size: int = 180, seed: int = 0,
) -> None:
    """The stress field of :func:`synthesize` as BOX files,
    ``out_dir/picker{p}/mic_{i:04d}.box`` (``x y w h conf``)."""
    xy, conf, _ = synthesize(m, k, n, seed=seed)
    for p in range(k):
        os.makedirs(os.path.join(out_dir, f"picker{p}"), exist_ok=True)
        for i in range(m):
            _write_rows(
                os.path.join(out_dir, f"picker{p}", f"mic_{i:04d}.box"),
                xy[i, p], conf[i, p], box_size,
            )


def synth_box_tree(
    dst: str, m: int, k: int, n_per: int, sizes, seed: int = 0
) -> None:
    """A k-picker BOX tree (one directory per picker) of ``m``
    micrographs: ``n_per`` particles uniform on the field, seen by
    every picker with 15 px of jitter, picker ``p`` at box
    ``sizes[p]`` (the k = 5 mixed-size ensemble)."""
    rng = np.random.default_rng(seed)
    for p in range(k):
        os.makedirs(os.path.join(dst, f"picker{p}"), exist_ok=True)
    for i in range(m):
        base = rng.uniform(200, 3800, size=(n_per, 2)).astype(
            np.float32
        )
        for p in range(k):
            jitter = rng.normal(0, 15, size=base.shape)
            conf = rng.uniform(0.05, 1.0, size=n_per)
            bs = int(sizes[p])
            with atomic_write(
                os.path.join(dst, f"picker{p}", f"mic_{i:04d}.box"),
                "wt",
            ) as f:
                for (x, y), c in zip(base + jitter, conf):
                    f.write(f"{x:.2f}\t{y:.2f}\t{bs}\t{bs}\t{c:.6f}\n")


#: the project's dense-field and k = 5 configurations as directory
#: cells: generator, picker count, particles per picker, box size(s)
CELLS = {
    # BASELINE.json configs[3]: 50,000 particles x 4 pickers, box 180
    "stress_50k": dict(
        box_size=180,
        write=lambda out, m, seed: write_stress_dir(
            out, m, k=4, n=50_000, box_size=180, seed=seed),
    ),
    # BASELINE.json configs[4]: 5 pickers of mixed box sizes, 700 each
    "k5_mixed": dict(
        box_size=np.asarray(MIXED_SIZES, np.float32),
        write=lambda out, m, seed: synth_box_tree(
            out, m, 5, 700, MIXED_SIZES, seed=seed),
    ),
}


def write_cell_dir(cell: str, out_dir: str, m: int, seed: int = 0):
    """Write ``m`` micrographs of a :data:`CELLS` entry as BOX files;
    returns the box size to run it with (a scalar, or one per
    picker)."""
    c = CELLS[cell]
    c["write"](out_dir, m, seed)
    return c["box_size"]


#: edge of the synthetic micrographs: EMPIAR-10017's 4096 x 4096
MICROGRAPH_SIZE = 4096


def synthetic_micrograph(seed: int, size: int = MICROGRAPH_SIZE,
                         box: int = 180):
    """A seeded ``(size, size)`` float32 micrograph at 10017's density:
    unit Gaussian noise plus 600-950 dark particle-like Gaussian blobs
    (sigma box/6, amplitude 1.5-3) whose centres keep a box-half from
    the edges.  Returns ``(image, centres)``, centres as ``(n, 2)``
    float32 (x, y) in pixels."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((size, size), dtype=np.float32)
    n = int(rng.integers(600, 951))
    half = box // 2
    centres = rng.uniform(half, size - half, size=(n, 2)).astype(np.float32)
    amp = rng.uniform(1.5, 3.0, size=n).astype(np.float32)
    sigma = box / 6.0
    r = int(3 * sigma)
    offs = np.arange(-r, r + 1, dtype=np.float32)
    for (x, y), a in zip(centres, amp):
        cx, cy = int(round(float(x))), int(round(float(y)))
        gx = np.exp(-0.5 * ((offs + cx - x) / sigma) ** 2)
        gy = np.exp(-0.5 * ((offs + cy - y) / sigma) ** 2)
        y0, y1 = max(cy - r, 0), min(cy + r + 1, size)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, size)
        blob = (a * np.outer(gy, gx)).astype(np.float32)
        img[y0:y1, x0:x1] -= blob[y0 - (cy - r):y1 - (cy - r),
                                  x0 - (cx - r):x1 - (cx - r)]
    return img, centres


def write_subsets_fixture(root: str, n: int = 40, seed: int = 2):
    """A ``build_subsets`` input under ``root``: ``mrc/`` with ``n``
    8 x 8 MRC files, ``box/`` with one BOX file each, and
    ``defocus.txt`` (``name dx dy`` per micrograph, seeded).  Returns
    ``(defocus_file, box_dir, mrc_dir)``."""
    from repic_tpu_torch.utils import mrc

    box_dir = os.path.join(root, "box")
    mrc_dir = os.path.join(root, "mrc")
    os.makedirs(box_dir, exist_ok=True)
    os.makedirs(mrc_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        base = f"mic_{i:03d}"
        mrc.write_mrc(os.path.join(mrc_dir, base + ".mrc"),
                      np.zeros((8, 8), np.float32))
        with atomic_write(os.path.join(box_dir, base + ".box"), "wt") as f:
            f.write("1\t1\t4\t4\t0.5\n")
        d = rng.uniform(1e4, 4e4)
        lines.append(f"{base}.mrc\t{d:.1f}\t{d:.1f}")
    defocus = os.path.join(root, "defocus.txt")
    with atomic_write(defocus, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return defocus, box_dir, mrc_dir


def subsets_membership(out_dir: str) -> dict:
    """``build_subsets``'s split membership: each output directory
    (relative to ``out_dir``) with the sorted names it links."""
    out = {}
    for d, _, files in sorted(os.walk(out_dir)):
        if files:
            out[os.path.relpath(d, out_dir)] = sorted(files)
    return out


def file_sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def tree_sha256(root: str) -> str:
    """One digest of every file under ``root``: relative paths and
    contents, in sorted order."""
    h = hashlib.sha256()
    for d, subdirs, files in sorted(os.walk(root)):
        subdirs.sort()
        for f in sorted(files):
            path = os.path.join(d, f)
            h.update(os.path.relpath(path, root).encode() + b"\0")
            h.update(file_sha256(path).encode())
    return h.hexdigest()


def pickle_sha256(path: str) -> str:
    """Digest of a pickle's content, not its bytes (the bytes depend on
    the numpy and scipy versions that wrote them): arrays by dtype
    kind, shape and values, sparse matrices as COO triples, lists and
    tuples element by element, floats by ``repr``."""
    import pickle

    with open(path, "rb") as f:
        obj = pickle.load(f)
    h = hashlib.sha256()

    def feed(x):
        if hasattr(x, "tocoo"):
            c = x.tocoo()
            h.update(f"coo{c.shape}".encode())
            for a in (c.row, c.col, c.data):
                feed(np.asarray(a, np.int64))
        elif isinstance(x, np.ndarray):
            h.update(f"nd{x.dtype.kind}{x.dtype.itemsize}{x.shape}".encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, (list, tuple)):
            h.update(f"{type(x).__name__}{len(x)}[".encode())
            for v in x:
                feed(v)
            h.update(b"]")
        else:
            h.update(f"{type(x).__name__}:{x!r};".encode())

    feed(obj)
    return h.hexdigest()


def output_digests(out_dir: str, exts=(".box", ".tsv")) -> dict:
    """Digests of a run's outputs in ``out_dir``, by file name, for the
    files with one of ``exts``: sha256 and line count; a pickle by
    content (:func:`pickle_sha256`); a ``_runtime.tsv`` by its
    largest-component and component-count columns (the first column
    is a time).  The JAX package's ``consensus_runtime.tsv`` is not an
    output."""
    out = {}
    for f in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, f)
        if f.endswith("runtime.tsv"):
            if "_runtime.tsv" in exts and not f.startswith("consensus"):
                with open(path) as fh:
                    out[f] = {"cc": fh.readline().split("\t")[1:3]}
        elif f.endswith(".pickle"):
            if ".pickle" in exts:
                out[f] = {"content_sha256": pickle_sha256(path)}
        elif f.endswith(exts):
            with open(path) as fh:
                rows = sum(1 for _ in fh)
            out[f] = {"sha256": file_sha256(path), "rows": rows}
    return out


#: what a journal record is compared on (``ts`` and ``wall_s`` are
#: clocks; of the ``trace`` id only its presence)
JOURNAL_RECORD_KEYS = ("status", "solver", "particles", "out", "stage")
JOURNAL_ERROR_KEYS = ("type", "kind", "path")


def dispatch_view(e: dict) -> dict:
    """A ``chunk_dispatches`` event as two packages compare it: its
    fields, the ``entry`` without its package (``repic_tpu.`` or
    ``repic_tpu_torch.``), the count reduced to whether it is a
    positive int (each package counts its own launches and fetches),
    the trace id to its presence."""
    out = {k: v for k, v in e.items() if k not in ("ts", "trace")}
    out["entry"] = str(out.get("entry", "")).split(".", 1)[-1]
    d = out.get("dispatches")
    out["dispatches"] = isinstance(d, int) and d > 0
    out["trace"] = "trace" in e
    return out


def journal_view(out_dir: str, root: str | None = None) -> dict:
    """A run's ``_journal.jsonl`` as two packages or two machines
    compare it: each micrograph's records in order (projected to
    :data:`JOURNAL_RECORD_KEYS` and the error's
    :data:`JOURNAL_ERROR_KEYS`, the error's path relative to ``root``
    when given, and whether it carries a ``trace`` id); the ladder
    events, clocks dropped and the trace id reduced to its presence, as
    sorted JSON strings -- the prefetch worker and the consumer write
    them from two threads; and the ``chunk_dispatches`` events in
    order, by :func:`dispatch_view` (one thread writes them, chunk by
    chunk)."""
    from repic_tpu_torch.runtime.journal import read_journal

    records, events, dispatches = {}, [], []
    for e in read_journal(out_dir):
        if "name" in e:
            r = {k: e.get(k) for k in JOURNAL_RECORD_KEYS}
            err = e.get("error")
            if err is not None:
                err = {k: err.get(k) for k in JOURNAL_ERROR_KEYS}
                if root is not None and err["path"]:
                    err["path"] = os.path.relpath(err["path"], root)
            r["error"] = err
            r["trace"] = "trace" in e
            records.setdefault(e["name"], []).append(r)
        elif e.get("event") == "chunk_dispatches":
            dispatches.append(dispatch_view(e))
        else:
            ev = {k: v for k, v in e.items() if k not in ("ts", "trace")}
            ev["trace"] = "trace" in e
            events.append(json.dumps(ev, sort_keys=True))
    return {"records": records, "events": sorted(events),
            "dispatches": dispatches}


def trace_view(out_dir: str, late_compile: bool = True) -> list:
    """``_trace.jsonl`` as two packages compare it: its records in
    order, the root as ``trace:<kind>`` and each segment as its name
    with ``[chunk]`` (ids and clocks dropped).  ``late_compile=False``
    leaves out the ``compile`` segments of chunks after the first: the
    run writes one when the chunk's window saw a build or a
    program-cache hit or miss, and which window sees them depends on
    the prefetch worker's timing and, in the reference, on XLA's
    compiles."""
    from repic_tpu_torch.telemetry.trace import read_trace

    out = []
    for rec in read_trace(out_dir):
        if rec.get("ev") == "trace":
            out.append(f"trace:{rec.get('kind')}")
        elif rec.get("ev") == "segment":
            seg, chunk = rec.get("seg"), rec.get("chunk")
            if seg == "compile" and chunk and not late_compile:
                continue
            out.append(seg if chunk is None else f"{seg}[{chunk}]")
    return out


#: registry entries that :func:`telemetry_view` leaves out: builds and
#: cached loads (a process's history), the prefetch overlap (timing),
#: status-server requests (the poller's pace)
TELEMETRY_SKIP = frozenset((
    "repic_persistent_cache_hits_total",
    "repic_consensus_prefetched_chunks_total",
    "repic_http_request_seconds",
))
#: the probe gauges that count logical events
TELEMETRY_GAUGES = ("repic_device_dispatches_total",
                    "repic_transfer_fetches_total")


def telemetry_view(out_dir: str) -> dict:
    """A telemetry-on run's artifacts as two packages compare them,
    clocks, ids, memory and builds left out:

    * ``metrics``: from ``_metrics.json``, every counter's value and
      every histogram's count per label set (not :data:`TELEMETRY_SKIP`),
      and the gauges of :data:`TELEMETRY_GAUGES`;
    * ``spans``: ``"name<parent"`` (the parent span's name, or
      nothing) -> count, from ``_events.jsonl``;
    * ``trace``: :func:`trace_view`;
    * ``journal``: per micrograph, and per event (``chunk_dispatches``
      included), whether each record carries a ``trace`` id."""
    from repic_tpu_torch.runtime.journal import read_journal
    from repic_tpu_torch.telemetry.events import read_events
    from repic_tpu_torch.telemetry.sinks import read_metrics_json

    metrics = {}
    for name, entry in sorted(read_metrics_json(out_dir).items()):
        if name in TELEMETRY_SKIP or not entry["samples"]:
            continue
        kind = entry["kind"]
        if kind == "gauge" and name not in TELEMETRY_GAUGES:
            continue
        metrics[name] = {
            json.dumps(sm["labels"], sort_keys=True):
                sm["count"] if kind == "histogram" else sm["value"]
            for sm in entry["samples"]
        }
    spans = [r for r in read_events(out_dir) if r.get("ev") == "span"]
    names = {r["span"]: r["name"] for r in spans}
    span_counts: dict = {}
    for r in spans:
        key = f"{r['name']}<{names.get(r.get('parent'), '')}"
        span_counts[key] = span_counts.get(key, 0) + 1
    journal: dict = {"records": {}, "events": []}
    for e in read_journal(out_dir):
        if "name" in e:
            journal["records"].setdefault(e["name"], []).append(
                "trace" in e)
        else:
            journal["events"].append([e["event"], "trace" in e])
    journal["events"].sort()
    return {"metrics": metrics, "spans": dict(sorted(span_counts.items())),
            "trace": trace_view(out_dir), "journal": journal}


#: serve-record keys that are clocks, process ids, timings, or (in the
#: port) the counts of a library build or load, left out of
#: :func:`job_view` and :func:`serve_journal_view`
SERVE_VOLATILE = frozenset((
    "ts", "pid", "port", "accepted_ts", "started_ts", "finished_ts",
    "wall_s", "compile_s", "persistent_cache_hits", "persistent_hit_s",
    "fresh_compiles",
))


def _serve_record(rec: dict, ids: dict, root: str | None) -> dict:
    """One serve record (job document or journal line) projected: the
    volatile keys dropped, job ids replaced by their order of first
    appearance, trace ids and deadlines reduced to their presence,
    paths relative to ``root``, errors to the journal's error keys."""
    out = {}
    for key, val in rec.items():
        if key in SERVE_VOLATILE:
            continue
        if key in ("id", "job"):
            val = ids.setdefault(val, f"job{len(ids)}")
        elif key == "recovered":
            val = [ids.setdefault(j, f"job{len(ids)}") for j in val]
        elif key in ("trace", "trace_id", "deadline_ts"):
            val = val is not None
        elif key == "error" and isinstance(val, dict):
            val = {k: val.get(k) for k in JOURNAL_ERROR_KEYS}
        elif (key == "request" and isinstance(val, dict) and root
              and "in_dir" in val):
            val = dict(val, in_dir=os.path.relpath(val["in_dir"], root))
        elif key == "result" and isinstance(val, dict):
            val = {k: v for k, v in val.items() if k != "out_dir"}
        elif key == "compile_cache":
            val = os.path.basename(val)
        elif key == "buckets":
            val = [_serve_record(b, ids, root) for b in val]
        out[key] = val
    return out


def job_view(doc: dict, root: str | None = None) -> dict:
    """A ``GET /v1/jobs/<id>`` document as two daemons compare it (see
    :func:`_serve_record`; ``root`` makes ``request.in_dir``
    relative)."""
    return _serve_record(doc, {}, root)


def serve_journal_view(work_dir: str, root: str | None = None) -> list:
    """A daemon's ``_serve_journal.jsonl`` as two daemons compare it:
    every record in order, projected by :func:`_serve_record` with job
    ids numbered by first appearance."""
    from repic_tpu_torch.runtime.journal import _read_entries

    ids: dict = {}
    return [_serve_record(e, ids, root) for e in _read_entries(
        os.path.join(work_dir, "_serve_journal.jsonl"))]


#: the serve burst's small jobs, in micrographs (bench_serve.py's mix)
SERVE_SMALL_SIZES = (1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7, 8)


def split_into_jobs(in_dir: str, out_root: str,
                    sizes=SERVE_SMALL_SIZES) -> list[str]:
    """Split a picker directory into serve job directories of
    ``sizes`` micrographs each, in name order, plus one job of the
    rest, which lands mid-burst (the head-of-line case): each job's
    ``<picker>/<name>.box`` is a symbolic link to the input file.
    Returns the job directories in submission order."""
    pickers = sorted(d for d in os.listdir(in_dir)
                     if os.path.isdir(os.path.join(in_dir, d)))
    names = sorted(f[:-4] for f in os.listdir(
        os.path.join(in_dir, pickers[0])) if f.endswith(".box"))
    bounds = np.cumsum((0,) + tuple(sizes))
    if bounds[-1] >= len(names):
        raise ValueError(f"{len(names)} micrographs cannot fill jobs of "
                         f"{list(sizes)} and a large one")
    parts = [names[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    jobs = [(f"small{j:02d}", part) for j, part in enumerate(parts)]
    mid = len(jobs) // 2
    jobs.insert(mid, ("large", names[bounds[-1]:]))
    out = []
    for job, part in jobs:
        root = os.path.join(out_root, job)
        for p in pickers:
            os.makedirs(os.path.join(root, p), exist_ok=True)
            for name in part:
                os.symlink(os.path.abspath(os.path.join(in_dir, p,
                                                        name + ".box")),
                           os.path.join(root, p, name + ".box"))
        out.append(root)
    return out
