"""Particle-coordinate format conversion (STAR / BOX / CBOX / TSV / CS),
the port of ``repic_tpu.utils.coords`` without pandas.

N-way conversion between RELION STAR, EMAN BOX, crYOLO CBOX, Topaz TSV
and CryoSparc ``.cs`` files, with column remapping, center<->corner
geometry shifts, rounding, confidence normalization / backfill, and
single-file or per-micrograph-split output.  Formats are entries in a
registry (:data:`FORMATS`) carrying a parser and a default column map;
conversion is a pipeline of small steps over a canonical
:class:`~repic_tpu_torch.utils.table.Table` whose columns are a subset
of ``["x", "y", "w", "h", "conf", "name"]``.  The table keeps pandas'
per-column dtypes and text rules, so every output file is byte for
byte the reference's.  Host code only.
"""

import math
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np

from repic_tpu_torch.runtime.atomic import atomic_write
from repic_tpu_torch.utils.box_io import _is_float
from repic_tpu_torch.utils.table import (
    EmptyDataError,
    ParserError,
    Table,
    concat,
    group_by,
    infer_column,
    read_whitespace_table,
)

# Canonical column names, in canonical order.
COLUMNS = ("x", "y", "w", "h", "conf", "name")

# RELION STAR loop labels
STAR_LABELS = {
    "x": "_rlnCoordinateX",
    "y": "_rlnCoordinateY",
    "conf": "_rlnAutopickFigureOfMerit",
    "name": "_rlnMicrographName",
}

AUTO = "auto"

_log_quiet = False


def _log(msg, lvl=0):
    """Leveled logger: 0 info (suppressed by quiet), 1 warn, 2 fatal."""
    if lvl == 0 and _log_quiet:
        return
    print(("INFO: ", "WARN: ", "CRITICAL: ")[lvl] + str(msg))
    if lvl == 2:
        sys.exit(1)


def _has_digit(s) -> bool:
    return re.search("[0-9]", str(s)) is not None


def _drop_nonnumeric_rows(t: Table) -> Table:
    """Drop rows whose non-missing values are all non-numbers (CBOX
    footers, a tabular header)."""
    if not len(t):
        return t
    keep = []
    for i in range(len(t)):
        vals = [v for v in t.row_values(i)
                if not (isinstance(v, (float, np.floating)) and math.isnan(v))]
        keep.append(not all(not _is_float(v) for v in vals))
    return t.rows(keep)


# --------------------------------------------------------------------
# parsers -- each returns a raw Table; columns are either integer
# positions (tsv-like formats) or STAR label strings
# --------------------------------------------------------------------


def read_tsv_like(path) -> Table:
    """Whitespace-delimited table; leading non-numeric / ``_``-label
    lines are skipped and trailing all-non-numeric rows (CBOX footers)
    are dropped."""
    skip = None
    with open(path, "rt") as f:
        for i, line in enumerate(f):
            if not line.startswith("_") and _has_digit(line):
                skip = i
                break
    if skip is None:
        # Header-only file: a tabular header still tokenizes and keeps
        # its positional columns; a ragged STAR-style header gives a
        # structureless empty table.
        try:
            t = read_whitespace_table(path)
        except (EmptyDataError, ParserError):
            return Table()
        return _drop_nonnumeric_rows(t)
    try:
        t = read_whitespace_table(path, skiprows=skip)
    except EmptyDataError:
        return Table()
    return _drop_nonnumeric_rows(t)


def read_star(path) -> Table:
    """RELION STAR table reader: ``_label #N`` loop headers map
    positions to labels, ``data_optics`` blocks are skipped, then the
    whitespace table is read and its columns renamed to the labels."""
    header: dict[int, str] = {}
    data_start = 0
    with open(path, "rt") as f:
        skipping_block = False
        for i, line in enumerate(f):
            ln = line.strip()
            if not ln:
                continue
            if ln.startswith("data_"):
                skipping_block = "data_optics" in ln
                continue
            if skipping_block:
                continue
            if ln.startswith("_") and ln.count("#") == 1:
                label, _, pos = ln.partition("#")
                try:
                    header[int(pos) - 1] = label.strip()
                except ValueError:
                    _log("STAR file not properly formatted", lvl=2)
                data_start = i + 1
            elif header and _has_digit(ln):
                data_start = i
                break
    try:
        t = read_whitespace_table(path, skiprows=data_start)
        t = t.rename({t.columns[k]: v for k, v in header.items()})
    except EmptyDataError:
        t = Table({v: np.empty(0, dtype=object) for v in header.values()})
    return t


def read_cs(path) -> Table:
    """CryoSparc ``.cs`` structured-array reader: fractional centre
    coordinates scaled to pixels by the stored micrograph dims, box w/h
    from the blob shape field.  Output columns are already canonical."""
    try:
        data = np.load(path, allow_pickle=True)
    except ValueError:
        _log(f"numpy could not load {path}", lvl=2)
    if len(data) == 0:
        _log(f"no data found in file at {path}", lvl=2)
    rows = data.tolist()
    return Table({
        "x": infer_python([r[10] * r[9][1] for r in rows]),
        "y": infer_python([r[11] * r[9][0] for r in rows]),
        "w": infer_python([r[3][1] for r in rows]),
        "h": infer_python([r[3][0] for r in rows]),
        "name": infer_python([r[8].decode() if isinstance(r[8], bytes)
                              else r[8] for r in rows]),
    })


def infer_python(values: list) -> np.ndarray:
    """A column of Python/numpy scalars with pandas' inference: int64 if
    every value is an integer, float64 if every value is a number,
    object otherwise."""
    vals = [v.item() if isinstance(v, np.generic) else v for v in values]
    if vals and all(isinstance(v, int) and not isinstance(v, bool)
                    for v in vals):
        return np.array(vals, dtype=np.int64)
    if vals and all(isinstance(v, (int, float)) and not isinstance(v, bool)
                    for v in vals):
        return np.array(vals, dtype=np.float64)
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def _to_numeric(t: Table) -> Table:
    """``DataFrame.apply(pd.to_numeric)``: object columns of number
    tokens become int64 / float64 (a non-number raises ValueError)."""
    out = {}
    for k in t.columns:
        v = t[k]
        if v.dtype.kind == "O":
            toks = [None if (isinstance(x, float) and math.isnan(x))
                    else str(x) for x in v.tolist()]
            v = infer_column(toks)
            if v.dtype.kind == "O":
                raise ValueError(f"Unable to parse string in column {k}")
        out[k] = v
    return Table(out)


@dataclass(frozen=True)
class Format:
    """A coordinate-file format: parser + default column mapping.

    ``colmap`` maps canonical names to raw-column keys (int position or
    STAR label); ``None`` = the format does not carry that column.
    ``centered``: x/y are particle centres (vs. lower-left corner);
    ``None`` = no geometry shift at all (cbox, as the reference).
    """

    name: str
    read: Callable[[str], Table]
    colmap: dict
    centered: bool | None


FORMATS = {
    "box": Format(
        "box", read_tsv_like,
        {"x": 0, "y": 1, "w": 2, "h": 3, "conf": 4, "name": None},
        centered=False,
    ),
    "cbox": Format(
        "cbox",
        lambda p: _to_numeric(read_tsv_like(p)),
        {"x": 0, "y": 1, "w": 3, "h": 4, "conf": 8, "name": None},
        centered=None,
    ),
    "tsv": Format(
        "tsv", read_tsv_like,
        {"x": 0, "y": 1, "w": None, "h": None, "conf": 2, "name": None},
        centered=True,
    ),
    "star": Format(
        "star", read_star,
        {
            "x": STAR_LABELS["x"],
            "y": STAR_LABELS["y"],
            "w": None,
            "h": None,
            "conf": STAR_LABELS["conf"],
            "name": STAR_LABELS["name"],
        },
        centered=True,
    ),
    "cs": Format(
        "cs", read_cs,
        {"x": "x", "y": "y", "w": "w", "h": "h", "conf": None,
         "name": "name"},
        centered=True,
    ),
}


# --------------------------------------------------------------------
# conversion pipeline steps
# --------------------------------------------------------------------


def _remap_columns(t: Table, colmap) -> Table:
    """Rename raw columns (int positions or label strings) to canonical
    names."""
    rename = {}
    for canon, raw in colmap.items():
        if raw is None:
            continue
        if isinstance(raw, str) and raw.lstrip("-").isdigit():
            raw = int(raw)
        if isinstance(raw, (int, np.integer)):
            if 0 <= raw < len(t.columns):
                rename[t.columns[raw]] = canon
        elif raw in t:
            rename[raw] = canon
    return t.rename(rename)


def _as_float(v: np.ndarray) -> np.ndarray:
    """``Series.astype(float)``: object values through Python's
    ``float``."""
    if v.dtype.kind == "O":
        return np.array([float(x) for x in v.tolist()], dtype=np.float64)
    return v.astype(np.float64)


def _shift_geometry(t: Table, in_fmt: Format, out_fmt: str, boxsize):
    """Center<->corner conversion between centred and corner formats.

    Centred input -> box output: set w=h=boxsize, x -= w/2, y -= h/2.
    Corner (box) input -> centred output: x += w/2, y += h/2.
    """
    if in_fmt.centered is None:
        return t
    out_centered = out_fmt in ("star", "tsv")
    if in_fmt.centered and not out_centered:
        if boxsize is None:
            raise ValueError("box size required for centered input")
        t["w"] = boxsize
        t["h"] = boxsize
        for c in ("x", "y", "w", "h"):
            t[c] = _as_float(t[c])
        t["x"] = t["x"] - t["w"] / 2
        t["y"] = t["y"] - t["h"] / 2
    elif not in_fmt.centered and out_centered:
        for c in ("x", "y", "w", "h"):
            t[c] = _as_float(t[c])
        t["x"] = t["x"] + t["w"] / 2
        t["y"] = t["y"] + t["h"] / 2
    return t


def _round_coords(t: Table, round_to):
    """Round x/y/w/h (half to even); integer cast at round_to=0."""
    if round_to is None:
        return t
    for c in ("x", "y", "w", "h"):
        if c in t:
            v = t[c]
            if v.dtype.kind not in "iuf":
                raise TypeError(f"cannot round a {v.dtype} column")
            v = np.round(v, round_to)
            if round_to == 0:
                if v.dtype.kind == "f" and not np.isfinite(v).all():
                    raise ValueError(
                        "Cannot convert non-finite values (NA or inf) to "
                        "integer")
                v = v.astype(np.int64)
            t[c] = v
    return t


def _normalize_conf(t: Table, norm_conf):
    """Linearly rescale confidences into [new_min, new_max] when they
    fall outside it."""
    if norm_conf is None or "conf" not in t:
        return t
    new_min, new_max = norm_conf
    conf = t["conf"]
    if len(conf) == 0 or np.isnan(conf.astype(np.float64)).all():
        return t   # NaN bounds: no comparison holds
    old_min, old_max = np.nanmin(conf), np.nanmax(conf)
    if old_min <= new_min or old_max > new_max:
        old_range = old_max - old_min
        if old_range == 0:
            t["conf"] = new_min
        else:
            t["conf"] = ((conf - old_min) * (new_max - new_min) / old_range
                         + new_min)
    return t


# --------------------------------------------------------------------
# writers
# --------------------------------------------------------------------


def write_star(t: Table, out_path, force=False) -> None:
    """STAR writer: ``data_/loop_`` header with 1-based column tags,
    then tab-separated rows."""
    from repic_tpu_torch.runtime.atomic import atomic_write

    _check_target(out_path, force)
    cols = t.columns
    lines = "data_\n\nloop_\n"
    for canon, label in STAR_LABELS.items():
        if canon in cols:
            lines += f"{label} #{cols.index(canon) + 1}\n"
    # atomic header publish, then the rows appended: a crash between
    # the two leaves a valid (header-only) STAR file
    with atomic_write(out_path) as f:
        f.write(lines)
    with open(out_path, "a") as f:
        f.write(t.to_csv(header=False, sep="\t"))


def write_tsv(t: Table, col_order, out_path, include_header=False,
              force=False):
    """BOX/TSV writer with caller-chosen column order."""
    _check_target(out_path, force)
    out_cols = [c for c in col_order if c in t]
    with atomic_write(out_path, "wt") as f:
        f.write(t[out_cols].to_csv(header=include_header, sep="\t"))


def _check_target(out_path, force):
    if force:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    elif Path(out_path).resolve().is_file():
        _log("re-run with the force flag to replace existing files", lvl=2)


# --------------------------------------------------------------------
# top-level conversion
# --------------------------------------------------------------------


def convert(
    paths,
    in_fmt: str,
    out_fmt: str,
    *,
    boxsize=None,
    out_dir=None,
    in_cols=None,
    out_col_order=COLUMNS,
    suffix="",
    include_header=False,
    single_out=False,
    multi_out=False,
    round_to=None,
    norm_conf=None,
    require_conf=None,
    force=False,
    quiet=False,
):
    """Convert coordinate files between formats: parse -> column remap
    (``in_cols`` overrides; "auto" keeps the format default, "none"
    drops the column) -> geometry shift -> rounding -> confidence
    normalization / backfill -> column selection -> optional
    concatenation (``single_out``) or per-micrograph split
    (``multi_out``) -> write, or return the tables when ``out_dir`` is
    None.
    """
    global _log_quiet
    _log_quiet = quiet

    fmt = FORMATS.get(in_fmt)
    if fmt is None:
        _log("unknown format", lvl=2)

    colmap = dict(fmt.colmap)
    if in_cols is not None:
        for canon, override in zip(COLUMNS, in_cols):
            if override == "none":
                colmap[canon] = None
            elif override != AUTO:
                colmap[canon] = override
    _log("using the following input column mapping:")
    _log(colmap)

    try:
        raw = {Path(p): fmt.read(p) for p in paths}
    except ParserError as e:
        _log(f"input '{in_fmt}' file not properly formatted")
        _log(repr(e), lvl=2)

    out_tables = {}
    for path, t in raw.items():
        t = _remap_columns(t, colmap)
        try:
            t = _shift_geometry(t, fmt, out_fmt, boxsize)
            t = _round_coords(t, round_to)
        except KeyError as e:
            _log(f"didn't find column {e} in input columns "
                 f"({t.columns})", lvl=2)
        except (TypeError, ValueError) as e:
            _log(f"unexpected value in input columns ({e})", lvl=2)
        t = _normalize_conf(t, norm_conf)
        if require_conf is not None and "conf" not in t:
            t["conf"] = float(require_conf)

        if out_fmt in ("star", "tsv"):
            keep = ["x", "y", "conf", "name"]
        else:
            keep = list(COLUMNS)
        out_tables[path] = t[[c for c in keep if c in t]]

    if single_out:
        out_tables = {Path("all"): concat(list(out_tables.values()))}
    if multi_out:
        if all("name" in t for t in out_tables.values()):
            merged = concat(list(out_tables.values()))
            out_tables = {Path(str(k)): g
                          for k, g in group_by(merged, "name")}
        else:
            _log("cannot fulfill multi_out without micrograph name "
                 "information", lvl=1)

    if out_dir is None:
        return {str(k): v for k, v in out_tables.items()}

    out_dir = Path(out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    in_paths = {Path(p).resolve() for p in paths}
    for name, t in out_tables.items():
        stem = name.stem
        # Output lands under out_dir, keeping any directory structure
        # a multi_out micrograph name carries (absolute names keep
        # their path minus the anchor); nothing is written outside
        # out_dir and the working directory is not changed.
        if name.resolve() in in_paths:
            rel_parent = Path()
        else:
            rel_parent = name.parent
            if rel_parent.is_absolute():
                rel_parent = rel_parent.relative_to(rel_parent.anchor)
            rel_parent = Path(
                *[p for p in rel_parent.parts if p not in ("..", ".")]
            )
        parent = out_dir / rel_parent
        parent.mkdir(parents=True, exist_ok=True)
        out_path = parent / f"{stem}{suffix}.{out_fmt}"
        if out_fmt == "star":
            write_star(t, out_path, force=force)
        else:
            _log("using the following output column order:")
            _log(out_col_order)
            write_tsv(t, out_col_order, out_path,
                      include_header=include_header, force=force)
        _log(f"wrote to {out_path}")
    return None


# --------------------------------------------------------------------
# CLI (python -m repic_tpu_torch convert; also runnable standalone)
# --------------------------------------------------------------------

name = "convert"


def add_arguments(parser) -> None:
    parser.add_argument("input", nargs="+",
                        help="input particle coordinate file(s)")
    parser.add_argument("out_dir", help="output directory")
    parser.add_argument("-f", dest="in_fmt", required=True,
                        choices=sorted(FORMATS),
                        help="format FROM which to convert")
    parser.add_argument("-t", dest="out_fmt", required=True,
                        choices=["star", "box", "tsv"],
                        help="format TO which to convert")
    parser.add_argument("-b", dest="boxsize", type=int, default=None,
                        help="box size (required for centered input "
                        "-> box output)")
    parser.add_argument("-c", dest="in_cols", nargs=6, default=None,
                        metavar=("X", "Y", "W", "H", "CONF", "NAME"),
                        help="input column overrides ('auto' keeps the "
                        "format default, 'none' drops the column)")
    parser.add_argument("-d", dest="out_col_order", nargs=6,
                        default=list(COLUMNS),
                        help="output column order (BOX/TSV)")
    parser.add_argument("-s", dest="suffix", default="",
                        help="suffix appended to output file stems")
    parser.add_argument("--header", action="store_true",
                        help="include column header (BOX/TSV output)")
    parser.add_argument("--single_out", action="store_true",
                        help="concatenate everything into one file")
    parser.add_argument("--multi_out", action="store_true",
                        help="split output per micrograph name")
    parser.add_argument("--round", dest="round_to", type=int, default=None)
    parser.add_argument("--require_conf", type=float, default=None)
    parser.add_argument("--norm_conf", type=float, nargs=2, default=None)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--quiet", action="store_true")


def main(args) -> None:
    if (
        args.in_fmt in ("star", "tsv")
        and args.out_fmt != "star"
        and args.boxsize is None
    ):
        _log(f"box size required for '{args.in_fmt}' input", lvl=2)
    if args.single_out and args.multi_out:
        _log("cannot fulfill both single_out and multi_out flags", lvl=2)
    paths = [Path(p).resolve() for p in args.input]
    if not all(p.is_file() for p in paths):
        _log("bad input paths", lvl=2)
    convert(
        paths,
        args.in_fmt,
        args.out_fmt,
        boxsize=args.boxsize,
        out_dir=args.out_dir,
        in_cols=args.in_cols,
        out_col_order=tuple(args.out_col_order),
        suffix=args.suffix,
        include_header=args.header,
        single_out=args.single_out,
        multi_out=args.multi_out,
        round_to=args.round_to,
        norm_conf=args.norm_conf,
        require_conf=args.require_conf,
        force=args.force,
        quiet=args.quiet,
    )
    _log("done.")


if __name__ == "__main__":
    import argparse

    _parser = argparse.ArgumentParser(description=__doc__)
    add_arguments(_parser)
    main(_parser.parse_args())
