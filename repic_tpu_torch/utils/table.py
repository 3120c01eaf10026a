"""A small column table for the coordinate converter: ordered numpy
columns with the reference's (pandas') dtype and text rules, so that
``convert`` writes the reference's bytes without pandas.

* :func:`read_whitespace_table` is ``pd.read_csv(path, sep=r"\\s+",
  header=None, skiprows=n)``: tokens split on spaces and tabs (double
  quotes group), blank lines skipped, short rows padded with NaN, a row
  longer than the first raises :class:`ParserError`; each column is
  int64 when every token is an integer, uint64 when one only fits
  there (Python ints past that), bool when every token is a boolean
  word, float64 when every
  token is a number or missing, and object (the tokens, NaN where
  missing) otherwise.  Floats parse with pandas' C parser
  (:func:`parse_float`), whose rounding differs from Python's
  ``float`` on some long tokens.
* :meth:`Table.to_csv` is ``DataFrame.to_csv(sep="\\t", index=False)``:
  float64 as ``repr``, NaN as an empty field, fields holding the
  separator, a quote or a line break quoted.
* :func:`read_tab_table` is ``pd.read_csv(path, sep="\\t")`` (a
  header line, then rows).
* :func:`concat` and :func:`group_by` are ``pd.concat(...,
  ignore_index=True)`` and ``groupby(name)`` (keys sorted, NaN keys
  dropped).
"""

from __future__ import annotations

import math

import numpy as np

#: pandas' default missing-value tokens
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
    "n/a", "nan", "null",
))
TRUE_VALUES = frozenset(("True", "TRUE", "true"))
FALSE_VALUES = frozenset(("False", "FALSE", "false"))
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
        "infinity": math.inf, "+infinity": math.inf,
        "-infinity": -math.inf}
# 1e0 .. 1e308, each the correctly rounded double
_POW10 = [float(f"1e{k}") for k in range(309)]
_INT64 = (-(1 << 63), (1 << 63) - 1)


class EmptyDataError(ValueError):
    """No columns to parse (pandas' ``EmptyDataError``)."""


class ParserError(ValueError):
    """A row has more fields than the first (pandas' ``ParserError``)."""


def parse_float(tok: str) -> float | None:
    """pandas' ``precise_xstrtod`` on a whole token: at most 17 digits
    accumulate as ``number * 10 + digit`` in a double, the rest only
    move the exponent, and the power of ten is applied with one
    multiply or divide.  None unless the whole token is a number
    (``inf``/``infinity`` in any case, with a sign, count)."""
    low = tok.lower()
    if low in _INF:
        return _INF[low]
    n = len(tok)
    p = 0
    negative = False
    if p < n and tok[p] in "+-":
        negative = tok[p] == "-"
        p += 1
    number = 0.0
    exponent = 0
    digits = 0
    while p < n and "0" <= tok[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(tok[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and tok[p] == ".":
        p += 1
        decimals = 0
        while digits < 17 and p < n and "0" <= tok[p] <= "9":
            number = number * 10.0 + (ord(tok[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        while p < n and "0" <= tok[p] <= "9":
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and tok[p] in "eE":
        q = p + 1
        neg_exp = False
        if q < n and tok[q] in "+-":
            neg_exp = tok[q] == "-"
            q += 1
        e_digits = 0
        e = 0
        while e_digits < 17 and q < n and "0" <= tok[q] <= "9":
            e = e * 10 + (ord(tok[q]) - 48)
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if neg_exp else e
            p = q
    if p != n:
        return None
    if exponent > 308:
        return None   # ERANGE: not a number to the parser
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -308:
        if exponent < -616:
            number = 0.0
        else:
            number /= _POW10[-308 - exponent]
            number /= _POW10[308]
    else:
        number /= _POW10[-exponent]
    if math.isinf(number):
        return None
    return number


def _parse_int(tok: str) -> int | None:
    body = tok[1:] if tok[:1] in "+-" else tok
    if not body or not all("0" <= c <= "9" for c in body):
        return None
    return int(tok)


def infer_column(tokens: list) -> np.ndarray:
    """One column's array from its tokens (None = a missing field)."""
    na = [t is None or t in NA_VALUES for t in tokens]
    if not any(na):
        ints = [_parse_int(t) for t in tokens]
        if all(v is not None for v in ints):
            if all(_INT64[0] <= v <= _INT64[1] for v in ints):
                return np.array(ints, dtype=np.int64)
            if all(0 <= v < 1 << 64 for v in ints):
                return np.array(ints, dtype=np.uint64)
            out = np.empty(len(ints), dtype=object)
            out[:] = ints   # Python ints past 64 bits
            return out
        if all(t in TRUE_VALUES or t in FALSE_VALUES for t in tokens):
            return np.array([t in TRUE_VALUES for t in tokens], dtype=bool)
    floats = [math.nan if m else parse_float(t) for t, m in zip(tokens, na)]
    if all(v is not None for v in floats):
        return np.array(floats, dtype=np.float64)
    out = np.empty(len(tokens), dtype=object)
    out[:] = [math.nan if m else t for t, m in zip(tokens, na)]
    return out


def _split_fields(line: str) -> list:
    """Whitespace-separated fields; a double-quoted field may hold
    spaces (``""`` inside it is one quote)."""
    fields, cur, quoted, in_field, i = [], [], False, False, 0
    while i < len(line):
        c = line[i]
        if quoted:
            if c == '"':
                if i + 1 < len(line) and line[i + 1] == '"':
                    cur.append('"')
                    i += 1
                else:
                    quoted = False
            else:
                cur.append(c)
        elif c in " \t":
            if in_field:
                fields.append("".join(cur))
                cur, in_field = [], False
        elif c == '"':
            quoted = in_field = True
        else:
            cur.append(c)
            in_field = True
        i += 1
    if in_field:
        fields.append("".join(cur))
    return fields


def read_whitespace_table(path, skiprows: int = 0) -> "Table":
    """``pd.read_csv(path, sep=r"\\s+", header=None, skiprows=n)``."""
    with open(path, "rt", newline="") as f:
        text = f.read()
    lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    rows = []
    width = None
    for number, line in enumerate(lines[skiprows:], start=1):
        fields = _split_fields(line)
        if not fields:
            continue
        if width is None:
            width = len(fields)
        elif len(fields) > width:
            raise ParserError(
                "Error tokenizing data. C error: Expected "
                f"{width} fields in line {skiprows + number}, saw "
                f"{len(fields)}")
        rows.append(fields)
    if width is None:
        raise EmptyDataError("No columns to parse from file")
    cols = {}
    for j in range(width):
        cols[j] = infer_column(
            [r[j] if j < len(r) else None for r in rows])
    return Table(cols)


def read_tab_table(path) -> "Table":
    """``pd.read_csv(path, sep="\\t")``: the first line names the
    columns, each later non-blank line is one row of tab-separated
    tokens (short rows padded with missing values), typed per column as
    :func:`infer_column` types them."""
    with open(path, "rt", newline="") as f:
        text = f.read()
    lines = [ln for ln in text.replace("\r\n", "\n").replace(
        "\r", "\n").split("\n") if ln.strip()]
    if not lines:
        raise EmptyDataError("No columns to parse from file")
    names = lines[0].split("\t")
    rows = [ln.split("\t") for ln in lines[1:]]
    for number, r in enumerate(rows, start=2):
        if len(r) > len(names):
            raise ParserError(
                "Error tokenizing data. C error: Expected "
                f"{len(names)} fields in line {number}, saw {len(r)}")
    return Table({
        name: infer_column([r[j] if j < len(r) else None for r in rows])
        for j, name in enumerate(names)})


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _field(v, kind: str) -> str:
    if kind == "f":
        return "" if math.isnan(v) else repr(float(v))
    if kind in "iub":
        return str(v.item() if hasattr(v, "item") else v)
    if _is_missing(v):
        return ""
    if isinstance(v, float):
        return repr(v)
    return str(v)


def _quote(s: str, sep: str) -> str:
    if sep in s or '"' in s or "\n" in s or "\r" in s:
        return '"' + s.replace('"', '""') + '"'
    return s


class Table:
    """Ordered named columns of equal length (numpy arrays: int64,
    uint64, float64, bool or object)."""

    def __init__(self, columns: dict | None = None):
        self._cols = dict(columns or {})

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __len__(self) -> int:
        for v in self._cols.values():
            return len(v)
        return 0

    def __contains__(self, name) -> bool:
        return name in self._cols

    def __getitem__(self, key):
        if isinstance(key, list):
            return Table({k: self._cols[k] for k in key})
        return self._cols[key]

    def __setitem__(self, key, value):
        if np.isscalar(value):
            dtype = (np.float64 if isinstance(value, float)
                     else np.int64 if isinstance(value, int) else object)
            value = np.full(len(self), value, dtype=dtype)
        self._cols[key] = np.asarray(value)

    def rename(self, mapping: dict) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})

    def drop(self, name) -> "Table":
        return Table({k: v for k, v in self._cols.items() if k != name})

    def rows(self, mask) -> "Table":
        """The rows where ``mask`` is True (a boolean array)."""
        mask = np.asarray(mask, bool)
        return Table({k: v[mask] for k, v in self._cols.items()})

    def row_values(self, i: int) -> list:
        return [v[i] for v in self._cols.values()]

    def to_numpy(self, names, dtype=np.float64) -> np.ndarray:
        if not len(self):
            return np.zeros((0, len(names)), dtype)
        return np.column_stack(
            [np.asarray(self._cols[n], dtype=dtype) for n in names])

    def to_csv(self, header: bool = False, sep: str = "\t") -> str:
        """``DataFrame.to_csv(sep=sep, header=header, index=False)``."""
        kinds = [v.dtype.kind if v.dtype.kind in "fiub" else "O"
                 for v in self._cols.values()]
        lines = []
        if header:
            lines.append(sep.join(_quote(str(k), sep) for k in self._cols))
        cols = list(self._cols.values())
        for i in range(len(self)):
            lines.append(sep.join(
                _quote(_field(c[i], k), sep) for c, k in zip(cols, kinds)))
        return "".join(line + "\n" for line in lines)


def _combine(parts: list, lengths: list) -> np.ndarray:
    """One column of a concatenation; a ``None`` part stands for the
    ``lengths[i]`` rows of a table without the column (missing values:
    even an empty table without it turns an int column into float64, as
    concatenating a dict of frames does)."""
    keep = list(zip(parts, lengths))
    present = [p for p, _ in keep if p is not None]
    kinds = {p.dtype.kind for p in present}
    if len(present) == len(keep) and len(kinds) == 1 and kinds <= set("iub"):
        return np.concatenate(present)
    if kinds <= set("iuf"):
        return np.concatenate([np.full(n, np.nan) if p is None
                               else p.astype(np.float64) for p, n in keep])
    out = []
    for p, n in keep:
        if p is None:
            out.extend([math.nan] * n)
        else:
            out.extend(v.item() if isinstance(v, np.generic) else v
                       for v in p)
    arr = np.empty(len(out), dtype=object)
    arr[:] = out
    return arr


def concat(tables: list) -> Table:
    """``pd.concat({key: table, ...}, ignore_index=True)`` (a dict, as
    ``convert`` concatenates): the union of the columns in order of
    appearance; a table without a column gives missing values there
    (int columns then become float64)."""
    names: list = []
    for t in tables:
        for k in t.columns:
            if k not in names:
                names.append(k)
    lengths = [len(t) for t in tables]
    return Table({
        k: _combine([t[k] if k in t else None for t in tables], lengths)
        for k in names})


def group_by(table: Table, name) -> list:
    """``[(key, rows without the column)]`` over the distinct non-missing
    values of column ``name``, keys sorted, rows in table order."""
    col = table[name]
    keys = sorted({v for v in col.tolist() if not _is_missing(v)})
    rest = table.drop(name)
    return [(k, rest.rows(np.array([v == k for v in col.tolist()])))
            for k in keys]
