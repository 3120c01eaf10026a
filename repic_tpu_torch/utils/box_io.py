"""BOX coordinate-file I/O (the port's own copy of ``repic_tpu``'s).

Reading is the line-loop tier of ``repic_tpu.utils.box_io`` — the
semantic specification of the BOX format there, and the tier that
needs no pandas and no native parser:

* an optional single header line, sniffed by "is the first token a
  float?";
* ``x y w h conf`` columns; ``w``/``h`` default to 0 and ``conf`` to 1
  when absent;
* negative confidences are log-likelihoods, sigmoid-mapped to
  probabilities when any weight is negative.

Writing renders the consensus output format: ``int(rint(x)) TAB
int(rint(y)) TAB box TAB box TAB weight``, sorted by weight
descending (stable), weights printed from float32 values.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Sequence

import numpy as np


class BoxParseError(ValueError):
    """A BOX file could not be read or parsed; carries its ``path``."""

    def __init__(self, path: str, cause: BaseException):
        super().__init__(
            f"failed to read BOX file {path}: "
            f"{type(cause).__name__}: {cause}"
        )
        self.path = path


class BoxSet(NamedTuple):
    """Particles of one picker on one micrograph (host-side, ragged)."""

    xy: np.ndarray     # (n, 2) float32 — lower-left corner
    conf: np.ndarray   # (n,) float32 — probability-scale confidence
    wh: np.ndarray     # (n, 2) float32 — box width/height as read

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def _is_float(tok) -> bool:
    try:
        float(tok)
    except (TypeError, ValueError):
        return False
    return True


def read_box(path: str) -> BoxSet:
    """Parse a BOX file; empty files yield an empty :class:`BoxSet`."""
    try:
        return _read_box_slow(path)
    except (OSError, ValueError, IndexError) as e:
        raise BoxParseError(path, e) from e


def _finish_box(x, y, w, h, conf) -> BoxSet:
    conf = conf.astype(np.float32)
    if conf.size and conf.min() < 0:
        # log-likelihood scores -> probabilities
        conf = 1.0 / (1.0 + np.exp(-conf))
    if not x.size:
        return BoxSet(
            xy=np.zeros((0, 2), np.float32),
            conf=conf,
            wh=np.zeros((0, 2), np.float32),
        )
    return BoxSet(
        xy=np.stack([x, y], axis=-1).astype(np.float32),
        conf=conf,
        wh=np.stack([w, h], axis=-1).astype(np.float32),
    )


def _read_box_slow(path: str) -> BoxSet:
    xs, ys, ws, hs, cs = [], [], [], [], []
    with open(path, "rt") as f:
        first = True
        for line in f:
            toks = line.strip().split()
            if not toks:
                continue
            if first and not _is_float(toks[0]):
                first = False
                continue  # header line
            first = False
            xs.append(float(toks[0]))
            ys.append(float(toks[1]))
            ws.append(float(toks[2]) if len(toks) > 2 else 0.0)
            hs.append(float(toks[3]) if len(toks) > 3 else 0.0)
            cs.append(float(toks[4]) if len(toks) > 4 else 1.0)
    return _finish_box(
        np.asarray(xs),
        np.asarray(ys),
        np.asarray(ws),
        np.asarray(hs),
        np.asarray(cs),
    )


def render_box(
    xy: np.ndarray,
    weights: np.ndarray,
    box_size,
    *,
    num_particles: int | None = None,
) -> tuple[str, int]:
    """Render a consensus BOX file's content; returns ``(content,
    rows)``.  ``weights`` must be a float32 array: its elements print
    with float32 ``str`` (a Python float prints more digits)."""
    xy = np.asarray(xy)
    weights = np.asarray(weights)
    order = np.argsort(-weights, kind="stable")
    if num_particles is not None:
        order = order[:num_particles]
    # scalar box size, or one per row for mixed-size ensembles
    sizes = np.broadcast_to(
        np.asarray(box_size).reshape(-1), (len(weights),)
    )
    lines = []
    for i in order:
        bs = str(int(sizes[i]))
        lines.append(
            "\t".join(
                [
                    str(int(np.rint(xy[i, 0]))),
                    str(int(np.rint(xy[i, 1]))),
                    bs,
                    bs,
                    str(weights[i]),
                ]
            )
            + "\n"
        )
    return "".join(lines), len(order)


@contextlib.contextmanager
def atomic_write(path: str):
    """Write ``path`` through a same-directory temp file published
    with one ``os.replace``: a reader never sees a torn file."""
    tmp = f"{path}.tmp{os.getpid()}"
    f = open(tmp, "wt")
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    f.close()
    os.replace(tmp, path)


def write_empty_box(path: str) -> None:
    """Empty placeholder BOX file, published atomically."""
    with atomic_write(path):
        pass


def discover_picker_dirs(in_dir: str) -> list[str]:
    """Sorted picker subdirectory names."""
    return sorted(
        d
        for d in os.listdir(in_dir)
        if os.path.isdir(os.path.join(in_dir, d))
    )


def micrograph_names(picker_dir: str) -> list[str]:
    """Sorted micrograph basenames from a picker's BOX files."""
    return sorted(
        f[: -len(".box")]
        for f in os.listdir(picker_dir)
        if f.endswith(".box")
    )


def load_micrograph_set(
    in_dir: str, pickers: Sequence[str], name: str
) -> list[BoxSet] | None:
    """Load one micrograph's BOX file from every picker.

    Returns None if any picker is missing the micrograph or picked no
    particles (the run then writes an empty consensus file)."""
    sets = []
    for p in pickers:
        path = os.path.join(in_dir, p, name + ".box")
        if not os.path.isfile(path):
            matches = [
                f
                for f in os.listdir(os.path.join(in_dir, p))
                if f.endswith(".box") and name in f
            ]
            if len(matches) != 1:
                return None
            path = os.path.join(in_dir, p, matches[0])
        bs = read_box(path)
        if bs.n == 0:
            return None
        sets.append(bs)
    return sets
