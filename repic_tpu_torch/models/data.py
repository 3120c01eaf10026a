"""Training data for the CNN picker (the port of
``repic_tpu.models.data``): (patch, label) arrays from micrographs and
coordinate files, with the reference DataLoader's sampling.

* micrographs are preprocessed as at pick time (blur, 3x mean-bin,
  z-score; :func:`repic_tpu_torch.models.preprocess.
  preprocess_micrograph`, on the caller's device);
* positives: one patch of ``particle_size/bin`` px centred on each
  labelled coordinate, boundary-clipped coordinates dropped;
* negatives: one random patch per positive, rejection-sampled with the
  caller's numpy ``Generator`` to lie at least ``0.5 * particle_size``
  (binned) from every positive of the micrograph;
* every patch then goes through bytescale -> 64x64 bilinear resize ->
  per-patch z-score on the device.

Labels come from BOX files or RELION coordinate STAR files matched to
micrographs by stem (:func:`_discover_labels`), from a RELION particle
STAR, from pickles of pre-extracted patches, or from pre-picked
results.  Each loader returns the reference's arrays bit for bit:
``data (N, 64, 64, 1)`` float32 and ``labels (N,)`` int32, 1 =
particle.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle

import numpy as np
import torch

from repic_tpu_torch.models import preprocess as pp
from repic_tpu_torch.models.cnn import PATCH_SIZE
from repic_tpu_torch.utils import mrc
from repic_tpu_torch.utils.box_io import read_box

NEGATIVE_DISTANCE_RATIO = 0.5

logger = logging.getLogger("repic_tpu_torch.models.data")


def _device(device):
    from repic_tpu_torch.pipeline.consensus import resolve_device

    return resolve_device(device)


def _read_micrograph(path: str) -> np.ndarray:
    raw = mrc.read_mrc(path).astype(np.float32)
    return raw[0] if raw.ndim == 3 else raw


def _centers_from_box(box_path: str) -> np.ndarray:
    """BOX corners -> particle centres, (N, 2) float64 (x, y)."""
    bs = read_box(box_path)
    if len(bs.xy) == 0:
        return np.zeros((0, 2), np.float64)
    return np.asarray(bs.xy, np.float64) + np.asarray(
        bs.wh, np.float64) / 2.0


def _column(table, name: str):
    """The column whose lower-cased name is ``name``, or None."""
    cols = {c.lower(): c for c in table.columns if isinstance(c, str)}
    return cols.get(name)


def _centers_from_star(star_path: str) -> np.ndarray:
    """RELION coordinate STAR -> particle centres, (N, 2) float64 (STAR
    coordinates are centres already)."""
    from repic_tpu_torch.utils.coords import read_star

    t = read_star(star_path)
    xcol = _column(t, "_rlncoordinatex")
    ycol = _column(t, "_rlncoordinatey")
    if xcol is None or ycol is None or len(t) == 0:
        return np.zeros((0, 2), np.float64)
    return np.stack([np.asarray(t[xcol]).astype(np.float64),
                     np.asarray(t[ycol]).astype(np.float64)], axis=1)


def _discover_labels(label_dir: str) -> dict[str, str]:
    """Map micrograph stem -> label file.  A ``_deeppicker`` suffix
    before the extension is stripped when matching; any BOX file beats
    any STAR file for a stem, within a format an exact stem beats a
    suffix-stripped one, and files are enumerated sorted."""
    out: dict[str, str] = {}
    for pattern in ("*.star", "*.box"):  # box overwrites star
        suffixed, exact = [], []
        for p in sorted(glob.glob(os.path.join(label_dir, pattern))):
            stem = os.path.splitext(os.path.basename(p))[0]
            if stem.endswith("_deeppicker"):
                suffixed.append((stem[: -len("_deeppicker")], p))
            else:
                exact.append((stem, p))
        for stem, p in suffixed + exact:  # exact wins collisions
            out[stem] = p
    return out


def _centers_from_label(path: str) -> np.ndarray:
    if path.endswith(".star"):
        return _centers_from_star(path)
    return _centers_from_box(path)


def extract_micrograph_patches(
    raw_img: np.ndarray,
    centers: np.ndarray,
    particle_size: int,
    rng: np.random.Generator,
    *,
    produce_negative: bool = True,
    negative_distance_ratio: float = NEGATIVE_DISTANCE_RATIO,
    max_tries: int = 1000,
    device=None,
):
    """Positive and negative raw patches of one micrograph, on the
    binned grid: ``(pos, neg)`` of shape ``(n, p, p)`` with ``p = 2 *
    (particle_size_bin // 2)``, before the per-patch preparation.  The
    micrograph is preprocessed on ``device`` (``cuda`` unless the caller
    asks for the CPU); the sampling draws from ``rng`` in the
    reference's order."""
    img = pp.preprocess_micrograph(torch.from_numpy(
        np.ascontiguousarray(raw_img, np.float32)).to(_device(device))
    ).cpu().numpy()
    n_row, n_col = img.shape
    psize_bin = int(particle_size / pp.BIN_SIZE)
    radius = psize_bin // 2

    cx = (centers[:, 0] / pp.BIN_SIZE).astype(int)
    cy = (centers[:, 1] / pp.BIN_SIZE).astype(int)
    # drop boundary-clipped coordinates
    ok = (
        (cx >= radius)
        & (cy >= radius)
        & (cx + radius <= n_col)
        & (cy + radius <= n_row)
    )
    cx, cy = cx[ok], cy[ok]
    empty = np.zeros((0, 2 * radius, 2 * radius), img.dtype)

    pos = np.stack([
        img[y - radius:y + radius, x - radius:x + radius]
        for x, y in zip(cx, cy)
    ]) if len(cx) else empty

    if not produce_negative:
        return pos, empty

    min_dist = negative_distance_ratio * psize_bin
    neg = []
    for _ in range(len(cx)):
        for _try in range(max_tries):
            x = rng.integers(radius, n_col - radius + 1)
            y = rng.integers(radius, n_row - radius + 1)
            d2 = (cx - x) ** 2 + (cy - y) ** 2
            if len(d2) == 0 or d2.min() >= min_dist**2:
                neg.append(img[y - radius:y + radius, x - radius:x + radius])
                break
    dropped = len(cx) - len(neg)
    if dropped:
        # rejection sampling ran out of tries: background is scarce,
        # and the class balance skews positive
        logger.warning(
            "negative sampling produced %d/%d patches (%d dropped "
            "after %d tries each) — dense micrograph; class balance "
            "will skew positive",
            len(neg), len(cx), dropped, max_tries,
        )
    neg = np.stack(neg) if neg else empty
    return pos, neg


def _pairs(mrc_dir: str, label_dir: str) -> list:
    labels = _discover_labels(label_dir)
    return [
        (m, labels[os.path.splitext(os.path.basename(m))[0]])
        for m in sorted(glob.glob(os.path.join(mrc_dir, "*.mrc")))
        if os.path.splitext(os.path.basename(m))[0] in labels
    ]


def load_dataset(
    mrc_dir: str,
    label_dir: str,
    particle_size: int,
    *,
    seed: int = 1234,
    patch_norm: str = "reference",
    max_micrographs: int | None = None,
    device=None,
):
    """``(data, labels)`` from micrographs paired by stem with BOX or
    RELION coordinate STAR labels (BOX wins when both exist), one
    negative per positive."""
    rng = np.random.default_rng(seed)
    pairs = _pairs(mrc_dir, label_dir)
    if max_micrographs:
        pairs = pairs[:max_micrographs]
    if not pairs:
        raise FileNotFoundError(
            f"no micrograph/label pairs between {mrc_dir} and {label_dir}"
        )

    all_pos, all_neg = [], []
    for mrc_path, box_path in pairs:
        raw = _read_micrograph(mrc_path)
        centers = _centers_from_label(box_path)
        if len(centers) == 0:
            continue
        pos, neg = extract_micrograph_patches(
            raw, centers, particle_size, rng, device=device)
        all_pos.append(pos)
        all_neg.append(neg)
    return _finish_patches(all_pos, all_neg, patch_norm, device=device)


def _finish_patches(all_pos, all_neg, patch_norm, *, device=None):
    """The tail of every source: concatenate the raw patches, prepare
    them on the device, emit ``(data, labels)``."""
    pos = np.concatenate(all_pos) if all_pos else np.zeros((0, 2, 2))
    neg = np.concatenate(all_neg) if all_neg else np.zeros((0, 2, 2))
    if len(pos) == 0:
        raise ValueError("no usable positive patches extracted")

    raw_patches = torch.from_numpy(
        np.concatenate([pos, neg]).astype(np.float32)).to(_device(device))
    if patch_norm == "reference":
        prepared = pp.prepare_patches(raw_patches, PATCH_SIZE)
    else:
        # float patches: XLA's summation order, bit for bit
        prepared = pp.resize_patches(raw_patches, PATCH_SIZE, ordered=True)
    data = prepared.cpu().numpy()[..., None]
    labels = np.concatenate(
        [np.ones(len(pos), np.int32), np.zeros(len(neg), np.int32)]
    )
    return data, labels


def load_dataset_relion_star(
    star_path: str,
    mrc_dir: str,
    particle_size: int,
    *,
    seed: int = 1234,
    patch_norm: str = "reference",
    device=None,
):
    """``(data, labels)`` from a RELION particle STAR file: the table's
    ``_rlnMicrographName`` and centre coordinates, micrographs resolved
    by basename under ``mrc_dir``, in sorted name order."""
    from repic_tpu_torch.utils.coords import read_star
    from repic_tpu_torch.utils.table import group_by

    rng = np.random.default_rng(seed)
    t = read_star(star_path)
    mic_col = _column(t, "_rlnmicrographname")
    xcol = _column(t, "_rlncoordinatex")
    ycol = _column(t, "_rlncoordinatey")
    if mic_col is None or xcol is None or ycol is None:
        raise ValueError(
            f"{star_path}: need _rlnMicrographName and "
            "_rlnCoordinateX/Y columns"
        )
    all_pos, all_neg = [], []
    for mic_name, group in group_by(t, mic_col):
        mrc_path = os.path.join(mrc_dir, os.path.basename(str(mic_name)))
        if not os.path.isfile(mrc_path):
            logger.warning("micrograph %s not found; skipped", mrc_path)
            continue
        raw = _read_micrograph(mrc_path)
        centers = np.stack([np.asarray(group[xcol]).astype(np.float64),
                            np.asarray(group[ycol]).astype(np.float64)],
                           axis=1)
        pos, neg = extract_micrograph_patches(
            raw, centers, particle_size, rng, device=device)
        all_pos.append(pos)
        all_neg.append(neg)
    return _finish_patches(all_pos, all_neg, patch_norm, device=device)


def extract_dataset(
    mrc_dir: str,
    label_dir: str,
    particle_size: int,
    out_pickle: str,
    *,
    seed: int = 1234,
    device=None,
):
    """Extract raw (positive, negative) patch lists to a pickle -- the
    cross-molecule training format :func:`load_dataset_extracted` reads:
    ``(positives, negatives)``, two lists of 2-D raw binned patches.
    Returns their lengths."""
    from repic_tpu_torch.runtime.atomic import atomic_write

    rng = np.random.default_rng(seed)
    pairs = _pairs(mrc_dir, label_dir)
    if not pairs:
        raise FileNotFoundError(
            f"no micrograph/label pairs between {mrc_dir} and {label_dir}"
        )
    positives, negatives = [], []
    for mrc_path, box_path in pairs:
        raw = _read_micrograph(mrc_path)
        centers = _centers_from_label(box_path)
        if len(centers) == 0:
            continue
        pos, neg = extract_micrograph_patches(
            raw, centers, particle_size, rng, device=device)
        positives.extend(list(pos))
        negatives.extend(list(neg))
    with atomic_write(out_pickle, "wb") as f:
        pickle.dump((positives, negatives), f)
    return len(positives), len(negatives)


def load_dataset_extracted(
    base_dir: str,
    input_files: str,
    *,
    patch_norm: str = "reference",
    per_molecule_cap: int | None = None,
    device=None,
):
    """``(data, labels)`` from pre-extracted patch pickles:
    ``input_files`` is a ``;``-separated list of pickle names under
    ``base_dir``; ``per_molecule_cap`` bounds each molecule's positives
    (and negatives)."""
    all_pos, all_neg = [], []
    for name in input_files.split(";"):
        path = os.path.join(base_dir, name.strip())
        with open(path, "rb") as f:
            positives, negatives = pickle.load(f)
        n = len(positives)
        if per_molecule_cap is not None:
            n = min(n, per_molecule_cap)
        if n == 0:
            continue
        # patch sizes differ across molecules: prepared per molecule;
        # a dense molecule may have few or no negatives
        all_pos.append(np.stack(positives[:n]))
        neg = negatives[:n]
        all_neg.append(
            np.stack(neg) if neg
            else np.zeros((0,) + all_pos[-1].shape[1:], np.float32)
        )
    datas, labels = [], []
    for pos, neg in zip(all_pos, all_neg):
        d, lab = _finish_patches([pos], [neg], patch_norm, device=device)
        datas.append(d)
        labels.append(lab)
    if not datas:
        raise ValueError("no usable positive patches extracted")
    return np.concatenate(datas), np.concatenate(labels)


def load_dataset_prepicked(
    mrc_dir: str,
    results_pickle: str,
    particle_size: int,
    *,
    select: float = 0.5,
    seed: int = 1234,
    patch_norm: str = "reference",
    device=None,
):
    """``(data, labels)`` from pre-picked results (self-training):
    ``results_pickle`` holds per-micrograph lists of ``[x, y, score,
    micrograph_name]`` rows.  ``select`` in ``(0, 1]`` is a score
    threshold, in ``(1, 100]`` the top-scoring percentage, above 100 the
    top-scoring count."""
    rng = np.random.default_rng(seed)
    with open(results_pickle, "rb") as f:
        coordinate = pickle.load(f)
    rows = [r for mic in coordinate for r in mic]
    if not rows:
        raise ValueError(f"{results_pickle}: no picked particles")
    if select <= 1.0:
        rows = [r for r in rows if float(r[2]) >= select]
    else:
        rows.sort(key=lambda r: float(r[2]), reverse=True)
        keep = (int(len(rows) * select / 100.0) if select <= 100
                else int(select))
        rows = rows[:keep]
    by_mic: dict[str, list] = {}
    for r in rows:
        by_mic.setdefault(os.path.basename(str(r[3])), []).append(r)
    all_pos, all_neg = [], []
    for mic_name, group in sorted(by_mic.items()):
        mrc_path = os.path.join(mrc_dir, mic_name)
        if not os.path.isfile(mrc_path):
            logger.warning("micrograph %s not found; skipped", mrc_path)
            continue
        raw = _read_micrograph(mrc_path)
        centers = np.asarray(
            [[float(r[0]), float(r[1])] for r in group], np.float64)
        pos, neg = extract_micrograph_patches(
            raw, centers, particle_size, rng, device=device)
        all_pos.append(pos)
        all_neg.append(neg)
    return _finish_patches(all_pos, all_neg, patch_norm, device=device)


def shuffle_in_unison(data, labels, rng: np.random.Generator):
    """Joint shuffle of ``data`` and ``labels``."""
    perm = rng.permutation(len(data))
    return data[perm], labels[perm]
