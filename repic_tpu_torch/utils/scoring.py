"""Particle-detection scoring: segmentation-mask precision/recall/F1
(the port of ``repic_tpu.utils.scoring``), rasterized with torch ops on
the command's device.

Ground-truth and picker box sets become binary micrograph masks
compared pixel-wise: precision, recall, F1 and picked-positive fraction,
with an optional confidence threshold on the picker boxes.  A mask is a
2-D difference array: each box adds +1/-1 at its four corners
(``index_put_(..., accumulate=True)`` on int32) and two cumulative sums
recover the coverage count.  Boxes are rounded on the host (half to
even); boxes with a negative rounded corner are dropped and the other
edges clip to the micrograph.  Counts are int32 and the ratios float32
divisions, as the reference computes them; an empty ground-truth set
gives recall 0.0.  ``--match distance`` runs the centre-distance
analysis of :mod:`repic_tpu_torch.utils.matching` instead.
"""

import os
from pathlib import Path

import numpy as np
import torch


def _rasterize_padded(boxes, valid, h, w, hb: int, wb: int):
    """Difference-array union rasterization into a ``(hb, wb)`` mask;
    boxes clip to the true dims ``h <= hb``, ``w <= wb`` so padding
    pixels stay zero."""
    x0 = torch.clamp(boxes[:, 0], 0, w)
    y0 = torch.clamp(boxes[:, 1], 0, h)
    x1 = torch.minimum(torch.maximum(boxes[:, 0] + boxes[:, 2], x0),
                       torch.full_like(x0, w))
    y1 = torch.minimum(torch.maximum(boxes[:, 1] + boxes[:, 3], y0),
                       torch.full_like(y0, h))
    x1 = torch.where(valid, x1, x0)
    y1 = torch.where(valid, y1, y0)
    diff = torch.zeros((hb + 1, wb + 1), dtype=torch.int32,
                       device=boxes.device)
    one = torch.ones_like(x0, dtype=torch.int32)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_put_((ys.long(), xs.long()), sign * one, accumulate=True)
    count = torch.cumsum(torch.cumsum(diff, dim=0, dtype=torch.int32),
                         dim=1, dtype=torch.int32)
    return count[:hb, :wb] > 0


def rasterize_union(boxes, valid, h: int, w: int):
    """Union mask of axis-aligned boxes.

    Args:
        boxes: ``(n, 4)`` int32 ``x, y, bw, bh`` (lower-left corner).
        valid: ``(n,)`` bool -- padded slots contribute nothing.
        h, w: mask dims (pixels).

    Returns:
        ``(h, w)`` bool coverage mask on ``boxes``' device.
    """
    return _rasterize_padded(boxes, valid, h, w, h, w)


def segmentation_scores_masked(
    gt_boxes, gt_valid, p_boxes, p_valid, h, w, hb: int, wb: int
):
    """(precision, recall, f1, pos_frac) between two box sets, as 0-d
    float32 tensors; all-zero denominators give 0.0."""
    gt = _rasterize_padded(gt_boxes, gt_valid, h, w, hb, wb)
    p = _rasterize_padded(p_boxes, p_valid, h, w, hb, wb)
    dev = gt.device
    num_pos = p.sum(dtype=torch.int32)
    gt_area = gt.sum(dtype=torch.int32)
    tp = (gt & p).sum(dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    prec = torch.where(num_pos > 0, tp / num_pos, zero)
    rec = torch.where(gt_area > 0, tp / gt_area, zero)
    f1 = torch.where(prec + rec > 0, 2 * prec * rec / (prec + rec), zero)
    # a 0-d int32 tensor: an IEEE division (torch divides by a Python
    # number through its reciprocal)
    pos_frac = num_pos / torch.tensor(h * w, dtype=torch.int32, device=dev)
    return prec, rec, f1, pos_frac


def _to_int_boxes(df, conf_thresh=None):
    """Host-side prep: threshold on confidence, round to int boxes (half
    to even).  Boxes with a negative rounded corner are dropped: the
    reference scorer paints with ``arr[y:y+h, x:x+w]``, and a negative
    slice start gives an empty slice on any micrograph larger than the
    box."""
    if len(df) == 0:
        return np.zeros((0, 4), np.int32)
    arr = df.to_numpy(["x", "y", "w", "h"], float)
    if conf_thresh is not None and "conf" in df:
        arr = arr[np.asarray(df["conf"], float) >= conf_thresh]
    out = np.rint(arr).astype(np.int32)
    return out[(out[:, 0] >= 0) & (out[:, 1] >= 0)]


def get_segmentation_scores(
    gt_df, pckr_df, conf_thresh=None, mrc_w=None, mrc_h=None, device=None
):
    """Score one micrograph's picker boxes against ground truth, the
    masks rasterized on ``device`` (``cuda`` unless the caller asks for
    the CPU).

    Tables carry canonical x/y/w/h[/conf] columns (utils/coords).  When
    micrograph dims are not given they are the max box extent over both
    sets -- before confidence thresholding, which only gates painting.
    """
    from repic_tpu_torch.pipeline.consensus import resolve_device

    dev = resolve_device(device)
    gt = _to_int_boxes(gt_df)
    pk = _to_int_boxes(pckr_df)

    def _extent(df, pos, size):
        if len(df) == 0:
            return 0
        vals = (np.asarray(df[pos], float)
                + np.asarray(df[size], float))
        # the float extent is rounded, not its parts
        return int(np.rint(vals.max()))

    if mrc_w is None:
        mrc_w = max(_extent(gt_df, "x", "w"), _extent(pckr_df, "x", "w"))
    if mrc_h is None:
        mrc_h = max(_extent(gt_df, "y", "h"), _extent(pckr_df, "y", "h"))
    if conf_thresh is not None:
        pk = _to_int_boxes(pckr_df, conf_thresh)

    def on_device(a):
        return (torch.from_numpy(a).to(dev),
                torch.ones(len(a), dtype=torch.bool, device=dev))

    prec, rec, f1, pos_frac = segmentation_scores_masked(
        *on_device(gt), *on_device(pk), mrc_h, mrc_w, mrc_h, mrc_w,
    )
    return float(prec), float(rec), float(f1), float(pos_frac)


def match_by_stem(gt_paths, pckr_paths, gt_ext=".box", pckr_ext=".box"):
    """Pair GT and picker files by lower-cased stem, allowing picker
    suffixes."""
    gt_paths = [f for f in gt_paths if f.endswith(gt_ext)]
    pckr_paths = [f for f in pckr_paths if f.endswith(pckr_ext)]
    pairs = []
    for g in gt_paths:
        stem = Path(g).stem.lower()
        hit = next(
            (p for p in pckr_paths if Path(p).stem.lower().startswith(stem)),
            None,
        )
        if hit is not None:
            pairs.append((stem, g, hit))
    return pairs


def _converted_pairs(
    gt_paths, pckr_paths, gt_fmt, pckr_fmt, box_size, sort=False
):
    """Pair GT/picker files by stem and convert both sides to
    canonical BOX tables (the shared front half of both metric
    families).  Yields ``(stem, gt_df, pckr_df)``."""
    from repic_tpu_torch.utils.coords import convert

    pairs = match_by_stem(
        gt_paths, pckr_paths,
        gt_ext=f".{gt_fmt}", pckr_ext=f".{pckr_fmt}",
    )
    if sort:
        pairs = sorted(pairs)
    assert len(pairs) > 0, (
        "No paired ground truth and picker particle sets found"
    )
    for stem, g, p in pairs:
        gt_df = next(iter(convert(
            [g], gt_fmt, "box", boxsize=box_size, quiet=True
        ).values()))
        p_df = next(iter(convert(
            [p], pckr_fmt, "box", boxsize=box_size, quiet=True
        ).values()))
        yield stem, gt_df, p_df


def score_box_files(
    gt_paths,
    pckr_paths,
    conf_thresh=None,
    mrc_w=None,
    mrc_h=None,
    verbose=False,
    gt_fmt="box",
    pckr_fmt="box",
    box_size=None,
    device=None,
):
    """Score every matched (ground truth, picker) coordinate-file pair,
    rasterizing on ``device`` (``cuda`` unless the caller asks for the
    CPU).

    Either side may be in any converter-registry format (box, cbox,
    star, tsv, cs): inputs go through the ``convert`` pipeline.
    Centered formats (star/tsv/cs) need ``box_size`` for the
    center->corner shift.
    """
    rows = []
    for stem, gt_df, p_df in _converted_pairs(
        gt_paths, pckr_paths, gt_fmt, pckr_fmt, box_size
    ):
        for df in (gt_df, p_df):
            if "conf" not in df:
                df["conf"] = 1
        scores = get_segmentation_scores(
            gt_df, p_df, conf_thresh=conf_thresh, mrc_w=mrc_w, mrc_h=mrc_h,
            device=device,
        )
        if verbose:
            print(
                f"{stem} - precision: {scores[0]:.3f} "
                f"recall: {scores[1]:.3f} F1-score: {scores[2]:.3f}"
            )
        rows.append((stem, *scores))
    return rows


def score_distance_files(
    gt_paths,
    pckr_paths,
    particle_size,
    rate=0.2,
    gt_fmt="star",
    pckr_fmt="box",
    box_size=None,
):
    """Distance-matching analysis over matched (GT, picker) pairs:
    centre-distance greedy matching with TP iff distance < ``rate *
    particle_size`` (:mod:`repic_tpu_torch.utils.matching`).  Pairs are
    processed in sorted stem order (the curve's tie order).  Either side
    may be any converter-registry format; coordinates are reduced to box
    centres (host code).
    """

    def centers(df):
        if len(df) == 0:
            return np.zeros((0, 2), np.float64)
        arr = df.to_numpy(["x", "y", "w", "h"], np.float64)
        return arr[:, :2] + arr[:, 2:] / 2.0

    triples = []
    for _stem, gt_df, p_df in _converted_pairs(
        gt_paths, pckr_paths, gt_fmt, pckr_fmt,
        box_size or particle_size, sort=True,
    ):
        conf = (
            np.asarray(p_df["conf"], np.float64)
            if "conf" in p_df and len(p_df)
            else np.ones(len(p_df), np.float64)
        )
        triples.append((centers(p_df), conf, centers(gt_df)))
    from repic_tpu_torch.utils.matching import analyze_distance_matches

    return analyze_distance_matches(triples, particle_size, rate=rate)


def write_scores_tsv(rows, out_dir) -> str:
    """The ``particle_set_comp.tsv`` output."""
    from repic_tpu_torch.runtime.atomic import atomic_write

    out_file = os.path.join(out_dir, "particle_set_comp.tsv")
    with atomic_write(out_file) as o:
        o.write("\t".join(
            ["filename", "precision", "recall", "f1", "pos_frac"]) + "\n")
        for entry in rows:
            o.write("\t".join(str(v) for v in entry) + "\n")
    return out_file


# CLI (python -m repic_tpu_torch score)

name = "score"


def add_arguments(parser) -> None:
    parser.add_argument("-g", nargs="+", required=True,
                        help="ground truth BOX file(s)")
    parser.add_argument("-p", nargs="+", required=True,
                        help="picker BOX file(s)")
    parser.add_argument("-c", type=float, default=None,
                        help="confidence threshold")
    parser.add_argument("--height", type=int, default=None,
                        help="micrograph height (pixels)")
    parser.add_argument("--width", type=int, default=None,
                        help="micrograph width (pixels)")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--out_dir", type=str, default=None)
    # format routing through the converter registry
    from repic_tpu_torch.utils.coords import FORMATS

    parser.add_argument(
        "--gt_format", choices=sorted(FORMATS), default="box",
        help="format of the ground-truth file(s) (default: box)",
    )
    parser.add_argument(
        "--pckr_format", choices=sorted(FORMATS), default="box",
        help="format of the picker file(s) (default: box)",
    )
    parser.add_argument(
        "--box_size", type=int, default=None,
        help="particle box size; required when a centered format "
        "(star/tsv/cs) is scored, and the particle size for "
        "--match distance",
    )
    parser.add_argument(
        "--match",
        choices=["mask", "distance"],
        default="mask",
        help="metric family: segmentation-mask pixel overlap, or "
        "center-distance greedy matching with TP iff dist < dist_rate "
        "* box_size",
    )
    parser.add_argument(
        "--dist_rate", type=float, default=0.2,
        help="--match distance: match radius as a fraction of "
        "box_size (default 0.2)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device the masks are rasterized on (default cuda; fails "
        "when there is none)",
    )


def main(args) -> None:
    out_dir = args.out_dir
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
    else:
        out_dir = os.path.dirname(args.p[0]) or "."
    if args.match == "distance":
        from repic_tpu_torch.utils.matching import write_results_txt

        assert args.box_size is not None, (
            "--match distance needs --box_size (the particle size "
            "setting the match radius)"
        )
        # Mask-mode-only knobs must not be silently ignored: the
        # distance analysis pins its own 0.5 threshold and never
        # rasterizes, so -c/--height/--width cannot take effect.
        assert args.c is None and args.height is None and args.width is None, (
            "-c/--height/--width apply to --match mask only; the "
            "distance analysis uses the reference's fixed 0.5 "
            "threshold and no rasterization"
        )
        analysis = score_distance_files(
            args.g, args.p, args.box_size, rate=args.dist_rate,
            gt_fmt=args.gt_format, pckr_fmt=args.pckr_format,
            box_size=args.box_size,
        )
        out_file = write_results_txt(analysis, out_dir)
        print(
            "(threshold 0.5)precision:%f recall:%f"
            % (analysis["precision_05"], analysis["recall_05"])
        )
        if args.verbose:
            print(f"wrote {out_file}")
        return
    rows = score_box_files(
        args.g, args.p, conf_thresh=args.c,
        mrc_w=args.width, mrc_h=args.height, verbose=args.verbose,
        gt_fmt=args.gt_format, pckr_fmt=args.pckr_format,
        box_size=args.box_size, device=args.device,
    )
    out_file = write_scores_tsv(rows, out_dir)
    if args.verbose:
        print(f"wrote {out_file}")


if __name__ == "__main__":
    import argparse

    _parser = argparse.ArgumentParser(description=__doc__)
    add_arguments(_parser)
    main(_parser.parse_args())
