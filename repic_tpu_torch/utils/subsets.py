"""Defocus-stratified dataset splitting for iterative picking (the port
of ``repic_tpu.utils.subsets``; numpy and the port's MRC reader).

Micrographs are ranked by mean CTFFIND4 defocus, cut into low / medium
/ high tertiles of the defocus *range*, and sampled round-robin across
tertiles into train / val / test sets, so each set spans the defocus
distribution.  The train set is 20% of the data with nested
1/25/50/100% subsets; val is 6 micrographs; test is the rest.  Outputs
are symlink trees pairing each micrograph with its BOX labels, plus a
defocus histogram plot when matplotlib is installed.  The generator is
seeded per call and directories are enumerated sorted, so splits are
reproducible and machine-independent.
"""

import os
import shutil
from bisect import bisect, bisect_right

import numpy as np

from repic_tpu_torch.utils import mrc as mrc_io

SEED = 0
VAL_SIZE = 6
TRAIN_FRACTION = 0.2
SUBSET_TARGETS = (1, 25, 50, 100)


def parse_defocus_file(path):
    """``fname defocus_x defocus_y`` rows -> [(fname, mean_defocus)]."""
    data = []
    with open(path, "rt") as f:
        for line in f:
            fname, dx, dy = line.rstrip().split()
            data.append((fname, (float(dx) + float(dy)) / 2))
    return data


def scan_mrc_dir(mrc_dir):
    """Equal-weight fallback when no defocus file exists: every valid
    single-frame MRC in the directory."""
    data = []
    for f in sorted(os.listdir(mrc_dir)):
        path = os.path.join(mrc_dir, f)
        if mrc_io.is_single_frame_micrograph(path):
            data.append((path, 1.0))
    return data


def tertile_split(data):
    """Split (fname, defocus) pairs into low/med/high bins at 33%/66%
    of the defocus *value range* (not count terciles), preserving the
    reference's bisect boundary behavior."""
    data = sorted(data, key=lambda x: float(x[1]))
    defocus = [d for _, d in data]
    lo_cut, med_cut = [
        (defocus[-1] - defocus[0]) * v + defocus[0] for v in (0.33, 0.66)
    ]
    i = bisect(defocus, lo_cut)
    j = bisect(defocus, med_cut)
    low, med, high = data[: i + 1], data[i + 1: j + 1], data[j + 1:]
    assert len(data) == len(low) + len(med) + len(high)
    return low, med, high


def calc_subsets(n, step=3):
    """Nested train-subset sizes for the 1/25/50/100% targets: the
    largest multiple of ``step`` whose percentage of ``n`` still falls
    under each target; 100% is always the full train set."""
    subset_dict = dict.fromkeys(SUBSET_TARGETS)
    s = step
    while s < n:
        i = bisect_right(SUBSET_TARGETS, s / n * 100)
        subset_dict[SUBSET_TARGETS[i]] = s
        s += step
    subset_dict[100] = n
    return {k: v for k, v in subset_dict.items() if v is not None}


def sample_from_bin(bins, i, rng):
    """Pop from bin ``i``, falling back to a random non-empty bin."""
    while True:
        if bins[i]:
            return bins[i].pop()
        i = rng.choice([j for j, b in enumerate(bins) if len(b) > 0])


def split_dataset(data, *, ignore_test=False, seed=SEED):
    """Round-robin tertile sampling into (train, val, test, subsets).

    train draws 20% of the data (or all-but-val with ``ignore_test``),
    val draws ``VAL_SIZE``, test is everything left.
    """
    rng = np.random.default_rng(seed)
    low, med, high = tertile_split(data)
    bins = [low, med, high]
    for b in bins:
        rng.shuffle(b)
    rng.shuffle(bins)

    n = len(data)
    thres = n - VAL_SIZE if ignore_test else int(np.rint(TRAIN_FRACTION * n))
    train = []
    curr = 0
    while len(train) < thres:
        train.append(sample_from_bin(bins, curr, rng))
        curr = (curr + 1) % 3
    subsets = calc_subsets(thres)
    if ignore_test:
        subsets = {100: subsets[100]}

    val = []
    curr = 0
    while len(val) < VAL_SIZE:
        val.append(sample_from_bin(bins, curr, rng))
        curr = (curr + 1) % 3

    test = []
    if not ignore_test:
        test = sum(bins, [])
        assert len(train) + len(val) + len(test) == n, (
            "examples lost while building subsets"
        )
    return train, val, test, subsets


def create_symlinks(out_dir, box_dir, mrc_dir, files, label):
    """Symlink tree for one subset: each micrograph's .mrc plus its
    .box labels when present."""
    sub_dir = os.path.join(out_dir, label)
    if os.path.isdir(sub_dir):
        shutil.rmtree(sub_dir)
    os.makedirs(sub_dir, exist_ok=True)
    for fname, _ in files:
        base = ".".join(os.path.basename(fname).split(".")[:-1])
        box_src = os.path.join(box_dir, base + ".box")
        if os.path.isfile(box_src):
            os.symlink(box_src, os.path.join(sub_dir, base + ".box"))
        os.symlink(
            os.path.join(mrc_dir, base + ".mrc"),
            os.path.join(sub_dir, base + ".mrc"),
        )


def plot_defocus(data, low, med, out_file):
    """Defocus histogram with tertile boundary markers."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    defocus = [d for _, d in sorted(data, key=lambda x: float(x[1]))]
    fig, ax = plt.subplots(1, 1, figsize=(8, 8))
    counts, edges, _ = ax.hist(
        defocus, bins=32, facecolor="tab:blue", edgecolor="k"
    )
    ax.axvline(low[-1][1], color="tab:red", lw=2)
    y = counts.max() * 1.1
    ax.text((edges.min() + low[-1][1]) / 2, y, "Low", size=16, ha="center")
    if len(med) > 0:
        ax.axvline(med[-1][1], color="tab:red", lw=2)
        ax.text((low[-1][1] + med[-1][1]) / 2, y, "Medium", size=16,
                ha="center")
        x_hi = (med[-1][1] + edges.max()) / 2
    else:
        x_hi = (low[-1][1] + edges.max()) / 2
    ax.text(x_hi, y, "High", size=16, ha="center")
    ax.set_xlabel("Mean defocus value")
    ax.set_ylabel("Frequency")
    fig.tight_layout()
    fig.savefig(out_file, bbox_inches="tight", dpi=150)
    plt.close(fig)


# CLI (python -m repic_tpu_torch build_subsets)

name = "build_subsets"


def add_arguments(parser) -> None:
    parser.add_argument("defocus_file", type=str,
                        help="RELION CTFFIND4 defocus value file")
    parser.add_argument("box_dir", type=str,
                        help="directory of particle BOX files")
    parser.add_argument("mrc_dir", type=str,
                        help="directory of micrograph MRC files")
    parser.add_argument("out_dir", type=str, help="output directory")
    parser.add_argument("--train_set", type=str, default=None,
                        help="verify this training subset exists after "
                        "splitting (e.g. train_25)")
    parser.add_argument("--ignore_test", action="store_true",
                        help="only build train and val datasets")
    parser.add_argument("--seed", type=int, default=SEED)


def main(args) -> None:
    import sys

    assert os.path.isdir(args.box_dir), (
        f"Error - particle directory '{args.box_dir}' does not exist"
    )
    assert os.path.isdir(args.mrc_dir), (
        f"Error - micrograph directory '{args.mrc_dir}' does not exist"
    )
    box_dir = os.path.abspath(args.box_dir)
    mrc_dir = os.path.abspath(args.mrc_dir)
    out_dir = os.path.abspath(args.out_dir)
    os.makedirs(out_dir, exist_ok=True)

    if os.path.isfile(args.defocus_file):
        data = parse_defocus_file(args.defocus_file)
        low, med, _ = tertile_split(data)
        plot_defocus(
            data, low, med,
            ".".join(args.defocus_file.split(".")[:-1] + ["png"]),
        )
    else:
        print(
            f"Error - defocus file '{args.defocus_file}' not found. "
            "Micrographs will be equally weighted"
        )
        data = scan_mrc_dir(mrc_dir)
        print(f"{len(data)} valid MRC files found")

    train, val, test, subsets = split_dataset(
        data, ignore_test=args.ignore_test, seed=args.seed
    )

    if args.train_set is not None:
        want = int(args.train_set.split("_")[-1])
        if want not in subsets:
            print(
                f"Error - training subset '{args.train_set}' not "
                "available. Try a larger training subset or increase "
                "available data"
            )
            sys.exit(-2)

    for key, size in subsets.items():
        label = (
            "train"
            if args.ignore_test
            else os.path.join("train", f"train_{key}")
        )
        create_symlinks(out_dir, box_dir, mrc_dir, train[:size], label)
    create_symlinks(out_dir, box_dir, mrc_dir, val, "val")
    if not args.ignore_test:
        create_symlinks(out_dir, box_dir, mrc_dir, test, "test")


if __name__ == "__main__":
    import argparse

    _parser = argparse.ArgumentParser(description=__doc__)
    add_arguments(_parser)
    main(_parser.parse_args())
