"""Seeded synthetic inputs: picker directories at EMPIAR-10017
density, and packings whose rounding candidates nearly tie.

Each micrograph holds true particles on a jittered grid (about 676 on
a 3,700-pixel field, spaced wider than an IoU of 0.3 reaches for box
180), seen by each of K pickers with probability 0.9 and a few pixels
of jitter, plus uniform false positives, so every picker file holds
600-950 boxes — the 10017 set's density (up to 908 boxes per file;
padded to N = 1024).  Files use the 5-column ``x y w h conf`` format.
"""

from __future__ import annotations

import os

import numpy as np

FIELD = 3700.0
GRID = 26


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
            with open(os.path.join(d, name + ".box"), "w") as f:
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
