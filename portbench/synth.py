"""Seeded inputs of the benchmark, generated in memory.

Frozen copies of the port's generators (``repic_tpu_torch/utils/
synthetic.py``), kept here so that a change to the program cannot move
the yardstick.  Seed rule: every generator draws from one
``numpy.random.default_rng(seed)`` in a fixed order, so one seed gives
the same arrays on every machine; the harness passes the run's
``--seed`` through :func:`rng_seed`.

* :func:`density_10017` copies ``write_synthetic_dir``'s density model
  (true particles on a jittered 26 x 26 grid over a 3,700 px field,
  seen by each picker with probability 0.9 and 8 px of jitter, plus
  uniform false positives, 600-950 boxes a file);
* :func:`box_tree` copies ``synth_box_tree`` (``n_per`` particles
  uniform on [200, 3800), seen by every picker with 15 px of jitter);
* :func:`micrograph` copies ``synthetic_micrograph`` (unit Gaussian
  noise plus 600-950 dark Gaussian blobs of sigma box/6).

A consensus configuration names its generator; :func:`generator` finds
it here or, for a name not here, in ``portbench/generators/<name>.py``,
so a configuration can bring its generator as a new file.

The BOX files that the originals write round coordinates and
confidences; the copies round the same way, so the arrays hold what the
program would read from those files.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def rng_seed(seed: int, stream: int) -> np.random.SeedSequence:
    """The seed sequence of one input stream of a run (any whole
    number, negative and past 64 bits included)."""
    return np.random.SeedSequence([abs(int(seed)) % (1 << 128),
                                   int(seed < 0), int(stream)])


def density_10017(rng, *, pickers: int, field: float = 3700.0,
                  grid: int = 26, seen: float = 0.9, jitter: float = 8.0,
                  boxes=(600, 950)):
    """One micrograph of ``write_synthetic_dir``: a list of
    ``(xy (n, 2) float32, conf (n,) float32)``, one per picker, in the
    file's row order (coordinates rounded to whole pixels, confidences
    to 6 decimals)."""
    step = field / grid
    gx, gy = np.meshgrid(np.arange(grid), np.arange(grid))
    base = np.stack([gx.ravel(), gy.ravel()], -1) * step
    true_xy = base + rng.uniform(-0.15, 0.15, base.shape) * step
    out = []
    for _ in range(pickers):
        seen_xy = true_xy[rng.uniform(size=len(true_xy)) < seen]
        seen_xy = seen_xy + rng.normal(0.0, jitter, seen_xy.shape)
        n_total = int(rng.integers(boxes[0], boxes[1] + 1))
        fp = rng.uniform(0.0, field, (max(n_total - len(seen_xy), 0), 2))
        xy = np.concatenate([seen_xy, fp])
        conf = np.concatenate([
            rng.uniform(0.4, 1.0, len(seen_xy)),
            rng.uniform(0.05, 0.6, len(fp)),
        ])
        order = rng.permutation(len(xy))
        out.append((np.round(xy[order]).astype(np.float32),
                    np.round(conf[order], 6).astype(np.float32)))
    return out


def box_tree(rng, *, pickers: int, n_per: int, lo: float = 200.0,
             hi: float = 3800.0, jitter: float = 15.0):
    """One micrograph of ``synth_box_tree``: ``n_per`` particles
    uniform on ``[lo, hi)^2`` seen by every picker with ``jitter`` px
    of Gaussian jitter and a uniform confidence in [0.05, 1);
    coordinates rounded to 2 decimals, confidences to 6."""
    base = rng.uniform(lo, hi, size=(n_per, 2)).astype(np.float32)
    out = []
    for _ in range(pickers):
        xy = base + rng.normal(0, jitter, size=base.shape)
        conf = rng.uniform(0.05, 1.0, size=n_per)
        out.append((np.round(xy, 2).astype(np.float32),
                    np.round(conf, 6).astype(np.float32)))
    return out


def micrograph(rng, *, size: int = 4096, box: int = 180,
               particles=(600, 950)):
    """``synthetic_micrograph``: ``(image (size, size) float32,
    centres (n, 2) float32)``."""
    img = rng.standard_normal((size, size), dtype=np.float32)
    n = int(rng.integers(particles[0], particles[1] + 1))
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


GENERATORS = {"density_10017": density_10017, "box_tree": box_tree}


def generator(name: str):
    """The consensus generator ``name``: :data:`GENERATORS`' entry, else
    ``portbench/generators/<name>.py``'s ``generate(rng, *, pickers,
    **args)``."""
    if name in GENERATORS:
        return GENERATORS[name]
    path = os.path.join(HERE, "generators", name + ".py")
    if not os.path.exists(path):
        raise ValueError(f"unknown generator {name!r}: not in GENERATORS "
                         f"and no {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench.generators." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate
