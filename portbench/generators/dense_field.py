"""The dense-field stress micrograph (BASELINE.json configs[3]).

A frozen copy of the project's stress field (``bench_stress.py:
synthesize``, copied into the port as ``repic_tpu_torch/utils/
synthetic.py: synthesize``): ``n`` true particles on a square grid
``spacing`` px apart, offset by one ``spacing`` from the origin; each
picker reports every particle once, moved by Gaussian jitter of
``jitter`` px, with a confidence uniform on [0.05, 1).

One micrograph draws in the original's order for ``m = 1``: each
picker's jitter (float32), then the ``(pickers, n)`` confidences.  So
``generate(numpy.random.default_rng(s), pickers=k, n=n)`` holds the
values of ``synthesize(1, k, n, seed=s)``, rounded as the BOX files of
``write_stress_dir`` round them: coordinates to 2 decimals, confidences
to 6.
"""

from __future__ import annotations

import numpy as np


def generate(rng, *, pickers: int, n: int = 50_000, spacing: float = 150.0,
             jitter: float = 10.0):
    """One micrograph: a list of ``(xy (n, 2) float32, conf (n,)
    float32)``, one per picker, in grid order."""
    side = int(np.ceil(np.sqrt(n)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    base = (np.stack([gx, gy], -1).reshape(-1, 2)[:n].astype(np.float32)
            * spacing + spacing)
    xy = [base + rng.normal(0, jitter, base.shape).astype(np.float32)
          for _ in range(pickers)]
    conf = rng.uniform(0.05, 1.0, size=(pickers, n)).astype(np.float32)
    return [(np.round(xy[p].astype(np.float64), 2).astype(np.float32),
             np.round(conf[p].astype(np.float64), 6).astype(np.float32))
            for p in range(pickers)]
