"""Device-side greedy peak suppression (the port of
``repic_tpu.ops.nms``).

Candidates are resolved in raster order: for each candidate ``i``,
later candidates within ``window / 2`` are killed in ascending order
while they are weaker-or-equal; the first *stronger* one kills ``i``
(and ``i``'s pass stops there).  The order-dependent scan is a Python
loop over the padded candidate count carrying a ``(P,)`` dead mask on
the device; each step is an O(P) masked vector computation, and no
step reads a value back to the host (``torch.where`` replaces the
reference's branch on an inactive candidate).

Distances compare as integer squared pixels on doubled coordinates
against ``window**2``: exact, so the keep mask is the host loop's
(``repic_tpu_torch.models.infer.greedy_suppress_host``) bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repic_tpu_torch.parallel.batching import bucket_size

# the reference's rule: from this many candidates on, suppress on the
# device (on the card the device path is still the slower one at 1,024
# and 4,096 candidates: ROADMAP Queue 2)
DEVICE_NMS_MIN_P = 1024

# Max grid coordinate for exact int32 doubled-coordinate distances:
# 2 * (2 * (COORD_LIMIT - 1))**2 must stay below 2**31.
COORD_LIMIT = 16384


def _suppress(yx, scores, thr2, valid):
    """The keep mask of padded candidates, all on their device."""
    cap = len(scores)
    idx = torch.arange(cap, device=scores.device)
    dead = torch.zeros(cap, dtype=torch.bool, device=scores.device)
    for i in range(cap):
        d = yx - yx[i]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
        close = (d2 < thr2) & (idx > i) & ~dead & valid
        stronger = close & (scores > scores[i])
        # the FIRST stronger neighbour, or cap when there is none
        first = torch.where(stronger, idx, cap).amin()
        kills = close & (idx < first)
        new_dead = dead | kills | ((idx == i) & (first < cap))
        # i already dead or padding: its pass is a no-op
        active = ~dead[i] & valid[i]
        dead = torch.where(active, new_dead, dead)
    return ~dead & valid


def greedy_suppress_device(yx, scores, thr: float, device=None) -> np.ndarray:
    """Keep mask for integer candidate coords ``(P, 2)`` in raster
    order, computed on ``device`` (``cuda`` unless the caller asks for
    the CPU).

    Equal to the host loop for float32-exact scores.  Coordinates must
    lie in ``[0, 16384)`` (int32 arithmetic on doubled coordinates);
    beyond that it raises ``ValueError``."""
    from repic_tpu_torch.pipeline.consensus import resolve_device

    dev = resolve_device(device)
    p = len(yx)
    if p == 0:
        return np.zeros(0, bool)
    yx = np.asarray(yx)
    if yx.max(initial=0) >= COORD_LIMIT:
        raise ValueError(
            f"device NMS supports grid coordinates < {COORD_LIMIT} "
            f"(got {int(yx.max())}); use the host path"
        )
    cap = bucket_size(p, minimum=256)
    yx_pad = np.zeros((cap, 2), np.int32)
    yx_pad[:p] = np.asarray(yx, np.int32)
    sc_pad = np.full(cap, -np.inf, np.float32)
    sc_pad[:p] = np.asarray(scores, np.float32)
    valid = np.zeros(cap, bool)
    valid[:p] = True
    # thr is window/2 with integer window: doubling the coordinates
    # turns ``d < thr`` into ``(2dx)^2 + (2dy)^2 < window^2``
    thr2_x4 = int(round(4 * thr * thr))
    keep = _suppress(
        torch.from_numpy(yx_pad * 2).to(dev),
        torch.from_numpy(sc_pad).to(dev),
        thr2_x4,
        torch.from_numpy(valid).to(dev),
    )
    return keep.cpu().numpy()[:p]
