"""Pairwise box-IoU (Jaccard) of square boxes.

``inter / (sa^2 + sb^2 - inter)`` with ``inter`` the overlap area;
with equal sizes this is the reference's ``inter / (2 b^2 - inter)``.
Each operation rounds to float32 on its own (no fused multiply-add),
which is how the JAX package's CPU program evaluates it too.
"""

from __future__ import annotations

import torch

from repic_tpu_torch.analysis.contracts import Contract, checked, spec


def _size(s, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(s, dtype=like.dtype, device=like.device)


def pair_iou_xy(xa, ya, xb, yb, box_size, box_size_b=None):
    """Elementwise IoU from separate x/y coordinate tensors (they
    broadcast against each other, and against tensor box sizes)."""
    sa = _size(box_size, xa)
    sb = sa if box_size_b is None else _size(box_size_b, xa)
    ovx = torch.clamp_min(
        torch.minimum(xa + sa, xb + sb) - torch.maximum(xa, xb), 0.0
    )
    ovy = torch.clamp_min(
        torch.minimum(ya + sa, yb + sb) - torch.maximum(ya, yb), 0.0
    )
    inter = ovx * ovy
    return inter / (sa * sa + sb * sb - inter)


def pair_iou(xy_a, xy_b, box_size, box_size_b=None):
    """All-pairs IoU: ``(..., Na, 2)`` x ``(..., Nb, 2)`` ->
    ``(..., Na, Nb)``.  Tensor box sizes broadcast over the leading
    dims (shape ``(...,)``)."""
    sa = _size(box_size, xy_a)
    sa = sa.reshape(sa.shape + (1, 1)) if sa.dim() else sa
    sb = None
    if box_size_b is not None:
        sb = _size(box_size_b, xy_a)
        sb = sb.reshape(sb.shape + (1, 1)) if sb.dim() else sb
    return pair_iou_xy(
        xy_a[..., :, None, 0], xy_a[..., :, None, 1],
        xy_b[..., None, :, 0], xy_b[..., None, :, 1],
        sa, sb,
    )


@checked(Contract(
    args={
        "xy_a": spec("N 2"),
        "mask_a": spec("N", "bool"),
        "xy_b": spec("M 2"),
        "mask_b": spec("M", "bool"),
        "box_size": spec(""),
    },
    returns=spec("N M"),
    dims={"N": 8, "M": 5},
))
def pairwise_iou_matrix(
    xy_a, mask_a, xy_b, mask_b, box_size, box_size_b=None
):
    """Masked all-pairs IoU: entries involving padded slots are 0."""
    iou = pair_iou(xy_a, xy_b, box_size, box_size_b)
    valid = mask_a[..., :, None] & mask_b[..., None, :]
    return torch.where(valid, iou, torch.zeros((), dtype=iou.dtype,
                                               device=iou.device))
