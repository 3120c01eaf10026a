"""Fused IoU top-D neighbour search (kernel 1).

:func:`topk_neighbors` is the counterpart of ``repic_tpu``'s
``pallas_topk_neighbors``: for each anchor of set A against all of set
B, the top-``d`` IoUs (``-1`` in empty slots), their candidate indices
(sentinel ``M`` for empty slots) and the count of candidates above the
threshold.  Ties keep the lower candidate index.  On a CUDA tensor it
launches ``csrc/neighbors.cu``; on a CPU tensor it runs
:func:`topk_neighbors_plain`, which builds the masked IoU matrix and
takes a stable descending sort.

Both take an optional leading batch dimension, so one call (one
launch) covers every (micrograph, picker pair) of a chunk.

:func:`pallas_topk_neighbors` is the registry entry under the
reference's name: its :class:`KernelContract` holds the kernel against
the dense IoU matrix and a top-``d`` (KERNELCHECK).
"""

from __future__ import annotations

import math
import numbers

import torch

from repic_tpu_torch import _build
from repic_tpu_torch.analysis.contracts import Contract, checked, spec
from repic_tpu_torch.analysis.kernels import KernelContract
from repic_tpu_torch.ops.iou import pair_iou

NEG = -1.0  # value of an empty top-D slot (any IoU is >= 0)
#: fail-fast ceiling on d for direct callers (the reference's MAX_D)
MAX_D = 1024

#: launches of the CUDA kernel (compare-only launches excluded by the
#: caller resetting it)
LAUNCHES = 0


def _batched(xy_a, mask_a, xy_b, mask_b):
    single = xy_a.dim() == 2
    if single:
        xy_a, mask_a = xy_a[None], mask_a[None]
        xy_b, mask_b = xy_b[None], mask_b[None]
    return single, xy_a, mask_a, xy_b, mask_b


def _empty(b, n, m, d, like):
    dev = like.device
    return (
        torch.full((b, n, d), NEG, dtype=like.dtype, device=dev),
        torch.full((b, n, d), m, dtype=torch.int32, device=dev),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
    )


def _unbatch(single, out):
    return tuple(o[0] for o in out) if single else out


def topk_neighbors_plain(
    xy_a, mask_a, xy_b, mask_b, size_a, size_b,
    *, d: int = 16, threshold: float = 0.3,
):
    """Plain PyTorch version of :func:`topk_neighbors`."""
    single, xy_a, mask_a, xy_b, mask_b = _batched(xy_a, mask_a, xy_b, mask_b)
    b, n, m = xy_a.shape[0], xy_a.shape[1], xy_b.shape[1]
    if n == 0 or m == 0:
        return _unbatch(single, _empty(b, n, m, d, xy_a))

    def sizes(s):
        s = torch.as_tensor(s, dtype=xy_a.dtype, device=xy_a.device)
        return s.reshape(-1).expand(b)

    iou = pair_iou(xy_a, xy_b, sizes(size_a), sizes(size_b))
    valid = mask_a[:, :, None] & mask_b[:, None, :]
    iou = torch.where(valid, iou, torch.full((), NEG, dtype=iou.dtype,
                                             device=iou.device))
    thr = torch.tensor(threshold, dtype=iou.dtype, device=iou.device)
    cnt = (iou > thr).sum(-1, dtype=torch.int32)
    vals, order = torch.sort(iou, dim=-1, descending=True, stable=True)
    vals, order = vals[..., :d], order[..., :d].to(torch.int32)
    if d > m:
        pad_v, pad_i, _ = _empty(b, n, m, d - m, xy_a)
        vals = torch.cat([vals, pad_v], -1)
        order = torch.cat([order, pad_i], -1)
    order = torch.where(vals > NEG, order, torch.full_like(order, m))
    return _unbatch(single, (vals, order, cnt))


def _size_arg(s, b: int, dev):
    """One side's box edges for the kernel: ``(value, pointer, keep)``.

    A Python number travels as a kernel argument (null pointer), with
    no tensor work on the host.  Anything else is read on the card from
    ``b`` floats (copied there first when it is not already); ``keep``
    holds them."""
    if isinstance(s, numbers.Real):
        if not (math.isfinite(s) and s > 0):
            raise ValueError("box sizes must be positive and finite")
        return float(s), None, None
    keep = torch.as_tensor(s, dtype=torch.float32, device=dev)
    keep = keep.reshape(-1).expand(b).contiguous()
    return 0.0, keep.data_ptr(), keep


def topk_neighbors(
    xy_a, mask_a, xy_b, mask_b, size_a, size_b,
    *, d: int = 16, threshold: float = 0.3,
):
    """Top-``d`` IoU neighbours of each anchor (kernel 1).

    Args:
        xy_a/mask_a: ``([B,] N, 2)`` float32 / ``([B,] N)`` bool.
        xy_b/mask_b: ``([B,] M, 2)`` / ``([B,] M)``.
        size_a/size_b: box edges — Python numbers (positive and
            finite; kernel arguments, no copy to the card) or tensors
            of one or ``B`` values (best on the card).

    Returns:
        ``(iou, idx, count)``: ``([B,] N, d)`` float32 (``-1`` empty),
        ``([B,] N, d)`` int32 (sentinel ``M``), ``([B,] N)`` int32.
    """
    global LAUNCHES
    if d > MAX_D:
        raise ValueError(f"d={d} exceeds MAX_D={MAX_D}")
    if xy_a.device.type == "cpu":
        return topk_neighbors_plain(
            xy_a, mask_a, xy_b, mask_b, size_a, size_b,
            d=d, threshold=threshold,
        )
    if xy_a.device.type != "cuda":
        raise ValueError(f"unsupported device {xy_a.device}")
    single, xy_a, mask_a, xy_b, mask_b = _batched(xy_a, mask_a, xy_b, mask_b)
    b, n, m = xy_a.shape[0], xy_a.shape[1], xy_b.shape[1]
    for t, want in ((xy_a, (b, n, 2)), (xy_b, (b, m, 2))):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(
                f"expected float32 {want}, got {t.dtype} {tuple(t.shape)}"
            )
    for t, want in ((mask_a, (b, n)), (mask_b, (b, m))):
        if tuple(t.shape) != want:
            raise ValueError(f"expected mask {want}, got {tuple(t.shape)}")
    dev = xy_a.device
    for t in (mask_a, mask_b, xy_b):
        if t.device != dev:
            raise ValueError("all inputs must be on one device")
    if n == 0 or m == 0 or b == 0:
        return _unbatch(single, _empty(b, n, m, d, xy_a))
    sa, sa_ptr, _sa = _size_arg(size_a, b, dev)
    sb, sb_ptr, _sb = _size_arg(size_b, b, dev)
    xy_a, xy_b = _build.aligned(xy_a), _build.aligned(xy_b)
    mask_a = mask_a.to(torch.bool).contiguous()
    mask_b = mask_b.to(torch.bool).contiguous()
    out_v = torch.empty((b, n, d), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, n, d), dtype=torch.int32, device=dev)
    out_c = torch.empty((b, n), dtype=torch.int32, device=dev)
    lib = _build.load("neighbors")
    err = lib.repic_topk_neighbors(
        xy_a.data_ptr(), mask_a.data_ptr(), xy_b.data_ptr(),
        mask_b.data_ptr(), sa_ptr, sa, sb_ptr, sb,
        out_v.data_ptr(), out_i.data_ptr(), out_c.data_ptr(),
        b, n, m, d, float(threshold), _build.stream_ptr(dev),
    )
    _build.check(err, "topk_neighbors")
    LAUNCHES += 1
    return _unbatch(single, (out_v, out_i, out_c))


# -- the registry entry and its kernel contract (KERNELCHECK) ----------

_PROBE_D = 8
_PROBE_BOX = 180.0
_PROBE_THRESHOLD = 0.3


def _probe_inputs(dims: dict):
    """The reference's probe inputs (same generator, same draws)."""
    import numpy as np

    n, m = dims["N"], dims["M"]
    rng = np.random.default_rng(n + m)
    xa = torch.tensor(rng.uniform(0, 2000.0, (n, 2)), dtype=torch.float32)
    xb = torch.tensor(rng.uniform(0, 2000.0, (m, 2)), dtype=torch.float32)
    ma = torch.from_numpy(rng.uniform(size=n) > 0.15)
    mb = torch.from_numpy(rng.uniform(size=m) > 0.15)
    return (xa, ma, xb, mb, _PROBE_BOX, _PROBE_BOX), {}


def _reference(xy_a, mask_a, xy_b, mask_b, size_a, size_b):
    """Ground truth: the dense IoU matrix and a top-d, the unfused path
    this kernel replaces."""
    from repic_tpu_torch.ops.iou import pairwise_iou_matrix

    iou = pairwise_iou_matrix(xy_a, mask_a, xy_b, mask_b, size_a, size_b)
    v, i = torch.topk(iou, _PROBE_D, dim=-1)
    cnt = (iou > _PROBE_THRESHOLD).sum(-1, dtype=torch.int32)
    return v, i.to(torch.int32), cnt


def _compare(got, want, tol):
    """Values (empty slots read as IoU 0) and adjacency counts; indices
    are skipped -- zero-IoU candidates form large tie classes, which
    the kernel and a top-k may order differently."""
    import numpy as np

    tv, _ti, cnt = got
    rv, _ri, rc = want
    msgs = []
    tvc = np.where(tv < 0, 0.0, tv)
    if not np.allclose(tvc, rv, atol=tol, rtol=0.0):
        delta = float(np.max(np.abs(tvc - rv)))
        msgs.append(
            f"top-{_PROBE_D} IoU values: max |kernel - reference| "
            f"= {delta:.3g} > tol {tol:g}"
        )
    if not np.array_equal(cnt, rc):
        msgs.append(
            f"adjacency counts differ for {int(np.sum(cnt != rc))} "
            "anchor(s)"
        )
    return msgs


@checked(Contract(
    args={
        "xy_a": spec("N 2"),
        "mask_a": spec("N", "bool"),
        "xy_b": spec("M 2"),
        "mask_b": spec("M", "bool"),
        "size_a": spec(""),
        "size_b": spec(""),
    },
    returns=(
        spec("N 8"), spec("N 8", "int32"), spec("N", "int32")
    ),
    dims={"N": 40, "M": 70},
    static={"d": _PROBE_D, "threshold": _PROBE_THRESHOLD},
    kernel=KernelContract(
        # bucket-aligned rungs plus a ragged one
        ladder=(
            {"N": 64, "M": 128},
            {"N": 96, "M": 256},
            {"N": 40, "M": 70},
        ),
        make_inputs=_probe_inputs,
        reference=_reference,
        compare=_compare,
        tol=1e-6,
    ),
))
def pallas_topk_neighbors(
    xy_a, mask_a, xy_b, mask_b, size_a, size_b,
    *, d: int = 16, threshold: float = 0.3,
):
    """:func:`topk_neighbors` under the reference's name: the kernel's
    registry entry."""
    return topk_neighbors(xy_a, mask_a, xy_b, mask_b, size_a, size_b,
                          d=d, threshold=threshold)
