"""Whole-micrograph particle picking with the CNN (the port of
``repic_tpu.models.infer``):

    read MRC -> preprocess (blur, 3x bin, z-score)
    -> score every sliding 64x64 window (stride 4 on the binned image)
    -> local-maximum peak detection + greedy suppression
    -> upscale coordinates back to the original pixel grid

Two scoring paths share one set of weights:

* ``mode="patch"``: every stride-4 window bytescaled, resized and
  standardized on its own and scored by :class:`PickerCNN`, a band of
  output rows per batch;
* ``mode="fcn"``: the micrograph scored by :class:`PickerFCN` over
  ``(16 / step)^2`` shifted copies, interleaved into the stride-``step``
  grid (global normalization: exact only for models trained with
  ``patch_norm="global"``).

Scoring runs under :func:`_fp32_flags`: cuDNN with TF32 off,
deterministic and without autotuning, and cuBLAS's TF32 off too (the
patch head's ``linear`` and the downsampling resize's contractions), so
float32 stays float32 on the card whatever the caller set process-wide,
and the same micrograph scores to the same bits every time.  Peak
detection labels plateaus and takes their centres of mass with
``scipy.ndimage`` on the host; the suppression runs on the device for
dense candidate sets (``ops/nms.py``), by the reference's rule.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from repic_tpu_torch.analysis.contracts import Contract, checked
from repic_tpu_torch.models import preprocess as pp
from repic_tpu_torch.models.checkpoint import params_from_jax
from repic_tpu_torch.models.cnn import (
    FCN_STRIDE,
    PATCH_SIZE,
    build_model,
    fc_params_as_conv,
)

STEP_SIZE = 4  # window stride on the binned micrograph
ROW_CHUNK = 8  # scored rows per batch (batch = rows * out_w)


@contextlib.contextmanager
def _fp32_flags():
    """TF32 off for cuDNN and cuBLAS, deterministic cuDNN algorithms, no
    autotuning; the caller's cuBLAS setting is restored on exit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def score_grid_shape(shape, patch_size: int, step: int = STEP_SIZE):
    """(out_h, out_w) of the sliding-window score map."""
    return (
        (shape[0] - patch_size) // step + 1,
        (shape[1] - patch_size) // step + 1,
    )


#: the registry entry's static knobs (the reference's)
_SCORE_STATIC = {"patch_size": 16, "step": STEP_SIZE}


@checked(Contract(static=_SCORE_STATIC))
@torch.no_grad()
def score_micrograph_patches(
    params, img, *, patch_size: int, step: int = STEP_SIZE,
    norm: str = "reference", arch: str = "deep", dtype: str = "float32",
):
    """Dense sliding-window scoring via the patch classifier.

    Args:
        params: the port's :class:`PickerCNN` state dict on ``img``'s
            device (``checkpoint.params_from_jax``).
        img: ``(H, W)`` preprocessed (binned, z-scored) micrograph.
        patch_size: window size on the binned grid.
        step: window stride.
        norm: ``"reference"`` = bytescale + resize + standardize per
            patch; ``"global"`` = resize only.

    Output rows are scored ``ROW_CHUNK`` at a time; the last band is
    clamped to the final full band.

    Returns:
        ``(out_h, out_w)`` float32 positive-class probabilities.
    """
    out_h, out_w = score_grid_shape(img.shape, patch_size, step)
    row_chunk = min(ROW_CHUNK, out_h)
    model = build_model("cnn", params, arch=arch, dtype=dtype)
    # (out_h, out_w, patch, patch) view of every window
    windows = img.float().unfold(0, patch_size, step).unfold(
        1, patch_size, step)
    out = torch.empty((out_h, out_w), dtype=torch.float32, device=img.device)
    n_chunks = -(-out_h // row_chunk)
    with _fp32_flags():
        for c in range(n_chunks):
            i0 = min(c * row_chunk, max(out_h - row_chunk, 0))
            patches = windows[i0:i0 + row_chunk].reshape(
                -1, patch_size, patch_size)
            if norm == "reference":
                x = pp.prepare_patches(patches, PATCH_SIZE, ordered=False)
            else:
                x = pp.resize_patches(patches, PATCH_SIZE)
            logits = model(x[..., None])
            prob = torch.softmax(logits, dim=-1)[:, 1]
            out[i0:i0 + row_chunk] = prob.reshape(row_chunk, out_w)
    return out


@torch.no_grad()
def score_micrograph_fcn(
    fcn_params, img, *, patch_size: int, step: int = STEP_SIZE,
    arch: str = "deep", dtype: str = "float32",
):
    """Fully-convolutional scoring with stride-``step`` shift filling.

    The micrograph is resized once so each ``patch_size`` window maps
    to 64 x 64; the FCN (output stride 16) scores ``(16/sstep)^2``
    shifted copies as one batch, interleaved so that ``out[dy + i*n,
    dx + j*n] = maps[dy*n + dx, i, j]``.
    """
    model = build_model("fcn", fcn_params, arch=arch, dtype=dtype)
    H, W = img.shape
    scale = PATCH_SIZE / patch_size
    sh, sw = int(round(H * scale)), int(round(W * scale))
    sstep = max(1, int(round(step * scale)))
    n_shift = FCN_STRIDE // sstep
    out_h = (sh - PATCH_SIZE) // sstep + 1
    out_w = (sw - PATCH_SIZE) // sstep + 1
    sub_h, sub_w = sh - (n_shift - 1) * sstep, sw - (n_shift - 1) * sstep
    with _fp32_flags():
        scaled = pp.resize_images(img.float(), sh, sw)
        subs = torch.stack([
            scaled[dy * sstep:dy * sstep + sub_h,
                   dx * sstep:dx * sstep + sub_w]
            for dy in range(n_shift) for dx in range(n_shift)
        ])
        logits = model(subs[..., None])
    maps = torch.softmax(logits, dim=-1)[..., 1]      # (S, h16, w16)
    h16, w16 = maps.shape[1:]
    maps = maps.reshape(n_shift, n_shift, h16, w16)
    dense = maps.permute(2, 0, 3, 1).reshape(h16 * n_shift, w16 * n_shift)
    return dense[:out_h, :out_w]


def local_maxima_mask(score_map: torch.Tensor, window: int):
    """Local-max detection with scipy ``maximum_filter(size=w)``'s
    footprint: the window spans ``[-w//2, w-1-w//2]`` (asymmetric for
    even ``w``), padded with -inf for the max and +inf for the min."""
    lo, hi = window // 2, window - 1 - window // 2
    x = score_map[None, None]
    data_max = F.max_pool2d(
        F.pad(x, (lo, hi, lo, hi), value=-float("inf")), window, stride=1)
    data_min = -F.max_pool2d(
        F.pad(-x, (lo, hi, lo, hi), value=-float("inf")), window, stride=1)
    data_max, data_min = data_max[0, 0], data_min[0, 0]
    return (score_map == data_max) & (data_max - data_min > 0)


def _pack_score_and_maxima(smap, window: int):
    """Score map + its local-maxima mask as one stacked float32 tensor,
    fetched to the host in one copy."""
    smap = smap.float()
    return torch.stack([smap, local_maxima_mask(smap, window).float()])


def greedy_suppress_host(yx: np.ndarray, scores: np.ndarray, thr: float):
    """The raster-order greedy suppression's keep mask, as a host loop
    vectorized over the inner scan (the semantic specification the
    device path is held to)."""
    order = np.arange(len(yx))
    dead = np.zeros(len(yx), bool)
    for i in order[:-1]:
        if dead[i]:
            continue
        rest = order[i + 1:]
        rest = rest[~dead[rest]]
        if len(rest) == 0:
            break
        d = np.hypot(yx[i, 0] - yx[rest, 0], yx[i, 1] - yx[rest, 1])
        close = rest[d < thr]
        if len(close) == 0:
            continue
        stronger = scores[close] > scores[i]
        if stronger.any():
            # kill weaker-or-equal neighbours ascending until the first
            # stronger one kills i
            cut = int(np.argmax(stronger))
            dead[close[:cut]] = True
            dead[i] = True
        else:
            dead[close] = True
    return ~dead


def peak_detection(
    score_map: np.ndarray,
    window: int,
    device_nms: bool | None = None,
    maxima: np.ndarray | None = None,
    *,
    device=None,
):
    """Local maxima + raster-order greedy suppression.

    Plateau maxima merge by connected-component centre of mass, then
    candidate pairs closer than ``window / 2`` resolve greedily in
    raster order, keeping the higher score.  ``device_nms=None`` takes
    the device path (on ``device``: ``cuda`` unless the caller asks for
    the CPU) exactly where the reference does: at least
    ``DEVICE_NMS_MIN_P`` candidates, coordinates below ``COORD_LIMIT``
    and scores that survive a float32 round trip.

    Returns:
        ``(P, 3)`` float64 array of (x, y, score) on the score-map grid.
    """
    from scipy import ndimage

    from repic_tpu_torch.ops.nms import (
        COORD_LIMIT,
        DEVICE_NMS_MIN_P,
        greedy_suppress_device,
    )
    from repic_tpu_torch.pipeline.consensus import resolve_device

    score_map = np.asarray(score_map)
    if maxima is None:
        # the mask of the float32 map, as the reference's device array
        t = torch.from_numpy(score_map.astype(np.float32)).to(
            resolve_device(device))
        maxima = local_maxima_mask(t, window).cpu().numpy()
    else:
        maxima = np.asarray(maxima, bool)
    labeled, num = ndimage.label(maxima)
    if num == 0:
        return np.zeros((0, 3), np.float64)
    yx = np.array(
        ndimage.center_of_mass(score_map, labeled, range(1, num + 1))
    ).astype(int)
    scores = score_map[yx[:, 0], yx[:, 1]]
    thr = window / 2.0
    if device_nms is None:
        device_nms = (
            len(yx) >= DEVICE_NMS_MIN_P
            and yx.max(initial=0) < COORD_LIMIT
            and np.array_equal(
                scores, scores.astype(np.float32).astype(scores.dtype)
            )
        )
    if device_nms:
        keep = greedy_suppress_device(yx, scores, thr, device=device)
    else:
        keep = greedy_suppress_host(yx, scores, thr)
    return np.column_stack(
        [yx[keep, 1], yx[keep, 0], scores[keep]]
    ).astype(np.float64)


def pick_micrograph(
    params,
    raw_img: np.ndarray,
    particle_size: int,
    *,
    mode: str = "patch",
    norm: str = "reference",
    step: int = STEP_SIZE,
    arch: str = "deep",
    dtype: str = "float32",
    device=None,
):
    """Full picking pass over one raw micrograph on ``device`` (``cuda``
    unless the caller asks for the CPU).

    ``params`` is the reference's :class:`PickerCNN` parameter tree
    (numpy leaves, as :func:`~repic_tpu_torch.models.checkpoint.
    load_checkpoint` returns it).  Returns ``(P, 3)`` of (x_center,
    y_center, score) in original pixel coordinates: ``(idx * step +
    patch/2) * bin``.
    """
    from repic_tpu_torch.pipeline.consensus import resolve_device

    dev = resolve_device(device)
    img = pp.preprocess_micrograph(torch.from_numpy(
        np.ascontiguousarray(raw_img, np.float32)).to(dev))
    patch_size = int(particle_size / pp.BIN_SIZE)
    if mode == "fcn":
        sd = params_from_jax(fc_params_as_conv(params))
        smap = score_micrograph_fcn(
            {k: v.to(dev) for k, v in sd.items()}, img,
            patch_size=patch_size, step=step, arch=arch, dtype=dtype,
        )
    else:
        sd = params_from_jax(params)
        smap = score_micrograph_patches(
            {k: v.to(dev) for k, v in sd.items()}, img,
            patch_size=patch_size, step=step, norm=norm, arch=arch,
            dtype=dtype,
        )
    return picks_from_score_map(smap, particle_size, mode=mode, step=step,
                                device=dev)


def picks_from_score_map(smap, particle_size: int, *, mode: str = "patch",
                         step: int = STEP_SIZE, device=None):
    """The picks of a score map (the back half of
    :func:`pick_micrograph`): its local maxima in one fetch, peak
    detection, then centres in original pixels, ``(idx * eff_step +
    patch/2) * bin`` with the FCN's effective step in ``fcn`` mode.
    ``smap`` is a tensor (or an array, moved to ``device``)."""
    from repic_tpu_torch.pipeline.consensus import resolve_device

    dev = resolve_device(device)
    patch_size = int(particle_size / pp.BIN_SIZE)
    window = int(0.6 * patch_size / step)
    if mode == "fcn":
        scale = PATCH_SIZE / patch_size
        eff_step = max(1, int(round(step * scale))) / scale
    else:
        eff_step = step
    w = max(window, 1)
    smap = torch.as_tensor(smap).to(dev)
    packed = _pack_score_and_maxima(smap, w).cpu().numpy()
    peaks = peak_detection(packed[0], w, maxima=packed[1] > 0.5,
                           device=dev)
    if len(peaks) == 0:
        return peaks
    coords = peaks.copy()
    coords[:, 0] = (coords[:, 0] * eff_step + patch_size / 2) * pp.BIN_SIZE
    coords[:, 1] = (coords[:, 1] * eff_step + patch_size / 2) * pp.BIN_SIZE
    return coords
