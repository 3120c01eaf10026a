"""Micrograph and patch preprocessing for the CNN picker (the port of
``repic_tpu.models.preprocess``), as torch ops on the tensor's device:

    micrograph: gaussian blur sigma=0.1 -> 3x3 mean-bin -> z-score
    patch:      bytescale to uint8 -> bilinear resize to 64x64
                -> per-patch z-score

The reference's spreads are written out: the micrograph divides by the
population std (``ddof=0``), the patches by the sample std (``ddof=1``).

The antialiased resize is ``jax.image.resize(..., "linear",
antialias=True)``.  Upsampling (every particle size under 192 px, whose
binned patch is under 64) is ``F.interpolate(mode="bilinear",
antialias=True)``, which gives JAX's floats on integer-valued patches.
Downsampling builds ``jax.image.scale_and_translate``'s per-axis
triangle-kernel weight matrices (kernel scale ``min(1, out/in)``, each
output's weights renormalised) and applies them as two contractions,
since ``F.interpolate``'s antialiased filter differs there.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BIN_SIZE = 3
GAUSSIAN_SIGMA = 0.1


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    # scipy.ndimage.gaussian_filter semantics: truncate=4.0 =>
    # radius = int(4*sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, radius: int, device) -> torch.Tensor:
    """Indices of a length-``n`` axis padded by ``radius`` with the edge
    sample repeated (numpy 'symmetric', scipy 'reflect')."""
    i = torch.arange(-radius, n + radius, device=device)
    i = torch.where(i < 0, -i - 1, i)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def gaussian_blur(img: torch.Tensor, sigma: float = GAUSSIAN_SIGMA):
    """Separable Gaussian blur matching scipy's default truncation
    (sigma 0.1 has radius 0: the identity)."""
    radius = int(4.0 * sigma + 0.5)
    if radius == 0:
        return img
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(img.device)
    h, w = img.shape
    cols = img[_symmetric_index(h, radius, img.device)]      # (h+2r, w)
    img = F.conv1d(cols.t()[:, None], k.flip(0)[None, None])[:, 0].t()
    rows = img[:, _symmetric_index(w, radius, img.device)]   # (h, w+2r)
    return F.conv1d(rows[:, None], k.flip(0)[None, None])[:, 0]


def _const(x: torch.Tensor, value) -> torch.Tensor:
    """``value`` as a 0-d tensor on ``x``'s device.  Dividing by it is
    an IEEE division; torch divides by a Python number (and divides a
    Python number by a tensor) through a reciprocal, which rounds
    differently from the reference's division."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


def _mean(x: torch.Tensor, dim: tuple, keepdim: bool = False):
    """Sum over ``dim`` divided by the count (``torch.mean`` multiplies
    by the count's reciprocal)."""
    n = 1
    for d in dim:
        n *= x.shape[d]
    return x.sum(dim=dim, keepdim=keepdim) / _const(x, n)


def _sum_in_order(parts) -> torch.Tensor:
    """Left-to-right float32 sum of equally shaped tensors."""
    it = iter(parts)
    acc = next(it).clone()
    for p in it:
        acc += p
    return acc


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a 2-D float32 tensor in the order XLA's CPU backend sums
    ``jnp.sum``/``jnp.mean`` over a whole image: while an axis is longer
    than 32, windows of 32 x 32 (zero padding split evenly, the extra
    row or column at the end) each summed row by row in order; then the
    remainder's rows summed in order and the row sums added in order.
    At a real micrograph's binned size (up to a few thousand pixels a
    side, two window levels and a 2 x 2 remainder) this is the
    reference's float32 sum bit for bit, so the z-scored micrograph is
    too; elsewhere it agrees to float32 rounding."""
    x = x.float()
    while max(x.shape) > 32:
        h, w = x.shape
        wh, ww = (32 if h > 32 else 1), (32 if w > 32 else 1)
        ph, pw = -(-h // wh) * wh - h, -(-w // ww) * ww - w
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        blk = x.reshape(x.shape[0] // wh, wh, x.shape[1] // ww, ww)
        x = _sum_in_order(blk[:, i, :, j] for i in range(wh)
                          for j in range(ww))
    rows = _sum_in_order(x[:, j] for j in range(x.shape[1]))
    return _sum_in_order(rows[i] for i in range(x.shape[0]))


def bin2d(img: torch.Tensor, factor: int = BIN_SIZE) -> torch.Tensor:
    """Mean-pool ``factor x factor`` blocks, cropping the remainder: each
    block summed row by row, times the float32 reciprocal of its size
    (the reference's compiled mean)."""
    h = (img.shape[0] // factor) * factor
    w = (img.shape[1] // factor) * factor
    blk = img[:h, :w].reshape(h // factor, factor, w // factor, factor)
    total = _sum_in_order(blk[:, i, :, j] for i in range(factor)
                          for j in range(factor))
    return total * _recip(img, factor * factor)


def _recip(x: torch.Tensor, n: int) -> torch.Tensor:
    """float32 ``1 / n`` as a 0-d tensor on ``x``'s device."""
    return _const(x, np.float32(1) / np.float32(n))


def preprocess_micrograph(img: torch.Tensor) -> torch.Tensor:
    """Blur + bin + z-score with the population std (ddof=0), as the
    reference computes them: the mean is :func:`tree_sum` times the
    float32 ``1/N``, the variance the centred squares' :func:`tree_sum`
    divided by ``N``, the z-score an IEEE division."""
    img = bin2d(gaussian_blur(img.float()))
    mean = tree_sum(img) * _recip(img, img.numel())
    centered = img - mean
    std = torch.sqrt(tree_sum(centered * centered)
                     / _const(img, img.numel()))
    return (img - mean) / std


def bytescale(patches: torch.Tensor) -> torch.Tensor:
    """Per-patch min-max scale to rounded uint8 values in [0, 255]
    (the +0.5 floor-round of ``scipy.misc.bytescale``)."""
    cmin = patches.amin(dim=(-2, -1), keepdim=True)
    cmax = patches.amax(dim=(-2, -1), keepdim=True)
    scale = torch.where(cmax > cmin, cmax - cmin, 1.0)
    b = (patches - cmin) * (_const(scale, 255.0) / scale)
    return torch.floor(torch.clamp(b, 0, 255) + 0.5)


def standardize_patches(patches: torch.Tensor) -> torch.Tensor:
    """Per-patch z-score with the sample std (ddof=1)."""
    n = patches.shape[-2] * patches.shape[-1]
    mean = _mean(patches, (-2, -1), keepdim=True)
    var = torch.square(patches - mean).sum(
        dim=(-2, -1), keepdim=True) / _const(patches, max(n - 1, 1))
    std = torch.sqrt(var)
    return (patches - mean) / torch.where(std > 0, std, 1.0)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """``(in_size, out_size)`` float32 weights of
    ``jax.image.scale_and_translate``'s antialiased triangle kernel,
    computed on the host with the float32 arithmetic XLA's CPU backend
    compiles for it: the division by the kernel scale as a multiply by
    its reciprocal, ``1 - |x| * r`` as one fused multiply-add, and each
    output's weight sum over windows of 32 input rows (centred by equal
    zero padding), each window summed in order, then the windows in
    order.  The weights are then bit for bit the reference's, so the
    rounding after the resize lands on the same uint8 levels."""
    f32, f64 = np.float32, np.float64
    inv_scale = f32(1.0 / (out_size / in_size))
    recip = f32(1.0 / max(1.0 / (out_size / in_size), 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    # the fused multiply-add: one rounding of the exact 1 - |x| * r
    w = np.maximum(f32(0), (1.0 - x.astype(f64) * f64(recip)).astype(f32))
    win = 32
    pad = (-(-in_size // win) * win - in_size) // 2
    padded = np.concatenate([np.zeros((pad, out_size), f32), w])
    total = np.zeros(out_size, f32)
    for start in range(0, len(padded), win):
        part = np.zeros(out_size, f32)
        for row in padded[start:start + win]:
            part += row
        total += part
    eps = f32(1000.0 * float(np.finfo(np.float32).eps))
    w = np.where(np.abs(total) > eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_images(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of the last two axes of ``x`` (any
    leading batch shape): ``jax.image.resize(..., "linear",
    antialias=True)``.  Downsampling contracts the rows first, then the
    columns, as JAX does."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    if out_h >= h and out_w >= w:
        lead = x.shape[:-2]
        y = F.interpolate(x.reshape(-1, 1, h, w).float(), (out_h, out_w),
                          mode="bilinear", antialias=True,
                          align_corners=False)
        return y.reshape(*lead, out_h, out_w)
    wh = torch.from_numpy(resize_weights(h, out_h)).to(x.device)
    ww = torch.from_numpy(resize_weights(w, out_w)).to(x.device)
    y = torch.einsum("...hw,hH->...Hw", x.float(), wh)
    return torch.einsum("...Hw,wW->...HW", y, ww)


def resize_patches(patches: torch.Tensor, out_size: int) -> torch.Tensor:
    """Antialiased bilinear resize of ``(B, h, w)`` to ``(B, s, s)``."""
    return resize_images(patches, out_size, out_size)


def prepare_patches(patches: torch.Tensor, out_size: int) -> torch.Tensor:
    """bytescale -> resize -> round half-to-even and clamp to [0, 255]
    (a uint8 resize) -> standardize: the full per-patch chain."""
    resized = resize_patches(bytescale(patches), out_size)
    return standardize_patches(
        torch.clamp(torch.round(resized), 0.0, 255.0)
    )
