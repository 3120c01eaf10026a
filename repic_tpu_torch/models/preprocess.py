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
since ``F.interpolate``'s antialiased filter differs there.  Float
patches (``patch_norm="global"``) upsample with XLA's CPU summation
order (``ordered=True``): one fused multiply-add per input index in
ascending order, rows first, bit for bit JAX's.
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


def _sum_in_order(parts) -> torch.Tensor:
    """Left-to-right float32 sum of equally shaped tensors."""
    it = iter(parts)
    acc = next(it).clone()
    for p in it:
        acc += p
    return acc


#: XLA's CPU tree-reduction window
REDUCE_WINDOW = 32


def _lanes(h: int, w: int) -> int:
    """Vector lanes LLVM's loop vectorizer gives the row loop of XLA's
    CPU reduce of an ``h x w`` block (each side at most 32) to a scalar;
    0 when the loop stays scalar.  The columns of a row are unrolled, so
    only blocks of 2-8 columns vectorize, at the widths its cost model
    picks for an x86-64 target with 256-bit vectors."""
    if not 2 <= w <= 8:
        return 0
    if h in (2, 4, 8):
        return h
    if h < 16:
        return 0
    if 20 <= h <= 23:
        return 4
    if 28 <= h <= 31:
        return 8 if w == 2 else 4
    return 8 if w <= 6 else 4


def _chain(x: torch.Tensor, rows) -> torch.Tensor:
    """Left-to-right sum of ``x[..., r, c]`` over ``rows``, each row's
    columns in order."""
    return _sum_in_order(x[..., r, c] for r in rows
                         for c in range(x.shape[-1]))


def _block_sum(x: torch.Tensor, vectorized: bool = True) -> torch.Tensor:
    """Sum of the last two axes (each at most 32) in the order of XLA's
    CPU loop: one chain in row-major order, or with ``L = _lanes(h, w)``
    lanes, lane ``l`` chaining rows ``l, l + L, ...`` below the last
    whole group of ``L`` rows, the lanes folded in halves (lane ``i``
    plus lane ``i + L/2`` until one is left), then the chain continued
    over the rows that remain."""
    h, w = x.shape[-2:]
    lanes = _lanes(h, w) if vectorized else 0
    if lanes == 0:
        return _chain(x, range(h))
    full = h // lanes * lanes
    acc = [_chain(x, range(lane, full, lanes)) for lane in range(lanes)]
    while len(acc) > 1:
        half = len(acc) // 2
        acc = [acc[i] + acc[i + half] for i in range(half)]
    return _sum_in_order([acc[0]] + [x[..., r, c] for r in range(full, h)
                                     for c in range(w)])


def _window_sum(x: torch.Tensor, row_pad=(0, 0), col_pad=(0, 0)):
    """Sum of each window (the last two axes) of one tree level whose
    axes were padded by ``row_pad`` / ``col_pad`` (before, after).  A
    padding of exactly ``(0, 1)`` leaves the bounds check on the
    window's last column (row) alone, and LLVM peels it: the other
    columns are summed first, then the peeled column row by row; or, with
    no column peeled, the other rows, then the peeled row.  The first
    block vectorizes (:func:`_block_sum`) only where no other padding
    leaves a check in its loop."""
    h, w = x.shape[-2:]
    cols = w - 1 if tuple(col_pad) == (0, 1) else w
    rows = h - 1 if tuple(row_pad) == (0, 1) and cols == w else h
    checked = any(p not in ((0, 0), (0, 1)) for p in (row_pad, col_pad))
    parts = [_block_sum(x[..., :rows, :cols], vectorized=not checked)]
    if cols < w:
        parts += [x[..., r, cols] for r in range(rows)]
    if rows < h:
        parts += [x[..., rows, c] for c in range(w)]
    return _sum_in_order(parts)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last two axes of a float32 tensor in the order XLA's
    CPU backend sums ``jnp.sum``/``jnp.mean`` over them.  While an axis
    is longer than 32, its windows are 32 long (zero padding split
    evenly, the odd one at the end) and the other axis's whole length
    when that is at most 32; each window is summed by
    :func:`_window_sum`.  Then the remainder, at most 32 x 32, is summed
    the same way.  This is the reference's float32 sum bit for bit at
    every shape, as XLA compiles it for an x86-64 host with 256-bit
    vectors (:func:`_lanes`), so the z-scored micrograph and the
    standardized patches are too, on the CPU and on the card."""
    x = x.float()
    while max(x.shape[-2:]) > REDUCE_WINDOW:
        h, w = x.shape[-2:]
        wh = REDUCE_WINDOW if h > REDUCE_WINDOW else h
        ww = REDUCE_WINDOW if w > REDUCE_WINDOW else w
        ph, pw = -(-h // wh) * wh - h, -(-w // ww) * ww - w
        row_pad, col_pad = (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)
        x = F.pad(x, (*col_pad, *row_pad))
        lead = x.shape[:-2]
        blk = x.reshape(*lead, x.shape[-2] // wh, wh, x.shape[-1] // ww, ww)
        x = _window_sum(blk.transpose(-3, -2), row_pad, col_pad)
    return _window_sum(x)


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


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (float32 ``torch.sqrt`` on
    the CPU is not), through float64: one rounding of the exact root."""
    return torch.sqrt(x.double()).float()


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
    std = _sqrt(tree_sum(centered * centered)
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


def standardize_patches(patches: torch.Tensor, *,
                        ordered: bool = True) -> torch.Tensor:
    """Per-patch z-score with the sample std (ddof=1).

    ``ordered`` computes it as the reference does op by op (its training
    data): the sums are :func:`tree_sum`, the mean multiplies by the
    float32 reciprocal of ``n``, the variance and the z-score are IEEE
    divisions -- the reference's bits.  Its chains cost about a thousand
    small operations per call, so scoring (where the reference's chain
    runs compiled, with the variance times ``1/(n-1)``) takes the plain
    sums instead, within float32 rounding."""
    n = patches.shape[-2] * patches.shape[-1]
    if ordered:
        mean = (tree_sum(patches) * _recip(patches, n))[..., None, None]
        centered = patches - mean
        var = tree_sum(centered * centered)[..., None, None]
    else:
        mean = patches.sum(dim=(-2, -1), keepdim=True) / _const(patches, n)
        centered = patches - mean
        var = torch.square(centered).sum(dim=(-2, -1), keepdim=True)
    std = _sqrt(var / _const(patches, max(n - 1, 1)))
    return centered / torch.where(std > 0, std, 1.0)


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


def _contract_in_order(x: torch.Tensor, weights: np.ndarray) -> torch.Tensor:
    """``x @ weights`` over the last axis of ``x``, summed as XLA's CPU
    dot does: for each output, one fused multiply-add per input index
    in ascending order (a float64 multiply-add rounded to float32 at
    every step stands in for the fused one).  Only the nonzero weights
    are visited: a zero weight leaves the sum as it is."""
    n_out = weights.shape[1]
    nz = weights != 0
    taps = max(int(nz.sum(axis=0).max()), 1)
    idx = np.zeros((taps, n_out), np.int64)
    wt = np.zeros((taps, n_out), np.float64)
    for j in range(n_out):
        ks = np.nonzero(nz[:, j])[0]
        idx[: len(ks), j] = ks
        wt[: len(ks), j] = weights[ks, j]
    idx_t = torch.from_numpy(idx).to(x.device)
    wt_t = torch.from_numpy(wt).to(x.device)
    xd = x.to(torch.float64)
    acc = torch.zeros(x.shape[:-1] + (n_out,), dtype=torch.float32,
                      device=x.device)
    for t in range(taps):
        acc = (acc.to(torch.float64) + xd[..., idx_t[t]] * wt_t[t]).to(
            torch.float32)
    return acc


def resize_images(x: torch.Tensor, out_h: int, out_w: int, *,
                  ordered: bool = False) -> torch.Tensor:
    """Antialiased bilinear resize of the last two axes of ``x`` (any
    leading batch shape): ``jax.image.resize(..., "linear",
    antialias=True)``, rows first, then columns, as JAX does.
    Upsampling is ``F.interpolate``, JAX's floats on integer-valued
    inputs (the uint8 chain); with ``ordered`` (float inputs: the
    ``patch_norm="global"`` loaders) it sums in XLA's CPU order instead
    (:func:`_contract_in_order`), bit for bit on any input.
    Downsampling contracts with two ``einsum``s, which give XLA's bits
    on the CPU."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    if ordered and (out_h >= h or out_w >= w):
        y = _contract_in_order(x.float().transpose(-1, -2),
                               resize_weights(h, out_h))
        return _contract_in_order(y.transpose(-1, -2),
                                  resize_weights(w, out_w))
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


def resize_patches(patches: torch.Tensor, out_size: int, *,
                   ordered: bool = False) -> torch.Tensor:
    """Antialiased bilinear resize of ``(B, h, w)`` to ``(B, s, s)``
    (``ordered`` as in :func:`resize_images`)."""
    return resize_images(patches, out_size, out_size, ordered=ordered)


def prepare_patches(patches: torch.Tensor, out_size: int, *,
                    ordered: bool = True) -> torch.Tensor:
    """bytescale -> resize -> round half-to-even and clamp to [0, 255]
    (a uint8 resize) -> standardize (``ordered`` as in
    :func:`standardize_patches`): the full per-patch chain."""
    resized = resize_patches(bytescale(patches), out_size)
    return standardize_patches(
        torch.clamp(torch.round(resized), 0.0, 255.0), ordered=ordered
    )
