"""Plain reference of the CNN picker (DeepPicker's deep architecture)
for one micrograph, in PyTorch and NumPy.

It imports nothing of the program.  From the raw micrograph and the
weights (the reference's parameter tree: HWIO conv kernels, ``(in,
out)`` dense kernels) it works out again the score map and the picks:

* preprocessing: 3 x 3 mean binning (the sigma-0.1 blur is the
  identity), then a z-score with the population deviation;
* ``patch`` mode: every ``patch`` x ``patch`` window at stride ``step``
  min-max scaled to whole levels 0-255 (round half up), resized to 64 x
  64 by linear interpolation (half-pixel centres, edge weights
  renormalised), rounded half to even, z-scored with the sample
  deviation, and classified;
* ``fcn`` mode: the binned micrograph resized by ``64 / patch``, and
  every 64 x 64 window at the resized stride ``s`` classified as it
  stands, over the grid that the ``(16 / s)^2`` copies shifted by ``s``
  cover at the classifier's stride of 16;
* the classifier: conv 9x9x8, 5x5x16, 3x3x32, 2x2x64 (valid, each with
  relu and a 2 x 2 max pool), then dense 128 with relu and dense 2; the
  score is the softmax's second class;
* peaks: the map's local maxima over a ``0.6 * patch / step`` window,
  plateaus merged at their centre of mass, then raster-order greedy
  suppression within half the window keeping the higher score; picks
  in pixels are ``(index * step + patch / 2) * bin``.

Everything runs in float64 on the device given, in blocks of window
rows, so it stands apart from the program's float32 algorithms.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BIN = 3
PATCH = 64
CONV = ((9, 8), (5, 16), (3, 32), (2, 64))


def preprocess(img: np.ndarray, device) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(img, np.float32), device=device).double()
    h, w = (x.shape[0] // BIN) * BIN, (x.shape[1] // BIN) * BIN
    x = x[:h, :w].reshape(h // BIN, BIN, w // BIN, BIN).mean((1, 3))
    return (x - x.mean()) / x.std(unbiased=False)


def linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``(n_in, n_out)`` weights of linear interpolation from ``n_in``
    to ``n_out`` samples (upsampling: a unit triangle kernel)."""
    if n_out < n_in:
        raise ValueError("the reference resizes up only")
    u = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(u[None, :] - np.arange(n_in)[:, None]))
    w = w / w.sum(0, keepdims=True)
    return torch.as_tensor(w, device=device)


def classifier_params(tree: dict, device) -> list:
    """The tree's tensors in float64, conv kernels as OIHW."""
    out = []
    for i in range(len(CONV)):
        layer = tree[f"backbone"][f"conv{i + 1}"]
        out.append((torch.as_tensor(layer["kernel"], device=device)
                    .double().permute(3, 2, 0, 1).contiguous(),
                    torch.as_tensor(layer["bias"], device=device).double()))
    for name in ("fc1", "fc2"):
        out.append((torch.as_tensor(tree[name]["kernel"], device=device)
                    .double(),
                    torch.as_tensor(tree[name]["bias"], device=device)
                    .double()))
    return out


def classify(x: torch.Tensor, params: list) -> torch.Tensor:
    """Second-class softmax of ``(B, 64, 64)`` patches."""
    x = x[:, None]
    for w, b in params[:len(CONV)]:
        x = F.max_pool2d(F.relu(F.conv2d(x, w, b)), 2, 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (row, col, chan)
    (w1, b1), (w2, b2) = params[len(CONV):]
    x = F.relu(x @ w1 + b1)
    return torch.softmax(x @ w2 + b2, dim=-1)[:, 1]


def score_map(img: np.ndarray, tree: dict, particle_size: int, *,
              mode: str = "patch", step: int = 4, device="cpu",
              rows_per_block: int = 8) -> np.ndarray:
    """The score map of one raw micrograph (float64 numpy)."""
    patch = int(particle_size / BIN)
    params = classifier_params(tree, device)
    x = preprocess(img, device)
    if mode == "fcn":
        scale = PATCH / patch
        sh, sw = int(round(x.shape[0] * scale)), int(round(x.shape[1] * scale))
        x = (linear_weights(x.shape[0], sh, device).T @ x
             @ linear_weights(x.shape[1], sw, device))
        step = max(1, int(round(step * scale)))
        size, prep = PATCH, None
    else:
        size = patch
        wr = linear_weights(patch, PATCH, device)

        def prep(p):
            lo = p.amin((-2, -1), keepdim=True)
            hi = p.amax((-2, -1), keepdim=True)
            span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
            b = torch.floor(torch.clamp((p - lo) * 255.0 / span, 0, 255)
                            + 0.5)
            r = torch.clamp(torch.round(wr.T @ b @ wr), 0, 255)
            mean = r.mean((-2, -1), keepdim=True)
            sd = r.std((-2, -1), keepdim=True, unbiased=True)
            return (r - mean) / torch.where(sd > 0, sd, torch.ones_like(sd))
    out_h = (x.shape[0] - size) // step + 1
    out_w = (x.shape[1] - size) // step + 1
    if mode == "fcn":
        # the grid that (16 / step)^2 copies shifted by step each cover
        # at stride 16
        n = 16 // step
        out_h = min(out_h, n * ((x.shape[0] - (n - 1) * step - size) // 16
                                + 1))
        out_w = min(out_w, n * ((x.shape[1] - (n - 1) * step - size) // 16
                                + 1))
    win = x.unfold(0, size, step).unfold(1, size, step)[:out_h, :out_w]
    out = torch.empty((out_h, out_w), dtype=torch.float64, device=device)
    for r0 in range(0, out_h, rows_per_block):
        p = win[r0:r0 + rows_per_block].reshape(-1, size, size)
        if prep is not None:
            p = prep(p)
        out[r0:r0 + rows_per_block] = classify(p, params).reshape(-1, out_w)
    return out.cpu().numpy()


def suppress(yx: np.ndarray, scores: np.ndarray, thr: float) -> np.ndarray:
    """Raster-order greedy suppression: a candidate meets the alive ones
    after it within ``thr``; if one is stronger, the weaker-or-equal
    ones before the first stronger die and so does the candidate, else
    all of them die.  Returns the keep mask."""
    dead = np.zeros(len(yx), bool)
    for i in range(len(yx)):
        if dead[i]:
            continue
        rest = np.arange(i + 1, len(yx))
        rest = rest[~dead[rest]]
        d = np.hypot(yx[i, 0] - yx[rest, 0], yx[i, 1] - yx[rest, 1])
        close = rest[d < thr]
        stronger = scores[close] > scores[i]
        if stronger.any():
            dead[close[:int(np.argmax(stronger))]] = True
            dead[i] = True
        else:
            dead[close] = True
    return ~dead


def peaks(smap: np.ndarray, particle_size: int, *, mode: str = "patch",
          step: int = 4) -> np.ndarray:
    """``(P, 3)`` picks (x, y, score) in micrograph pixels."""
    from scipy import ndimage

    patch = int(particle_size / BIN)
    window = max(int(0.6 * patch / step), 1)
    hi = ndimage.maximum_filter(smap, size=window, mode="constant",
                                cval=-np.inf)
    lo = ndimage.minimum_filter(smap, size=window, mode="constant",
                                cval=np.inf)
    labeled, num = ndimage.label((smap == hi) & (hi - lo > 0))
    if num == 0:
        return np.zeros((0, 3))
    yx = np.array(ndimage.center_of_mass(smap, labeled, range(1, num + 1)))
    yx = yx.astype(int)
    scores = smap[yx[:, 0], yx[:, 1]]
    keep = suppress(yx, scores, window / 2.0)
    eff = step
    if mode == "fcn":
        scale = PATCH / patch
        eff = max(1, int(round(step * scale))) / scale
    xy = (yx[keep][:, ::-1] * eff + patch / 2) * BIN
    return np.column_stack([xy, scores[keep]])
