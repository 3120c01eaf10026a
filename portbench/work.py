"""Counted work and the card's published peaks: the yardstick of the
utilisation metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
full 700 W power limit).  The picker's float32 convolutions run without
TF32, outside the tensor cores, so its peak is the float32 rate.

FLOPs count a multiply-add as two and are worked out from the shapes
alone (the architecture and the window grid), whatever code runs; bytes
count each input byte read once and each output byte written once.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12, "fp8": 1979e12, "int8": 1979e12}
PEAK_BYTES_PER_S = 3.35e12

#: DeepPicker's deep stack: (kernel, features) per conv block, then the
#: dense widths
CONV = ((9, 8), (5, 16), (3, 32), (2, 64))
FC = (128, 2)
PATCH = 64
BIN = 3


def conv_stack_flops(h: int, w: int, head_as_conv: bool = False) -> int:
    """FLOPs of the classifier over one ``h x w`` input: valid convs
    each followed by a 2 x 2 pool, then the dense head (as a 2 x 2 conv
    and a 1 x 1 conv over the feature map when ``head_as_conv``)."""
    flops, cin = 0, 1
    for k, f in CONV:
        h, w = h - k + 1, w - k + 1
        flops += 2 * h * w * f * k * k * cin
        h, w, cin = h // 2, w // 2, f
    if head_as_conv:
        h, w = h - 1, w - 1
        flops += 2 * h * w * FC[0] * 4 * cin
        flops += 2 * h * w * FC[1] * FC[0]
    else:
        flops += 2 * (h * w * cin) * FC[0] + 2 * FC[0] * FC[1]
    return flops


def binned(size: int) -> int:
    return size // BIN


def patch_windows(size: int, particle_size: int, step: int = 4) -> int:
    """Windows of the patch-mode grid on a ``size`` x ``size``
    micrograph."""
    n = (binned(size) - int(particle_size / BIN)) // step + 1
    return n * n


def pick_flops(size: int, particle_size: int, mode: str,
               step: int = 4) -> int:
    """The picker's convolution FLOPs on one ``size`` x ``size``
    micrograph: per window in ``patch`` mode; in ``fcn`` mode over the
    resized micrograph's ``(16 / s)^2`` shifted copies at stride ``s``."""
    patch = int(particle_size / BIN)
    if mode == "patch":
        return patch_windows(size, particle_size, step) * conv_stack_flops(
            PATCH, PATCH)
    scale = PATCH / patch
    s = int(round(binned(size) * scale))
    sstep = max(1, int(round(step * scale)))
    n_shift = 16 // sstep
    sub = s - (n_shift - 1) * sstep
    return n_shift * n_shift * conv_stack_flops(sub, sub, head_as_conv=True)


def share_of_peak(flops: float, seconds: float,
                  dtype: str = "float32") -> float:
    """Percent of the card's peak that ``flops`` in ``seconds`` is."""
    return 100.0 * flops / seconds / PEAK_FLOPS[dtype]
