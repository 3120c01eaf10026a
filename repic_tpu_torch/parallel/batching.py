"""Ragged -> padded batch packing for the micrograph axis.

One fixed-shape batch per chunk:

    xy   (M, K, N, 2)   conf (M, K, N)   mask (M, K, N)

with N bucketed on the {2^k, 1.5 * 2^k} grid.  Padded micrographs
(mask all-False) flow through the whole pipeline and produce zero
cliques; padded particle slots are masked out of every IoU.
:func:`to_device` is where host state crosses onto the device.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repic_tpu_torch.utils.box_io import BoxSet


def bucket_size(n: int, minimum: int = 64) -> int:
    """Smallest value >= n from {2^k, 1.5 * 2^k} (>= minimum)."""
    b = minimum
    while b < n:
        h = b + b // 2
        if n <= h:
            return h
        b *= 2
    return b


class PaddedBatch(NamedTuple):
    xy: np.ndarray        # (M, K, N, 2) float32
    conf: np.ndarray      # (M, K, N) float32
    mask: np.ndarray      # (M, K, N) bool
    names: tuple          # (M,) micrograph basenames ('' = padding)
    counts: np.ndarray    # (M, K) int32 true particle counts

    @property
    def num_micrographs(self) -> int:
        return sum(1 for n in self.names if n)

    @property
    def num_pickers(self) -> int:
        return self.xy.shape[1]

    @property
    def capacity(self) -> int:
        return self.xy.shape[2]


class DeviceBatch(NamedTuple):
    """A :class:`PaddedBatch`'s arrays as tensors on one device."""

    xy: torch.Tensor      # (M, K, N, 2) float32
    conf: torch.Tensor    # (M, K, N) float32
    mask: torch.Tensor    # (M, K, N) bool


def pad_batch(
    micrographs: Sequence[tuple[str, Sequence[BoxSet]]],
    *,
    pad_micrographs_to: int = 1,
    capacity: int | None = None,
    num_pickers: int | None = None,
) -> PaddedBatch:
    """Pack per-micrograph, per-picker ragged BoxSets into one batch.

    Args:
        micrographs: list of (name, [BoxSet per picker]); may be empty
            when ``num_pickers`` and ``capacity`` are given.
        pad_micrographs_to: round M up to a multiple of this, adding
            all-masked padding micrographs.
        capacity: static N; default = bucket_size(max particle count).
        num_pickers: static K, required for an empty list.
    """
    if not micrographs:
        if num_pickers is None or capacity is None:
            raise ValueError(
                "pad_batch([]) needs explicit num_pickers and capacity"
            )
        k = num_pickers
    else:
        k = len(micrographs[0][1])
    max_n = max(
        (bs.n for _, sets in micrographs for bs in sets), default=1
    )
    n = capacity or bucket_size(max_n)
    if n < max_n:
        raise ValueError(f"capacity {n} < max particle count {max_n}")
    m_real = len(micrographs)
    m = max(
        -(-m_real // pad_micrographs_to) * pad_micrographs_to,
        pad_micrographs_to,
    )

    xy = np.zeros((m, k, n, 2), np.float32)
    conf = np.zeros((m, k, n), np.float32)
    mask = np.zeros((m, k, n), bool)
    counts = np.zeros((m, k), np.int32)
    names = []
    for i, (name, sets) in enumerate(micrographs):
        names.append(name)
        for p, bs in enumerate(sets):
            xy[i, p, : bs.n] = bs.xy
            conf[i, p, : bs.n] = bs.conf
            mask[i, p, : bs.n] = True
            counts[i, p] = bs.n
    names.extend([""] * (m - m_real))
    return PaddedBatch(xy, conf, mask, tuple(names), counts)


def to_device(batch: PaddedBatch, device) -> DeviceBatch:
    """Copy a host batch onto ``device`` (one transfer per array)."""
    device = torch.device(device)
    return DeviceBatch(
        xy=torch.from_numpy(batch.xy).to(device),
        conf=torch.from_numpy(batch.conf).to(device),
        mask=torch.from_numpy(batch.mask).to(device),
    )
