"""Spatial bucketing: neighbour candidates without O(N^2) memory.

The dense neighbour search builds an ``(N, N)`` IoU matrix per picker
pair, which a 50,000-particle micrograph cannot afford (10 GB each).
Here every particle is hashed into a square grid whose cells are one
box wide, so all of a particle's overlapping neighbours lie in its 3x3
cell neighbourhood:

1. :func:`bucket_particles` builds a ``(G*G, B)`` cell -> particle
   table with a stable sort and a rank scatter; ``max_count`` reports
   the densest cell, so a caller escalates ``B`` when it overflows;
2. :func:`bucketed_topk_neighbors` gathers each anchor's 9 cells —
   ``(A, 9B)`` candidates instead of ``(N, N)`` — and keeps the top
   ``d`` IoUs, streaming anchors in chunks of 4,096.

Every function takes a leading micrograph axis M.  The rules follow
``repic_tpu.ops.spatial``: cells are ``floor(xy / cell)`` in float32,
clipped to ``[0, G-1]``; ties among equal IoUs keep the lower
candidate position (cell order, then rank in the cell), as
``lax.top_k`` does — a stable descending sort, never ``torch.topk``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repic_tpu_torch.ops.cliques import _gather_rows
from repic_tpu_torch.ops.iou import pair_iou_xy
from repic_tpu_torch.telemetry import probes as tlm_probes

#: anchors per neighbour-search block
ANCHOR_CHUNK = 4096

#: largest grid edge; past it particles clip into the border cells
MAX_GRID = 1024

_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


class BucketTable(NamedTuple):
    """Spatial hash of M particle sets (one per micrograph).

    ``table[m, c, r]`` is the index of the r-th particle in cell ``c``
    of micrograph ``m``, or ``N`` (one past the last slot) when empty.
    The table is complete iff ``max_count <= B``.
    """

    table: torch.Tensor      # (M, G*G, B) int32
    cell_ij: torch.Tensor    # (M, N, 2) int32 cell of each particle
    max_count: torch.Tensor  # (M,) int32 densest cell's population
    grid: int                # G

    @property
    def capacity(self) -> int:
        return self.table.shape[2]


def grid_size(extent: float, box_size: float) -> int:
    """Grid edge G for a coordinate extent (host side); past
    ``MAX_GRID`` cells particles clip into the border cells, which
    stays correct but drives the cell capacity up."""
    g = max(int(extent / float(box_size)) + 1, 1)
    return min(g, MAX_GRID)


def bucket_particles(
    xy: torch.Tensor,
    mask: torch.Tensor,
    box_size,
    *,
    grid: int,
    cell_capacity: int,
) -> BucketTable:
    """Hash ``(M, N, 2)`` particles into a ``grid x grid`` table of
    ``cell_capacity`` slots per cell; masked particles go nowhere.
    ``max_count`` is counted before the capacity cuts, so one pass at
    capacity 1 measures the capacity a set needs."""
    m, n, _ = xy.shape
    g = grid
    dev = xy.device
    size = torch.as_tensor(box_size, dtype=xy.dtype, device=dev)
    ij = torch.clamp(torch.floor(xy / size).to(torch.int32), 0, g - 1)
    cell = ij[..., 0] * g + ij[..., 1]
    cell = torch.where(mask, cell, torch.full_like(cell, g * g))
    sorted_cell, order = torch.sort(cell, dim=-1, stable=True)
    ids = torch.arange(g * g + 1, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(sorted_cell, ids.expand(m, -1).contiguous())
    ends = torch.searchsorted(
        sorted_cell, ids[: g * g].expand(m, -1).contiguous(), right=True
    )
    max_count = (ends - starts[:, : g * g]).amax(-1).to(torch.int32)
    rank = torch.arange(n, device=dev) - torch.gather(
        starts, 1, sorted_cell.long()
    )

    b = cell_capacity
    ok = (rank < b) & (sorted_cell < g * g)
    # one flat table per micrograph, each with a trash slot at its end
    width = g * g * b + 1
    slot = torch.where(ok, sorted_cell.long() * b + rank, g * g * b)
    flat = slot + torch.arange(m, device=dev)[:, None] * width
    table = torch.full((m * width,), n, dtype=torch.int32, device=dev)
    table[flat[ok]] = order[ok].to(torch.int32)
    # the two boolean-mask selects read the mask's count to the host
    tlm_probes.note_host_sync(2)
    table = table.reshape(m, width)[:, :-1].reshape(m, g * g, b)
    return BucketTable(table=table, cell_ij=ij, max_count=max_count, grid=g)


def neighbor_candidates(anchor_ij: torch.Tensor, bt: BucketTable):
    """``(M, A, 9B)`` candidate indices from the 3x3 neighbourhood of
    each anchor cell ``(M, A, 2)``; empty slots and cells off the grid
    hold the sentinel ``N``."""
    g = bt.grid
    m, a, _ = anchor_ij.shape
    b = bt.capacity
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=anchor_ij.device)
    nb = anchor_ij[:, :, None, :] + offs                 # (M, A, 9, 2)
    inside = ((nb >= 0) & (nb < g)).all(-1)              # (M, A, 9)
    nb = torch.clamp(nb, 0, g - 1)
    cell = (nb[..., 0] * g + nb[..., 1]).long()          # (M, A, 9)
    cand = torch.gather(
        bt.table, 1, cell.reshape(m, a * 9, 1).expand(m, a * 9, b)
    ).reshape(m, a, 9, b)
    sentinel = torch.full_like(cand, bt.cell_ij.shape[1])
    cand = torch.where(inside[..., None], cand, sentinel)
    return cand.reshape(m, a, 9 * b)


def _neighbor_iou_block(
    xy_a, mask_a, ij_a, xy_b, mask_b, bt_b, size_a, size_b
):
    """IoU of a block of anchors against their 3x3-cell candidates:
    ``(iou, idx)`` of shape ``(M, A, 9B)``, masked pairs 0.0."""
    nb_idx = neighbor_candidates(ij_a, bt_b)
    nb_valid = nb_idx < xy_b.shape[1]
    safe = torch.where(nb_valid, nb_idx, torch.zeros_like(nb_idx)).long()
    cand_x = _gather_rows(xy_b[..., 0], safe)
    cand_y = _gather_rows(xy_b[..., 1], safe)
    iou = pair_iou_xy(
        xy_a[..., 0][..., None], xy_a[..., 1][..., None],
        cand_x, cand_y, size_a, size_b,
    )
    ok = nb_valid & mask_a[..., None] & _gather_rows(mask_b, safe)
    return torch.where(ok, iou, torch.zeros((), dtype=iou.dtype,
                                            device=iou.device)), nb_idx


def bucketed_neighbor_iou(
    xy_a, mask_a, bt_a: BucketTable, xy_b, mask_b, bt_b: BucketTable,
    box_size, box_size_b=None,
):
    """IoU of every anchor of set a against its 3x3-cell candidates in
    set b: ``(iou, idx)`` of shape ``(M, Na, 9B)`` (sentinel slots 0.0).
    Complete — every pair with IoU > 0 appears — while cells are at
    least the larger box wide."""
    return _neighbor_iou_block(
        xy_a, mask_a, bt_a.cell_ij, xy_b, mask_b, bt_b,
        box_size, box_size if box_size_b is None else box_size_b,
    )


def bucketed_topk_neighbors(
    xy_a, mask_a, bt_a: BucketTable, xy_b, mask_b, bt_b: BucketTable,
    size_a, size_b=None,
    *,
    threshold: float,
    d: int,
    chunk: int = ANCHOR_CHUNK,
):
    """Top-``d`` neighbours of every anchor, in anchor chunks so the
    ``(M, chunk, 9B)`` candidate block bounds memory.

    Returns ``(iou (M, N, d'), idx (M, N, d'), adjacency (M, N))`` with
    ``d' = min(d, 9B)``; ``adjacency`` counts each anchor's candidates
    above the threshold (the completeness probe)."""
    m, n, _ = xy_a.shape
    c = min(chunk, n)
    d = min(d, 9 * bt_b.capacity)
    sb = size_a if size_b is None else size_b
    thr = torch.tensor(threshold, dtype=xy_a.dtype, device=xy_a.device)
    vals, idxs, adjs = [], [], []
    # the last block is padded, as the reference pads the anchor axis:
    # slicing past N gives the shorter block, same rows
    for s in range(0, n, c):
        iou_c, idx_c = _neighbor_iou_block(
            xy_a[:, s : s + c], mask_a[:, s : s + c],
            bt_a.cell_ij[:, s : s + c], xy_b, mask_b, bt_b, size_a, sb,
        )
        adjs.append((iou_c > thr).sum(-1, dtype=torch.int32))
        v, order = torch.sort(iou_c, dim=-1, descending=True, stable=True)
        vals.append(v[..., :d])
        idxs.append(torch.gather(idx_c, -1, order[..., :d]))
    return torch.cat(vals, 1), torch.cat(idxs, 1), torch.cat(adjs, 1)


def bucketed_pair_neighbors(
    xy, mask, sizes, *, grid: int, cell_capacity: int, threshold: float,
    d: int,
):
    """Bucket every picker of ``(M, K, N, ...)`` rows into cells the
    largest box wide and search picker 0 against each other picker.

    Returns ``(nbr_iou, nbr_idx, max_adjacency, max_cell_count)``: K-1
    lists of ``(M, N, d')`` and the ``(M,)`` overflow probes."""
    k = xy.shape[1]
    cell = sizes.amax()
    bts = [
        bucket_particles(xy[:, p], mask[:, p], cell, grid=grid,
                         cell_capacity=cell_capacity)
        for p in range(k)
    ]
    nbr_iou, nbr_idx, adjs = [], [], []
    for p in range(1, k):
        v, i, adj = bucketed_topk_neighbors(
            xy[:, 0], mask[:, 0], bts[0], xy[:, p], mask[:, p], bts[p],
            sizes[0], sizes[p], threshold=threshold, d=d,
        )
        nbr_iou.append(v)
        nbr_idx.append(i)
        adjs.append(adj.amax(-1))
    max_cell = torch.stack([bt.max_count for bt in bts]).amax(0)
    return nbr_iou, nbr_idx, torch.stack(adjs).amax(0), max_cell
