"""Tensorized k-partite clique enumeration, batched over micrographs.

The overlap graph is k-partite (edges join different pickers only),
so a k-clique holds exactly one particle per picker, and enumeration
is a fixed-shape tensor join anchored on picker 0:

1. for each other picker p, the top-``D`` IoU neighbours of every
   anchor (complete while no anchor has more than ``D`` overlaps
   above the threshold; ``max_adjacency`` reports overflow);
2. the cartesian product of the K-1 neighbour lists per anchor —
   ``(N, D^(K-1))`` candidate tuples in meshgrid-"ij" order;
3. every cross-picker edge checked from coordinates.

Per clique: confidence = median of the K member confidences, weight
= confidence * median of the C(K,2) edge IoUs, representative = the
member of largest weighted degree (first maximum).

Every function here takes a leading micrograph axis M.  Only the full
product assembly is ported; configurations that need the anchor-
chunked or staged assembly raise ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from repic_tpu_torch.ops.iou import pair_iou_xy, pairwise_iou_matrix

DEFAULT_THRESHOLD = 0.3

# Candidate-product size above which the reference runs its staged
# join.
_STAGED_DPROD = 256

_NOT_PORTED = (
    "not ported yet (ROADMAP Queue 1 item 6: the anchor-chunked and "
    "staged clique assembly)"
)


class CliqueSet(NamedTuple):
    """Padded candidate k-cliques of M micrographs (capacity C)."""

    member_idx: torch.Tensor    # (M, C, K) int32 per-picker particle
    valid: torch.Tensor         # (M, C) bool
    w: torch.Tensor             # (M, C) float32 objective weight
    confidence: torch.Tensor    # (M, C) float32 median confidence
    rep_slot: torch.Tensor      # (M, C) int32 representative's picker
    rep_xy: torch.Tensor        # (M, C, 2) float32
    max_adjacency: torch.Tensor  # (M,) int32 neighbour-overflow probe
    num_valid: torch.Tensor     # (M,) int32 valid before compaction

    @property
    def capacity(self) -> int:
        return self.member_idx.shape[1]


def _edge_pairs(k: int):
    return list(itertools.combinations(range(k), 2))


def _per_picker_sizes(box_size, k: int, dtype, device) -> torch.Tensor:
    """A scalar or per-picker box size as a ``(K,)`` tensor."""
    s = torch.as_tensor(box_size, dtype=dtype, device=device).reshape(-1)
    return s.expand(k).contiguous()


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[m, idx[m, ...]]`` for ``src (M, N)`` and any ``idx``
    shape with leading M."""
    m = src.shape[0]
    return torch.gather(src, 1, idx.reshape(m, -1)).reshape(idx.shape)


def median0(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0, even counts averaging the two middle values
    as ``(lo + hi) * 0.5`` — ``jnp.median``'s midpoint rule, not
    ``torch.median``'s lower value."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return (lo + hi) * 0.5


def topd_dense(iou: torch.Tensor, d: int):
    """Top-``d`` of the last axis in (value desc, index asc) order —
    ``lax.top_k``'s tie rule; ``torch.topk`` leaves ties unordered."""
    vals, order = torch.sort(iou, dim=-1, descending=True, stable=True)
    return vals[..., :d], order[..., :d].to(torch.int32)


def dense_neighbors(xy, mask, sizes, threshold: float, d: int):
    """Picker-0 anchors against each other picker via the masked IoU
    matrix (masked entries 0.0).  Returns lists of ``(M, N, d)``
    values and indices, and the ``(M,)`` max above-threshold count."""
    k = xy.shape[1]
    thr = _f32(threshold, xy)
    vals, idxs, adj = [], [], []
    for p in range(1, k):
        iou = pairwise_iou_matrix(
            xy[:, 0], mask[:, 0], xy[:, p], mask[:, p],
            sizes[0], sizes[p],
        )
        adj.append((iou > thr).sum(-1, dtype=torch.int32).amax(-1))
        v, i = topd_dense(iou, d)
        vals.append(v)
        idxs.append(i)
    return vals, idxs, torch.stack(adj).amax(0)


def enumerate_cliques(
    xy, conf, mask, box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    use_pallas: bool = False,
    clique_capacity: int | None = None,
    anchor_chunk: int | None = None,
) -> CliqueSet:
    """Enumerate all k-cliques of each micrograph's overlap graph.

    Args:
        xy/conf/mask: ``(M, K, N, 2)`` / ``(M, K, N)`` padded rows.
        box_size: scalar or ``(K,)`` box edges.
        use_pallas: neighbour search through kernel 1
            (:func:`~repic_tpu_torch.ops.iou_pallas.topk_neighbors`)
            instead of the IoU matrix and a sort.
        clique_capacity / anchor_chunk: as in the reference; a
            configuration that selects the staged or the anchor-chunked
            assembly raises ``NotImplementedError``.
    """
    _, k, n, _ = xy.shape
    if k < 2:
        raise ValueError(
            f"clique enumeration needs at least 2 pickers, got K={k}"
        )
    d = min(max_neighbors, n)
    sizes = _per_picker_sizes(box_size, k, xy.dtype, xy.device)
    if clique_capacity is not None and d ** (k - 1) > _STAGED_DPROD:
        raise NotImplementedError(
            f"D^(K-1) = {d ** (k - 1)} > {_STAGED_DPROD} selects the "
            f"staged join, {_NOT_PORTED}"
        )
    if (
        clique_capacity is not None
        and anchor_chunk is not None
        and n > anchor_chunk
    ):
        raise NotImplementedError(
            f"N = {n} > anchor_chunk = {anchor_chunk} selects the "
            f"anchor-chunked assembly, {_NOT_PORTED}"
        )
    if use_pallas:
        from repic_tpu_torch.ops.iou_pallas import topk_neighbors

        m = xy.shape[0]
        b = m * (k - 1)
        v, i, adj = topk_neighbors(
            xy[:, :1].expand(m, k - 1, n, 2).reshape(b, n, 2),
            mask[:, :1].expand(m, k - 1, n).reshape(b, n),
            xy[:, 1:].reshape(b, n, 2),
            mask[:, 1:].reshape(b, n),
            sizes[0].expand(b),
            sizes[1:].repeat(m),
            d=d, threshold=threshold,
        )
        v = v.reshape(m, k - 1, n, d)
        i = i.reshape(m, k - 1, n, d)
        nbr_iou = [v[:, s] for s in range(k - 1)]
        nbr_idx = [i[:, s] for s in range(k - 1)]
        max_adj = adj.reshape(m, (k - 1) * n).amax(-1)
    else:
        nbr_iou, nbr_idx, max_adj = dense_neighbors(
            xy, mask, sizes, threshold, d
        )
    return _assemble_cliques(
        xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adj
    )


def _assemble_block(
    xy, conf, mask, sizes, threshold, anchor_ids, anchor_mask,
    nbr_idx, nbr_iou,
):
    """Cartesian product of per-anchor neighbour lists, cross-edge
    validation from coordinates, and per-clique statistics.

    Args:
        anchor_ids: ``(A,)`` picker-0 particle indices of the block.
        anchor_mask: ``(M, A)`` anchor validity.
        nbr_idx/nbr_iou: K-1 tensors ``(M, A, D)``; indices may hold
            the sentinel ``N`` (no candidate), masked invalid.

    Returns a dict of ``(M, A * D^(K-1), ...)`` tensors.
    """
    m, k, n, _ = xy.shape
    a = anchor_ids.shape[0]
    d = nbr_idx[0].shape[-1]
    dev = xy.device
    dprod = d ** (k - 1)
    grids = torch.meshgrid(
        *([torch.arange(d, device=dev)] * (k - 1)), indexing="ij"
    )
    sel = [g.reshape(-1) for g in grids]
    anchor = anchor_ids.to(torch.int32)[None, :, None].expand(m, a, dprod)
    member_ok = anchor_mask[:, :, None].expand(m, a, dprod)
    members = [anchor]
    for s in range(k - 1):
        mem = nbr_idx[s][:, :, sel[s]]
        in_range = mem < n
        safe = torch.where(in_range, mem, torch.zeros_like(mem))
        member_ok = member_ok & in_range & _gather_rows(
            mask[:, s + 1], safe.long()
        )
        members.append(safe)

    xs, ys = xy[..., 0], xy[..., 1]              # (M, K, N)
    mx = [_gather_rows(xs[:, p], members[p].long()) for p in range(k)]
    my = [_gather_rows(ys[:, p], members[p].long()) for p in range(k)]
    zero = _f32(0.0, xy)
    edge_vals = []
    for p, q in _edge_pairs(k):
        if p == 0:
            edge_vals.append(nbr_iou[q - 1][:, :, sel[q - 1]])
        else:
            e = pair_iou_xy(
                mx[p], my[p], mx[q], my[q], sizes[p], sizes[q]
            )
            edge_vals.append(torch.where(member_ok, e, zero))
    edges = torch.stack(edge_vals)               # (E, M, A, Dprod)
    valid = member_ok & (edges > _f32(threshold, xy)).all(0)

    confs = torch.stack(
        [_gather_rows(conf[:, p], members[p].long()) for p in range(k)]
    )                                            # (K, M, A, Dprod)
    confidence = median0(confs)
    edge_med = median0(edges)
    w = torch.where(valid, confidence * edge_med, zero)
    confidence = torch.where(valid, confidence, zero)

    degs = []
    for k_slot in range(k):
        incident = [
            edges[e]
            for e, (p, q) in enumerate(_edge_pairs(k))
            if p == k_slot or q == k_slot
        ]
        degs.append(sum(incident))
    # torch.argmax returns the first maximum
    rep_slot = torch.argmax(torch.stack(degs), dim=0).to(torch.int32)
    member_idx = torch.stack(members, dim=-1)    # (M, A, Dprod, K)
    rep_particle = torch.gather(
        member_idx, -1, rep_slot[..., None].long()
    )[..., 0]
    flat = (rep_slot.long() * n + rep_particle.long())
    rep_x = _gather_rows(xs.reshape(m, k * n), flat)
    rep_y = _gather_rows(ys.reshape(m, k * n), flat)
    c = a * dprod
    return dict(
        member_idx=member_idx.reshape(m, c, k).to(torch.int32),
        valid=valid.reshape(m, c),
        w=w.reshape(m, c),
        confidence=confidence.reshape(m, c),
        rep_slot=rep_slot.reshape(m, c),
        rep_xy=torch.stack([rep_x, rep_y], -1).reshape(m, c, 2),
    )


def _assemble_cliques(
    xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adjacency,
) -> CliqueSet:
    """Full-anchor clique assembly (all anchors in one block)."""
    n = xy.shape[2]
    block = _assemble_block(
        xy, conf, mask, sizes, threshold,
        torch.arange(n, dtype=torch.int32, device=xy.device),
        mask[:, 0], nbr_idx, nbr_iou,
    )
    return CliqueSet(
        max_adjacency=max_adjacency.to(torch.int32),
        num_valid=block["valid"].sum(-1, dtype=torch.int32),
        **block,
    )


def _stream_compact(block: dict, keep: int) -> dict:
    """Pack each micrograph's valid rows into its first ``keep`` slots
    in index order (rows past ``keep`` are dropped); other slots are
    zero."""
    valid = block["valid"]
    m, c = valid.shape
    pos = torch.cumsum(valid.to(torch.int64), -1) - 1
    ok = valid & (pos < keep)
    tgt = torch.where(ok, pos, torch.full_like(pos, keep))
    flat = (tgt + torch.arange(m, device=valid.device)[:, None]
            * (keep + 1)).reshape(-1)
    out = {}
    for name, v in block.items():
        tail = v.shape[2:]
        src = (ok if name == "valid" else v).reshape((m * c,) + tail)
        buf = torch.zeros(
            (m * (keep + 1),) + tail, dtype=src.dtype, device=src.device
        )
        buf.index_copy_(0, flat[ok.reshape(-1)], src[ok.reshape(-1)])
        out[name] = buf.reshape((m, keep + 1) + tail)[:, :keep]
    return out


def compact_cliques(cs: CliqueSet, capacity: int) -> CliqueSet:
    """Keep each micrograph's ``capacity`` highest-weight cliques,
    ties in buffer order (a stable sort: ``lax.top_k``'s rule)."""
    key = torch.where(cs.valid, cs.w, _f32(-1.0, cs.w))
    keep = min(capacity, cs.w.shape[1])
    order = torch.sort(key, dim=-1, descending=True, stable=True)[1]
    order = order[:, :keep]

    def take(x):
        idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))

    return cs._replace(
        member_idx=take(cs.member_idx),
        valid=take(cs.valid),
        w=take(cs.w),
        confidence=take(cs.confidence),
        rep_slot=take(cs.rep_slot),
        rep_xy=take(cs.rep_xy),
    )
