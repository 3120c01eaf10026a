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

Every function here takes a leading micrograph axis M.  Three
assemblies share those rules, chosen as the reference chooses them
(:func:`enumerate_cliques`): the full product; the anchor-chunked
product, compacted per chunk (N > ``anchor_chunk``); and the staged
join, one picker at a time with compaction between stages (D^(K-1) >
256).  :func:`enumerate_cliques_bucketed` takes its neighbour lists
from the spatial hash of :mod:`~repic_tpu_torch.ops.spatial` instead
of the dense IoU matrices.  The neighbour search and the assembly are
the ``consensus_neighbors`` and ``consensus_join`` ranges of a
profiler trace (:func:`~repic_tpu_torch.utils.tracing.annotate`), and
each boolean-mask select of a compaction is a counted host sync.
"""

from __future__ import annotations

import itertools
import numbers
import warnings
from typing import NamedTuple

import torch

from repic_tpu_torch.ops.iou import pair_iou_xy, pairwise_iou_matrix
from repic_tpu_torch.ops.iou_pallas import MAX_D, topk_neighbors
from repic_tpu_torch.telemetry import probes as tlm_probes
from repic_tpu_torch.utils.tracing import annotate

DEFAULT_THRESHOLD = 0.3

# Candidate-product size above which the staged join replaces the
# one-shot product (given a clique capacity to bound its stages).
_STAGED_DPROD = 256

class CliqueSet(NamedTuple):
    """Padded candidate k-cliques of M micrographs (capacity C)."""

    member_idx: torch.Tensor    # (M, C, K) int32 per-picker particle
    valid: torch.Tensor         # (M, C) bool
    w: torch.Tensor             # (M, C) float32 objective weight
    confidence: torch.Tensor    # (M, C) float32 median confidence
    rep_slot: torch.Tensor      # (M, C) int32 representative's picker
    rep_xy: torch.Tensor        # (M, C, 2) float32
    max_adjacency: torch.Tensor  # (M,) int32 neighbour-overflow probe
    max_cell_count: torch.Tensor  # (M,) int32 cell overflow (0: dense)
    # (M,) int32 valid before compaction (product paths); on the staged
    # path the survivors at this capacity, the true count whenever
    # max_partial fits
    num_valid: torch.Tensor
    # (M,) int32 staged-join partial-tuple probe (0 on the products)
    max_partial: torch.Tensor

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


def _zeros_m(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(like.shape[0], dtype=torch.int32, device=like.device)


def enumerate_cliques(
    xy, conf, mask, box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    use_pallas: bool = False,
    clique_capacity: int | None = None,
    anchor_chunk: int | None = None,
    partial_capacity: int | None = None,
) -> CliqueSet:
    """Enumerate all k-cliques of each micrograph's overlap graph.

    Args:
        xy/conf/mask: ``(M, K, N, 2)`` / ``(M, K, N)`` padded rows.
        box_size: scalar or ``(K,)`` box edges.
        use_pallas: neighbour search through kernel 1
            (:func:`~repic_tpu_torch.ops.iou_pallas.topk_neighbors`)
            instead of the IoU matrix and a sort.
        clique_capacity / anchor_chunk / partial_capacity: with a
            clique capacity, D^(K-1) > 256 runs the staged join (its
            stages hold ``partial_capacity``, default the clique
            capacity, rows), else N > ``anchor_chunk`` the anchor-
            chunked product compacted to ``clique_capacity`` rows;
            otherwise the full product runs.
    """
    m, k, n, _ = xy.shape
    if k < 2:
        raise ValueError(
            f"clique enumeration needs at least 2 pickers, got K={k}"
        )
    d = min(max_neighbors, n)
    sizes = _per_picker_sizes(box_size, k, xy.dtype, xy.device)
    if use_pallas and d > MAX_D:
        warnings.warn(
            f"escalated neighbor capacity D={d} exceeds the neighbour "
            f"kernel's cap ({MAX_D}); using the matrix path for "
            "this program",
            stacklevel=2,
        )
        use_pallas = False
    with annotate("consensus_neighbors", timed=True):
        if use_pallas:
            b = m * (k - 1)
            # a Python number travels as a kernel argument; per-picker
            # sizes as the per-item views of `sizes`, on xy's device
            if isinstance(box_size, numbers.Real):
                sa = sb = box_size
            else:
                sa, sb = sizes[0].expand(b), sizes[1:].repeat(m)
            v, i, adj = topk_neighbors(
                xy[:, :1].expand(m, k - 1, n, 2).reshape(b, n, 2),
                mask[:, :1].expand(m, k - 1, n).reshape(b, n),
                xy[:, 1:].reshape(b, n, 2),
                mask[:, 1:].reshape(b, n),
                sa, sb,
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
    with annotate("consensus_join", timed=True):
        return _assemble(
            xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adj,
            _zeros_m(xy), d, clique_capacity, anchor_chunk, partial_capacity,
        )


def enumerate_cliques_bucketed(
    xy, conf, mask, box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    grid: int = 32,
    cell_capacity: int = 64,
    clique_capacity: int | None = None,
    anchor_chunk: int = 4096,
    partial_capacity: int | None = None,
) -> CliqueSet:
    """:func:`enumerate_cliques` with neighbour candidates from a
    spatial hash (:mod:`~repic_tpu_torch.ops.spatial`): O(N * 9 *
    cell_capacity) memory instead of O(N^2).  Cells are the largest
    box wide (two boxes overlap only when their corners differ by less
    than the larger size on both axes); ``max_cell_count`` reports the
    densest cell, complete iff ``<= cell_capacity``."""
    from repic_tpu_torch.ops.spatial import bucketed_pair_neighbors

    m, k, n, _ = xy.shape
    if k < 2:
        raise ValueError(
            f"clique enumeration needs at least 2 pickers, got K={k}"
        )
    d = min(max_neighbors, n)
    sizes = _per_picker_sizes(box_size, k, xy.dtype, xy.device)
    with annotate("consensus_neighbors", timed=True):
        nbr_iou, nbr_idx, max_adj, max_cell = bucketed_pair_neighbors(
            xy, mask, sizes, grid=grid, cell_capacity=cell_capacity,
            threshold=threshold, d=d,
        )
    with annotate("consensus_join", timed=True):
        return _assemble(
            xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adj,
            max_cell, d, clique_capacity, anchor_chunk, partial_capacity,
        )


def _assemble(
    xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adjacency,
    max_cell_count, d, clique_capacity, anchor_chunk, partial_capacity,
) -> CliqueSet:
    """The reference's choice of assembly for ``d`` neighbours per
    picker pair: staged, anchor-chunked or the full product."""
    k, n = xy.shape[1], xy.shape[2]
    probes = (max_adjacency, max_cell_count)
    if clique_capacity is not None and d ** (k - 1) > _STAGED_DPROD:
        return _assemble_cliques_staged(
            xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, *probes,
            partial_capacity or clique_capacity,
        )
    if (
        clique_capacity is not None
        and anchor_chunk is not None
        and n > anchor_chunk
    ):
        return _assemble_cliques_chunked(
            xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, *probes,
            clique_capacity, anchor_chunk,
        )
    return _assemble_cliques(
        xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, *probes
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

    member_idx = torch.stack(members, dim=-1)    # (M, A, Dprod, K)
    w, confidence, rep_slot, rep_xy = _clique_stats(
        xy, conf, valid, edges, member_idx
    )
    c = a * dprod
    return dict(
        member_idx=member_idx.reshape(m, c, k).to(torch.int32),
        valid=valid.reshape(m, c),
        w=w.reshape(m, c),
        confidence=confidence.reshape(m, c),
        rep_slot=rep_slot.reshape(m, c),
        rep_xy=rep_xy.reshape(m, c, 2),
    )


def _clique_stats(xy, conf, valid, edges, member_idx):
    """Per clique (any shape ``(M, ...)``): weight = median member
    confidence x median edge IoU, the confidence, and the member of
    largest weighted degree (first maximum) with its coordinates;
    ``edges`` is ``(E, M, ...)`` in :func:`_edge_pairs` order."""
    m, k, n, _ = xy.shape
    zero = _f32(0.0, xy)
    confs = torch.stack([
        _gather_rows(conf[:, p], member_idx[..., p].long())
        for p in range(k)
    ])
    confidence = median0(confs)
    w = torch.where(valid, confidence * median0(edges), zero)
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
    rep_particle = torch.gather(
        member_idx, -1, rep_slot[..., None].long()
    )[..., 0]
    flat = rep_slot.long() * n + rep_particle.long()
    rep_xy = torch.stack([
        _gather_rows(xy[..., 0].reshape(m, k * n), flat),
        _gather_rows(xy[..., 1].reshape(m, k * n), flat),
    ], -1)
    return w, confidence, rep_slot, rep_xy


def _assemble_cliques(
    xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adjacency,
    max_cell_count,
) -> CliqueSet:
    """Full-anchor clique assembly (all anchors in one block)."""
    n = xy.shape[2]
    block = _assemble_block(
        xy, conf, mask, sizes, threshold,
        torch.arange(n, dtype=torch.int32, device=xy.device),
        mask[:, 0], nbr_idx, nbr_iou,
    )
    return CliqueSet(
        max_adjacency=max_adjacency,
        max_cell_count=max_cell_count,
        num_valid=block["valid"].sum(-1, dtype=torch.int32),
        max_partial=_zeros_m(xy),
        **block,
    )


def _assemble_cliques_chunked(
    xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adjacency,
    max_cell_count, clique_capacity, anchor_chunk,
) -> CliqueSet:
    """Anchor-chunked assembly: blocks of ``anchor_chunk`` anchors
    (the last padded with masked anchors and sentinel neighbours), each
    compacted by index to ``min(cap, a * D^(K-1))`` rows, then one
    weight compaction of the merged buffers to ``clique_capacity``.
    Chunking bounds memory only: while nothing overflows, the rows are
    the full product's."""
    m, k, n, _ = xy.shape
    dev = xy.device
    a = min(anchor_chunk, n)
    pad = (-n) % a
    aid = torch.cat([
        torch.arange(n, dtype=torch.int32, device=dev),
        torch.zeros(pad, dtype=torch.int32, device=dev),
    ])
    amask = torch.cat(
        [mask[:, 0], torch.zeros((m, pad), dtype=torch.bool, device=dev)], 1
    )
    d = nbr_idx[0].shape[-1]

    def grow(x, fill):
        return torch.cat([x, torch.full((m, pad, d), fill, dtype=x.dtype,
                                        device=dev)], 1)

    nbr_idx = [grow(x, n) for x in nbr_idx]
    nbr_iou = [grow(x, 0.0) for x in nbr_iou]
    keep = min(clique_capacity, a * d ** (k - 1))
    parts, num_valid = [], _zeros_m(xy)
    for s in range(0, n + pad, a):
        block = _assemble_block(
            xy, conf, mask, sizes, threshold,
            aid[s : s + a], amask[:, s : s + a],
            [x[:, s : s + a] for x in nbr_idx],
            [x[:, s : s + a] for x in nbr_iou],
        )
        num_valid = num_valid + block["valid"].sum(-1, dtype=torch.int32)
        parts.append(_stream_compact(block, keep))
    merged = CliqueSet(
        max_adjacency=max_adjacency,
        max_cell_count=max_cell_count,
        num_valid=num_valid,
        max_partial=_zeros_m(xy),
        **{f: torch.cat([p[f] for p in parts], 1) for f in parts[0]},
    )
    return compact_cliques(merged, clique_capacity)


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
    # each field's two boolean-mask selects read the mask's count
    tlm_probes.note_host_sync(2 * len(block))
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


def _assemble_cliques_staged(
    xy, conf, mask, sizes, threshold, nbr_idx, nbr_iou, max_adjacency,
    max_cell_count, capacity,
) -> CliqueSet:
    """Staged k-partite join with compaction between stages.

    Partial cliques grow one picker at a time: stage ``s`` joins each
    partial tuple with its anchor's picker-``s`` neighbours (rows in
    ``repeat`` order), checks the new member against every earlier one,
    and compacts the survivors by index.  A buffer keeps its natural
    width while that is within ``capacity`` and only the last is cut
    to ``capacity`` rows (the output width).  A valid clique survives
    every stage unless a compaction overflows; ``max_partial``, the
    most tuples any stage kept, is what the caller escalates the
    partial capacity to.  Statistics as in :func:`_assemble_block`,
    every edge from coordinates.
    """
    m, k, n, _ = xy.shape
    d = nbr_idx[0].shape[-1]
    dev = xy.device
    thr = _f32(threshold, xy)
    xs, ys = xy[..., 0], xy[..., 1]                # (M, K, N)

    def at(src, idx):
        return _gather_rows(src, idx.long())

    # stage 1: (anchor, n_1) pairs straight from the neighbour lists
    anchor = torch.arange(n, dtype=torch.int32, device=dev)
    anchor = anchor.repeat_interleave(d).expand(m, n * d)
    m1 = nbr_idx[0].reshape(m, n * d)
    in_range = m1 < n
    m1 = torch.where(in_range, m1, torch.zeros_like(m1)).to(torch.int32)
    valid = (
        at(mask[:, 0], anchor) & in_range & at(mask[:, 1], m1)
        & (nbr_iou[0].reshape(m, n * d) > thr)
    )
    members = torch.stack([anchor, m1], -1)        # (M, N*D, 2)
    max_partial = valid.sum(-1, dtype=torch.int32)
    if k == 2 or members.shape[1] > capacity:
        part = _stream_compact({"members": members, "valid": valid},
                               capacity)
        members, valid = part["members"], part["valid"]

    # stages 2..K-1
    for s in range(2, k):
        slots = members.shape[1]
        anchors = members[..., 0].long()
        cand = torch.gather(
            nbr_idx[s - 1], 1, anchors[..., None].expand(m, slots, d)
        ).reshape(m, slots * d)
        ciou = torch.gather(
            nbr_iou[s - 1], 1, anchors[..., None].expand(m, slots, d)
        ).reshape(m, slots * d)
        ext = members.repeat_interleave(d, dim=1)  # (M, slots*D, s)
        in_range = cand < n
        m_new = torch.where(in_range, cand, torch.zeros_like(cand))
        v = (
            valid.repeat_interleave(d, dim=1) & (ciou > thr) & in_range
            & at(mask[:, s], m_new)
        )
        for t in range(1, s):
            e = pair_iou_xy(
                at(xs[:, t], ext[..., t]), at(ys[:, t], ext[..., t]),
                at(xs[:, s], m_new), at(ys[:, s], m_new),
                sizes[t], sizes[s],
            )
            v = v & (e > thr)
        members = torch.cat([ext, m_new.to(torch.int32)[..., None]], -1)
        max_partial = torch.maximum(max_partial, v.sum(-1, dtype=torch.int32))
        if s == k - 1 or members.shape[1] > capacity:
            part = _stream_compact({"members": members, "valid": v},
                                   capacity)
            members, valid = part["members"], part["valid"]
        else:
            valid = v

    mx = [at(xs[:, p], members[..., p]) for p in range(k)]
    my = [at(ys[:, p], members[..., p]) for p in range(k)]
    zero = _f32(0.0, xy)
    edges = torch.stack([
        torch.where(valid, pair_iou_xy(mx[p], my[p], mx[q], my[q],
                                       sizes[p], sizes[q]), zero)
        for p, q in _edge_pairs(k)
    ])                                             # (E, M, cap)
    valid = valid & (edges > thr).all(0)
    w, confidence, rep_slot, rep_xy = _clique_stats(
        xy, conf, valid, edges, members
    )
    return CliqueSet(
        member_idx=members.to(torch.int32),
        valid=valid,
        w=w,
        confidence=confidence,
        rep_slot=rep_slot,
        rep_xy=rep_xy,
        max_adjacency=max_adjacency,
        max_cell_count=max_cell_count,
        num_valid=valid.sum(-1, dtype=torch.int32),
        max_partial=max_partial,
    )
