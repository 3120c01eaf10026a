"""Directory consensus: BOX files -> cliques -> packing -> BOX files.

The pipeline of ``repic_tpu.pipeline.consensus`` on one device:

1. load every picker's BOX files and pad them into ``(M, K, N)``
   chunks (:mod:`repic_tpu_torch.parallel.batching`);
2. probe the adjacency once per batch shape and escalate the
   neighbour, clique, cell and partial-tuple capacities straight to
   what a run observed (:func:`run_consensus_batch`);
3. run :func:`consensus_one` over the whole chunk at once;
4. fetch one packed array per chunk and render the BOX files
   (:func:`emit_box_chunk`).

Above :data:`SPATIAL_THRESHOLD` particles per picker (or with
``spatial=True``) the neighbour search is the bucketed one of
:mod:`~repic_tpu_torch.ops.spatial`, probed for its cell capacity
first; the clique assembly is staged, anchor-chunked or the full
product as :func:`~repic_tpu_torch.ops.cliques.enumerate_cliques`
chooses.  ``solver="lp_device_fused"`` takes kernels 2 and 3 when the
configuration is inside the fused envelope and demotes statically to
the staged ``lp_device`` program otherwise; ``use_pallas`` takes
kernel 1 for the dense neighbour search.  ``solver="lp"`` rounds an
LP relaxation on the device; ``solver="exact"`` runs the greedy
program, fetches the whole result and re-solves each micrograph on
the host ladder (:mod:`repic_tpu_torch.runtime.ladder`).

``multi_out`` / ``get_cc`` write the tables of the two-phase
``get_cliques`` + ``run_ilp`` pair (:func:`write_consensus_tables`)
from one fetch of the whole result per chunk; ``stripes`` splits each
micrograph into x-stripes (:mod:`repic_tpu_torch.pipeline.giant`).
The journal, resume, cluster, gang and telemetry layers of the
reference are not ported yet.
"""

from __future__ import annotations

import os
import shutil
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch

from repic_tpu_torch.ops.cliques import (
    DEFAULT_THRESHOLD,
    compact_cliques,
    enumerate_cliques,
    enumerate_cliques_bucketed,
)
from repic_tpu_torch.ops.iou import pairwise_iou_matrix
from repic_tpu_torch.ops.solver import (
    pack_cliques_for_solver,
    solve_greedy,
    solve_lp_rounding,
)
from repic_tpu_torch.ops.spatial import (
    bucket_particles,
    bucketed_pair_neighbors,
    grid_size,
)
from repic_tpu_torch.parallel.batching import (
    PaddedBatch,
    bucket_size,
    pad_batch,
    to_device,
)
from repic_tpu_torch.solver.dual import solve_lp_device
from repic_tpu_torch.utils import box_io

SOLVERS = ("greedy", "lp", "lp_device", "lp_device_fused", "exact")
#: the solvers that run inside the device program ("exact" runs the
#: greedy program and re-solves on the host)
DEVICE_SOLVERS = ("greedy", "lp", "lp_device", "lp_device_fused")

#: particles per picker above which the reference switches to its
#: spatial (bucketed) neighbour search
SPATIAL_THRESHOLD = 4096


class ConsensusResult(NamedTuple):
    """Batched consensus output (clique capacity C), leading axis M."""

    rep_xy: torch.Tensor       # (M, C, 2) representative coordinates
    confidence: torch.Tensor   # (M, C) median member confidence
    w: torch.Tensor            # (M, C) objective weight
    member_idx: torch.Tensor   # (M, C, K) per-picker particle indices
    rep_slot: torch.Tensor     # (M, C) picker slot of representative
    picked: torch.Tensor       # (M, C) bool — selected by the solver
    valid: torch.Tensor        # (M, C) bool — real clique
    num_cliques: torch.Tensor  # (M,) valid cliques before compaction
    max_adjacency: torch.Tensor  # (M,) neighbour-overflow probe
    max_cell_count: torch.Tensor  # (M,) cell-overflow probe (0: dense)
    max_partial: torch.Tensor  # (M,) staged-join probe (0: products)


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; asking for a GPU
    where there is none raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is "
            "False (pass device='cpu' / --device cpu to run on the CPU)"
        )
    return dev


def consensus_one(
    xy, conf, mask, box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    clique_capacity: int = 4096,
    spatial_grid: int | None = None,
    cell_capacity: int = 64,
    solver: str = "lp_device",
    use_pallas: bool = False,
    partial_capacity: int | None = None,
) -> ConsensusResult:
    """Full consensus for a batch of M micrographs.

    Args:
        xy/conf/mask: ``(M, K, N, 2)`` / ``(M, K, N)`` tensors.
        box_size: scalar or ``(K,)`` box edges.
        spatial_grid: grid edge G of the bucketed neighbour search
            (``cell_capacity`` slots per cell); None runs the dense one.
        solver: ``"lp_device"`` (dual decomposition), ``"lp"`` (LP
            rounding), ``"greedy"``, or ``"lp_device_fused"`` (kernels
            2 and 3 inside the fused envelope, the staged
            ``lp_device`` program outside it).
        use_pallas: dense neighbour search through kernel 1.
        partial_capacity: rows of the staged join's buffers (default
            ``clique_capacity``).
    """
    if solver not in DEVICE_SOLVERS:
        raise ValueError(
            f"unknown device solver {solver!r}; choose one of "
            f"{DEVICE_SOLVERS}"
        )
    _, k, n, _ = xy.shape
    use_megakernel = False
    if solver == "lp_device_fused":
        from repic_tpu_torch.ops import megakernel

        use_megakernel = megakernel.fused_eligible(
            k, n, max_neighbors, spatial_grid=spatial_grid
        )
    # bound the anchor block's candidate tuples (anchors x D^(K-1)) to
    # about 2M, with at least 8 anchors a block
    dprod = max_neighbors ** (k - 1)
    anchor_chunk = int(min(4096, max(8, (1 << 21) // max(dprod, 1))))
    if use_megakernel:
        cs = megakernel.fused_cliqueset(
            xy, conf, mask, box_size,
            threshold=threshold,
            max_neighbors=max_neighbors,
            clique_capacity=clique_capacity,
        )
    elif spatial_grid is not None:
        cs = enumerate_cliques_bucketed(
            xy, conf, mask, box_size,
            threshold=threshold,
            max_neighbors=max_neighbors,
            grid=spatial_grid,
            cell_capacity=cell_capacity,
            clique_capacity=clique_capacity,
            anchor_chunk=anchor_chunk,
            partial_capacity=partial_capacity,
        )
    else:
        cs = enumerate_cliques(
            xy, conf, mask, box_size,
            threshold=threshold,
            max_neighbors=max_neighbors,
            use_pallas=use_pallas,
            clique_capacity=clique_capacity,
            anchor_chunk=anchor_chunk,
            partial_capacity=partial_capacity,
        )
    num_cliques = cs.num_valid
    cs = compact_cliques(cs, clique_capacity)
    vid, num_vertices = pack_cliques_for_solver(cs.member_idx, cs.valid, n)
    if use_megakernel:
        picked = megakernel.fused_dual_solve(
            vid, cs.w, cs.valid, num_vertices
        )
    elif solver in ("lp_device", "lp_device_fused"):
        picked = solve_lp_device(vid, cs.w, cs.valid, num_vertices)
    elif solver == "lp":
        picked = solve_lp_rounding(vid, cs.w, cs.valid, num_vertices)
    else:
        picked = solve_greedy(vid, cs.w, cs.valid, num_vertices)
    return ConsensusResult(
        rep_xy=cs.rep_xy,
        confidence=cs.confidence,
        w=cs.w,
        member_idx=cs.member_idx,
        rep_slot=cs.rep_slot,
        picked=picked & cs.valid,
        valid=cs.valid,
        num_cliques=num_cliques,
        max_adjacency=cs.max_adjacency,
        max_cell_count=cs.max_cell_count,
        max_partial=cs.max_partial,
    )


def _sizes(xy, box_size) -> torch.Tensor:
    k = xy.shape[1]
    return torch.as_tensor(
        box_size, dtype=xy.dtype, device=xy.device
    ).reshape(-1).expand(k)


def dense_probe(xy, mask, box_size, threshold: float) -> torch.Tensor:
    """Per-micrograph max above-threshold neighbour count over the
    anchor pairs — the first-visit adjacency probe."""
    k = xy.shape[1]
    sizes = _sizes(xy, box_size)
    thr = torch.tensor(threshold, dtype=xy.dtype, device=xy.device)
    adjs = []
    for p in range(1, k):
        iou = pairwise_iou_matrix(
            xy[:, 0], mask[:, 0], xy[:, p], mask[:, p], sizes[0], sizes[p]
        )
        adjs.append((iou > thr).sum(-1).amax(-1))
    return torch.stack(adjs).amax(0)


def cell_probe(xy, mask, box_size, grid: int) -> torch.Tensor:
    """Per-micrograph population of the densest cell over the pickers:
    one hashing pass at capacity 1 (the count is taken before the
    capacity cuts), so the main program runs at the exact cell
    capacity."""
    cell = _sizes(xy, box_size).amax()
    return torch.stack([
        bucket_particles(xy[:, p], mask[:, p], cell, grid=grid,
                         cell_capacity=1).max_count
        for p in range(xy.shape[1])
    ]).amax(0)


def spatial_probe(
    xy, mask, box_size, grid: int, cell_capacity: int, threshold: float
) -> torch.Tensor:
    """Per-micrograph max above-threshold neighbour count through the
    bucketed search at d = 1 (no candidate product)."""
    _, _, max_adj, _ = bucketed_pair_neighbors(
        xy, mask, _sizes(xy, box_size), grid=grid,
        cell_capacity=cell_capacity, threshold=threshold, d=1,
    )
    return max_adj


# Last sufficient (max_neighbors, clique_capacity, cell_capacity,
# partial_capacity) per workload shape, and the last three observed
# requirements: a repeat shape skips the probes and runs at the lower
# median of the recent requirements (in memory only).
_LAST_GOOD_CONFIG: dict = {}
_RECENT_REQUIREMENTS: dict = {}


def _next_bucket(x: int) -> int:
    return bucket_size(int(x), minimum=2)


def escalate_capacities(probes, d, cap, cell_cap, pcap, *, has_grid):
    """Escalate each overflowed capacity straight to the observed
    requirement.  ``probes`` is ``(max_adjacency, num_cliques,
    max_cell_count, max_partial)``; returns ``(d, cap, cell_cap, pcap,
    retry)``.  The cell capacity counts only with a grid; the partial
    capacity escalates apart from the clique capacity."""
    max_adj, n_cliques, max_cell, max_part = (int(v) for v in probes)
    retry = False
    if has_grid and max_cell > cell_cap:
        cell_cap = _next_bucket(max_cell)
        retry = True
    if max_adj > d:
        d = _next_bucket(max_adj)
        retry = True
    if n_cliques > cap:
        cap = _next_bucket(n_cliques)
        retry = True
    if max_part > pcap:
        pcap = _next_bucket(max_part)
        retry = True
    return d, cap, cell_cap, pcap, retry


# Packed-transfer layout: head row (index 0), channels 0..3 hold the
# four probes as int32 bits in the float32 lanes, in the order of
# escalate_capacities; body rows (1..C) hold picked, rep_x, rep_y,
# confidence, rep_slot.
_HEAD_ADJ, _HEAD_NC, _HEAD_CELL, _HEAD_PART = 0, 1, 2, 3
_BODY_PICKED, _BODY_X, _BODY_Y, _BODY_CONF, _BODY_SLOT = range(5)


def _pack_box_outputs(res: ConsensusResult) -> torch.Tensor:
    """The BOX-writing outputs and the probes as one ``(M, C+1, 5)``
    float32 tensor, so a chunk costs one device-to-host fetch."""
    m = res.picked.shape[0]
    f32 = torch.float32
    core = torch.cat(
        [
            res.picked.to(f32)[..., None],
            res.rep_xy.to(f32),
            res.confidence.to(f32)[..., None],
            res.rep_slot.to(f32)[..., None],
        ],
        dim=-1,
    )
    probes = torch.stack(
        [res.max_adjacency, res.num_cliques, res.max_cell_count,
         res.max_partial], dim=-1
    ).to(torch.int32).view(f32)
    head = torch.cat(
        [probes, torch.zeros((m, 1), dtype=f32, device=probes.device)], -1
    )[:, None, :]
    return torch.cat([head, core], dim=1)


def _packed_probes(packed: np.ndarray) -> np.ndarray:
    """(M, 4) int32 per-micrograph probes from the packed head row."""
    return np.ascontiguousarray(packed[:, 0, :4]).view(np.int32)


def _unpack_box_outputs(packed: np.ndarray):
    """(picked, rep_xy, confidence, rep_slot, num_cliques) host views."""
    body = packed[:, 1:, :]
    return (
        body[:, :, _BODY_PICKED] > 0.5,
        body[:, :, _BODY_X : _BODY_Y + 1],
        body[:, :, _BODY_CONF],
        body[:, :, _BODY_SLOT].astype(np.int32),
        _packed_probes(packed)[:, _HEAD_NC].astype(np.int64),
    )


def _pack_full_result(res: ConsensusResult) -> torch.Tensor:
    """The whole result and the probes as one ``(M, C+1, K+7)``
    float32 tensor, so a chunk on the tables path costs one fetch.
    Body channels: the K member ids (int32 bits), rep_x, rep_y, w,
    confidence, rep_slot (int32 bits), picked, valid.  Head row,
    channels 0..3: the probes as in :func:`_pack_box_outputs`."""
    m, _, k = res.member_idx.shape
    f32 = torch.float32

    def bits(x):
        return x.to(torch.int32).view(f32)

    body = torch.cat(
        [
            bits(res.member_idx),
            res.rep_xy.to(f32),
            res.w.to(f32)[..., None],
            res.confidence.to(f32)[..., None],
            bits(res.rep_slot)[..., None],
            res.picked.to(f32)[..., None],
            res.valid.to(f32)[..., None],
        ],
        dim=-1,
    )
    probes = bits(torch.stack(
        [res.max_adjacency, res.num_cliques, res.max_cell_count,
         res.max_partial], dim=-1
    ))
    head = torch.cat(
        [probes, torch.zeros((m, k + 3), dtype=f32, device=body.device)],
        -1,
    )[:, None, :]
    return torch.cat([head, body], dim=1)


def _unpack_full_result(packed: np.ndarray, k: int) -> ConsensusResult:
    """A host :class:`ConsensusResult` of numpy arrays from one fetched
    :func:`_pack_full_result` array."""
    head = _packed_probes(packed)
    body = packed[:, 1:, :]
    return ConsensusResult(
        rep_xy=body[:, :, k : k + 2],
        confidence=body[:, :, k + 3],
        w=body[:, :, k + 2],
        member_idx=np.ascontiguousarray(body[:, :, :k]).view(np.int32),
        rep_slot=np.ascontiguousarray(body[:, :, k + 4]).view(np.int32),
        picked=body[:, :, k + 5] > 0.5,
        valid=body[:, :, k + 6] > 0.5,
        num_cliques=head[:, _HEAD_NC],
        max_adjacency=head[:, _HEAD_ADJ],
        max_cell_count=head[:, _HEAD_CELL],
        max_partial=head[:, _HEAD_PART],
    )


def run_consensus_batch(
    batch: PaddedBatch,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    clique_capacity: int | None = None,
    spatial: bool | None = None,
    solver: str = "lp_device",
    use_pallas: bool = False,
    device=None,
    full: bool = False,
) -> tuple[ConsensusResult, np.ndarray]:
    """Run consensus on one host batch with automatic escalation.

    ``spatial`` selects the bucketed neighbour search; None picks it
    above :data:`SPATIAL_THRESHOLD` particles per picker, and
    ``use_pallas`` is then ignored with a warning.  Returns ``(result,
    packed)``: the device result of the accepted attempt and its
    fetched packed array — probes + everything the BOX writer needs,
    or with ``full`` the whole result (:func:`_pack_full_result`).
    A capacity that overflows re-runs the batch at the observed
    requirement.
    """
    dev = resolve_device(device)
    cap = clique_capacity or max(4 * batch.capacity, 1024)
    pcap = cap
    d = max_neighbors
    if spatial is None:
        spatial = batch.capacity > SPATIAL_THRESHOLD
    if spatial and use_pallas:
        warnings.warn(
            "the neighbour-search kernel applies to the dense all-pairs "
            "path only; this batch selected the spatial (bucketed) path "
            f"— auto-enabled above {SPATIAL_THRESHOLD} particles — so "
            "--pallas is ignored",
            stacklevel=2,
        )
        use_pallas = False
    sizes = np.asarray(box_size, np.float32)
    max_size = float(sizes.max())
    box_arg = (
        torch.from_numpy(sizes).to(dev) if sizes.ndim else float(box_size)
    )
    grid = None
    cell_cap = 64
    cfg_key = (
        batch.xy.shape, tuple(sizes.reshape(-1).tolist()), threshold,
        bool(spatial),
    )
    dbatch = to_device(batch, dev)
    known = _LAST_GOOD_CONFIG.get(cfg_key)
    if spatial:
        # the padded host batch, zero padding included, sets the grid
        grid = grid_size(float(np.max(batch.xy)) + max_size, max_size)
        if known is None:
            cell = cell_probe(dbatch.xy, dbatch.mask, box_arg, grid)
            cell_cap = _next_bucket(max(int(cell.max()), 2))
            adj = spatial_probe(dbatch.xy, dbatch.mask, box_arg, grid,
                                cell_cap, threshold)
            d = _next_bucket(max(int(adj.max()), 2))
    elif known is None:
        adj = dense_probe(dbatch.xy, dbatch.mask, box_arg, threshold)
        d = _next_bucket(max(int(adj.max()), 2))
    if known is not None:
        d, cap, cell_cap, pcap = known
    while True:
        res = consensus_one(
            dbatch.xy, dbatch.conf, dbatch.mask, box_arg,
            threshold=threshold,
            max_neighbors=d,
            clique_capacity=cap,
            spatial_grid=grid,
            cell_capacity=cell_cap,
            solver=solver,
            use_pallas=use_pallas,
            partial_capacity=pcap,
        )
        pack = _pack_full_result if full else _pack_box_outputs
        packed = pack(res).cpu().numpy()
        probes = _packed_probes(packed).max(axis=0)
        d, cap, cell_cap, pcap, retry = escalate_capacities(
            probes, d, cap, cell_cap, pcap, has_grid=grid is not None
        )
        if retry:
            continue
        if solver == "lp_device_fused":
            from repic_tpu_torch.ops import megakernel

            k, n = batch.xy.shape[1], batch.xy.shape[2]
            if not megakernel.fused_eligible(k, n, d, spatial_grid=grid):
                megakernel.note_demotion()
        # this batch's exact requirement; a probe that means nothing on
        # this path (no grid, no staged join) keeps the running value
        max_adj, n_cliques, max_cell, max_part = (int(v) for v in probes)
        req = (
            _next_bucket(max(max_adj, 2)),
            max(_next_bucket(max(n_cliques, 2)), 1024),
            _next_bucket(max(max_cell, 2)) if grid is not None else cell_cap,
            _next_bucket(max_part) if max_part > 0 else pcap,
        )
        recent = _RECENT_REQUIREMENTS.setdefault(cfg_key, [])
        recent.append(req)
        del recent[:-3]
        if known is None:
            _LAST_GOOD_CONFIG[cfg_key] = (d, cap, cell_cap, pcap)
            return res, packed
        by_cost = sorted(
            recent, key=lambda r: (r[0] * r[1] * r[2] * r[3], r)
        )
        _LAST_GOOD_CONFIG[cfg_key] = by_cost[(len(recent) - 1) // 2]
        return res, packed


def emit_box_chunk(
    batch: PaddedBatch,
    packed: np.ndarray,
    box_size,
    *,
    num_particles: int | None = None,
    sink,
) -> dict[str, int]:
    """Render one chunk's BOX files from its fetched packed array;
    ``sink(filename, content)`` receives each.  Returns the written
    row count per micrograph."""
    picked, rep_xy, confidence, rep_slot, _ = _unpack_box_outputs(packed)
    sizes = np.asarray(box_size)
    counts: dict[str, int] = {}
    for i, name in enumerate(batch.names):
        if not name:
            continue
        sel = np.where(picked[i])[0]
        row_sizes = sizes[rep_slot[i, sel]] if sizes.ndim else box_size
        content, n = box_io.render_box(
            rep_xy[i, sel],
            confidence[i, sel],
            row_sizes,
            num_particles=num_particles,
        )
        sink(name + ".box", content)
        counts[name] = n
    return counts


#: device bytes one chunk may hold in its IoU stages
CHUNK_BYTES = 4e9


def _auto_chunk(n_loaded: int, k: int, nb: int) -> int:
    """Micrograph-chunk size: :data:`CHUNK_BYTES` against ~3 live
    K x K x N x N float32 IoU stages per micrograph, rounded down to a
    power of two and clamped to the workload."""
    per_micrograph = 3.0 * k * k * nb * nb * 4
    chunk = max(int(CHUNK_BYTES // max(per_micrograph, 1.0)), 1)
    c = 1
    while c * 2 <= chunk:
        c *= 2
    return min(c, max(n_loaded, 1))


def iter_consensus_chunks(
    loaded,
    box_size,
    *,
    info: dict | None = None,
    **kwargs,
):
    """Run :func:`run_consensus_batch` over memory-bounded chunks of
    ``loaded`` (``(name, sets)`` pairs, all with the same pickers).

    Yields ``(part, batch, packed, seconds)`` per chunk: the chunk's
    pairs, its padded host batch (rows in ``part`` order), the fetched
    packed array and the seconds the device program and its fetch
    took.  ``kwargs`` go to :func:`run_consensus_batch`; ``info``
    receives the chunk size and the particle capacity."""
    k = len(loaded[0][1])
    nb = bucket_size(max(bs.n for _, sets in loaded for bs in sets))
    chunk = _auto_chunk(len(loaded), k, nb)
    if info is not None:
        info.update(chunk=chunk, capacity=nb)
    for i in range(0, len(loaded), chunk):
        part = loaded[i : i + chunk]
        single = chunk >= len(loaded)
        cbatch = pad_batch(
            part, pad_micrographs_to=1 if single else chunk, capacity=nb
        )
        t = time.time()
        _res, packed = run_consensus_batch(cbatch, box_size, **kwargs)
        yield part, cbatch, packed, time.time() - t


def _write_box_file(out_path, rep_xy, conf, rep_slot, box_size,
                    num_particles) -> int:
    """One micrograph's BOX file from selected rows (each row with its
    representative's box size when sizes are per picker); returns the
    written row count."""
    sizes = np.asarray(box_size)
    row_sizes = sizes[rep_slot] if sizes.ndim else box_size
    box_io.write_box(out_path, rep_xy, conf, row_sizes,
                     num_particles=num_particles)
    n = len(rep_xy)
    return n if num_particles is None else min(n, num_particles)


def _cc_keep_mask(member_idx, labels, node_mask):
    """Cliques inside the largest connected component: a clique's
    members share a component, so its anchor member's label decides."""
    from repic_tpu_torch.ops.components import largest_component_label

    keep_label = largest_component_label(labels, node_mask)
    return np.asarray(labels)[0, member_idx[:, 0]] == keep_label


def write_consensus_tables(
    part,
    res: ConsensusResult,
    cc,
    out_dir: str,
    box_size,
    pickers,
    *,
    multi_out: bool = False,
    get_cc: bool = False,
    num_particles: int | None = None,
) -> dict[str, int]:
    """The ``--multi_out`` / ``--get_cc`` outputs of one fetched chunk,
    equal to what ``get_cliques`` + ``run_ilp`` write for the same
    flags.

    * ``multi_out``: ``{name}.tsv`` — a header of picker names, one
      row per chosen clique with each picker's member coordinates,
      then every particle not in a chosen clique as a confidence-0
      singleton row (per picker, sorted by x, y, index).
    * ``get_cc``: only the cliques inside the largest connected
      component.  Applied to the picks: the packing decomposes over
      components, so solve-then-filter equals filter-then-solve.
    * neither: the BOX file of the picks (the ``exact`` solver's
      output).

    ``res`` is a host result (:func:`_unpack_full_result`), ``cc``
    the host ``(labels, node_mask)`` when ``get_cc``, and ``part`` the
    chunk's ``(name, sets)`` list in batch-row order.
    """
    counts: dict[str, int] = {}
    labels_b, node_mask_b = cc if cc is not None else (None, None)
    for i, (name, sets) in enumerate(part):
        k = len(sets)
        valid = res.valid[i]
        member_idx = res.member_idx[i][valid]
        conf = res.confidence[i][valid]
        picked = res.picked[i][valid]
        rep_xy = res.rep_xy[i][valid]
        rep_slot = res.rep_slot[i][valid]
        if get_cc:
            keep = _cc_keep_mask(member_idx, labels_b[i], node_mask_b[i])
            member_idx, conf, picked = (
                member_idx[keep], conf[keep], picked[keep]
            )
            rep_xy, rep_slot = rep_xy[keep], rep_slot[keep]
        chosen = np.where(picked)[0]
        if not multi_out:
            counts[name] = _write_box_file(
                os.path.join(out_dir, name + ".box"),
                rep_xy[chosen], conf[chosen], rep_slot[chosen],
                box_size, num_particles,
            )
            continue
        # chosen cliques in buffer order, then per picker the
        # particles of the (filtered) universe outside them, sorted by
        # (x, y, index): run_ilp sorts (x, y, id) tuples and the id
        # grows with the index inside a picker
        node_int = np.rint(
            np.stack(
                [sets[p].xy[member_idx[chosen, p]] for p in range(k)],
                axis=1,
            )
        ).astype(np.int64) if len(chosen) else np.zeros(
            (0, k, 2), np.int64
        )
        rows = [
            "\t".join(map(str, node_int[c].ravel()))
            + "\t" + str(float(conf[i_c]))
            for c, i_c in enumerate(chosen)
        ]
        for p in range(k):
            universe = (
                np.unique(member_idx[:, p]) if get_cc
                else np.arange(sets[p].n)
            )
            covered = (
                np.unique(member_idx[chosen, p]) if len(chosen)
                else np.empty(0, np.int64)
            )
            extras = np.setdiff1d(universe, covered)
            xy_e = sets[p].xy[extras]
            order = np.lexsort((extras, xy_e[:, 1], xy_e[:, 0]))
            for x, y in np.rint(xy_e[order]).astype(np.int64):
                cells = ["N/A\tN/A"] * k
                cells[p] = f"{x}\t{y}"
                rows.append("\t".join(cells) + "\t0.0")
        with box_io.atomic_write(os.path.join(out_dir, name + ".tsv")) as o:
            o.write("\t".join(pickers) + "\n")
            o.write("\n".join(rows))
        counts[name] = len(chosen)
    return counts


def _host_solve_chunk(part, res, capacity, *, budget_s, rungs, device):
    """Re-solve each micrograph of a fetched chunk on the host ladder
    (exact, under ``budget_s`` degrading to lp and greedy); ``rungs``
    receives the rung that solved each.  Returns ``res`` with the
    ladder's picks."""
    from repic_tpu_torch.runtime.ladder import solve_host_ladder

    picked_all = np.array(res.picked, dtype=bool)
    k = res.member_idx.shape[-1]
    offsets = np.arange(k, dtype=np.int64) * int(capacity)
    for i, (name, _sets) in enumerate(part):
        valid = res.valid[i]
        member = res.member_idx[i][valid].astype(np.int64)
        vid = member + offsets[None, :] if member.size else member
        picked_v, used = solve_host_ladder(
            vid, res.w[i][valid], k * int(capacity),
            solver="exact", budget_s=budget_s, device=device,
        )
        row = np.zeros(picked_all.shape[1], bool)
        row[np.where(valid)[0]] = picked_v
        picked_all[i] = row
        rungs[name] = used
    return res._replace(picked=picked_all)


def cc_labels_host(batch: PaddedBatch, box_size, threshold: float,
                   device):
    """The chunk's component labels and node mask on ``device``,
    fetched in one copy (labels -1 where a particle is no node); also
    the propagation rounds run."""
    from repic_tpu_torch.ops.components import connected_component_labels

    dbatch = to_device(batch, device)
    labels, node_mask, rounds = connected_component_labels(
        dbatch.xy, dbatch.mask, box_size, threshold=threshold
    )
    lab = torch.where(node_mask, labels, torch.full_like(labels, -1))
    lab = lab.cpu().numpy()
    return (lab, lab >= 0), rounds


def _check_flags(solver, solver_budget_s, stripes, multi_out, get_cc,
                 use_pallas) -> None:
    """Reject a bad flag combination before anything is deleted."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; choose one of "
                         f"{SOLVERS}")
    if solver_budget_s is not None and solver != "exact":
        raise ValueError(
            "solver_budget_s applies to solver='exact' only (the "
            "device greedy/lp packers take no budget)"
        )
    if stripes is None or stripes == "auto":
        return
    if multi_out or get_cc:
        raise ValueError(
            "--stripes composes with the plain BOX output only "
            "(use the batched path for --multi_out/--get_cc)"
        )
    if solver == "exact":
        raise ValueError(
            "--solver exact composes with the batched path only "
            "(not --stripes)"
        )
    if stripes < 1:
        raise ValueError(f"--stripes must be >= 1, got {stripes}")
    if use_pallas:
        warnings.warn(
            "--pallas applies to the batched dense path only; the "
            "striped (--stripes) path uses the bucketed/dense search "
            "without the kernel",
            stacklevel=3,
        )


def _run_striped(loaded, out_dir, box_size, stripes, stats, *, threshold,
                 max_neighbors, num_particles, spatial, solver, dev):
    """The striped branch: each micrograph alone through
    :func:`~repic_tpu_torch.pipeline.giant.run_consensus_giant`."""
    from repic_tpu_torch.pipeline.giant import run_consensus_giant

    compute_s = write_s = 0.0
    giant_stats = {}
    for name, sets in loaded:
        t1 = time.time()
        g = run_consensus_giant(
            sets, box_size, n_stripes=stripes, threshold=threshold,
            max_neighbors=max_neighbors, spatial=spatial, solver=solver,
            device=dev,
        )
        t2 = time.time()
        sel = g["picked"]
        stats["particle_counts"][name] = _write_box_file(
            os.path.join(out_dir, name + ".box"),
            g["rep_xy"][sel], g["confidence"][sel], g["rep_slot"][sel],
            box_size, num_particles,
        )
        write_s += time.time() - t2
        compute_s += t2 - t1
        stats["clique_counts"][name] = g["num_cliques"]
        stats["num_cliques"] += g["num_cliques"]
        giant_stats[name] = {
            "seconds": t2 - t1,
            "stripe_capacity": g["stripe_capacity"],
            "config": list(g["config"]),
        }
    stats.update(stripes=stripes, giant=giant_stats, compute_s=compute_s,
                 write_s=write_s)
    return stats


def run_consensus_dir(
    in_dir: str,
    out_dir: str,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    num_particles: int | None = None,
    spatial: bool | None = None,
    solver: str = "lp_device",
    use_pallas: bool = False,
    multi_out: bool = False,
    get_cc: bool = False,
    stripes: int | str | None = None,
    solver_budget_s: float | None = None,
    device=None,
) -> dict:
    """Read ``in_dir/<picker>/*.box``, run consensus, write one output
    per micrograph into ``out_dir`` (deleted first if it exists).
    Micrographs missing from a picker, or empty in one, get an empty
    BOX file.  ``spatial`` as in :func:`run_consensus_batch`, per
    chunk.

    ``multi_out`` / ``get_cc`` write the two-phase pair's tables
    (:func:`write_consensus_tables`).  ``solver="exact"`` re-solves
    each micrograph on the host ladder, under ``solver_budget_s``
    degrading to lp and greedy (``stats["solver_rungs"]`` names the
    rung of each).  ``stripes`` (an int, or ``"auto"``, which on one
    device means no striping) splits each micrograph into x-stripes.
    Flags are checked before ``out_dir`` is touched.  Returns run
    statistics."""
    _check_flags(solver, solver_budget_s, stripes, multi_out, get_cc,
                 use_pallas)
    dev = resolve_device(device)
    t0 = time.time()
    pickers = box_io.discover_picker_dirs(in_dir)
    if not pickers:
        raise ValueError(f"no picker subdirectories in {in_dir}")
    names = box_io.micrograph_names(os.path.join(in_dir, pickers[0]))
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    loaded, skipped = [], []
    for name in names:
        sets = box_io.load_micrograph_set(in_dir, pickers, name)
        if sets is None:
            skipped.append(name)
            box_io.write_empty_box(os.path.join(out_dir, name + ".box"))
        else:
            loaded.append((name, sets))
    stats = {
        "pickers": pickers,
        "micrographs": len(names),
        "skipped": skipped,
        "device": str(dev),
        "solver": solver,
        "multi_out": multi_out,
        "get_cc": get_cc,
        "load_s": time.time() - t0,
        "num_cliques": 0,
        "particle_counts": {},
        "clique_counts": {},
        "chunks": 0,
    }
    if not loaded:
        stats["total_s"] = time.time() - t0
        return stats
    if stripes == "auto":
        # the reference stripes only when there are fewer micrographs
        # than devices: never with one device
        stripes = None
    if stripes is not None:
        _run_striped(
            loaded, out_dir, box_size, stripes, stats,
            threshold=threshold, max_neighbors=max_neighbors,
            num_particles=num_particles, spatial=spatial, solver=solver,
            dev=dev,
        )
        stats["total_s"] = time.time() - t0
        return stats

    def _sink(fname, content):
        with box_io.atomic_write(os.path.join(out_dir, fname)) as o:
            o.write(content)

    host_solver = solver == "exact"
    # the exact solver shares the tables' data path: the device runs
    # the greedy program and the host re-solves the fetched result
    tables = multi_out or get_cc or host_solver
    device_solver = "greedy" if host_solver else solver
    cc_sizes = np.asarray(box_size, np.float32)
    cc_arg = (torch.from_numpy(cc_sizes).to(dev) if cc_sizes.ndim
              else float(box_size))
    k = len(loaded[0][1])
    compute_s = write_s = 0.0
    rungs: dict = {}
    cc_rounds = []
    chunks_info: dict = {}
    chunks = iter_consensus_chunks(
        loaded, box_size, info=chunks_info,
        threshold=threshold,
        max_neighbors=max_neighbors,
        spatial=spatial,
        solver=device_solver,
        use_pallas=use_pallas,
        device=dev,
        full=tables,
    )
    for part, cbatch, packed, chunk_s in chunks:
        t1 = time.time()
        nc = _packed_probes(packed)[:, _HEAD_NC]
        if tables:
            res = _unpack_full_result(packed, k)
            cc = None
            if get_cc:
                cc, rounds = cc_labels_host(cbatch, cc_arg, threshold, dev)
                cc_rounds.append(rounds)
            if host_solver:
                res = _host_solve_chunk(
                    part, res, cbatch.capacity, budget_s=solver_budget_s,
                    rungs=rungs, device=dev,
                )
            t2 = time.time()
            counts = write_consensus_tables(
                part, res, cc, out_dir, box_size, pickers,
                multi_out=multi_out, get_cc=get_cc,
                num_particles=num_particles,
            )
        else:
            t2 = time.time()
            counts = emit_box_chunk(
                cbatch, packed, box_size,
                num_particles=num_particles, sink=_sink,
            )
        write_s += time.time() - t2
        compute_s += chunk_s + (t2 - t1)
        stats["particle_counts"].update(counts)
        stats["clique_counts"].update(
            (name, int(c)) for name, c in zip(cbatch.names, nc) if name
        )
        stats["num_cliques"] += int(nc[: len(part)].sum())
        stats["chunks"] += 1
    if host_solver:
        stats["solver_rungs"] = rungs
    if get_cc:
        stats["cc_rounds"] = cc_rounds
    stats.update(
        chunk=chunks_info["chunk"],
        capacity=chunks_info["capacity"],
        compute_s=compute_s,
        write_s=write_s,
        total_s=time.time() - t0,
    )
    return stats
