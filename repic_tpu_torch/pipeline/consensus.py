"""Directory consensus: BOX files -> cliques -> packing -> BOX files.

The pipeline of ``repic_tpu.pipeline.consensus`` on one device:

1. load every picker's BOX files and pad them into ``(M, K, N)``
   chunks (:mod:`repic_tpu_torch.parallel.batching`);
2. probe the dense adjacency once per batch shape and escalate the
   neighbour and clique capacities straight to what a run observed
   (:func:`run_consensus_batch`);
3. run :func:`consensus_one` over the whole chunk at once;
4. fetch one packed array per chunk and render the BOX files
   (:func:`emit_box_chunk`).

``solver="lp_device_fused"`` takes kernels 2 and 3 when the
configuration is inside the fused envelope and demotes statically to
the staged ``lp_device`` program otherwise; ``use_pallas`` takes
kernel 1 for the staged neighbour search.  The journal, resume,
cluster, gang, striped and telemetry layers of the reference are not
ported yet.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import NamedTuple

import numpy as np
import torch

from repic_tpu_torch.ops.cliques import (
    DEFAULT_THRESHOLD,
    compact_cliques,
    enumerate_cliques,
)
from repic_tpu_torch.ops.iou import pairwise_iou_matrix
from repic_tpu_torch.ops.solver import pack_cliques_for_solver, solve_greedy
from repic_tpu_torch.parallel.batching import (
    PaddedBatch,
    bucket_size,
    pad_batch,
    to_device,
)
from repic_tpu_torch.solver.dual import solve_lp_device
from repic_tpu_torch.utils import box_io

SOLVERS = ("lp_device", "lp_device_fused", "greedy")

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
    solver: str = "lp_device",
    use_pallas: bool = False,
) -> ConsensusResult:
    """Full consensus for a batch of M micrographs.

    Args:
        xy/conf/mask: ``(M, K, N, 2)`` / ``(M, K, N)`` tensors.
        box_size: scalar or ``(K,)`` box edges.
        solver: ``"lp_device"`` (dual decomposition), ``"greedy"``, or
            ``"lp_device_fused"`` (kernels 2 and 3 inside the fused
            envelope, the staged ``lp_device`` program outside it).
        use_pallas: staged neighbour search through kernel 1.
    """
    if solver not in SOLVERS:
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet (ROADMAP Queue 1 "
            f"item 9); choose one of {SOLVERS}"
        )
    _, k, n, _ = xy.shape
    use_megakernel = False
    if solver == "lp_device_fused":
        from repic_tpu_torch.ops import megakernel

        use_megakernel = megakernel.fused_eligible(k, n, max_neighbors)
    dprod = max_neighbors ** (k - 1)
    anchor_chunk = int(min(4096, max(8, (1 << 21) // max(dprod, 1))))
    if use_megakernel:
        cs = megakernel.fused_cliqueset(
            xy, conf, mask, box_size,
            threshold=threshold,
            max_neighbors=max_neighbors,
            clique_capacity=clique_capacity,
        )
    else:
        cs = enumerate_cliques(
            xy, conf, mask, box_size,
            threshold=threshold,
            max_neighbors=max_neighbors,
            use_pallas=use_pallas,
            clique_capacity=clique_capacity,
            anchor_chunk=anchor_chunk,
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
    )


def dense_probe(xy, mask, box_size, threshold: float) -> torch.Tensor:
    """Per-micrograph max above-threshold neighbour count over the
    anchor pairs — the first-visit adjacency probe."""
    k = xy.shape[1]
    sizes = torch.as_tensor(
        box_size, dtype=xy.dtype, device=xy.device
    ).reshape(-1).expand(k)
    thr = torch.tensor(threshold, dtype=xy.dtype, device=xy.device)
    adjs = []
    for p in range(1, k):
        iou = pairwise_iou_matrix(
            xy[:, 0], mask[:, 0], xy[:, p], mask[:, p], sizes[0], sizes[p]
        )
        adjs.append((iou > thr).sum(-1).amax(-1))
    return torch.stack(adjs).amax(0)


# Last sufficient (max_neighbors, clique_capacity) per workload shape,
# and the last three observed requirements: a repeat shape skips the
# probe and runs at the lower median of the recent requirements (in
# memory only).
_LAST_GOOD_CONFIG: dict = {}
_RECENT_REQUIREMENTS: dict = {}


def _next_bucket(x: int) -> int:
    return bucket_size(int(x), minimum=2)


def escalate_capacities(probes, d, cap):
    """Escalate each overflowed capacity straight to the observed
    requirement.  ``probes`` is ``(max_adjacency, num_cliques)``;
    returns ``(d, cap, retry)``."""
    max_adj, n_cliques = (int(v) for v in probes)
    retry = False
    if max_adj > d:
        d = _next_bucket(max_adj)
        retry = True
    if n_cliques > cap:
        cap = _next_bucket(n_cliques)
        retry = True
    return d, cap, retry


# Packed-transfer layout: head row (index 0), channels 0..1 hold the
# two probes as int32 bits in the float32 lanes; body rows (1..C)
# hold picked, rep_x, rep_y, confidence, rep_slot.
_HEAD_ADJ, _HEAD_NC = 0, 1
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
        [res.max_adjacency, res.num_cliques], dim=-1
    ).to(torch.int32).view(f32)
    head = torch.cat(
        [probes, torch.zeros((m, 3), dtype=f32, device=probes.device)], -1
    )[:, None, :]
    return torch.cat([head, core], dim=1)


def _packed_probes(packed: np.ndarray) -> np.ndarray:
    """(M, 2) int32 per-micrograph probes from the packed head row."""
    return np.ascontiguousarray(packed[:, 0, :2]).view(np.int32)


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


def run_consensus_batch(
    batch: PaddedBatch,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    clique_capacity: int | None = None,
    solver: str = "lp_device",
    use_pallas: bool = False,
    device=None,
) -> tuple[ConsensusResult, np.ndarray]:
    """Run consensus on one host batch with automatic escalation.

    Returns ``(result, packed)``: the device result of the accepted
    attempt and its fetched packed array (probes + everything the BOX
    writer needs).  A capacity that overflows re-runs the batch at
    the observed requirement.
    """
    dev = resolve_device(device)
    if batch.capacity > SPATIAL_THRESHOLD:
        raise NotImplementedError(
            f"{batch.capacity} particles per picker selects the spatial "
            "(bucketed) neighbour search, not ported yet (ROADMAP "
            "Queue 1 item 7)"
        )
    cap = clique_capacity or max(4 * batch.capacity, 1024)
    d = max_neighbors
    sizes = np.asarray(box_size, np.float32)
    box_arg = (
        torch.from_numpy(sizes).to(dev) if sizes.ndim else float(box_size)
    )
    cfg_key = (batch.xy.shape, tuple(sizes.reshape(-1).tolist()), threshold)
    dbatch = to_device(batch, dev)
    known = _LAST_GOOD_CONFIG.get(cfg_key)
    if known is None:
        adj = dense_probe(dbatch.xy, dbatch.mask, box_arg, threshold)
        d = _next_bucket(max(int(adj.max()), 2))
    else:
        d, cap = known
    while True:
        res = consensus_one(
            dbatch.xy, dbatch.conf, dbatch.mask, box_arg,
            threshold=threshold,
            max_neighbors=d,
            clique_capacity=cap,
            solver=solver,
            use_pallas=use_pallas,
        )
        packed = _pack_box_outputs(res).cpu().numpy()
        probes = _packed_probes(packed).max(axis=0)
        d, cap, retry = escalate_capacities(probes, d, cap)
        if retry:
            continue
        if solver == "lp_device_fused":
            from repic_tpu_torch.ops import megakernel

            k, n = batch.xy.shape[1], batch.xy.shape[2]
            if not megakernel.fused_eligible(k, n, d):
                megakernel.note_demotion()
        max_adj, n_cliques = (int(v) for v in probes)
        req = (
            _next_bucket(max(max_adj, 2)),
            max(_next_bucket(max(n_cliques, 2)), 1024),
        )
        recent = _RECENT_REQUIREMENTS.setdefault(cfg_key, [])
        recent.append(req)
        del recent[:-3]
        if known is None:
            _LAST_GOOD_CONFIG[cfg_key] = (d, cap)
            return res, packed
        by_cost = sorted(recent, key=lambda r: (r[0] * r[1], r))
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


def run_consensus_dir(
    in_dir: str,
    out_dir: str,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    num_particles: int | None = None,
    solver: str = "lp_device",
    use_pallas: bool = False,
    device=None,
) -> dict:
    """Read ``in_dir/<picker>/*.box``, run consensus, write one BOX file
    per micrograph into ``out_dir`` (deleted first if it exists).
    Micrographs missing from a picker, or empty in one, get an empty
    BOX file.  Returns run statistics."""
    if solver not in SOLVERS:
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet (ROADMAP Queue 1 "
            f"item 9); choose one of {SOLVERS}"
        )
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
        "load_s": time.time() - t0,
        "num_cliques": 0,
        "particle_counts": {},
        "chunks": 0,
    }
    if not loaded:
        stats["total_s"] = time.time() - t0
        return stats

    def _sink(fname, content):
        with box_io.atomic_write(os.path.join(out_dir, fname)) as o:
            o.write(content)

    k = len(loaded[0][1])
    nb = bucket_size(max(bs.n for _, sets in loaded for bs in sets))
    chunk = _auto_chunk(len(loaded), k, nb)
    compute_s = write_s = 0.0
    for i in range(0, len(loaded), chunk):
        part = loaded[i : i + chunk]
        single = chunk >= len(loaded)
        cbatch = pad_batch(
            part, pad_micrographs_to=1 if single else chunk, capacity=nb
        )
        t1 = time.time()
        _res, packed = run_consensus_batch(
            cbatch, box_size,
            threshold=threshold,
            max_neighbors=max_neighbors,
            solver=solver,
            use_pallas=use_pallas,
            device=dev,
        )
        t2 = time.time()
        counts = emit_box_chunk(
            cbatch, packed, box_size,
            num_particles=num_particles, sink=_sink,
        )
        write_s += time.time() - t2
        compute_s += t2 - t1
        stats["particle_counts"].update(counts)
        stats["num_cliques"] += int(_packed_probes(packed)[:, _HEAD_NC].sum())
        stats["chunks"] += 1
    stats.update(
        chunk=chunk,
        capacity=nb,
        compute_s=compute_s,
        write_s=write_s,
        total_s=time.time() - t0,
    )
    return stats
