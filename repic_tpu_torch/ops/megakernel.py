"""The fused chunk program: clique candidates (kernel 2) and the dual
solve (kernel 3).

:func:`fused_clique_candidates` runs everything from IoU to the
compacted clique buffer — per-picker top-D neighbours (masked IoU
0.0), the D^(K-1) product with cross-edge checks, median confidence,
weight and representative, and compaction of the valid rows into the
buffer's leading slots in product-id order (slots past them are
zero).  :func:`fused_dual_solve` is the whole ``lp_device`` solve in
one launch.  On a CUDA tensor each launches its kernel
(``csrc/cliques.cu``, ``csrc/dual.cu``); on a CPU tensor each runs
its ``*_plain`` version, which is the staged program: the dense
enumeration of :mod:`~repic_tpu_torch.ops.cliques` compacted by index,
and :func:`~repic_tpu_torch.solver.dual.solve_lp_device`.

Valid rows leave in product order — the staged buffers' valid-row
order — so ``consensus_one``'s shared weight compaction yields the
same buffer on both rungs, and the BOX output is byte-identical.

Eligibility (:func:`fused_eligible`) is the reference's envelope:
dense path (no spatial grid), ``2 <= K <= 6``, ``N <= 8192``, ``D^(K-1) <= 4096``.
Outside it ``consensus_one`` demotes statically to the staged program
(counted in :data:`DEMOTIONS`).
"""

from __future__ import annotations

import ctypes

import torch

from repic_tpu_torch import _build, telemetry
from repic_tpu_torch.ops.cliques import (
    CliqueSet,
    _assemble_block,
    _per_picker_sizes,
    _stream_compact,
    dense_neighbors,
)
from repic_tpu_torch.solver import dual as _dual

_FUSED_MAX_DPROD = 4096
_FUSED_MAX_N = 8192
_FUSED_MAX_K = 6
#: lane width the reference solve kernel pads C to
SOLVE_LANE = 128

#: kernel launches by wrapper name (one per wrapper call that
#: launched its CUDA kernel)
LAUNCHES = {"fused_clique_candidates": 0, "fused_dual_solve": 0}
#: lp_device_fused chunks demoted to the staged program (envelope)
DEMOTIONS = 0
#: micrographs demoted off the fused rung after it ran, by reason
#: (``fault``: the ``megakernel_fallback`` fault site)
FALLBACKS: dict = {}
#: (M, 8) int32 chain counters of the last fused_dual_solve launch, per
#: micrograph: ascent steps, greedy rounds of the six fixpoints
#: (candidate 0 pass 0, pass 1, candidate 1 pass 0, ...), block barriers
SOLVE_CHAIN = None

# dynamic shared memory the solve may claim per block (the card's
# 227 KB less the kernel's static reduction buffers)
_SOLVE_SMEM_LIMIT = 220_000


# the reference's registry counters (its names and help strings)
_PROGRAMS = telemetry.counter(
    "repic_megakernel_programs_total",
    "coalesced chunks executed by the fused megakernel program",
)
_DISPATCHES_AVOIDED = telemetry.counter(
    "repic_megakernel_dispatches_avoided_total",
    "separately-dispatched stage boundaries (neighbor search, clique "
    "join, compaction, solve -> one fused program) avoided by "
    "megakernel chunks",
)
_FALLBACKS = telemetry.counter(
    "repic_megakernel_fallbacks_total",
    "chunks demoted from the fused megakernel to the staged rung",
)

#: stage boundaries of the staged chain that the fused program folds
#: away per chunk (neighbor search | join | compaction | solve -> 1)
STAGED_CHAIN_STAGES = 4


def fused_eligible(
    k: int, n: int, max_neighbors: int, *, spatial_grid=None
) -> bool:
    """Static envelope check: can the fused program run this config?
    A spatial grid (the bucketed neighbour search) is outside it."""
    d = min(max_neighbors, n)
    return (
        spatial_grid is None
        and 2 <= k <= _FUSED_MAX_K
        and 1 <= n <= _FUSED_MAX_N
        and d ** (k - 1) <= _FUSED_MAX_DPROD
    )


def note_demotion() -> None:
    """Count one accepted chunk outside the fused envelope (the
    reference's ``envelope`` fallback)."""
    global DEMOTIONS
    DEMOTIONS += 1
    _FALLBACKS.inc(reason="envelope")


def note_fallback(reason: str) -> None:
    """Count one demotion off the fused rung (``FALLBACKS``)."""
    FALLBACKS[reason] = FALLBACKS.get(reason, 0) + 1
    _FALLBACKS.inc(reason=reason)


def note_fused_chunk(n_micrographs: int) -> None:
    """Count one accepted chunk that ran the fused program."""
    _PROGRAMS.inc()
    if n_micrographs > 0:
        _DISPATCHES_AVOIDED.inc(STAGED_CHAIN_STAGES - 1)


def _dims(n, k, max_neighbors, clique_capacity):
    if not 2 <= k <= _FUSED_MAX_K:
        raise ValueError(
            f"fused clique kernel supports 2 <= K <= {_FUSED_MAX_K}, "
            f"got K={k}"
        )
    d = min(max_neighbors, n)
    dprod = d ** (k - 1)
    if dprod > _FUSED_MAX_DPROD:
        raise ValueError(
            f"candidate product D^(K-1)={dprod} exceeds the fused "
            f"envelope ({_FUSED_MAX_DPROD}); use the staged path"
        )
    return d, dprod, min(clique_capacity, n * dprod)


def fused_clique_candidates_plain(
    xy, conf, mask, box_size,
    *, threshold: float = 0.3, max_neighbors: int = 16,
    clique_capacity: int = 4096,
):
    """Plain PyTorch version of :func:`fused_clique_candidates`."""
    m, k, n, _ = xy.shape
    d, _dprod, cap = _dims(n, k, max_neighbors, clique_capacity)
    sizes = _per_picker_sizes(box_size, k, xy.dtype, xy.device)
    nbr_v, nbr_i, max_adj = dense_neighbors(xy, mask, sizes, threshold, d)
    block = _assemble_block(
        xy, conf, mask, sizes, threshold,
        torch.arange(n, dtype=torch.int32, device=xy.device),
        mask[:, 0], nbr_i, nbr_v,
    )
    num_valid = block["valid"].sum(-1, dtype=torch.int32)
    block["pid"] = torch.arange(
        block["valid"].shape[1], dtype=torch.int32, device=xy.device
    ).expand_as(block["valid"])
    out = _stream_compact(block, cap)
    return (
        out["member_idx"], out["valid"], out["w"], out["confidence"],
        out["rep_slot"], out["rep_xy"], out["pid"], num_valid,
        max_adj.to(torch.int32),
    )


def _check(t, dtype, shape, dev, name):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)}, "
            f"got {t.dtype} {tuple(t.shape)}"
        )
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")


def fused_clique_candidates(
    xy, conf, mask, box_size,
    *, threshold: float = 0.3, max_neighbors: int = 16,
    clique_capacity: int = 4096,
):
    """Fused IoU -> top-D -> clique join -> stats -> compaction.

    Args:
        xy/conf/mask: ``(M, K, N, 2)`` float32 / ``(M, K, N)`` float32
            / ``(M, K, N)`` bool padded picker rows.
        box_size: scalar or ``(K,)`` box edges.

    Returns:
        ``(member_idx (M, C, K) int32, valid (M, C) bool, w, confidence
        (M, C) float32, rep_slot (M, C) int32, rep_xy (M, C, 2), pid
        (M, C) int32, num_valid (M,) int32, max_adjacency (M,) int32)``
        with ``C = min(clique_capacity, N * D^(K-1))``; valid rows fill
        the leading slots in product-id order, the rest are zero.
        ``num_valid`` counts every valid clique, dropped or not.
    """
    if xy.device.type == "cpu":
        return fused_clique_candidates_plain(
            xy, conf, mask, box_size, threshold=threshold,
            max_neighbors=max_neighbors, clique_capacity=clique_capacity,
        )
    if xy.device.type != "cuda":
        raise ValueError(f"unsupported device {xy.device}")
    m, k, n, _ = xy.shape
    d, _dprod, cap = _dims(n, k, max_neighbors, clique_capacity)
    dev = xy.device
    _check(xy, torch.float32, (m, k, n, 2), dev, "xy")
    _check(conf, torch.float32, (m, k, n), dev, "conf")
    _check(mask, torch.bool, (m, k, n), dev, "mask")
    xy = _build.aligned(xy)
    conf, mask = conf.contiguous(), mask.contiguous()
    # the box edges travel as kernel arguments (no copy to the card)
    sizes = (ctypes.c_float * k)(*_per_picker_sizes(
        box_size, k, torch.float32, "cpu").tolist())
    i32, f32 = torch.int32, torch.float32
    nbr_v = torch.empty((m, k - 1, n, d), dtype=f32, device=dev)
    nbr_i = torch.empty((m, k - 1, n, d), dtype=i32, device=dev)
    anchor_count = torch.empty((m, n), dtype=i32, device=dev)
    # per anchor block (a block holds at least one anchor)
    block_count = torch.empty((m, n), dtype=i32, device=dev)
    block_adj = torch.empty((m, n), dtype=i32, device=dev)
    member_idx = torch.empty((m, cap, k), dtype=i32, device=dev)
    valid = torch.empty((m, cap), dtype=torch.bool, device=dev)
    w = torch.empty((m, cap), dtype=f32, device=dev)
    confidence = torch.empty((m, cap), dtype=f32, device=dev)
    rep_slot = torch.empty((m, cap), dtype=i32, device=dev)
    rep_xy = torch.empty((m, cap, 2), dtype=f32, device=dev)
    pid = torch.empty((m, cap), dtype=i32, device=dev)
    num_valid = torch.empty((m,), dtype=i32, device=dev)
    max_adj = torch.empty((m,), dtype=i32, device=dev)
    lib = _build.load("cliques")
    stream = _build.stream_ptr(dev)
    err = lib.repic_clique_count(
        xy.data_ptr(), mask.data_ptr(), ctypes.addressof(sizes),
        nbr_v.data_ptr(), nbr_i.data_ptr(), anchor_count.data_ptr(),
        block_count.data_ptr(), block_adj.data_ptr(),
        m, k, n, d, float(threshold), stream,
    )
    _build.check(err, "fused_clique_candidates (count)")
    err = lib.repic_clique_write(
        xy.data_ptr(), conf.data_ptr(), mask.data_ptr(),
        ctypes.addressof(sizes),
        nbr_v.data_ptr(), nbr_i.data_ptr(), anchor_count.data_ptr(),
        block_count.data_ptr(), block_adj.data_ptr(),
        member_idx.data_ptr(), valid.data_ptr(), w.data_ptr(),
        confidence.data_ptr(), rep_slot.data_ptr(), rep_xy.data_ptr(),
        pid.data_ptr(), num_valid.data_ptr(), max_adj.data_ptr(),
        m, k, n, d, cap, float(threshold), stream,
    )
    _build.check(err, "fused_clique_candidates (write)")
    LAUNCHES["fused_clique_candidates"] += 1
    return (
        member_idx, valid, w, confidence, rep_slot, rep_xy, pid,
        num_valid, max_adj,
    )


def fused_dual_solve_plain(member_vertex, w, valid, num_vertices):
    """Plain PyTorch version of :func:`fused_dual_solve`: the solve at
    the reference kernel's width, C padded with inert rows to a
    multiple of :data:`SOLVE_LANE` (the width sets the order of the
    objective sums)."""
    m, c, k = member_vertex.shape
    pad = -c % SOLVE_LANE

    def grow(x):
        return torch.cat([x, x.new_zeros((m, pad) + x.shape[2:])], 1)

    picked = _dual.solve_lp_device(
        grow(member_vertex), grow(w), grow(valid), num_vertices
    )
    return picked[:, :c]


def fused_dual_solve(member_vertex, w, valid, num_vertices):
    """``solve_lp_device`` of M packings in one launch (kernel 3).

    Args:
        member_vertex: ``(M, C, K)`` int32 vertex ids in ``[0, V)``.
        w: ``(M, C)`` float32; valid: ``(M, C)`` bool.
        num_vertices: V.

    Returns ``(M, C)`` bool picks, bitwise equal to the plain solve.
    """
    if w.device.type == "cpu":
        return fused_dual_solve_plain(member_vertex, w, valid, num_vertices)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    global SOLVE_CHAIN
    m, c, k = member_vertex.shape
    if k > _FUSED_MAX_K:
        raise ValueError(f"fused solve supports K <= {_FUSED_MAX_K}, got {k}")
    dev = w.device
    _check(member_vertex, torch.int32, (m, c, k), dev, "member_vertex")
    _check(w, torch.float32, (m, c), dev, "w")
    _check(valid, torch.bool, (m, c), dev, "valid")
    member_vertex = member_vertex.contiguous()
    w, valid = w.contiguous(), valid.contiguous()
    lib = _build.load("dual")
    per_block = lib.repic_dual_smem_bytes(c, k, num_vertices)
    use_smem = per_block <= _SOLVE_SMEM_LIMIT
    scratch = torch.empty(
        (1 if use_smem else m * per_block,), dtype=torch.uint8, device=dev
    )
    picked = torch.empty((m, c), dtype=torch.bool, device=dev)
    chain = torch.empty((m, 8), dtype=torch.int32, device=dev)
    err = lib.repic_dual_solve(
        member_vertex.data_ptr(), w.data_ptr(), valid.data_ptr(),
        picked.data_ptr(), scratch.data_ptr(), chain.data_ptr(),
        m, c, k, num_vertices, _dual.DEFAULT_NUM_ITERS, int(use_smem),
        float(_dual.DEFAULT_TOL), _build.stream_ptr(dev),
    )
    _build.check(err, "fused_dual_solve")
    SOLVE_CHAIN = chain
    LAUNCHES["fused_dual_solve"] += 1
    return picked


def fused_cliqueset(
    xy, conf, mask, box_size,
    *, threshold: float = 0.3, max_neighbors: int = 16,
    clique_capacity: int = 4096,
) -> CliqueSet:
    """The fused candidates as a :class:`CliqueSet`."""
    (member_idx, valid, w, confidence, rep_slot, rep_xy, _pid,
     num_valid, max_adjacency) = fused_clique_candidates(
        xy, conf, mask, box_size,
        threshold=threshold,
        max_neighbors=max_neighbors,
        clique_capacity=clique_capacity,
    )
    return CliqueSet(
        member_idx=member_idx,
        valid=valid,
        w=w,
        confidence=confidence,
        rep_slot=rep_slot,
        rep_xy=rep_xy,
        max_adjacency=max_adjacency,
        max_cell_count=torch.zeros_like(num_valid),
        num_valid=num_valid,
        max_partial=torch.zeros_like(num_valid),
    )
