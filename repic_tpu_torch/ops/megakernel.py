"""The fused chunk program: clique candidates (kernel 2) and the dual
solve (kernel 3); and the staged program's dual ascent (the ascent
kernel).

:func:`fused_clique_candidates` runs everything from IoU to the
compacted clique buffer — per-picker top-D neighbours (masked IoU
0.0), the D^(K-1) product with cross-edge checks, median confidence,
weight and representative, and compaction of the valid rows into the
buffer's leading slots in product-id order (slots past them are
zero).  :func:`fused_dual_solve` is the whole ``lp_device`` solve in
one launch.  On a CUDA tensor each launches its kernel
(``csrc/cliques.cu``, ``csrc/dual.cu``, ``csrc/ascent.cu``); on a CPU
tensor each runs
its ``*_plain`` version, which is the staged program: the dense
enumeration of :mod:`~repic_tpu_torch.ops.cliques` compacted by index,
and :func:`~repic_tpu_torch.solver.dual.solve_lp_device`.

Valid rows leave in product order — the staged buffers' valid-row
order — so ``consensus_one``'s shared weight compaction yields the
same buffer on both rungs, and the BOX output is byte-identical.

Each wrapper is a ``@checked`` entry whose :class:`KernelContract`
holds it, one micrograph at a time, against the unfused path
(KERNELCHECK): kernel 2 against the staged full-product enumeration
compacted in index order, kernel 3 against
:func:`~repic_tpu_torch.solver.dual.solve_dual_decomposition_plain`.
A chunk the fused program ran answers to the candidates entry's
dispatch budget of 3 (DISPATCHCHECK).

:func:`dual_ascent` is the ascent of every staged ``lp_device`` solve
on the card (:func:`~repic_tpu_torch.solver.dual.run_dual_ascent`):
kernel 3's staging and ascent at any C, with the vertex state and the
staged cliques placed by :func:`ascent_residency`; its contract holds
it bit for bit to the plain loop
(:func:`~repic_tpu_torch.solver.dual.dual_ascent_plain`).

Eligibility (:func:`fused_eligible`) is the reference's envelope:
dense path (no spatial grid), ``2 <= K <= 6``, ``N <= 8192``, ``D^(K-1) <= 4096``.
Outside it ``consensus_one`` demotes statically to the staged program
(counted in :data:`DEMOTIONS`).
"""

from __future__ import annotations

import ctypes

import torch

from repic_tpu_torch import _build, telemetry
from repic_tpu_torch.analysis.contracts import Contract, checked, spec
from repic_tpu_torch.analysis.kernels import KernelContract
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
LAUNCHES = {"fused_clique_candidates": 0, "fused_dual_solve": 0,
            "dual_ascent": 0}
#: lp_device_fused chunks demoted to the staged program (envelope)
DEMOTIONS = 0
#: micrographs demoted off the fused rung after it ran, by reason
#: (``fault``: the ``megakernel_fallback`` fault site)
FALLBACKS: dict = {}
#: (M, 8) int32 chain counters of the last fused_dual_solve launch, per
#: micrograph: ascent steps, greedy rounds of the six fixpoints
#: (candidate 0 pass 0, pass 1, candidate 1 pass 0, ...), block barriers
SOLVE_CHAIN = None

#: dynamic shared memory a block of kernel 3 or of the ascent kernel
#: may claim: the card's 227 KB less 1 KB for their static reduction
#: buffers
SMEM_LIMIT = 227 * 1024 - 1024
#: ascent-kernel launches by residency (:func:`ascent_residency`)
ASCENT_RESIDENCY = {"shared": 0, "split": 0, "global": 0}


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


# -- the kernel contracts (KERNELCHECK) --------------------------------

_PROBE_D = 4
_PROBE_CAP = 1024
_PROBE_BOX = 180.0
_PROBE_THRESHOLD = 0.3
_CANDIDATES_STATIC = {
    "threshold": _PROBE_THRESHOLD,
    "max_neighbors": _PROBE_D,
    "clique_capacity": _PROBE_CAP,
}


def _probe_inputs(dims: dict):
    """One micrograph of the reference's probe inputs (same generator,
    same draws): clustered fields, so real cliques and zero-weight ties
    form."""
    import numpy as np

    n, k = dims["N"], dims["K"]
    rng = np.random.default_rng(1000 * k + n)
    base = rng.uniform(0, 1500.0, (n, 2))
    xy = torch.tensor(base[None] + rng.normal(0, 25.0, (k, n, 2)),
                      dtype=torch.float32)
    conf = torch.tensor(rng.uniform(0.5, 1.0, (k, n)), dtype=torch.float32)
    mask = torch.from_numpy(rng.uniform(size=(k, n)) > 0.15)
    return (xy, conf, mask, _PROBE_BOX), {}


def _run_candidates(xy, conf, mask, box_size):
    """The kernel side: one micrograph through the batched wrapper."""
    out = fused_clique_candidates(xy[None], conf[None], mask[None],
                                  box_size, **_CANDIDATES_STATIC)
    return tuple(o[0] for o in out)


def _reference(xy, conf, mask, box_size):
    """Ground truth: the staged full-product path this kernel fuses
    away, compacted in index order to the kernel's buffer width (the
    chunked path's discipline: valid rows first, pid ascending)."""
    from repic_tpu_torch.ops.cliques import enumerate_cliques

    n = xy.shape[1]
    d = min(_PROBE_D, n)
    cap = min(_PROBE_CAP, n * d ** (xy.shape[0] - 1))
    cs = enumerate_cliques(
        xy[None], conf[None], mask[None], box_size,
        threshold=_PROBE_THRESHOLD, max_neighbors=_PROBE_D,
    )
    valid = cs.valid[0]
    length = valid.shape[0]            # full product: position == pid
    pos = torch.arange(length, device=valid.device)
    order = torch.argsort(torch.where(valid, pos, length), stable=True)
    order = order[:cap]
    return (
        cs.member_idx[0][order], valid[order], cs.w[0][order],
        cs.confidence[0][order], cs.rep_slot[0][order],
        cs.rep_xy[0][order], order.to(torch.int32), cs.num_valid[0],
        cs.max_adjacency[0],
    )


def _compare(got, want, tol):
    """Exact equality on valid rows and the two probes; invalid slots
    hold path-specific values on both sides and are skipped."""
    import numpy as np

    (g_mem, g_val, g_w, g_cf, g_slot, g_xy, g_pid, g_nv, g_adj) = got
    (r_mem, r_val, r_w, r_cf, r_slot, r_xy, r_pid, r_nv, r_adj) = want
    msgs = []
    if int(g_nv) != int(r_nv):
        msgs.append(f"num_valid: kernel {int(g_nv)} vs reference "
                    f"{int(r_nv)}")
    if int(g_adj) != int(r_adj):
        msgs.append(f"max_adjacency: kernel {int(g_adj)} vs reference "
                    f"{int(r_adj)}")
    if g_val.shape != r_val.shape or not np.array_equal(g_val, r_val):
        bad = (int(np.sum(g_val != r_val))
               if g_val.shape == r_val.shape else "every")
        msgs.append(f"valid mask differs on {bad} slot(s)")
        return msgs
    v = g_val
    for name, g, r in (
        ("member_idx", g_mem, r_mem),
        ("w", g_w, r_w),
        ("confidence", g_cf, r_cf),
        ("rep_slot", g_slot, r_slot),
        ("rep_xy", g_xy, r_xy),
        ("pid", g_pid, r_pid),
    ):
        g, r = g[v], r[v]
        if not np.array_equal(g, r):
            bad = int(np.sum(np.any(np.atleast_2d(g != r), axis=-1)))
            msgs.append(f"{name}: {bad} valid row(s) differ")
    return msgs


@checked(Contract(
    # per micrograph; the wrapper takes a leading micrograph axis
    args={
        "xy": spec("K N 2"),
        "conf": spec("K N"),
        "mask": spec("K N", "bool"),
        "box_size": spec(""),
    },
    returns=(
        spec("C K", "int32"), spec("C", "bool"), spec("C"),
        spec("C"), spec("C", "int32"), spec("C 2"),
        spec("C", "int32"), spec("", "int32"), spec("", "int32"),
    ),
    dims={"K": 3, "N": 8, "C": 128},
    static=_CANDIDATES_STATIC,
    kernel=KernelContract(
        # bucket-aligned rungs plus ragged ones, across picker counts
        # (K=2 degenerates the product join)
        ladder=(
            {"K": 3, "N": 64},
            {"K": 3, "N": 96},
            {"K": 2, "N": 40},
            {"K": 4, "N": 24},
        ),
        make_inputs=_probe_inputs,
        reference=_reference,
        run=_run_candidates,
        compare=_compare,
        tol=0.0,
    ),
    # the fused program's launches + the packed-output fetch: a chunk
    # stays within 3 (DISPATCHCHECK)
    dispatch_budget=3,
    batch=2,
))
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
    # the box edges travel as kernel arguments (no copy to the card);
    # edges held in a card tensor are read back first
    if isinstance(box_size, torch.Tensor) and box_size.device.type != "cpu":
        telemetry.probes.note_host_sync()
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

    picked = _dual.solve_dual_decomposition_plain(
        grow(member_vertex), grow(w), grow(valid), num_vertices
    ).picked
    return picked[:, :c]


_SOLVE_PROBE_V = 64


def _solve_probe_inputs(dims: dict):
    """One packing of the reference's probe inputs."""
    import numpy as np

    c, k = dims["C"], dims["K"]
    rng = np.random.default_rng(7 * c + k)
    mv = torch.tensor(rng.integers(0, _SOLVE_PROBE_V, (c, k)),
                      dtype=torch.int32)
    w = torch.tensor(rng.uniform(0.1, 1.0, (c,)), dtype=torch.float32)
    valid = torch.from_numpy(rng.uniform(size=c) > 0.2)
    return (mv, w, valid), {}


def _run_solve(member_vertex, w, valid):
    """The kernel side: one packing through the batched wrapper."""
    return fused_dual_solve(member_vertex[None], w[None], valid[None],
                            _SOLVE_PROBE_V)[0]


def _solve_reference(member_vertex, w, valid):
    """Ground truth: the staged ``lp_device`` solve, its ascent the
    plain loop."""
    return _dual.solve_dual_decomposition_plain(
        member_vertex[None], w[None], valid[None], _SOLVE_PROBE_V,
    ).picked[0]


def _solve_compare(got, want, tol):
    import numpy as np

    if got.shape != want.shape or got.dtype != want.dtype:
        return [f"picked: kernel ({got.shape}, {got.dtype}) vs "
                f"reference ({want.shape}, {want.dtype})"]
    if not np.array_equal(got, want):
        return [f"picked mask differs on {int(np.sum(got != want))} "
                "clique(s)"]
    return []


@checked(Contract(
    args={
        "member_vertex": spec("C K", "int32"),
        "w": spec("C"),
        "valid": spec("C", "bool"),
    },
    returns=spec("C", "bool"),
    dims={"C": 16, "K": 3},
    static={"num_vertices": _SOLVE_PROBE_V},
    kernel=KernelContract(
        ladder=(
            {"C": 16, "K": 3},
            {"C": 100, "K": 4},
            {"C": 128, "K": 2},
        ),
        make_inputs=_solve_probe_inputs,
        reference=_solve_reference,
        run=_run_solve,
        compare=_solve_compare,
        tol=0.0,
    ),
    dispatch_budget=3,
    batch=2,
))
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
    use_smem = per_block <= SMEM_LIMIT
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


# -- the ascent kernel: the staged program's dual ascent ---------------


def _align16(x: int) -> int:
    return (x + 15) & ~15


def ascent_smem_bytes(num_vertices: int, k: int, n_near: int,
                      state_smem: bool) -> int:
    """Dynamic shared memory of the ascent kernel with ``n_near``
    staged cliques there, and the vertex state (``lam``, ``lam_sum``,
    ``ax``: V x 12 B) with ``state_smem`` (``csrc/ascent.cu:
    ascent_layout``)."""
    idb = 2 if num_vertices <= 65535 else 4
    state = 3 * _align16(4 * num_vertices) if state_smem else 0
    return state + _align16(idb * n_near * k) + _align16(4 * n_near)


def ascent_residency(num_vertices: int, c: int, k: int) -> tuple:
    """Where the ascent kernel keeps a ``(C, K)`` packing over V
    vertices, from the shapes against :data:`SMEM_LIMIT`:
    ``(residency, n_near)``, the staged cliques that stay in shared
    memory being the first ``n_near`` valid ones.

    * ``shared``: the vertex state and every clique in shared memory;
    * ``split``: the state there, the cliques as far as they fit, the
      others in the block's global slice;
    * ``global``: the state (V x 12 B past the limit) in the global
      slice, the cliques in shared memory as far as they fit.
    """
    limit = SMEM_LIMIT
    if ascent_smem_bytes(num_vertices, k, c, True) <= limit:
        return "shared", c
    state_smem = ascent_smem_bytes(num_vertices, k, 0, True) <= limit
    used = ascent_smem_bytes(num_vertices, k, 0, state_smem)
    per = (2 if num_vertices <= 65535 else 4) * k + 4
    # the two arrays' 16-byte alignments add less than 32 bytes
    n_near = min(c, max(0, (limit - used - 30) // per))
    return ("split" if state_smem else "global"), n_near


def _ascent_probe_inputs(dims: dict):
    """One packing over ``V`` vertices, its members drawn from the
    first ``min(V, 64 K)`` so that the cliques contend at any V."""
    import numpy as np

    c, k, v = dims["C"], dims["K"], dims["V"]
    rng = np.random.default_rng(7 * c + k + v)
    mv = torch.tensor(rng.integers(0, min(v, 64 * k), (c, k)),
                      dtype=torch.int32)
    w = torch.tensor(rng.uniform(0.1, 1.0, (c,)), dtype=torch.float32)
    valid = torch.from_numpy(rng.uniform(size=c) > 0.2)
    return (mv, w, valid), {"num_vertices": v}


def _run_ascent(member_vertex, w, valid, num_vertices):
    """The kernel side: one packing through the batched wrapper."""
    out = dual_ascent(member_vertex[None], w[None], valid[None],
                      num_vertices)
    return tuple(o[0] for o in out)


def _ascent_reference(member_vertex, w, valid, num_vertices):
    """Ground truth: the plain ascent loop."""
    out = _dual.dual_ascent_plain(member_vertex[None], w[None],
                                  valid[None], num_vertices)
    return tuple(o[0] for o in out)


def _ascent_compare(got, want, tol):
    """Bit for bit: lam, lam_avg, t, delta."""
    import numpy as np

    msgs = []
    for name, g, r in zip(("lam", "lam_avg", "t", "delta"), got, want):
        if g.shape != r.shape or g.dtype != r.dtype:
            msgs.append(f"{name}: kernel ({g.shape}, {g.dtype}) vs "
                        f"reference ({r.shape}, {r.dtype})")
        elif not np.array_equal(g.view(np.int32), r.view(np.int32)):
            bad = int(np.sum(g.view(np.int32) != r.view(np.int32)))
            msgs.append(f"{name}: {bad} value(s) differ in their bits")
    return msgs


@checked(Contract(
    args={
        "member_vertex": spec("C K", "int32"),
        "w": spec("C"),
        "valid": spec("C", "bool"),
    },
    returns=(spec("V"), spec("V"), spec("", "int32"), spec("")),
    dims={"C": 16, "K": 3, "V": _SOLVE_PROBE_V},
    static={"num_vertices": _SOLVE_PROBE_V},
    kernel=KernelContract(
        # kernel 3's rungs (shared residency), then split residency
        # (the state takes most of shared memory, past 1,956 cliques
        # the rest go to the global slice), global residency (V x 12 B
        # past the limit) and a width past kernel 3's (read at run time)
        ladder=(
            {"C": 16, "K": 3, "V": _SOLVE_PROBE_V},
            {"C": 100, "K": 4, "V": _SOLVE_PROBE_V},
            {"C": 128, "K": 2, "V": _SOLVE_PROBE_V},
            {"C": 4096, "K": 5, "V": 17000},
            {"C": 256, "K": 3, "V": 20000},
            {"C": 300, "K": 7, "V": _SOLVE_PROBE_V},
        ),
        make_inputs=_ascent_probe_inputs,
        reference=_ascent_reference,
        run=_run_ascent,
        compare=_ascent_compare,
        tol=0.0,
    ),
    batch=2,
))
def dual_ascent(member_vertex, w, valid, num_vertices, *,
                num_iters: int = _dual.DEFAULT_NUM_ITERS,
                tol: float = _dual.DEFAULT_TOL):
    """The dual ascent of M packings in one launch (the ascent kernel):
    :func:`~repic_tpu_torch.solver.dual.dual_ascent_plain`'s
    ``(lam, lam_avg, t, delta)``, bit for bit.

    One block per micrograph runs its steps to its own stop; where the
    vertex state and the staged cliques live follows
    :func:`ascent_residency`.  The launch syncs nothing: the telemetry
    reads the steps after the chunk's packed fetch
    (:func:`~repic_tpu_torch.telemetry.probes.defer_ascent_steps`).

    Args:
        member_vertex: ``(M, C, K)`` int32 vertex ids in ``[0, V)``.
        w: ``(M, C)`` float32; valid: ``(M, C)`` bool.
        num_vertices: V.
    """
    if w.device.type == "cpu":
        return _dual.dual_ascent_plain(member_vertex, w, valid,
                                       num_vertices, num_iters=num_iters,
                                       tol=tol)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    m, c, k = member_vertex.shape
    dev = w.device
    # the solver's ids may be int64 (a copy only where they are)
    member_vertex = member_vertex.to(torch.int32).contiguous()
    w = w.to(torch.float32).contiguous()
    _check(valid, torch.bool, (m, c), dev, "valid")
    _check(member_vertex, torch.int32, (m, c, k), dev, "member_vertex")
    _check(w, torch.float32, (m, c), dev, "w")
    valid = valid.contiguous()
    f32 = torch.float32
    lam = torch.empty((m, num_vertices), dtype=f32, device=dev)
    lam_avg = torch.empty_like(lam)
    t = torch.empty((m,), dtype=torch.int32, device=dev)
    delta = torch.empty((m,), dtype=f32, device=dev)
    if m == 0:
        return lam, lam_avg, t, delta
    residency, n_near = ascent_residency(num_vertices, c, k)
    state_smem = int(residency != "global")
    lib = _build.load("ascent")
    per_block = lib.repic_dual_ascent_slice_bytes(
        c, k, num_vertices, n_near, state_smem)
    scratch = torch.empty((max(m * per_block, 1),), dtype=torch.uint8,
                          device=dev)
    err = lib.repic_dual_ascent(
        member_vertex.data_ptr(), w.data_ptr(), valid.data_ptr(),
        lam.data_ptr(), lam_avg.data_ptr(), t.data_ptr(), delta.data_ptr(),
        scratch.data_ptr(), m, c, k, num_vertices, n_near, state_smem,
        int(num_iters), float(tol), _build.stream_ptr(dev),
    )
    _build.check(err, "dual_ascent")
    LAUNCHES["dual_ascent"] += 1
    ASCENT_RESIDENCY[residency] += 1
    telemetry.probes.defer_ascent_steps(t)
    return lam, lam_avg, t, delta


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
