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

Around the chunk loop runs the reference's fault-tolerant runtime on
one host and one card (:mod:`repic_tpu_torch.runtime`): the BOX files
load in a thread pool, a bad one is quarantined; the chunk engine
(:func:`_iter_chunks_serial`) halves a chunk that runs out of memory,
retries, falls back to single micrographs and quarantines, one chunk
ahead in a worker thread (:func:`iter_consensus_chunks`); every
outcome is journaled, ``resume`` continues a run, and accepted
capacities persist in a sidecar file.

The telemetry layer (:mod:`repic_tpu_torch.telemetry`) instruments the
run as the reference does: ``_events.jsonl`` with the ``load``,
``consensus_chunk``, ``consensus_dispatch``, ``write`` (and
``host_solve``, ``consensus_micrograph``) spans, the reference's
counters in ``_metrics.json`` / ``_metrics.prom``, a synthetic root
trace with the ``load`` / ``compile`` / ``execute`` / ``emit``
segments in ``_trace.jsonl``, and the ``/status`` progress of the
status server.  Every accepted chunk journals a ``chunk_dispatches``
event: its kernel launches plus device-to-host fetches.  Under a
profiler (``consensus --profile``) each span is a range of the trace,
and the chunk program's six stages (``consensus_neighbors``,
``consensus_join``, ``consensus_compact``, ``consensus_ascent``,
``consensus_rounding``, ``consensus_fetch``) are ranges inside
``consensus_dispatch``, timed on the device (:func:`consume_dispatch_report`).

A chunk runs over a mesh of devices (:mod:`repic_tpu_torch.parallel.mesh`):
one contiguous slice of its micrographs per device, the results
concatenated in micrograph order, chunks padded to a multiple of the
mesh.  Cluster mode (``cluster=ClusterConfig(...)``) runs one process
per host over a shared output directory
(:mod:`repic_tpu_torch.runtime.cluster`): heartbeats, a leased shard of
the micrographs, per-host journals and telemetry, and the takeover of
a lost host's work.  Gang mode (``gang=GangConfig(...)``) runs every
chunk as one job over N processes (:mod:`repic_tpu_torch.parallel.gang`):
each process runs its rows on its card, the processes agree on the
capacities with MAX all-reduces on a gloo group under a collective
watchdog, and a peer lost mid-collective re-forms a smaller gang
(:func:`_run_gang`).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import queue
import shutil
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from repic_tpu_torch import telemetry
from repic_tpu_torch.analysis import dispatchcheck
from repic_tpu_torch.analysis.contracts import Contract, checked, spec
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
from repic_tpu_torch.parallel.mesh import (
    MICROGRAPH_AXIS,
    shard_over_micrographs,
)
from repic_tpu_torch.runtime import faults
from repic_tpu_torch.runtime.atomic import atomic_write, file_lock
from repic_tpu_torch.runtime.journal import (
    DONE_STATUSES,
    STATUS_QUARANTINED,
    RunJournal,
    error_info,
)
from repic_tpu_torch.runtime.ladder import (
    DEFAULT_POLICY,
    ChunkOutcomes,
    RetryPolicy,
    classify_error,
    solve_host_ladder,
)
from repic_tpu_torch.solver.dual import note_program_solves, solve_lp_device
from repic_tpu_torch.telemetry import events as tlm_events
from repic_tpu_torch.telemetry import probes as tlm_probes
from repic_tpu_torch.telemetry import server as tlm_server
from repic_tpu_torch.telemetry import trace as tlm_trace
from repic_tpu_torch.utils import box_io
from repic_tpu_torch.utils.tracing import StageTimer, annotate, stage_clock

_log = tlm_events.get_logger("consensus")

# the reference's instruments, their names and help strings unchanged
_ESCALATIONS = telemetry.counter(
    "repic_consensus_capacity_escalations_total",
    "batch re-runs forced by capacity-probe overflow "
    "(each costs one fresh XLA compile)",
)
_CHUNK_HALVINGS = telemetry.counter(
    "repic_consensus_chunk_halvings_total",
    "OOM-driven micrograph-chunk halvings",
)
_CHUNKS = telemetry.counter(
    "repic_consensus_chunks_total",
    "consensus chunk executions",
)
_PREFETCHED_CHUNKS = telemetry.counter(
    "repic_consensus_prefetched_chunks_total",
    "chunks produced by the one-deep prefetch worker while the "
    "consumer was still emitting the previous chunk (device compute "
    "overlapped with host BOX emission)",
)
_MICROGRAPHS = telemetry.counter(
    "repic_consensus_micrographs_total",
    "micrographs processed by directory-scale consensus runs",
)
_PROGRAM_HITS = telemetry.counter(
    "repic_program_cache_hits_total",
    "consensus batch executions whose program signature was already "
    "compiled this process (warm path)",
)
_PROGRAM_MISSES = telemetry.counter(
    "repic_program_cache_misses_total",
    "consensus batch executions that compiled a new program "
    "signature (cold path: trace + XLA compile)",
)
#: the (configuration, input shape) signatures this process has run
_PROGRAM_SIGNATURES: set = set()

#: the last accepted chunk's dispatch report, per thread: the prefetch
#: worker runs the whole chunk generator on one thread, so the batch
#: that sets it and the loop that journals it share the slot
_DISPATCH_REPORT = threading.local()
#: the last accepted chunks' reports over every thread, newest last
_RECENT_REPORTS: collections.deque = collections.deque(maxlen=64)
_RECENT_LOCK = threading.Lock()
#: the fields of the journaled ``chunk_dispatches`` event (the
#: reference's four)
JOURNAL_DISPATCH_FIELDS = ("entry", "dispatches", "micrographs", "solver")


def consume_dispatch_report() -> dict | None:
    """Pop the calling thread's last accepted chunk's dispatch report,
    set by :func:`run_consensus_batch`, or None.

    ``entry``, ``dispatches`` (kernel launches plus device-to-host
    fetches of the accepted attempt), ``micrographs`` and ``solver``
    are what the run journal records.  The rest covers the whole
    batch, rejected attempts included, since their time is spent:

    * ``attempts`` -- 1 plus the capacity escalations;
    * ``host_syncs`` -- blocking device-to-host reads: the first-visit
      probes, each test of the greedy rounds' loops (and of the dual
      ascent's, where it runs as the plain loop: on a CPU tensor), the
      compactions' boolean-mask selects, the packed fetch, and after it
      the one read of the ascent kernel's steps;
    * ``ascent_steps`` -- trips of the ``lp_device`` dual ascent (of
      the ascent kernel: the most steps of any micrograph, read after
      the packed fetch);
    * ``stage_ms`` -- only while a profiler records on this thread
      (``consensus --profile DIR``, with ``REPIC_TPU_NO_PREFETCH=1`` so
      the chunks run on the profiled thread) and the chunk runs on one
      device: milliseconds on the device's clock of each stage range,
      ``consensus_neighbors``, ``consensus_join``,
      ``consensus_compact``, ``consensus_ascent``,
      ``consensus_rounding``, ``consensus_fetch``.  A path that runs
      no such stage (the fused kernels; the ``greedy`` and ``lp``
      solvers have no ascent or rounding range) lacks its key.
    """
    report = getattr(_DISPATCH_REPORT, "report", None)
    _DISPATCH_REPORT.report = None
    return report


def recent_dispatch_reports(n: int) -> list[dict]:
    """The last ``n`` accepted chunks' dispatch reports (at most 64),
    oldest first, over every thread; the per-thread slot of
    :func:`consume_dispatch_report` is left as it is."""
    if n <= 0:
        return []
    with _RECENT_LOCK:
        return list(_RECENT_REPORTS)[-n:]


def _journal_dispatches(journal, report: dict) -> None:
    journal.record_event(
        "chunk_dispatches",
        **{key: report[key] for key in JOURNAL_DISPATCH_FIELDS})


def launch_counts() -> dict:
    """This process's launches of each kernel so far, from the
    wrappers' ``LAUNCHES`` counters (a CPU tensor launches nothing):
    kernel 1, kernels 2 and 3, and the ascent kernel of the staged
    ``lp_device`` program."""
    from repic_tpu_torch.ops import iou_pallas, megakernel

    return {"topk_neighbors": int(iou_pallas.LAUNCHES),
            **{k: int(v) for k, v in megakernel.LAUNCHES.items()}}


def _dispatch_marks() -> tuple[int, int]:
    """(kernel launches, device-to-host fetches) so far."""
    return sum(launch_counts().values()), tlm_probes.counters()[2]


def program_signature(threshold, d, cap, grid, cell_cap, solver,
                      use_pallas, pcap, shape) -> tuple:
    """The static signature of one batch program: the configuration and
    the input shape (the reference's key, its mesh flag always off)."""
    return (
        float(threshold), int(d), int(cap), False,
        None if grid is None else int(grid), int(cell_cap),
        str(solver), bool(use_pallas), int(pcap), tuple(shape),
    )


def note_program_signature(sig: tuple) -> bool:
    """Mark ``sig`` as seen without counting a hit or a miss: the
    warmup replay's entry point, so the first real request on a
    replayed signature counts as the hit it is.  Returns True when the
    signature was already known."""
    if sig in _PROGRAM_SIGNATURES:
        return True
    _PROGRAM_SIGNATURES.add(sig)
    return False


def _persist_program_signature(sig: tuple, box_rank: int) -> None:
    """Record an executed signature in the compile-cache sidecar
    (no-op unless :func:`repic_tpu_torch.runtime.compilecache.enable`
    ran), so a restarted daemon can replay it; ``box_rank`` is the box
    argument's rank (scalar or per-picker), an input the replay must
    reproduce."""
    from repic_tpu_torch.runtime import compilecache

    if compilecache.enabled_dir() is None:
        return
    (threshold, d, cap, mesh_flag, grid, cell_cap, solver,
     use_pallas, pcap, shape) = sig
    compilecache.record_program({
        "threshold": threshold,
        "max_neighbors": d,
        "clique_capacity": cap,
        "mesh": mesh_flag,
        "spatial_grid": grid,
        "cell_capacity": cell_cap,
        "solver": solver,
        "use_pallas": use_pallas,
        "partial_capacity": pcap,
        "shape": list(shape),
        "box_rank": int(box_rank),
    })


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


@checked(Contract(
    # per micrograph (K picker rows of N padded particles in, C =
    # clique_capacity padded cliques out); the function takes a leading
    # micrograph axis, the pspecs name the axis a mesh splits
    args={
        "xy": spec("K N 2"),
        "conf": spec("K N"),
        "mask": spec("K N", "bool"),
        "box_size": spec(""),
    },
    returns={
        "rep_xy": spec("C 2"),
        "confidence": spec("C"),
        "w": spec("C"),
        "member_idx": spec("C K", "int32"),
        "rep_slot": spec("C", "int32"),
        "picked": spec("C", "bool"),
        "valid": spec("C", "bool"),
        "num_cliques": spec("", "int32"),
        "max_adjacency": spec("", "int32"),
        "max_partial": spec("", "int32"),
    },
    dims={"K": 3, "N": 8, "C": 64},
    static={"clique_capacity": 64, "max_neighbors": 4},
    pspecs={
        "xy": (MICROGRAPH_AXIS,),
        "conf": (MICROGRAPH_AXIS,),
        "mask": (MICROGRAPH_AXIS,),
    },
    max_trace_variants=4,
    # a staged chunk: its kernel launches (kernel 1 under --pallas)
    # plus the one packed fetch stay within 5 (DISPATCHCHECK)
    dispatch_budget=5,
    batch=2,
))
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
    with annotate("consensus_compact", timed=True):
        cs = compact_cliques(cs, clique_capacity)
        vid, num_vertices = pack_cliques_for_solver(
            cs.member_idx, cs.valid, n)
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


def consensus_over_mesh(xy, conf, mask, box_size, mesh=None, **config):
    """:func:`consensus_one` over a mesh: each device of ``mesh`` runs
    its contiguous slice of the batch's micrographs
    (:func:`~repic_tpu_torch.parallel.mesh.shard_over_micrographs`), and
    the slices' results are concatenated on ``mesh[0]`` in micrograph
    order.  Every micrograph is its own problem and every capacity is
    the batch's, so the result equals the one-device run's.  No mesh,
    or a mesh of one device, runs :func:`consensus_one` as is."""
    if mesh is None or len(mesh) <= 1:
        return consensus_one(xy, conf, mask, box_size, **config)
    slices = shard_over_micrographs(mesh, xy, conf, mask)
    parts = []
    for dev, x, c, m in zip(mesh, *slices):
        if x.shape[0] == 0:
            continue
        size = (box_size.to(dev) if isinstance(box_size, torch.Tensor)
                else box_size)
        parts.append(consensus_one(x, c, m, size, **config))
    home = torch.device(mesh[0])
    return ConsensusResult(*(
        torch.cat([getattr(p, f).to(home) for p in parts])
        for f in ConsensusResult._fields
    ))


def make_batched_consensus(
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    clique_capacity: int = 4096,
    mesh=None,
    spatial_grid: int | None = None,
    cell_capacity: int = 64,
    solver: str = "lp_device",
    use_pallas: bool = False,
    partial_capacity: int | None = None,
):
    """``fn(xy, conf, mask, box_size) -> ConsensusResult`` for a static
    configuration, split over ``mesh`` (the reference returns a jitted
    program; nothing is traced or compiled here, so this only binds the
    configuration to :func:`consensus_over_mesh`)."""
    config = dict(
        threshold=threshold, max_neighbors=max_neighbors,
        clique_capacity=clique_capacity, spatial_grid=spatial_grid,
        cell_capacity=cell_capacity, solver=solver, use_pallas=use_pallas,
        partial_capacity=partial_capacity,
    )

    def fn(xy, conf, mask, box_size):
        return consensus_over_mesh(xy, conf, mask, box_size, mesh, **config)

    return fn


@checked(Contract(
    # a gang chunk: this process's rows of the global batch (M of them)
    args={
        "xy": spec("M K N 2"),
        "conf": spec("M K N"),
        "mask": spec("M K N", "bool"),
        "box_size": spec(""),
    },
    returns={
        "rep_xy": spec("M C 2"),
        "confidence": spec("M C"),
        "w": spec("M C"),
        "member_idx": spec("M C K", "int32"),
        "rep_slot": spec("M C", "int32"),
        "picked": spec("M C", "bool"),
        "valid": spec("M C", "bool"),
        "num_cliques": spec("M", "int32"),
        "max_adjacency": spec("M", "int32"),
        "max_partial": spec("M", "int32"),
    },
    dims={"M": 8, "K": 3, "N": 8, "C": 64},
    static={"clique_capacity": 64, "max_neighbors": 4},
    pspecs={
        "xy": (MICROGRAPH_AXIS,),
        "conf": (MICROGRAPH_AXIS,),
        "mask": (MICROGRAPH_AXIS,),
    },
    max_trace_variants=4,
))
def gang_consensus_chunk(
    xy,
    conf,
    mask,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    clique_capacity: int = 4096,
    mesh=None,
    spatial_grid: int | None = None,
    cell_capacity: int = 64,
    solver: str = "lp_device",
    use_pallas: bool = False,
    partial_capacity: int | None = None,
) -> ConsensusResult:
    """One gang chunk: the batched consensus program over this
    process's rows of the global batch
    (:func:`~repic_tpu_torch.parallel.distributed.assemble_global_batch`),
    at capacities every process of the gang agreed on
    (:func:`~repic_tpu_torch.parallel.distributed.gang_all_reduce_max`).
    Every micrograph is its own problem, so the rows' results are the
    unsharded program's rows."""
    fn = make_batched_consensus(
        threshold=threshold,
        max_neighbors=max_neighbors,
        clique_capacity=clique_capacity,
        mesh=mesh,
        spatial_grid=spatial_grid,
        cell_capacity=cell_capacity,
        solver=solver,
        use_pallas=use_pallas,
        partial_capacity=partial_capacity,
    )
    return fn(xy, conf, mask, box_size)


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
# median of the recent requirements.  The accepted configs persist
# across processes in a sidecar file (_config_cache_path).
_LAST_GOOD_CONFIG: dict = {}
_RECENT_REQUIREMENTS: dict = {}
_CONFIG_CACHE_LOADED = False
_LAST_PERSISTED: dict = {}


def _config_cache_path():
    """The sidecar of accepted capacity configs,
    ``~/.cache/repic_tpu_torch/capacity_configs.json`` (the reference's
    format, a file of its own).  A persisted config is a starting point:
    the escalation loop still corrects an underestimate with one re-run.
    ``REPIC_TPU_NO_CACHE`` or ``REPIC_TPU_NO_CONFIG_CACHE`` turn it off
    (None)."""
    if os.environ.get("REPIC_TPU_NO_CACHE") or os.environ.get(
        "REPIC_TPU_NO_CONFIG_CACHE"
    ):
        return None
    return os.path.join(
        os.path.expanduser("~"), ".cache", "repic_tpu_torch",
        "capacity_configs.json",
    )


def _load_persisted_configs() -> None:
    """Fill ``_LAST_GOOD_CONFIG`` from the sidecar, once per process
    (the latch is set even when the cache is off or the file is
    unreadable); in-process records win.  A corrupt sidecar is
    ignored."""
    global _CONFIG_CACHE_LOADED
    if _CONFIG_CACHE_LOADED:
        return
    _CONFIG_CACHE_LOADED = True
    path = _config_cache_path()
    if path is None:
        return
    try:
        with open(path) as f:
            entries = json.load(f)
        for e in entries:
            shape, sizes, threshold, spatial = e["key"]
            key = (tuple(shape), tuple(sizes), float(threshold),
                   bool(spatial))
            _LAST_GOOD_CONFIG.setdefault(key, tuple(e["cfg"]))
    except (OSError, ValueError, KeyError, TypeError):
        pass


def _persist_config(cfg_key, cfg) -> None:
    """Write one accepted config through to the sidecar (the last 64
    keys kept), skipped when this process already wrote the same value.
    The read-merge-replace cycle runs under ``file_lock`` so concurrent
    processes keep each other's entries; any failure is swallowed --
    persistence never takes down a computed result."""
    if _LAST_PERSISTED.get(cfg_key) == tuple(cfg):
        return
    path = _config_cache_path()
    if path is None:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with file_lock(path):
            entries = []
            try:
                with open(path) as f:
                    loaded = json.load(f)
                if isinstance(loaded, list):
                    entries = [e for e in loaded
                               if isinstance(e, dict) and "key" in e]
            except (OSError, ValueError):
                pass
            ser_key = [list(cfg_key[0]), list(cfg_key[1]), cfg_key[2],
                       cfg_key[3]]
            entries = [e for e in entries if e.get("key") != ser_key]
            entries.append({"key": ser_key, "cfg": list(cfg)})
            del entries[:-64]
            with atomic_write(path) as f:
                json.dump(entries, f)
        _LAST_PERSISTED[cfg_key] = tuple(cfg)
    except (OSError, ValueError, TypeError):
        pass


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
    mesh=None,
    capacities: tuple | None = None,
    extent: float | None = None,
    reduce_probes=None,
) -> tuple[ConsensusResult, np.ndarray]:
    """Run consensus on one host batch with automatic escalation.

    ``spatial`` selects the bucketed neighbour search; None picks it
    above :data:`SPATIAL_THRESHOLD` particles per picker, and
    ``use_pallas`` is then ignored with a warning.  Returns ``(result,
    packed)``: the device result of the accepted attempt and its
    fetched packed array — probes + everything the BOX writer needs,
    or with ``full`` the whole result (:func:`_pack_full_result`).
    A capacity that overflows re-runs the batch at the observed
    requirement.  ``mesh`` (a tuple of devices, the first of them
    ``device``) splits the chunk program over its devices
    (:func:`consensus_over_mesh`).  The batch's dispatch report (the
    accepted attempt's kernel launches and fetches, the attempts, host
    syncs and ascent steps, and under a profiler the stage split) is
    left for :func:`consume_dispatch_report` and
    :func:`recent_dispatch_reports`.

    A gang chunk (:func:`_run_gang`) passes the last three together:
    ``capacities`` ``(d, cap, cell_cap, pcap)`` and the spatial
    ``extent`` that the gang agreed on take the place of this batch's
    own probes, extent and escalation memo, ``reduce_probes(probes,
    capacities)`` turns each attempt's probes into their gang-wide
    maximum, so that every process escalates in step, and
    :func:`gang_consensus_chunk` runs the attempt.
    """
    # the batch's marks: its probes and every attempt count
    sync_mark, step_mark = tlm_probes.chunk_counts(first=True)
    dev = resolve_device(device)
    if mesh is not None and len(mesh) > 1:
        dev = torch.device(mesh[0])
    else:
        mesh = None
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
    _load_persisted_configs()
    known = (_LAST_GOOD_CONFIG.get(cfg_key) if capacities is None
             else tuple(capacities))
    if spatial:
        # the padded host batch, zero padding included, sets the grid
        if extent is None:
            extent = float(np.max(batch.xy))
        grid = grid_size(extent + max_size, max_size)
        if known is None:
            cell = cell_probe(dbatch.xy, dbatch.mask, box_arg, grid)
            cell_cap = _next_bucket(max(tlm_probes.host_int(cell.max()), 2))
            adj = spatial_probe(dbatch.xy, dbatch.mask, box_arg, grid,
                                cell_cap, threshold)
            d = _next_bucket(max(tlm_probes.host_int(adj.max()), 2))
    elif known is None:
        adj = dense_probe(dbatch.xy, dbatch.mask, box_arg, threshold)
        d = _next_bucket(max(tlm_probes.host_int(adj.max()), 2))
    if known is not None:
        d, cap, cell_cap, pcap = known
    pack = _pack_full_result if full else _pack_box_outputs
    program = (consensus_over_mesh if reduce_probes is None
               else gang_consensus_chunk)
    n_real = sum(1 for n in batch.names if n)
    attempts = 0
    stage_ms = collections.Counter()
    while True:
        attempts += 1
        # the dispatch window of this attempt: a rejected (escalated)
        # attempt and the first-visit probes above are not counted
        launch_mark, fetch_mark = _dispatch_marks()
        sig = program_signature(threshold, d, cap, grid, cell_cap, solver,
                                use_pallas, pcap, batch.xy.shape)
        if sig in _PROGRAM_SIGNATURES:
            _PROGRAM_HITS.inc()
        else:
            _PROGRAM_SIGNATURES.add(sig)
            _PROGRAM_MISSES.inc()
            _persist_program_signature(sig, box_rank=sizes.ndim)
        with (
            stage_clock(None if mesh else dev) as clock,
            tlm_events.span("consensus_dispatch",
                            micrographs=int(batch.xy.shape[0]),
                            capacity=batch.capacity) as dispatch,
        ):
            res = program(
                dbatch.xy, dbatch.conf, dbatch.mask, box_arg, mesh=mesh,
                threshold=threshold,
                max_neighbors=d,
                clique_capacity=cap,
                spatial_grid=grid,
                cell_capacity=cell_cap,
                solver=solver,
                use_pallas=use_pallas,
                partial_capacity=pcap,
            )
            with annotate("consensus_fetch", timed=True):
                out = pack(res)
                tlm_probes.note_dispatch()
                # The span's clock stops after the launches and before
                # the blocking fetch: under --device-time its host_s is
                # the host's issue work and its device_tail_s the
                # chunk's device execution (the fetch would drain the
                # device first).  The fetch still nests in its range.
                dispatch.stop()
                # the one packed fetch of the chunk: its probes size a
                # retry only on the rare escalation, not a per-item
                # ladder
                packed = out.cpu().numpy()  # repic: noqa[RT502]
                tlm_probes.note_host_sync()
            if clock is not None:
                clock.resolve()
                stage_ms.update(clock.ms)
        telemetry.record_transfer(packed.nbytes)
        probes = _packed_probes(packed).max(axis=0)
        if reduce_probes is not None:
            probes = reduce_probes(probes, (d, cap, cell_cap, pcap))
        d, cap, cell_cap, pcap, retry = escalate_capacities(
            probes, d, cap, cell_cap, pcap, has_grid=grid is not None
        )
        if retry:
            _ESCALATIONS.inc()
            tlm_events.event(
                "capacity_escalated",
                max_neighbors=d, clique_capacity=cap,
                cell_capacity=cell_cap, partial_capacity=pcap,
            )
            continue
        if solver in ("lp_device", "lp_device_fused"):
            note_program_solves(n_real)
        entry = "repic_tpu_torch.pipeline.consensus.consensus_one"
        if solver == "lp_device_fused":
            from repic_tpu_torch.ops import megakernel

            k, n = batch.xy.shape[1], batch.xy.shape[2]
            if not megakernel.fused_eligible(k, n, d, spatial_grid=grid):
                megakernel.note_demotion()
            else:
                megakernel.note_fused_chunk(n_real)
                entry = "repic_tpu_torch.ops.megakernel.fused_clique_candidates"
        launch_now, fetch_now = _dispatch_marks()
        dispatches = (launch_now - launch_mark) + (fetch_now - fetch_mark)
        syncs, steps = tlm_probes.chunk_counts()
        report = {
            "entry": entry,
            "dispatches": dispatches,
            "micrographs": n_real,
            "solver": solver,
            "attempts": attempts,
            "host_syncs": syncs - sync_mark,
            "ascent_steps": steps - step_mark,
        }
        if stage_ms:
            report["stage_ms"] = dict(stage_ms)
        _DISPATCH_REPORT.report = report
        with _RECENT_LOCK:
            _RECENT_REPORTS.append(report)
        if dispatchcheck.installed():
            dispatchcheck.note_chunk(entry, dispatches, solver=solver,
                                     micrographs=n_real)
        if capacities is not None:
            # the gang's capacities are the gang's, not this batch's memo
            return res, packed
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
            _persist_config(cfg_key, (d, cap, cell_cap, pcap))
            return res, packed
        by_cost = sorted(
            recent, key=lambda r: (r[0] * r[1] * r[2] * r[3], r)
        )
        chosen = by_cost[(len(recent) - 1) // 2]
        _LAST_GOOD_CONFIG[cfg_key] = chosen
        _persist_config(cfg_key, chosen)
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


#: device bytes one chunk may hold in its IoU stages (the default of
#: ``REPIC_CONSENSUS_CHUNK_BYTES``)
CHUNK_BYTES = 4e9


def _auto_chunk(n_loaded: int, k: int, nb: int, n_dev: int = 1) -> int:
    """Micrograph-chunk size: ``REPIC_CONSENSUS_CHUNK`` when set, else
    ``REPIC_CONSENSUS_CHUNK_BYTES`` (default :data:`CHUNK_BYTES`)
    against ~3 live K x K x N x N float32 IoU stages per micrograph,
    rounded down to a power of two.  Always a multiple of the mesh's
    ``n_dev`` devices, and clamped to the workload rounded up to one.
    The clique product is data-dependent and not estimated: OOM
    halving in the chunk loop is its backstop."""

    def _axis_multiple(c: int) -> int:
        return max(-(-c // n_dev) * n_dev, n_dev)

    cap = _axis_multiple(n_loaded)
    explicit = os.environ.get("REPIC_CONSENSUS_CHUNK")
    if explicit:
        return min(_axis_multiple(max(int(explicit), 1)), cap)
    budget = float(os.environ.get("REPIC_CONSENSUS_CHUNK_BYTES",
                                  CHUNK_BYTES))
    per_micrograph = 3.0 * k * k * nb * nb * 4
    chunk = max(int(budget // max(per_micrograph, 1.0)), 1)
    c = 1
    while c * 2 <= chunk:
        c *= 2
    return min(_axis_multiple(c), cap)


class ConsensusCancelled(RuntimeError):
    """A chunk loop stopped by its ``cancel`` poll at a chunk boundary;
    the message is the reason."""


def _iter_chunks_serial(
    loaded,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    spatial: bool | None = None,
    solver: str = "lp_device",
    use_pallas: bool = False,
    device=None,
    mesh=None,
    extra_device_outputs=None,
    fetch: bool = False,
    finish=None,
    strict: bool = True,
    policy: RetryPolicy | None = None,
    outcomes: ChunkOutcomes | None = None,
    journal: RunJournal | None = None,
    cancel=None,
    info: dict | None = None,
):
    """Run :func:`run_consensus_batch` over memory-bounded chunks of
    ``loaded`` (``(name, sets)`` pairs, all with the same pickers),
    serially; :func:`iter_consensus_chunks` runs it one chunk ahead.

    One chunk covering the whole workload pads to a multiple of the
    mesh; otherwise every chunk pads to the chunk size, itself a
    multiple of the mesh (one shape, one escalation memo entry).  Failures walk the runtime ladder
    (:mod:`repic_tpu_torch.runtime.ladder`): a chunk that runs out of
    memory is halved and retried; in lenient mode (``strict=False``)
    other errors get bounded-backoff retries, then each micrograph of
    the chunk runs alone, and one that still fails is quarantined
    (``outcomes``, ``journal``).  Strict mode runs only the halving
    rung and raises everything else.  The fault keys are the
    reference's: ``chunk:{first name}:{len}`` and ``mic:{name}``.

    Args:
        device: where the chunks run (resolved as by
            :func:`resolve_device`).
        mesh: a tuple of devices, the first ``device``, over which each
            chunk is split (:func:`consensus_over_mesh`); None is
            ``device`` alone.
        fetch: yield the whole result fetched to the host
            (:func:`_unpack_full_result`); otherwise the device result,
            with the fetched BOX-writing array
            (:func:`_pack_box_outputs`) as ``extras``.
        extra_device_outputs: ``f(batch) -> extras`` run and fetched per
            chunk with ``fetch`` (the ``--get_cc`` component labels).
        finish: ``f(part, batch, result, extras) -> (result, extras)``,
            the host finish of each accepted chunk (the exact rung,
            the fallback hooks), run here -- in the prefetch worker --
            outside the ladder: what it raises reaches the consumer.
        policy: the :class:`RetryPolicy` of the lenient rungs.
        outcomes: per-micrograph ladder status and quarantines.
        journal: receives ladder events and quarantines as they happen.
        cancel: polled before each chunk and each per-micrograph
            attempt; a truthy return raises :class:`ConsensusCancelled`.
        info: receives the chunk size (updated when it halves) and the
            particle capacity.

    An accepted chunk (not the single-micrograph fallback) journals a
    ``chunk_dispatches`` event.

    Yields:
        ``(part, batch, result, extras, seconds)`` per chunk: the
        chunk's pairs, its padded host batch (rows in ``part`` order),
        the result, the extras, and the seconds of the device program,
        its fetches and ``finish``.
    """
    if extra_device_outputs is not None and not fetch:
        raise ValueError("extra_device_outputs needs fetch=True")
    dev = resolve_device(device)
    n_dev = 1 if mesh is None else len(mesh)
    policy = policy or DEFAULT_POLICY
    if outcomes is None:
        outcomes = ChunkOutcomes()
    k = len(loaded[0][1])
    nb = bucket_size(max(bs.n for _, sets in loaded for bs in sets))
    chunk = _auto_chunk(len(loaded), k, nb, n_dev)
    if info is not None:
        info.update(chunk=chunk, capacity=nb)

    def _execute(cbatch):
        res, packed = run_consensus_batch(
            cbatch, box_size, threshold=threshold,
            max_neighbors=max_neighbors, spatial=spatial, solver=solver,
            use_pallas=use_pallas, device=dev, full=fetch, mesh=mesh,
        )
        if not fetch:
            return res, packed
        extras = (extra_device_outputs(cbatch)
                  if extra_device_outputs is not None else None)
        return _unpack_full_result(packed, k), extras

    def _finished(part, cbatch, res, extras, t1):
        if finish is not None:
            res, extras = finish(part, cbatch, res, extras)
        return part, cbatch, res, extras, time.time() - t1

    def _check_cancel():
        if cancel is None:
            return
        reason = cancel()
        if reason:
            raise ConsensusCancelled(
                reason if isinstance(reason, str) else "cancelled")

    def _fallback(part):
        """Each micrograph of a failed chunk alone; one that still
        fails is quarantined instead of raising."""
        for name, sets in part:
            _check_cancel()
            mkey = f"mic:{name}"
            for attempt in range(policy.max_retries + 1):
                t1 = time.time()
                try:
                    with tlm_events.span("consensus_micrograph",
                                         micrograph=name, attempt=attempt,
                                         capacity=nb):
                        faults.inject("oom", mkey)
                        faults.inject("io", mkey)
                        b1 = pad_batch([(name, sets)],
                                       pad_micrographs_to=1, capacity=nb)
                        res1, extras1 = _execute(b1)
                except Exception as e:  # noqa: BLE001 — ladder rung
                    if attempt < policy.max_retries:
                        time.sleep(policy.backoff(attempt + 1))
                        continue
                    info_ = error_info(e, kind=classify_error(e))
                    outcomes.quarantined[name] = info_
                    if journal is not None:
                        journal.record(name, "quarantined", error=info_,
                                       stage="consensus")
                    break
                outcomes.mark([name], "degraded")
                yield _finished([(name, sets)], b1, res1, extras1, t1)
                break

    i = 0
    attempts = 0  # same-size transient retries of the current chunk
    while i < len(loaded):
        _check_cancel()
        single = chunk >= len(loaded)
        part = loaded[i : i + chunk]
        cbatch = pad_batch(part,
                           pad_micrographs_to=n_dev if single else chunk,
                           capacity=nb)
        ckey = f"chunk:{part[0][0]}:{len(part)}"
        t1 = time.time()
        try:
            # the padded capacity: device time is reported per capacity
            with tlm_events.span("consensus_chunk", micrographs=len(part),
                                 capacity=cbatch.capacity):
                faults.inject("oom", ckey)
                faults.inject("io", ckey)
                res, extras = _execute(cbatch)
            _CHUNKS.inc()
            report = consume_dispatch_report()
            if journal is not None and report is not None:
                _journal_dispatches(journal, report)
        except Exception as e:  # noqa: BLE001 — routed to the ladder
            kind = classify_error(e)
            if kind == "oom" and chunk > n_dev:
                # the failed attempt's tensors die with ``e`` at the end
                # of this block, so the halved retry can reuse them
                chunk = max(-(-(chunk // 2) // n_dev) * n_dev, n_dev)
                _CHUNK_HALVINGS.inc()
                _log.info("consensus chunk exhausted device memory; "
                          f"retrying at {chunk} micrographs/chunk")
                if info is not None:
                    info["chunk"] = chunk
                if journal is not None:
                    journal.record_event("chunk_halved", chunk=chunk,
                                         error=str(e)[:200])
                outcomes.mark((n for n, _ in part), "retried")
                attempts = 0
                continue
            if strict:
                raise
            if kind != "oom" and attempts < policy.max_retries:
                attempts += 1
                delay = policy.backoff(attempts)
                if journal is not None:
                    journal.record_event("chunk_retry", attempt=attempts,
                                         backoff_s=delay, error=str(e)[:200])
                outcomes.mark((n for n, _ in part), "retried")
                time.sleep(delay)
                continue
            # the chunk's ladder is spent: each micrograph alone
            if journal is not None:
                journal.record_event("per_micrograph_fallback",
                                     names=[n for n, _ in part],
                                     error=str(e)[:200])
            yield from _fallback(part)
            i += len(part)
            attempts = 0
            continue
        attempts = 0
        yield _finished(part, cbatch, res, extras, t1)
        res = extras = None  # hold no chunk's tensors into the next one
        i += len(part)


#: set to 1/true/yes to run the chunk loop without the prefetch worker
NO_PREFETCH_ENV = "REPIC_TPU_NO_PREFETCH"


def _prefetch_disabled() -> bool:
    val = os.environ.get(NO_PREFETCH_ENV, "").strip().lower()
    return val in ("1", "true", "yes")


def _prefetch_chunks(gen, device: torch.device):
    """Run ``gen`` one item ahead in a worker thread.

    While the consumer writes chunk *i*, the worker runs chunk *i+1*'s
    device program and fetch.  ``Queue(maxsize=1)`` bounds the
    lookahead to one chunk.  The worker is the only thread advancing
    ``gen``, so the consumer sees the serial sequence.  Torch's
    per-thread state -- grad mode, the current device and stream --
    is the caller's in the worker too.  An exception re-raises in the
    consumer where its chunk would have been yielded; an early
    ``close()`` stops and joins the worker, which closes ``gen`` in
    its own thread.
    """
    q = queue.Queue(maxsize=1)
    stop = threading.Event()
    done = object()
    grad = torch.is_grad_enabled()
    stream = (torch.cuda.current_stream(device)
              if device.type == "cuda" else None)

    def _pump():
        try:
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(torch.set_grad_enabled(grad))
                if stream is not None:
                    ctx.enter_context(torch.cuda.stream(stream))
                while not stop.is_set():
                    try:
                        item, err = next(gen), None
                    except StopIteration:
                        item, err = done, None
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        item, err = done, e
                    # a bounded put that still sees a consumer's stop
                    while not stop.is_set():
                        try:
                            q.put((item, err), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if item is done:
                        return
        finally:
            gen.close()

    # the worker's spans and journal records keep the caller's trace
    worker = threading.Thread(target=tlm_trace.thread_target(_pump),
                              name="repic-chunk-prefetch", daemon=True)
    worker.start()
    try:
        first = True
        while True:
            # a chunk already queued when the consumer comes back for it
            # was computed while the previous one was emitted
            ready = not first and not q.empty()
            item, err = q.get()
            if err is not None:
                raise err
            if item is done:
                return
            if ready:
                _PREFETCHED_CHUNKS.inc()
            first = False
            yield item
    finally:
        stop.set()
        # unblock a worker parked in q.put
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        worker.join(timeout=30.0)


def iter_consensus_chunks(loaded, box_size, *, prefetch: bool | None = None,
                          **kwargs):
    """:func:`_iter_chunks_serial` (same keywords and yield contract),
    by default one chunk ahead in a worker thread
    (:func:`_prefetch_chunks`).  ``prefetch=None`` prefetches unless
    ``REPIC_TPU_NO_PREFETCH`` is set; the yielded sequence and the
    journal are the same either way."""
    dev = resolve_device(kwargs.pop("device", None))
    gen = _iter_chunks_serial(loaded, box_size, device=dev, **kwargs)
    if prefetch is None:
        prefetch = not _prefetch_disabled()
    if not prefetch:
        yield from gen
        return
    yield from _prefetch_chunks(gen, dev)


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
        with atomic_write(os.path.join(out_dir, name + ".tsv")) as o:
            o.write("\t".join(pickers) + "\n")
            o.write("\n".join(rows))
        counts[name] = len(chosen)
    return counts


def _ladder_row(res, i, capacity, **kw):
    """Micrograph ``i`` of a host result re-solved on the host ladder
    (``solve_host_ladder`` keywords in ``kw``): its ``(C,)`` picks and
    the rung that produced them."""
    valid = np.asarray(res.valid[i]).astype(bool)
    k = res.member_idx.shape[-1]
    member = np.asarray(res.member_idx[i])[valid].astype(np.int64)
    offsets = np.arange(k, dtype=np.int64) * int(capacity)
    vid = member + offsets[None, :] if member.size else member
    picked_v, used = solve_host_ladder(
        vid, np.asarray(res.w[i])[valid], k * int(capacity), **kw)
    row = np.zeros(len(valid), bool)
    row[np.where(valid)[0]] = picked_v
    return row, used


def _host_solve_chunk(part, res, capacity, *, budget_s, outcomes, device,
                      strict=False):
    """Re-solve each micrograph of a fetched chunk on the host ladder
    (exact, under ``budget_s`` degrading to lp and greedy); the rung
    that ran goes to ``outcomes.solver``, and a degraded one marks the
    micrograph ``degraded``.  Returns ``res`` with the ladder's picks.

    An unexpected solver failure (not a spent budget: the ladder takes
    that) keeps the device program's greedy picks, recorded as the
    ``greedy`` rung, unless ``strict``, which re-raises."""
    picked_all = np.array(res.picked, dtype=bool)
    for i, (name, _sets) in enumerate(part):
        try:
            row, used = _ladder_row(res, i, capacity, solver="exact",
                                    budget_s=budget_s, device=device)
        except Exception:  # noqa: BLE001 — lenient terminal rung
            if strict:
                raise
            outcomes.solver[name] = "greedy"  # the device's picks kept
            outcomes.mark([name], "degraded")
            continue
        picked_all[i] = row
        outcomes.solver[name] = used
        if used != "exact":
            outcomes.mark([name], "degraded")
    return res._replace(picked=picked_all)


def _demote(part, res, capacity, site, ladder_solver, *, outcomes,
            device, journal, rung, reason):
    """Each micrograph of ``part`` whose name fires the fault ``site``
    has its device packing re-solved on the host ladder from
    ``ladder_solver``: marked degraded, the rung that ran recorded in
    ``outcomes``, a ``solver_degraded`` event journaled.  ``res`` is a
    host result; returns ``(res, changed)``."""
    hit = [(i, name) for i, (name, _sets) in enumerate(part)
           if faults.check(site, name)]
    if not hit:
        return res, False
    picked_all = np.array(res.picked, dtype=bool)
    for i, name in hit:
        picked_all[i], used = _ladder_row(res, i, capacity,
                                          solver=ladder_solver,
                                          device=device)
        outcomes.solver[name] = used
        outcomes.mark([name], "degraded")
        if site == "megakernel_fallback":
            from repic_tpu_torch.ops import megakernel

            megakernel.note_fallback("fault")
        if journal is not None:
            journal.record_event("solver_degraded", micrograph=name,
                                 rung=rung, fallback=used, reason=reason)
    return res._replace(picked=picked_all), True


def _maybe_diverge_fallback(part, res, capacity, *, solver, outcomes,
                            device, journal=None):
    """The ``solver_diverge`` site: a named micrograph's ``lp_device``
    solve reads as not converged and is re-solved on the host ladder
    from ``lp`` (journaled with ``rung`` the requested solver and
    ``reason="diverged"``).  A no-op without a fault plan."""
    if solver not in ("lp_device", "lp_device_fused") \
            or not faults.active():
        return res, False
    return _demote(part, res, capacity, "solver_diverge", "lp",
                   outcomes=outcomes, device=device, journal=journal,
                   rung=solver, reason="diverged")


def _maybe_megakernel_fallback(part, res, capacity, *, solver, outcomes,
                               device, journal=None):
    """The ``megakernel_fallback`` site, under ``lp_device_fused``: a
    named micrograph's fused packing is re-solved on the host ladder
    from the staged ``lp_device`` rung (``rung="lp_device_fused"``,
    ``reason="megakernel_fallback"``) and counted by
    ``megakernel.note_fallback``.  A no-op without a fault plan."""
    if solver != "lp_device_fused" or not faults.active():
        return res, False
    return _demote(part, res, capacity, "megakernel_fallback", "lp_device",
                   outcomes=outcomes, device=device, journal=journal,
                   rung="lp_device_fused", reason="megakernel_fallback")


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
    telemetry.record_transfer(lab.nbytes)
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


def _run_striped(loaded, out_dir, box_size, stripes, stats, journal, *,
                 threshold, max_neighbors, num_particles, spatial, solver,
                 dev, run_tlm):
    """The striped branch: each micrograph alone through
    :func:`~repic_tpu_torch.pipeline.giant.run_consensus_giant`, one
    journal record each; the sinks and ``/status`` refresh per
    micrograph."""
    from repic_tpu_torch.pipeline.giant import run_consensus_giant

    compute_s = write_s = 0.0
    giant_stats = {}
    for name, sets in loaded:
        t1 = time.time()
        with tlm_events.span("consensus_micrograph", micrograph=name,
                             striped=True):
            g = run_consensus_giant(
                sets, box_size, n_stripes=stripes, threshold=threshold,
                max_neighbors=max_neighbors, spatial=spatial,
                solver=solver, device=dev,
            )
        _MICROGRAPHS.inc()
        # a striped micrograph's execute includes its first-use builds
        tlm_trace.add_segment("execute", t1, time.time() - t1,
                              micrograph=name, striped=True)
        t2 = time.time()
        sel = g["picked"]
        stats["particle_counts"][name] = _write_box_file(
            os.path.join(out_dir, name + ".box"),
            g["rep_xy"][sel], g["confidence"][sel], g["rep_slot"][sel],
            box_size, num_particles,
        )
        write_s += time.time() - t2
        compute_s += t2 - t1
        journal.record(name, "ok", wall_s=round(time.time() - t1, 6),
                       solver=solver, out=name + ".box",
                       particles=stats["particle_counts"][name])
        stats["clique_counts"][name] = g["num_cliques"]
        stats["num_cliques"] += g["num_cliques"]
        giant_stats[name] = {
            "seconds": t2 - t1,
            "stripe_capacity": g["stripe_capacity"],
            "config": list(g["config"]),
        }
        telemetry.flush_run(run_tlm)
        tlm_server.set_ready(True)
        done = len(stats["particle_counts"])
        tlm_server.set_status(
            phase="running",
            chunks_done=done,
            micrographs_done=stats["resumed"] + done
            + len(stats["skipped"]) + len(stats["quarantined"]),
            quarantined=len(stats["quarantined"]),
        )
        tlm_trace.add_segment("emit", t2, time.time() - t2,
                              micrograph=name)
    stats.update(stripes=stripes, giant=giant_stats, compute_s=compute_s,
                 write_s=write_s)
    return stats


def _resolve_mesh(dev: torch.device, use_mesh: bool, mesh) -> tuple:
    """The devices a directory run splits its chunks over: ``mesh`` when
    given, every card of the process for a card run with ``use_mesh``,
    else ``dev`` alone."""
    from repic_tpu_torch.parallel.mesh import consensus_mesh

    if mesh is not None:
        return consensus_mesh(mesh)
    if use_mesh and dev.type == "cuda":
        return consensus_mesh()
    return (dev,)


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
    resume: bool = False,
    strict: bool = False,
    retry_policy: RetryPolicy | None = None,
    solver_budget_s: float | None = None,
    device=None,
    use_mesh: bool = True,
    mesh=None,
    cluster=None,
    gang=None,
) -> dict:
    """Read ``in_dir/<picker>/*.box``, run consensus, write one output
    per micrograph into ``out_dir`` (deleted first unless ``resume``).
    Micrographs missing from a picker, or empty in one, get an empty
    BOX file.  ``spatial`` as in :func:`run_consensus_batch`, per
    chunk.

    ``multi_out`` / ``get_cc`` write the two-phase pair's tables
    (:func:`write_consensus_tables`).  ``solver="exact"`` re-solves
    each micrograph on the host ladder, under ``solver_budget_s``
    degrading to lp and greedy (``stats["solver_rungs"]`` names the
    rung of each).  ``stripes`` (an int, or ``"auto"``, which on one
    device means no striping) splits each micrograph into x-stripes.
    Flags are checked before ``out_dir`` is touched.

    The fault-tolerant runtime: every micrograph's outcome goes to
    ``_journal.jsonl`` and the run configuration to ``_manifest.json``
    (:mod:`repic_tpu_torch.runtime.journal`); the stage seconds to
    ``consensus_runtime.tsv``.  By default the run is lenient: a BOX
    file that cannot be read, or a micrograph that still fails after
    the chunk ladder (``retry_policy``), is quarantined and the run
    goes on; ``strict`` fails fast.  ``resume`` keeps ``out_dir`` and
    processes only the micrographs the journal does not record as
    done, unless the manifest pins another configuration, which
    restarts the run from scratch.  Every accepted chunk journals a
    ``chunk_dispatches`` event.

    ``use_mesh`` splits each chunk over every card of this process
    (:func:`~repic_tpu_torch.parallel.mesh.consensus_mesh`; on the CPU
    the mesh is ``device`` alone), or ``mesh`` names the devices;
    ``use_mesh=False`` runs on ``device`` alone.  The output is the
    same either way.

    Cluster mode (``cluster=ClusterConfig(...)``): several processes
    share ``out_dir`` and a coordination directory
    (:mod:`repic_tpu_torch.runtime.cluster`).  Each heartbeats, leases
    its shard of the micrographs, journals to ``_journal.<host>.jsonl``
    (and writes ``_events.<host>.jsonl``, ``_metrics.<host>.json``,
    ``_trace.<host>.jsonl``), checks for a fence and its crash points
    at chunk boundaries, and after its own lease takes over the work of
    hosts whose heartbeat went stale.  A cluster run always resumes
    (``out_dir`` is never deleted under live peers) and composes with
    the batched path only.

    Gang mode (``gang=GangConfig(...)``): N processes run every chunk
    as one gang-scheduled job (:mod:`repic_tpu_torch.parallel.gang`).
    Each process loads, runs, emits and journals only its
    ``shard_for_process`` rows of the chunk's global batch, on its own
    card (``LOCAL_RANK``'s, round the host's cards); the processes agree
    on the batch capacity, the spatial extent and every escalation
    probe through MAX all-reduces on a gloo group, each under the
    collective watchdog of
    :class:`~repic_tpu_torch.parallel.gang.GangSupervisor`.  A peer
    lost mid-collective is a *gang fault*: the survivors abort, re-form
    a smaller gang over the remaining work or degrade to independent
    per-host execution, journaling ``gang_formed`` / ``gang_fault`` /
    ``gang_reformed`` / ``gang_degraded`` with ``gang_epoch`` on every
    record, so a fenced straggler's late writes lose.  Gang mode implies
    cluster semantics (heartbeats, fences, per-host journals) and
    composes with the plain-BOX batched path only (not ``stripes``,
    ``multi_out``, ``get_cc`` or ``solver="exact"``).

    Returns run statistics (``stats["cluster"]`` in cluster mode,
    ``stats["gang"]`` in gang mode)."""
    _check_flags(solver, solver_budget_s, stripes, multi_out, get_cc,
                 use_pallas)
    if gang is not None and (stripes is not None or multi_out or get_cc
                             or solver == "exact"):
        raise ValueError(
            "gang mode composes with the plain-BOX batched path "
            "only (not --stripes/--multi_out/--get_cc/--solver "
            "exact)"
        )
    dev = resolve_device(device)
    gang_sup = None
    if gang is not None:
        from repic_tpu_torch.parallel.distributed import _env_int
        from repic_tpu_torch.parallel.gang import GangSupervisor
        from repic_tpu_torch.runtime.cluster import ClusterConfig

        # the group forms before anything touches the card; the
        # supervisor binds to the journal once the run directory exists
        gang_sup = GangSupervisor(
            gang,
            cluster.coordination_dir
            if cluster is not None and cluster.coordination_dir
            else out_dir,
        )
        gang_sup.form_runtime()
        if cluster is None:
            # heartbeats (the watchdog's liveness input), fences and
            # per-host journals
            cluster = ClusterConfig(coordination_dir=out_dir)
        # one card per gang process: torchrun's LOCAL_RANK names it,
        # round the host's cards (several processes may share one)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", (_env_int("LOCAL_RANK") or 0)
                               % torch.cuda.device_count())
        if dev.type == "cuda":
            # the chunk's kernels launch from this thread
            torch.cuda.set_device(dev)
        mesh = (dev,)
    if cluster is not None:
        if stripes is not None:
            raise ValueError(
                "cluster mode composes with the batched path only "
                "(not --stripes)"
            )
        # a shared out_dir is never deleted under live peers
        resume = True
    mesh = _resolve_mesh(dev, use_mesh, mesh)
    dev = mesh[0]
    policy = retry_policy or DEFAULT_POLICY
    timer = StageTimer()
    t0 = time.time()
    pickers = box_io.discover_picker_dirs(in_dir)
    if not pickers:
        raise ValueError(f"no picker subdirectories in {in_dir}")
    names = box_io.micrograph_names(os.path.join(in_dir, pickers[0]))
    if os.path.isdir(out_dir) and not resume:
        shutil.rmtree(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    # what changes the output's content, and the input names: the
    # performance knobs stay out, so a resumed run may change them
    run_config = {
        "in_dir": os.path.abspath(in_dir),
        "box_size": np.asarray(box_size).tolist(),
        "threshold": threshold,
        "num_particles": num_particles,
        "solver": solver,
        "multi_out": multi_out,
        "get_cc": get_cc,
        "pickers": pickers,
        "names": names,
    }
    ctx = host = None
    if cluster is not None:
        from repic_tpu_torch.runtime.cluster import ClusterContext

        ctx = ClusterContext(cluster, out_dir)
        host = ctx.host
        # per-host journal over the merged view; a manifest of another
        # configuration raises ManifestMismatch (no restart)
        journal = RunJournal.open(out_dir, run_config, host=host,
                                  cluster=True)
        ctx.start()
    else:
        journal = RunJournal.open(out_dir, run_config, resume=resume)
        if resume and not journal.resumed:
            # --resume found another run (or none): start from scratch,
            # so no output of the other run survives beside this one's
            journal.close()
            shutil.rmtree(out_dir)
            os.makedirs(out_dir, exist_ok=True)
            journal = RunJournal.open(out_dir, run_config)
    # the event log and the metric sinks live next to the journal (per
    # host in a shared directory)
    run_tlm = telemetry.start_run(out_dir, host=host)
    run_id = run_tlm.log.run_id if run_tlm.log is not None else None
    # a synthetic root trace, unless the caller runs this inside one
    trace_ctx = trace_token = None
    if tlm_trace.current() is None:
        trace_ctx = tlm_trace.start(out_dir, kind="cli", host=host,
                                    run_id=run_id)
        trace_token = tlm_trace.activate(trace_ctx)
    tlm_server.set_status(
        run_id=run_id,
        out_dir=os.path.abspath(out_dir),
        phase="loading",
        micrographs_total=len(names),
        chunks_done=0,
    )
    if ctx is not None:
        tlm_server.set_status(cluster={
            "host": ctx.host,
            "rank": ctx.rank,
            "num_hosts": ctx.num_hosts,
            "coordination_dir": os.path.abspath(ctx.coord_dir),
            "host_timeout_s": ctx.cfg.host_timeout_s,
        })
    try:
        return _run_journaled(
            in_dir, out_dir, box_size, pickers, names, journal, timer, t0,
            threshold=threshold, max_neighbors=max_neighbors,
            num_particles=num_particles, spatial=spatial, solver=solver,
            use_pallas=use_pallas, multi_out=multi_out, get_cc=get_cc,
            stripes=stripes, strict=strict, policy=policy,
            solver_budget_s=solver_budget_s, dev=dev, mesh=mesh,
            run_tlm=run_tlm, ctx=ctx, gang_sup=gang_sup,
        )
    finally:
        # a raising run still restores the previous event log and
        # writes its sinks; a cluster host records a clean stop, so
        # peers take over what it left without waiting out a timeout
        journal.close()
        if ctx is not None:
            ctx.stop()
        telemetry.finish_run(run_tlm)
        if trace_token is not None:
            tlm_trace.deactivate(trace_token)
            trace_ctx.close()
        # winding down: readiness off, liveness stays up
        tlm_server.set_ready(False)
        tlm_server.set_status(phase="finished")


def _run_journaled(in_dir, out_dir, box_size, pickers, names, journal,
                   timer, t0, *, threshold, max_neighbors, num_particles,
                   spatial, solver, use_pallas, multi_out, get_cc, stripes,
                   strict, policy, solver_budget_s, dev, mesh, run_tlm,
                   ctx=None, gang_sup=None):
    """:func:`run_consensus_dir` once its journal and telemetry are
    open (and, in cluster mode, its :class:`ClusterContext` started)."""
    out_ext = ".tsv" if multi_out else ".box"
    already_done = set()
    if journal.resumed:
        latest = journal.latest()
        for nm in journal.done_names():
            out_name = latest[nm].get("out", nm + out_ext)
            if os.path.exists(os.path.join(out_dir, out_name)):
                already_done.add(nm)
    if gang_sup is not None:
        # the gang owns the todo collectively (each chunk is one job
        # over every process): no per-host lease split; every member
        # derives the same list from the merged journal view
        gang_sup.bind(journal, ctx)
        todo = [n for n in names if n not in already_done]
        ctx.crash_point("start")
    elif ctx is not None:
        # this host's shard of the FULL name list (a done-filtered list
        # would move the shard boundaries between staggered hosts);
        # dead peers' unfinished names come back into it
        todo = ctx.plan_shard(names, journal, done=already_done,
                              strict=strict)
        ctx.crash_point("start")
    else:
        todo = [n for n in names if n not in already_done]

    def _gang_fields():
        """The epoch tag of every gang-mode journal record (the
        write-fencing input of the merged fold)."""
        return {} if gang_sup is None else {"gang_epoch": gang_sup.epoch}

    def _load_one(nm):
        """One micrograph's BOX files; in lenient mode a read or parse
        failure is returned, to be quarantined."""
        try:
            return box_io.load_micrograph_set(in_dir, pickers, nm)
        except (box_io.BoxParseError, OSError) as e:
            if strict:
                raise
            return e

    skipped, quarantined = [], {}

    def _load(nms):
        """Load ``nms`` -- the native parser releases the GIL, so
        threads overlap the reads; map keeps the order -- and journal
        the quarantines and the empty inputs; returns the
        ``(name, sets)`` pairs to run."""
        with tlm_trace.segment("load", micrographs=len(nms)), \
                tlm_events.span("load", micrographs=len(nms)):
            if len(nms) > 1:
                workers = min(32, max(4, os.cpu_count() or 4))
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    all_sets = list(ex.map(_load_one, nms))
            else:
                all_sets = [_load_one(nm) for nm in nms]
        out = []
        for name, sets in zip(nms, all_sets):
            if isinstance(sets, BaseException):
                info = error_info(sets, path=getattr(sets, "path", None),
                                  kind=classify_error(sets))
                quarantined[name] = info
                journal.record(name, "quarantined", error=info,
                               stage="load", **_gang_fields())
            elif sets is None:
                skipped.append(name)
                box_io.write_empty_box(os.path.join(out_dir, name + ".box"))
                journal.record(name, "skipped", out=name + ".box",
                               **_gang_fields())
            else:
                out.append((name, sets))
        return out

    # a gang process loads its own shard, chunk by chunk
    loaded = [] if gang_sup is not None else _load(todo)
    stats = {
        "pickers": pickers,
        "micrographs": len(names),
        "skipped": skipped,
        "quarantined": quarantined,
        "resumed": len(already_done),
        "device": str(dev),
        "solver": solver,
        "multi_out": multi_out,
        "get_cc": get_cc,
        "load_s": time.time() - t0,
        "num_cliques": 0,
        "particle_counts": {},
        "clique_counts": {},
        "chunks": 0,
        "compute_s": 0.0,
        "write_s": 0.0,
    }
    if not loaded and ctx is None:
        stats["total_s"] = time.time() - t0
        stats["journal"] = journal.summary()
        return stats
    # a cluster host goes on with an empty shard: the harvest below
    # may still take over a lost peer's work
    timer.stages.append(("load", stats["load_s"]))
    if stripes == "auto":
        # stripe only when there are fewer micrographs than devices
        # (the batched axis would leave devices idle) and the fields
        # are dense; the tables need the batched path
        max_n = max((bs.n for _, sets in loaded for bs in sets), default=0)
        if (not (multi_out or get_cc or solver == "exact")
                and len(loaded) < len(mesh)
                and max_n > SPATIAL_THRESHOLD):
            stripes = len(mesh)
            if use_pallas:
                warnings.warn(
                    "--pallas applies to the batched dense path only; "
                    "--stripes auto selected the striped path",
                    stacklevel=3,
                )
        else:
            stripes = None
    if stripes is not None:
        _run_striped(
            loaded, out_dir, box_size, stripes, stats, journal,
            threshold=threshold, max_neighbors=max_neighbors,
            num_particles=num_particles, spatial=spatial, solver=solver,
            dev=dev, run_tlm=run_tlm,
        )
    else:
        outcomes = ChunkOutcomes()
        if ctx is not None:
            # takeovers of a previous generation, recorded by plan_shard
            outcomes.reassigned.update(ctx.reassigned)
        kw = dict(
            threshold=threshold, max_neighbors=max_neighbors,
            num_particles=num_particles, spatial=spatial, solver=solver,
            use_pallas=use_pallas, multi_out=multi_out, get_cc=get_cc,
            strict=strict, policy=policy, solver_budget_s=solver_budget_s,
            dev=dev, mesh=mesh, out_ext=out_ext, run_tlm=run_tlm,
            outcomes=outcomes, ctx=ctx,
        )
        if gang_sup is not None:
            _run_gang(todo, gang_sup, _load, out_dir, box_size, pickers,
                      stats, journal, chunked_kw=kw)
        elif loaded:
            _run_chunked(loaded, out_dir, box_size, pickers, stats,
                         journal, **kw)
        # the host ladder's reassignment rung: after its own lease a
        # cluster host takes over the work of peers whose heartbeat
        # went stale (suspect -> fence -> reassign) until none is left;
        # a gang owns its todo collectively (a degraded one runs its
        # own final sweep)
        while ctx is not None and gang_sup is None:
            orphans = ctx.harvest_orphans(journal, names, strict=strict)
            if not orphans:
                break
            outcomes.reassigned.update(ctx.reassigned)
            adopted = _load(orphans)
            if adopted:
                _run_chunked(adopted, out_dir, box_size, pickers, stats,
                             journal, **kw)
        # micrographs the ladder quarantined while chunking (journaled
        # as it happened)
        stats["quarantined"].update(outcomes.quarantined)
        if solver == "exact":
            stats["solver_rungs"] = dict(outcomes.solver)
    if ctx is not None:
        stats["cluster"] = ctx.stats()
    if gang_sup is not None:
        stats["gang"] = {
            "epoch": gang_sup.epoch,
            "world": gang_sup.world,
            "rank": gang_sup.rank,
            "mode": gang_sup.mode,
            "faults": gang_sup.faults_seen,
            "reformations": gang_sup.reformations,
        }
    timer.stages.append(("compute", stats["compute_s"]))
    timer.stages.append(("write", stats["write_s"]))
    timer.write_tsv(out_dir, "consensus_runtime.tsv")
    stats["total_s"] = time.time() - t0
    stats["journal"] = journal.summary()
    return stats


def _run_chunked(loaded, out_dir, box_size, pickers, stats, journal, *,
                 threshold, max_neighbors, num_particles, spatial, solver,
                 use_pallas, multi_out, get_cc, strict, policy,
                 solver_budget_s, dev, mesh, out_ext, run_tlm, outcomes,
                 ctx=None, gang_epoch=None):
    """The batched branch over one work list (a cluster host calls it
    again for each batch of work it takes over): the chunk engine, one
    journal record per micrograph (with ``reassigned_from`` for work
    taken over), the ladder's outcomes in ``outcomes``; per chunk the
    ``compile`` / ``execute`` / ``emit`` trace segments, a sink flush,
    the ``/status`` progress and, in cluster mode, the crash point and
    the fence check.  ``stats`` accumulates across calls."""
    host_solver = solver == "exact"
    # the exact solver shares the tables' data path: the device runs
    # the greedy program and the host re-solves the fetched result
    want_fetch = multi_out or get_cc or host_solver
    device_solver = "greedy" if host_solver else solver
    k = len(loaded[0][1])
    cc_fn = None
    if get_cc:
        cc_sizes = np.asarray(box_size, np.float32)
        cc_arg = (torch.from_numpy(cc_sizes).to(dev) if cc_sizes.ndim
                  else float(box_size))

        def cc_fn(b):
            return cc_labels_host(b, cc_arg, threshold, dev)

    def _finish(part, cbatch, res, extras):
        """The host side of an accepted chunk, in the chunk engine's
        thread: the exact rung, then the fault-driven demotions."""
        if host_solver:
            with tlm_events.span("host_solve", micrographs=len(part)):
                res = _host_solve_chunk(
                    part, res, cbatch.capacity, budget_s=solver_budget_s,
                    outcomes=outcomes, device=dev, strict=strict,
                )
        if device_solver in ("lp_device", "lp_device_fused") \
                and faults.active():
            host = res
            if not want_fetch:
                full = _pack_full_result(res).cpu().numpy()
                telemetry.record_transfer(full.nbytes)
                host = _unpack_full_result(full, k)
            kw = dict(solver=device_solver, outcomes=outcomes, device=dev,
                      journal=journal)
            host, diverged = _maybe_diverge_fallback(
                part, host, cbatch.capacity, **kw)
            host, demoted = _maybe_megakernel_fallback(
                part, host, cbatch.capacity, **kw)
            if (diverged or demoted) and not want_fetch:
                # the fetched BOX array predates the host re-solve
                extras = extras.copy()
                extras[:, 1:, _BODY_PICKED] = host.picked
            res = host
        return res, extras

    cc_rounds = stats.setdefault("cc_rounds", []) if get_cc else []
    chunks_info: dict = {}
    # a chunk's window since the previous chunk's emit: the build
    # seconds inside it are its compile segment (with the program-cache
    # deltas), the rest its execute segment
    t_mark = time.time()
    comp_mark = tlm_probes.compile_seconds()
    hits_mark, miss_mark = _PROGRAM_HITS.value(), _PROGRAM_MISSES.value()
    for part, cbatch, res, extra, chunk_s in iter_consensus_chunks(
        loaded, box_size, info=chunks_info,
        threshold=threshold, max_neighbors=max_neighbors, spatial=spatial,
        solver=device_solver, use_pallas=use_pallas, device=dev, mesh=mesh,
        extra_device_outputs=cc_fn, fetch=want_fetch, finish=_finish,
        strict=strict, policy=policy, outcomes=outcomes, journal=journal,
    ):
        chunk_i = stats["chunks"]
        t_now = time.time()
        chunk_wall = max(t_now - t_mark, float(chunk_s), 0.0)
        compile_seg = min(
            max(tlm_probes.compile_seconds() - comp_mark, 0.0), chunk_wall)
        hits_now, miss_now = _PROGRAM_HITS.value(), _PROGRAM_MISSES.value()
        if (chunk_i == 0 or compile_seg > 0.0 or hits_now > hits_mark
                or miss_now > miss_mark):
            tlm_trace.add_segment(
                "compile", t_now - chunk_wall, compile_seg, chunk=chunk_i,
                cache_hits=int(hits_now - hits_mark),
                cache_misses=int(miss_now - miss_mark),
            )
        tlm_trace.add_segment(
            "execute", t_now - chunk_wall + compile_seg,
            chunk_wall - compile_seg, chunk=chunk_i,
            micrographs=len(part), capacity=cbatch.capacity,
        )
        t_emit0 = time.time()
        with tlm_events.span("write", micrographs=len(part)):
            if want_fetch:
                cc = None
                if get_cc:
                    cc, rounds = extra
                    cc_rounds.append(rounds)
                counts = write_consensus_tables(
                    part, res, cc, out_dir, box_size, pickers,
                    multi_out=multi_out, get_cc=get_cc,
                    num_particles=num_particles,
                )
                nc = res.num_cliques
            else:
                counts = emit_box_chunk(cbatch, extra, box_size,
                                        num_particles=num_particles,
                                        sink=_box_sink(out_dir))
                nc = _packed_probes(extra)[:, _HEAD_NC]
        _close_chunk(part, cbatch.names, counts, nc, chunk_s, t_emit0,
                     stats=stats, journal=journal, outcomes=outcomes,
                     solver=solver, out_ext=out_ext, run_tlm=run_tlm,
                     ctx=ctx, gang_epoch=gang_epoch,
                     crash_key=f"after_chunk:{chunk_i}")
        t_mark = time.time()
        comp_mark = tlm_probes.compile_seconds()
        hits_mark, miss_mark = hits_now, miss_now
    stats.update(chunk=chunks_info["chunk"], capacity=chunks_info["capacity"])


def _box_sink(out_dir):
    """``sink(filename, content)`` writing each BOX file atomically
    into ``out_dir``."""
    def sink(fname, content):
        with atomic_write(os.path.join(out_dir, fname)) as o:
            o.write(content)

    return sink


def _close_chunk(part, names, counts, nc, chunk_s, t_emit0, *, stats,
                 journal, outcomes, solver, out_ext, run_tlm, ctx,
                 gang_epoch, crash_key):
    """The host tail of a written chunk, shared by the chunk engine's
    loop (:func:`_run_chunked`) and the gang's (:func:`_run_gang`):
    the run's statistics, one journal record per micrograph (with
    ``reassigned_from`` for work taken over, and ``gang_epoch`` when
    given), a sink flush, the ``/status`` progress, the ``emit`` trace
    segment from ``t_emit0`` and, in cluster mode, the crash point
    ``crash_key`` and the fence check.  ``counts`` are the written rows
    and ``nc`` the clique counts of the rows ``names``."""
    chunk_i = stats["chunks"]
    stats["write_s"] += time.time() - t_emit0
    stats["compute_s"] += chunk_s
    _MICROGRAPHS.inc(len(part))
    stats["particle_counts"].update(counts)
    stats["clique_counts"].update(
        (name, int(c)) for name, c in zip(names, nc) if name
    )
    stats["num_cliques"] += int(np.sum(nc[: len(part)], dtype=np.int64))
    stats["chunks"] += 1
    for nm, _sets in part:
        fields = dict(
            wall_s=round(chunk_s / max(len(part), 1), 6),
            solver=outcomes.solver.get(nm, solver),
            particles=counts.get(nm), out=nm + out_ext,
        )
        src = outcomes.reassigned.get(nm)
        if src is not None:
            fields["reassigned_from"] = src
        if gang_epoch is not None:
            # a gang's records, a degraded gang's too, carry its epoch,
            # outranking any straggler of an older gang
            fields["gang_epoch"] = gang_epoch
        journal.record(nm, outcomes.status.get(nm, "ok"), **fields)
    telemetry.flush_run(run_tlm)
    ladder_tally: dict = {}
    for st in outcomes.status.values():
        ladder_tally[st] = ladder_tally.get(st, 0) + 1
    if ctx is not None:
        # a cluster host counts the whole run's progress, its peers'
        # included, from the merged journal; quarantines from the
        # same view
        merged = ctx.merged_latest()
        q_count = sum(1 for e in merged.values()
                      if e.get("status") == STATUS_QUARANTINED)
        done = q_count + sum(1 for e in merged.values()
                             if e.get("status") in DONE_STATUSES)
    else:
        # progress over the whole run: resumed, skipped and
        # quarantined micrographs count as processed
        q_count = len(stats["quarantined"]) + len(outcomes.quarantined)
        done = (stats["resumed"] + len(stats["particle_counts"])
                + len(stats["skipped"]) + q_count)
    tlm_server.set_ready(True)  # the first chunk is done: warmed up
    tlm_server.set_status(
        phase="running",
        chunks_done=stats["chunks"],
        micrographs_done=done,
        quarantined=q_count,
        ladder=ladder_tally,
    )
    # emit covers the chunk's host tail (write, journal, flush), so
    # the segments stay contiguous and sum to the run's wall
    tlm_trace.add_segment("emit", t_emit0, time.time() - t_emit0,
                          chunk=chunk_i, micrographs=len(part))
    if ctx is not None:
        # the host_crash site, and a fenced host stops before its
        # next chunk (a survivor owns its lease now)
        ctx.crash_point(crash_key)
        ctx.ensure_not_fenced()


def _merged_remaining(ctx, pool) -> list:
    """Names of ``pool`` not yet terminal in the merged (all hosts,
    epoch-aware) journal view."""
    merged = ctx.merged_latest()
    return [
        n for n in pool
        if merged.get(n, {}).get("status") not in DONE_STATUSES
        and merged.get(n, {}).get("status") != STATUS_QUARANTINED
    ]


def _run_gang(todo_all, sup, load, out_dir, box_size, pickers, stats,
              journal, *, chunked_kw):
    """The gang branch: every chunk is one job over the gang; this
    process loads, runs, emits and journals its
    :func:`~repic_tpu_torch.parallel.distributed.shard_for_process`
    share, padded to the gang's per-process row quota.  The processes
    agree on the batch capacity and the spatial extent, then on every
    attempt's probes, through MAX all-reduces, each under the
    supervisor's collective watchdog; the chunk itself runs through
    :func:`run_consensus_batch` on this process's card.  A gang fault
    re-forms the gang (or degrades it), and the loop resumes over the
    epoch record's todo; a degraded gang runs its deterministic
    independent share, then a final sweep, through
    :func:`_run_chunked`.  ``chunked_kw`` are :func:`_run_chunked`'s
    keywords, whose options this branch shares."""
    from repic_tpu_torch.parallel import distributed as dist
    from repic_tpu_torch.parallel.gang import GangFault, GangFenced
    from repic_tpu_torch.runtime.cluster import HostFenced

    kw = chunked_kw
    ctx, dev, solver = kw["ctx"], kw["dev"], kw["solver"]
    k = len(pickers)
    max_size = float(np.asarray(box_size, np.float32).max())
    quarantined, skipped = stats["quarantined"], stats["skipped"]
    loaded_by_name: dict = {}
    caps = None
    # the capacities whose collective COMPLETED in this epoch: a
    # dispatch aborted by a fault never finished its first run, so its
    # retry on the re-formed gang gets the first-run deadline again
    executed: set = set()
    todo = list(todo_all)
    chunk_global = None

    def _agree(values, key, fresh):
        return sup.dispatch(lambda: dist.gang_all_reduce_max(values),
                            key=key, fresh_compile=fresh)

    while todo and sup.mode == "gang":
        my_todo = dist.shard_for_process(todo, sup.rank, sup.world)
        fresh = [n for n in my_todo if n not in loaded_by_name
                 and n not in quarantined and n not in skipped]
        if fresh:
            for nm, sets in load(fresh):
                loaded_by_name[nm] = sets
        mine = [loaded_by_name[n] for n in my_todo if n in loaded_by_name]
        fault = None
        try:
            local_max_n = max((bs.n for sets in mine for bs in sets),
                              default=0)
            local_extent = max(
                (float(np.max(bs.xy)) if bs.n else 0.0
                 for sets in mine for bs in sets),
                default=0.0,
            )
            # every process must pad and escalate alike
            agreed = _agree(np.asarray((local_max_n, local_extent)),
                            "exchange", True)
            nb = bucket_size(max(int(agreed[0]), 1))
            if caps is None:
                cap0 = max(4 * nb, 1024)
                caps = (kw["max_neighbors"], cap0, 64, cap0)
            if chunk_global is None:
                # one card per process: the gang's devices are its world
                chunk_global = _auto_chunk(len(todo), k, nb, sup.world)
            rows = dist.local_row_quota(
                -(-min(chunk_global, len(todo)) // sup.world), 1)
            per = -(-len(todo) // sup.world)
            for ci in range(max(-(-per // rows), 1)):
                part = [(nm, loaded_by_name[nm])
                        for nm in my_todo[ci * rows:(ci + 1) * rows]
                        if nm in loaded_by_name]
                lbatch = pad_batch(part, pad_micrographs_to=rows,
                                   capacity=nb, num_pickers=k)
                local, _layout = dist.assemble_global_batch(
                    (lbatch.xy, lbatch.conf, lbatch.mask), pad_rows_to=rows,
                    process_id=sup.rank, process_count=sup.world)
                lbatch = lbatch._replace(xy=local[0], conf=local[1],
                                         mask=local[2])
                ckey = f"gchunk:{sup.epoch}:{ci}"
                accepted = []

                def _reduce(probes, attempt, ckey=ckey, accepted=accepted):
                    out = _agree(probes, ckey, attempt not in executed)
                    executed.add(attempt)
                    accepted[:] = [attempt]
                    return out

                t1 = time.time()
                with tlm_events.span("gang_chunk", micrographs=len(part),
                                     epoch=sup.epoch, capacity=nb):
                    faults.inject("oom", ckey)
                    faults.inject("io", ckey)
                    packed = run_consensus_batch(
                        lbatch, box_size, threshold=kw["threshold"],
                        spatial=kw["spatial"], solver=solver,
                        use_pallas=kw["use_pallas"], device=dev,
                        capacities=caps, extent=float(agreed[1]),
                        reduce_probes=_reduce,
                    )[1]
                caps = accepted[0]
                chunk_s = time.time() - t1
                _CHUNKS.inc()
                report = consume_dispatch_report()
                if report is not None:
                    _journal_dispatches(journal, report)
                tlm_trace.add_segment(
                    "execute", t1, chunk_s, chunk=stats["chunks"],
                    gang_epoch=sup.epoch, micrographs=len(part),
                    capacity=nb,
                )
                t2 = time.time()
                with tlm_events.span("write", micrographs=len(part)):
                    counts = emit_box_chunk(
                        lbatch, packed, box_size,
                        num_particles=kw["num_particles"],
                        sink=_box_sink(out_dir),
                    )
                # the gang's records: its own outcomes, every one "ok"
                _close_chunk(part, lbatch.names, counts,
                             _packed_probes(packed)[:, _HEAD_NC], chunk_s,
                             t2, stats=stats, journal=journal,
                             outcomes=ChunkOutcomes(), solver=solver,
                             out_ext=kw["out_ext"], run_tlm=kw["run_tlm"],
                             ctx=ctx, gang_epoch=sup.epoch,
                             crash_key=f"after_chunk:{ci}")
                stats.update(chunk=chunk_global, capacity=nb)
            todo = []
        except GangFault as gf:
            fault = gf
        except (GangFenced, HostFenced, ConsensusCancelled):
            # presumed dead by the re-formed gang / fenced by a
            # survivor: stop -- late writes lose by epoch
            raise
        except Exception as e:  # noqa: BLE001 — the gang ladder
            if kw["strict"]:
                raise
            fault = GangFault(
                f"gang dispatch failed: {str(e)[:200]}",
                kind="dispatch_error",
                oom=classify_error(e) == "oom",
            )
            sup.faults_seen += 1
            # the watchdog's classifications count inside dispatch;
            # this one is classified here
            telemetry.counter(
                "repic_gang_faults_total",
                "SPMD dispatches classified as gang faults",
            ).inc()
        if fault is None:
            continue
        # a classified gang fault: journal it, then abort + re-form, or
        # degrade once the fault budget is spent (a poison chunk must
        # not re-form forever)
        sup.record_fault(fault, chunk=chunk_global or 0,
                         context="consensus_dir")
        remaining = _merged_remaining(ctx, todo_all)
        if sup.faults_seen > sup.cfg.max_faults:
            sup.degrade(f"fault budget ({sup.cfg.max_faults}) exhausted")
        else:
            sup.reform(remaining, chunk=chunk_global or 0, oom=fault.oom)
        if sup.mode == "gang":
            # the epoch record's todo is adopted verbatim, so every
            # survivor walks the same list; a name a peer finished just
            # before the fault runs again, harmlessly (atomic, equal
            # outputs; the higher epoch wins the fold)
            rec_todo = sup.current_todo()
            todo = list(rec_todo if rec_todo is not None else remaining)
            rec_chunk = sup.current_chunk()
            if rec_chunk:
                chunk_global = rec_chunk
            caps = None               # re-probe on the new gang
            executed.clear()

    if sup.mode != "independent":
        return
    # degraded: independent per-host execution over deterministic
    # shares of the remainder, then a final sweep of anything still
    # unclaimed (duplicates are harmless, as above)
    for final_pass in (False, True):
        remaining = _merged_remaining(ctx, todo_all)
        if not remaining:
            break
        share = remaining if final_pass else sup.independent_share(remaining)
        if not share:
            continue
        share = load(share)
        if share:
            _run_chunked(share, out_dir, box_size, pickers, stats, journal,
                         gang_epoch=sup.epoch, **kw)
