"""Plan -> execute chunk -> emit: the pure consensus library API (the
port of ``repic_tpu.pipeline.engine``).

:func:`run_consensus_dir` interleaves planning, execution and emission
with file I/O at every edge.  A long-lived server needs each stage on
its own: it takes requests over HTTP, schedules chunks from many
requests into shared padded capacity buckets, and emits artifacts
wherever the request says.  This module exposes the stages without
any filesystem assumption:

* :func:`plan_request` -- pure planning over already-loaded ``(name,
  [BoxSet])`` pairs: the padded capacity bucket, the memory-bounded
  chunk size and the per-chunk names.  :attr:`RequestPlan.bucket_key`
  is the warm-affinity handle the serve scheduler groups requests by.
* :func:`execute_request` -- a generator over executed chunks through
  :func:`~repic_tpu_torch.pipeline.consensus.iter_consensus_chunks`
  (capacity escalation, OOM halving, retries, quarantine), with a
  ``cancel`` hook polled at every chunk boundary.
* :func:`emit_box_chunk` (re-exported) -- emission through a
  caller-supplied sink.

:func:`consensus_chunk_program` is one chunk's device program at an
explicit configuration.  The port compiles no program per signature:
"compiled" means the kernel libraries are built and loaded
(:mod:`repic_tpu_torch._build`) and the signature was seen before, as
the program-cache counters on ``/metrics`` count it.  Every function
that touches a tensor takes a ``device`` keyword (``cuda`` unless the
caller asks for the CPU).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, fields

import torch

from repic_tpu_torch.analysis.contracts import Contract, checked, spec
from repic_tpu_torch.ops.cliques import DEFAULT_THRESHOLD
from repic_tpu_torch.parallel.mesh import MICROGRAPH_AXIS
from repic_tpu_torch.parallel.batching import bucket_size
from repic_tpu_torch.pipeline.consensus import (  # noqa: F401 - re-exports
    ConsensusCancelled,
    _auto_chunk,
    consensus_one,
    emit_box_chunk,
    iter_consensus_chunks,
    note_program_signature,
    program_signature,
    resolve_device,
)
from repic_tpu_torch.runtime.ladder import DEFAULT_POLICY, RetryPolicy
from repic_tpu_torch.telemetry import events as tlm_events


@dataclass(frozen=True)
class ConsensusOptions:
    """The consensus knobs of one request, as one serializable value:
    the serve request's ``options`` object and the engine's planning
    input.  The reference's keys exactly; ``use_mesh`` splits each
    chunk over every card of the process (:func:`request_mesh`), and
    ``use_mesh``/``use_pallas`` stay out of
    :attr:`RequestPlan.bucket_key`."""

    threshold: float = DEFAULT_THRESHOLD
    max_neighbors: int = 16
    num_particles: int | None = None
    use_mesh: bool = True
    spatial: bool | None = None
    solver: str = "lp_device"
    use_pallas: bool = False
    strict: bool = False
    max_retries: int | None = None

    def __post_init__(self):
        if self.solver not in (
            "greedy", "lp", "lp_device", "lp_device_fused"
        ):
            raise ValueError(
                f"engine solver must be 'greedy', 'lp', 'lp_device' "
                f"or 'lp_device_fused', got {self.solver!r} (the "
                "host-side 'exact' ladder is a run_consensus_dir "
                "mode, not a serve mode)"
            )

    @classmethod
    def from_dict(cls, data: dict) -> "ConsensusOptions":
        """Build from an untrusted request payload: an unknown key is
        a ``ValueError`` (a 400), and every field is type- and
        range-checked here, so a malformed request costs the client a
        400 and never a worker."""
        if not isinstance(data, dict):
            raise ValueError("options must be a JSON object")
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise ValueError(
                f"unknown option(s) {unknown}; known: {sorted(known)}"
            )

        def _num(name, lo, hi, integer=False, optional=False):
            if name not in data:
                return
            v = data[name]
            if optional and v is None:
                return
            # bool is an int subclass: rejected explicitly
            bad_type = isinstance(v, bool) or not isinstance(
                v, int if integer else (int, float)
            )
            if bad_type or not math.isfinite(v) or not (
                lo <= v <= hi
            ):
                kind = "an integer" if integer else "a number"
                raise ValueError(
                    f"option {name!r} must be {kind} in "
                    f"[{lo}, {hi}], got {v!r}"
                )

        def _flag(name, optional=False):
            if name not in data:
                return
            v = data[name]
            if optional and v is None:
                return
            if not isinstance(v, bool):
                raise ValueError(
                    f"option {name!r} must be a boolean, got {v!r}"
                )

        _num("threshold", 1e-6, 1.0)
        _num("max_neighbors", 1, 4096, integer=True)
        _num("num_particles", 1, 10**7, integer=True, optional=True)
        _num("max_retries", 0, 100, integer=True, optional=True)
        _flag("use_mesh")
        _flag("use_pallas")
        _flag("strict")
        _flag("spatial", optional=True)
        if "solver" in data and not isinstance(data["solver"], str):
            raise ValueError(
                f"option 'solver' must be a string, got "
                f"{data['solver']!r}"
            )
        return cls(**data)

    def policy(self) -> RetryPolicy:
        if self.max_retries is None:
            return DEFAULT_POLICY
        return RetryPolicy(max_retries=self.max_retries)


@dataclass(frozen=True)
class ChunkPlan:
    """One fixed-shape chunk: which micrographs, padded to what."""

    index: int
    names: tuple
    capacity: int      # padded particle capacity (bucket_size grid)
    micrographs: int   # padded micrograph count (mesh multiple)


@dataclass(frozen=True)
class RequestPlan:
    """The scheduling view of one request: the scheduler's estimate
    (OOM halving may still shrink chunks mid-run)."""

    options: ConsensusOptions
    num_pickers: int
    capacity: int
    chunk: int
    n_dev: int
    chunks: tuple = field(default_factory=tuple)

    @property
    def bucket_key(self) -> tuple:
        """The warm-affinity handle: requests sharing it run the same
        configuration at the same padded capacity, and the continuous
        batcher coalesces their micrographs into one chunk.  It leaves
        out the micrograph count and the chunk size, so jobs of
        different sizes share one bucket."""
        return (
            self.num_pickers,
            self.capacity,
            self.options.threshold,
            self.options.solver,
        )


def request_mesh(options: ConsensusOptions | None, device) -> tuple:
    """The devices a request's chunks are split over: every card of
    the process when ``options.use_mesh`` and ``device`` is a card,
    else ``device`` alone (its length is the plan's ``n_dev``)."""
    from repic_tpu_torch.parallel.mesh import consensus_mesh

    dev = resolve_device(device)
    if (options is None or options.use_mesh) and dev.type == "cuda":
        return consensus_mesh()
    return (dev,)


def plan_request(
    loaded,
    box_size,
    options: ConsensusOptions | None = None,
    *,
    n_dev: int = 1,
) -> RequestPlan:
    """Plan a request over already-loaded ``(name, [BoxSet])`` pairs:
    the ``bucket_size`` / ``_auto_chunk`` arithmetic of
    :func:`iter_consensus_chunks` over a mesh of ``n_dev`` devices as a
    value, with no file and no device work.  Runs in a
    ``plan_request`` span."""
    options = options or ConsensusOptions()
    if not loaded:
        raise ValueError("plan_request needs >= 1 loaded micrograph")
    with tlm_events.span("plan_request", micrographs=len(loaded),
                         n_dev=n_dev):
        k = len(loaded[0][1])
        nb = bucket_size(
            max(bs.n for _, sets in loaded for bs in sets)
        )
        chunk = _auto_chunk(len(loaded), k, nb, n_dev)
        names = [n for n, _ in loaded]
        single = chunk >= len(loaded)
        chunks = []
        for idx, start in enumerate(range(0, len(names), chunk)):
            part = tuple(names[start : start + chunk])
            m = -(-len(part) // n_dev) * n_dev if single else chunk
            chunks.append(
                ChunkPlan(
                    index=idx, names=part, capacity=nb, micrographs=m
                )
            )
        return RequestPlan(
            options=options,
            num_pickers=k,
            capacity=nb,
            chunk=chunk,
            n_dev=n_dev,
            chunks=tuple(chunks),
        )


def execute_request(
    loaded,
    box_size,
    options: ConsensusOptions | None = None,
    *,
    device=None,
    mesh=None,
    cancel=None,
    outcomes=None,
    journal=None,
):
    """Execute a request chunk by chunk (a generator), each chunk split
    over ``mesh`` (default :func:`request_mesh`).

    Yields ``(part, batch, result, packed, seconds)`` per chunk: the
    default fetch of :func:`iter_consensus_chunks`, whose extras are
    the packed BOX array :func:`emit_box_chunk` consumes.  ``cancel``
    is polled at every chunk boundary (by the prefetch worker, one
    chunk ahead); a truthy return raises :class:`ConsensusCancelled`.
    Failures walk the runtime ladder: retries, OOM halving, the
    per-micrograph fallback and quarantine (lenient unless
    ``options.strict``).
    """
    options = options or ConsensusOptions()
    if mesh is None:
        mesh = request_mesh(options, device)
    yield from iter_consensus_chunks(
        loaded,
        box_size,
        threshold=options.threshold,
        max_neighbors=options.max_neighbors,
        spatial=options.spatial,
        solver=options.solver,
        use_pallas=options.use_pallas,
        device=mesh[0],
        mesh=mesh,
        strict=options.strict,
        policy=options.policy(),
        outcomes=outcomes,
        journal=journal,
        cancel=cancel,
    )


@checked(Contract(
    # the serve path's execute entry: one padded chunk (M micrographs,
    # K pickers, N particle capacity) through the chunk program
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
    dims={"M": 2, "K": 3, "N": 8, "C": 64},
    static={"clique_capacity": 64, "max_neighbors": 4},
    pspecs={
        "xy": (MICROGRAPH_AXIS,),
        "conf": (MICROGRAPH_AXIS,),
        "mask": (MICROGRAPH_AXIS,),
    },
    max_trace_variants=4,
))
def consensus_chunk_program(
    xy: torch.Tensor,
    conf: torch.Tensor,
    mask: torch.Tensor,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    clique_capacity: int = 4096,
    spatial_grid: int | None = None,
    cell_capacity: int = 64,
    solver: str = "lp_device",
    use_pallas: bool = False,
    partial_capacity: int | None = None,
):
    """One chunk's device program at an explicit configuration: the
    program the batch path runs (:func:`consensus_one`), on the device
    of its inputs."""
    return consensus_one(
        xy, conf, mask, box_size,
        threshold=threshold,
        max_neighbors=max_neighbors,
        clique_capacity=clique_capacity,
        spatial_grid=spatial_grid,
        cell_capacity=cell_capacity,
        solver=solver,
        use_pallas=use_pallas,
        partial_capacity=partial_capacity,
    )


def _padding_chunk(m: int, k: int, n: int, dev: torch.device):
    """An all-padding ``(M, K, N)`` chunk: zero cliques, zero work."""
    return (
        torch.zeros((m, k, n, 2), dtype=torch.float32, device=dev),
        torch.zeros((m, k, n), dtype=torch.float32, device=dev),
        torch.zeros((m, k, n), dtype=torch.bool, device=dev),
    )


def warmup(
    num_pickers: int = 2,
    capacity: int = 64,
    *,
    box_size: float = 180.0,
    device=None,
) -> dict:
    """Run one tiny all-padding chunk program: the serve daemon's
    readiness gate.  On a CUDA device it first builds (if missing)
    and loads every kernel library, so a broken toolchain or
    kernel build turns the readiness probe red instead of failing a
    user's first fused job.  Returns a summary for the serve journal;
    ``compile_s`` is the wall of the whole gate."""
    dev = resolve_device(device)
    t0 = time.time()
    if dev.type == "cuda":
        from repic_tpu_torch import _build

        _build.build_all()
    k, n = int(num_pickers), int(capacity)
    res = consensus_chunk_program(
        *_padding_chunk(1, k, n, dev),
        float(box_size),
        max_neighbors=4,
        clique_capacity=64,
    )
    res.picked.cpu()  # waits for the chunk's device work
    return {
        "num_pickers": k,
        "capacity": n,
        "compile_s": round(time.time() - t0, 3),
    }


def parse_warmup_buckets(specs) -> list:
    """``--warmup-bucket K:N`` parser -> ``[(num_pickers, capacity),
    ...]`` (deduped, order kept); a malformed spec raises
    ``ValueError`` naming it."""
    out: list = []
    for spec in specs or ():
        try:
            k_s, n_s = str(spec).split(":", 1)
            k, n = int(k_s), int(n_s)
            if k < 2 or n < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad --warmup-bucket {spec!r} "
                "(want K:N, e.g. 3:256 — K pickers, N particle "
                "capacity, K >= 2)"
            ) from None
        if (k, n) not in out:
            out.append((k, n))
    return out


def warmup_buckets(buckets, *, box_size: float = 180.0,
                   device=None) -> list:
    """:func:`warmup` each declared ``(num_pickers, capacity)``
    bucket, for buckets an operator knows are coming."""
    return [
        warmup(k, n, box_size=box_size, device=device)
        for k, n in buckets or ()
    ]


def warmup_from_cache(
    max_programs: int | None = None,
    budget_s: float | None = 300.0,
    *,
    device=None,
) -> dict:
    """Replay every program signature recorded in the compile-cache
    sidecar (:mod:`repic_tpu_torch.runtime.compilecache`): run each as
    an all-padding chunk at that exact configuration and shape, then
    register the signature as seen, so the first real request on a
    previously served bucket is a program-cache hit.

    Returns the reference's summary: programs warmed / failed /
    skipped, the wall, and the persistent-cache hits (library loads
    from ``build/repic_tpu_torch/``), their seconds and the fresh
    builds seen meanwhile.  One unreplayable entry is counted and
    skipped; ``budget_s`` bounds the replay's wall, past which the
    rest count as skipped.
    """
    from repic_tpu_torch.runtime import compilecache
    from repic_tpu_torch.telemetry import probes as tlm_probes

    dev = resolve_device(device)
    entries = compilecache.load_programs()
    if max_programs is not None:
        entries = entries[-int(max_programs):]
    t0 = time.time()
    hits0 = tlm_probes.persistent_cache_hits()
    hit_s0 = tlm_probes.persistent_cache_hit_seconds()
    fresh0 = tlm_probes.fresh_compiles()
    warmed = failed = skipped = 0
    for i, e in enumerate(entries):
        if budget_s is not None and time.time() - t0 > budget_s:
            skipped = len(entries) - i
            break
        try:
            shape = tuple(int(v) for v in e["shape"])
            m, k, n, _ = shape
            sig = program_signature(
                e["threshold"], e["max_neighbors"],
                e["clique_capacity"], e["spatial_grid"],
                e["cell_capacity"], e["solver"], e["use_pallas"],
                e["partial_capacity"], shape,
            )
            box = (
                torch.full((k,), 180.0, dtype=torch.float32,
                           device=dev)
                if int(e.get("box_rank", 0))
                else 180.0
            )
            res = consensus_chunk_program(
                *_padding_chunk(m, k, n, dev),
                box,
                threshold=e["threshold"],
                max_neighbors=e["max_neighbors"],
                clique_capacity=e["clique_capacity"],
                spatial_grid=e["spatial_grid"],
                cell_capacity=e["cell_capacity"],
                solver=e["solver"],
                use_pallas=e["use_pallas"],
                partial_capacity=e["partial_capacity"],
            )
            # warming IS running each program to its end: the per-entry
            # sync is what counts a failed program as failed
            res.picked.cpu()  # repic: noqa[RT004]
            note_program_signature(sig)
            warmed += 1
        except Exception:  # noqa: BLE001 — per-entry best effort
            failed += 1
    return {
        "programs_warmed": warmed,
        "programs_failed": failed,
        "programs_skipped": skipped,
        "wall_s": round(time.time() - t0, 3),
        "persistent_cache_hits": (
            tlm_probes.persistent_cache_hits() - hits0
        ),
        "persistent_hit_s": round(
            tlm_probes.persistent_cache_hit_seconds() - hit_s0, 3
        ),
        "fresh_compiles": tlm_probes.fresh_compiles() - fresh0,
    }
