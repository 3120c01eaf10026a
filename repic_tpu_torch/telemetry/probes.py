"""Device telemetry probes: builds, transfers, dispatches, device memory
(the port's counterpart of ``repic_tpu.telemetry.probes``).

Spans (:mod:`repic_tpu_torch.telemetry.events`) attach per-stage
deltas of these counters, and ``report`` prints run totals.

* **Builds** -- the port compiles no program per input shape; what it
  compiles is its native code at first use: ``nvcc`` for the CUDA
  kernels (:mod:`repic_tpu_torch._build`) and ``g++`` for the host
  cores (:mod:`repic_tpu_torch.native`).  Each fresh build counts as a
  compile (``repic_recompiles_total``, ``compile_seconds``); loading a
  library already built into ``build/repic_tpu_torch/`` counts as a
  compile that was a persistent-cache hit
  (``repic_persistent_cache_hits_total``), as the reference counts an
  executable read back from its on-disk cache.
* **Transfers** -- counted at the port's own fetch sites
  (:func:`record_transfer`): the packed chunk fetches and the capacity
  probes.
* **Dispatches** -- :func:`note_dispatch` counts one call of the
  chunk program, which is many CUDA launches; the kernel wrappers
  count their own launches (``LAUNCHES``).
* **Host syncs and ascent steps** -- :func:`host_bool`,
  :func:`host_int` and :func:`note_host_sync` count the blocking
  device-to-host reads of the chunk program (a loop test, a probe, a
  boolean-mask select, the packed fetch), :func:`note_ascent_step`
  the trips of the ``lp_device`` ascent's plain loop, and
  :func:`defer_ascent_steps` those of its kernel inside a chunk, read
  after the chunk's packed fetch; :func:`chunk_counts` reads both.
  They reach the chunk's dispatch report, never the registry.
* **Device memory** -- the CUDA caching allocator's statistics,
  sampled on demand (snapshot time), never per operation.

"A CUDA run" means the process has initialised CUDA.  Then
:func:`sync_device`, :func:`device_memory` and :func:`live_buffers`
call the CUDA API and let its errors propagate; on a CPU run there is
nothing to measure and they return ``0.0``, ``{}`` and ``(0, 0)``.
The counters are module ints under one lock, cheap enough to stay live
when telemetry is disabled.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

_lock = threading.Lock()

# Device-time attribution mode (``--device-time``): spans bracket
# their sections with device syncs, splitting every stage into host
# wall time and the device tail still executing at span end.  Read
# once per span boundary.
_device_time = False


def set_device_time(flag: bool) -> None:
    """Enable/disable device-sync span bracketing (``--device-time``)."""
    global _device_time
    _device_time = bool(flag)


def device_time_enabled() -> bool:
    return _device_time


def _cuda_run() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def sync_device() -> float:
    """Block until the current CUDA device has drained every stream;
    returns the seconds spent waiting (0.0 on a CPU run).

    ``torch.cuda.synchronize`` waits for all streams of the device,
    the prefetch worker's included."""
    if not _cuda_run():
        return 0.0
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


@contextlib.contextmanager
def device_time(enabled: bool):
    """Scoped attribution mode for CLI mains: the latch is process-wide,
    so the previous value comes back on the way out."""
    if not enabled:
        yield
        return
    prev = _device_time
    set_device_time(True)
    try:
        yield
    finally:
        set_device_time(prev)


# cumulative totals (the build and fetch sites bump these; the
# registry mirrors them at publish() time)
_compiles = 0
_compile_seconds = 0.0
_transfer_bytes = 0
_transfer_fetches = 0
_device_dispatches = 0
_persistent_hits = 0
_persistent_hit_seconds = 0.0
_host_syncs = 0
_ascent_steps = 0
# per thread, while it runs a chunk: the ascent kernels' per-micrograph
# steps (card tensors) not yet counted (``steps``, None outside a chunk)
_deferred = threading.local()


def note_build(seconds: float) -> None:
    """Count one fresh build of a native library (``nvcc``/``g++``)."""
    global _compiles, _compile_seconds
    with _lock:
        _compiles += 1
        _compile_seconds += float(seconds)


def note_cached_load(seconds: float) -> None:
    """Count one load of a library already built on disk: a compile
    that was a persistent-cache hit."""
    global _persistent_hits, _persistent_hit_seconds
    note_build(seconds)
    with _lock:
        _persistent_hits += 1
        _persistent_hit_seconds += float(seconds)
    # lazy: the package __init__ imports this module
    from repic_tpu_torch.telemetry import metrics as _m

    _m.counter(
        "repic_persistent_cache_hits_total",
        "XLA executables deserialized from the persistent "
        "on-disk compilation cache",
    ).inc()


def record_transfer(nbytes: int, fetches: int = 1) -> None:
    """Count one (or more) host<->device transfers of ``nbytes``."""
    global _transfer_bytes, _transfer_fetches
    with _lock:
        _transfer_bytes += int(nbytes)
        _transfer_fetches += int(fetches)


def note_dispatch(n: int = 1) -> None:
    """Count ``n`` calls of the chunk program."""
    global _device_dispatches
    with _lock:
        _device_dispatches += int(n)


def note_host_sync(n: int = 1) -> None:
    """Count ``n`` blocking device-to-host reads on the chunk path.  A
    read on a CPU tensor counts too: the count is of the program's
    sync sites, the same on either device."""
    global _host_syncs
    with _lock:
        _host_syncs += int(n)


def host_bool(t: torch.Tensor) -> bool:
    """``bool(t)``, counted as one host sync."""
    note_host_sync()
    return bool(t)


def host_int(t: torch.Tensor) -> int:
    """``int(t)``, counted as one host sync."""
    note_host_sync()
    return int(t)


def note_ascent_step() -> None:
    """Count one trip of the ``lp_device`` dual ascent's loop."""
    global _ascent_steps
    with _lock:
        _ascent_steps += 1


def defer_ascent_steps(t: torch.Tensor) -> None:
    """Count the trips of an ascent that ran as one kernel launch in
    the chunk this thread runs: the largest of its per-micrograph steps
    ``t`` (a card tensor), which is the trip count of the batched loop
    it replaces.  The launch syncs nothing: the chunk's last
    :func:`chunk_counts`, after its packed fetch has drained the
    stream, reads ``t``.  Outside a chunk (the runtime ladder's rung, a
    contract probe) nothing is kept or counted."""
    pending = getattr(_deferred, "steps", None)
    if pending is not None:
        pending.append(t)


def chunk_counts(*, first: bool = False) -> tuple[int, int]:
    """(host syncs, ascent steps) so far, over every thread: the marks
    a chunk's dispatch report is cut from.  The chunk's first mark
    (``first``) opens this thread's list of deferred ascent steps; a
    later mark reads the list in and closes it.  The read is one
    counted host sync, on the thread's own stream after the packed
    fetch: it waits for no work."""
    global _ascent_steps
    pending = getattr(_deferred, "steps", None)
    _deferred.steps = [] if first else None
    if pending:
        # a mesh chunk's launches are on its cards: one read from the
        # first
        home = pending[0].device
        flat = torch.cat([t.reshape(-1).to(home) for t in pending]).cpu()
        note_host_sync()
        steps = sum(int(x.max()) for x in
                    flat.split([t.numel() for t in pending]) if x.numel())
        with _lock:
            _ascent_steps += steps
    return _host_syncs, _ascent_steps


def counters() -> tuple[int, int, int]:
    """(compiles, transfer_bytes, transfer_fetches): the cumulative
    counters spans diff at their boundaries."""
    return _compiles, _transfer_bytes, _transfer_fetches


def persistent_cache_hits() -> int:
    """Loads of a library already built on disk, so far."""
    return _persistent_hits


def persistent_cache_hit_seconds() -> float:
    """Cumulative seconds of those loads."""
    return _persistent_hit_seconds


def fresh_compiles() -> int:
    """Builds that were not loads of a library already on disk."""
    return max(_compiles - _persistent_hits, 0)


def compile_seconds() -> float:
    """Cumulative build (and cached-load) seconds so far: the delta a
    chunk's ``compile`` trace segment is cut from."""
    return _compile_seconds


def device_memory() -> dict:
    """The caching allocator's statistics of the current CUDA device:
    ``bytes_in_use`` (allocated now), ``peak_bytes_in_use`` and
    ``bytes_limit`` (the device's total memory); ``{}`` on a CPU run."""
    if not _cuda_run():
        return {}
    stats = torch.cuda.memory_stats()
    _free, total = torch.cuda.mem_get_info()
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
    }


def live_buffers() -> tuple[int, int]:
    """(count, bytes) of the allocator's active blocks; (0, 0) on a CPU
    run."""
    if not _cuda_run():
        return 0, 0
    stats = torch.cuda.memory_stats()
    return (
        int(stats.get("active.all.current", 0)),
        int(stats.get("active_bytes.all.current", 0)),
    )


def snapshot(sample_memory: bool = True) -> dict:
    """One JSON-safe sample of every probe (used by publish/report)."""
    out = {
        "recompiles": _compiles,
        "compile_seconds": round(_compile_seconds, 6),
        "transfer_bytes": _transfer_bytes,
        "transfer_fetches": _transfer_fetches,
        "device_dispatches": _device_dispatches,
    }
    if sample_memory:
        mem = device_memory()
        if mem:
            out["device_memory"] = mem
        n, nbytes = live_buffers()
        out["live_buffer_count"] = n
        out["live_buffer_bytes"] = nbytes
    return out


def publish(registry=None, baseline: dict | None = None,
            sample_memory: bool = True) -> dict:
    """Mirror the probe totals into the metrics registry as gauges;
    returns the snapshot it published.

    With ``baseline`` (an earlier :func:`snapshot`) the cumulative
    counters are published as deltas: a run's sinks report that run's
    numbers, not the process lifetime's.  ``sample_memory=False``
    (the streaming flushes) leaves the memory gauges untouched.
    Gauge names and help strings are the reference's."""
    from repic_tpu_torch.telemetry import metrics as _metrics

    reg = registry or _metrics.get_registry()
    snap = snapshot(sample_memory=sample_memory)
    if baseline:
        for key in (
            "recompiles",
            "compile_seconds",
            "transfer_bytes",
            "transfer_fetches",
            "device_dispatches",
        ):
            snap[key] = snap[key] - baseline.get(key, 0)
    reg.gauge(
        "repic_recompiles_total",
        "XLA backend compiles observed by jax.monitoring",
    ).set(snap["recompiles"])
    reg.gauge(
        "repic_compile_seconds_total",
        "cumulative XLA backend compile wall time",
    ).set(snap["compile_seconds"])
    reg.gauge(
        "repic_transfer_bytes_total",
        "host<->device bytes moved by instrumented fetch sites",
    ).set(snap["transfer_bytes"])
    reg.gauge(
        "repic_transfer_fetches_total",
        "host<->device round trips at instrumented fetch sites",
    ).set(snap["transfer_fetches"])
    reg.gauge(
        "repic_device_dispatches_total",
        "device-program launches at instrumented dispatch sites",
    ).set(snap["device_dispatches"])
    if sample_memory:
        reg.gauge(
            "repic_live_buffer_count", "live device arrays at publish"
        ).set(snap.get("live_buffer_count", 0))
        reg.gauge(
            "repic_live_buffer_bytes",
            "live device array bytes at publish",
        ).set(snap.get("live_buffer_bytes", 0))
        mem = snap.get("device_memory", {})
        if mem:
            g = reg.gauge(
                "repic_device_memory_bytes",
                "allocator stats of device 0 (absent on CPU)",
            )
            for key, val in mem.items():
                g.set(val, stat=key)
    return snap

