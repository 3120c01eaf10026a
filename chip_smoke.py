#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``repic_tpu_torch``).

Needs one CUDA GPU (an H100; the kernels are built for ``sm_90a``) and
the CUDA toolkit; imports no JAX.  Run from the repository root:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit; build every kernel source
   (one ``nvcc`` per source, all at once), print ptxas's register and
   spill lines, and fail if any kernel spills;
2. hold each kernel against its plain PyTorch version on the card —
   on the reference kernels' contract ladders and the ascent kernel's
   (shared, split and global residency) (kernel 1 at d = 1, 4,
   8, 16, 24, 32 and 48, also with N not a multiple of its anchors per
   block, M past one staged tile, every anchor or every candidate
   masked, negative thresholds and per-item box sizes; kernel 2 at
   d = 1, 4, 8, 16 and 24, and on an all-masked micrograph; kernel 3
   also with no valid clique and with every clique valid) and at the
   main path's
   chunk shape (32 micrographs of the synthetic set): integer and
   boolean outputs equal, floats equal (tolerance 0); print kernel 3's
   chain at the chunk (ascent steps, greedy rounds, block barriers);
3. run ``python -m repic_tpu_torch consensus examples/10017 OUT 180``
   for ``lp_device``, ``lp_device --pallas`` and ``lp_device_fused``
   and compare every BOX file byte for byte with the JAX package's
   golden output (``tests/golden/torch_port_10017``);
4. run a seeded 256-micrograph directory at the 10017 density
   (8 chunks of 32 at N = 1024) through ``run_consensus_dir`` with
   ``lp_device_fused`` and with ``lp_device --pallas``: every kernel's
   launch count is reset just before and read just after, must be
   above 0, and no chunk may be demoted; both outputs must be
   byte-identical; prints micrographs per second, the warm run's
   load / compute / write split, and the device's busy share in a
   third run under ``torch.profiler``;
5. after phases 6 to 16, print the ``{"kernels": [...]}`` line
   (launches, kernel and plain times, bound, max abs error; kernel 1's
   and the ascent kernel's entries carry the k5_mixed chunk as
   ``k5_chunk``, the ascent kernel's its launches by residency), the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``;
6. ``stress_50k`` (the dense-field configuration: 50,000 particles x
   4 pickers, box 180; the spatial path with the anchor-chunked
   assembly): write the seed-0 field as BOX files, run
   ``run_consensus_dir`` (spatial auto) with ``lp_device`` and
   ``greedy`` on the golden micrographs and hold every BOX file's
   sha256, row count and clique count to the JAX digests
   (``tests/golden/torch_port_digests.json``); then a warm pass over
   :data:`STRESS_WARM` = 64 of the configuration's 128 micrographs with
   its load / compute / write split, micrographs per second, accepted
   capacities, peak device memory and, in a profiled run of the golden
   directory, the device's busy share;
7. ``k5_mixed`` (5 pickers of box sizes 180, 200, 220, 160, 180, 700
   particles each; the staged join): the golden micrographs with
   ``lp_device``, ``lp_device --pallas`` (kernel 1 must launch),
   ``lp_device_fused`` (every chunk must be demoted: D^4 is outside the
   fused envelope) and ``greedy``, each against the JAX digests; kernel
   1 at this chunk's shape (M = 16, K = 5, N = 768, the accepted d, the
   per-picker sizes as device views) against its plain version, with
   its time, device time and bound; the ascent kernel on the solver
   inputs of that chunk's accepted attempt, likewise; then a warm pass
   over the
   :data:`K5_WARM` = 512 of the configuration's 1,024 micrographs;
8. the rest of the flags, through the CLI's parser and commands in this
   process (the escalation memo cleared and the launch counts set to 0
   before each run), each output file held to the JAX digests
   (``tests/golden/torch_port_flags_digests.json``): ``consensus
   --multi_out``, ``--get_cc`` and both on 10017 under ``lp_device``
   (the ascent kernel must launch), ``lp_device --pallas`` (kernel 1
   and the ascent kernel must launch) and ``lp_device_fused`` (kernels
   2 and 3 must launch, no chunk demoted); ``--solver exact`` and ``--solver lp``; ``get_cliques``
   (plain, ``--multi_out``, ``--get_cc``; pickles by content) then
   ``run_ilp`` with each backend; ``--stripes 4`` on the two
   ``stress_50k`` golden micrographs under ``lp_device`` and ``lp``,
   with each micrograph's seconds, stripe capacity, accepted
   capacities and the peak device memory; last, the seconds to read
   the synthetic and stress BOX files with the native parser and with
   the line loop;
9. the fault-tolerant runtime (``tests/golden/
   torch_port_runtime_digests.json``): (a) ``consensus --solver
   lp_device_fused`` on 10017 with one BOX file unreadable and
   ``REPIC_TPU_FAULTS`` halving a chunk and demoting a micrograph --
   11 BOX files and the journal equal the JAX run's, kernels 2 and 3
   launched -- then ``--resume`` after the repair (all 12); (b)
   ``--strict`` on that input exits non-zero naming the file; (c)
   ``synthetic_256`` fused and ``--pallas`` with the chunk prefetch on
   and off, :data:`PREFETCH_PAIRS` alternating warm pairs each, every
   run's BOX bytes equal to phase 4's, with the medians and ranges of
   the wall, ``load_s``, ``compute_s`` and ``write_s``; (d) two
   processes over one capacity-config sidecar in a temporary HOME, both
   runs' BOX files and the sidecar equal to the JAX package's.  Every
   other phase runs with the sidecar off;
10. the observability layer (``tests/golden/
   torch_port_telemetry_digests.json``): (a) ``consensus`` on 10017
   with ``--profile DIR --device-time --status-port 0``, fused and
   ``--pallas``, in a process of its own while a poller reads
   ``/healthz``, ``/healthz/ready``, ``/status`` and ``/metrics``: the
   BOX files equal the goldens, the output directory holds the
   reference's files, the projected counters, spans, trace segments and
   journal trace ids equal the JAX digest, ``report`` and ``trace``
   exit 0, the report's profiler section has ``0 < device_busy_s <=
   wall_s`` and at least the wrappers' launches as device ops, the
   trace names the run's kernels, and the allocator gauges are set;
   a fused run in chunks of 2 must answer 200 on all four paths while
   it runs; (b) telemetry on against ``REPIC_TPU_TELEMETRY``'s off
   switch on ``synthetic_256``, fused and ``--pallas``,
   :data:`TELEMETRY_PAIRS` alternating warm pairs each, every run's
   BOX bytes equal to phase 4's, with the medians and ranges of the
   wall, ``load_s``, ``compute_s`` and ``write_s``; (c) one
   ``--device-time --profile`` run of ``k5_mixed``'s 32 golden
   micrographs and of ``stress_50k``'s 2, held to the JAX digests,
   with each stage's ``host_s``, ``device_tail_s``, ``device_frac``
   and the dispatch gap;
11. the engine and the serve daemon (``tests/golden/
   torch_port_serve_digests.json``): (a) ``ConsensusDaemon(device=
   "cuda", warmup=True, warmup_buckets=[(3, 1024)])`` in this process
   serves 10017 fused, ``--pallas`` and ``lp_device``, one job after
   another: every artifact fetched over HTTP equals the JAX golden, the
   job document, run journal and request journal equal the JAX
   daemon's, and the kernels of each job's options launched (none for
   ``lp_device``); (b) the synthetic set cut into bench_serve's burst
   (16 small jobs of 1-8 micrographs and one of the other 184), posted
   from :data:`SERVE_CLIENTS` client threads to a fresh daemon under
   ``batch`` and ``single``, fused and ``--pallas``: one cold burst and
   :data:`SERVE_ROUNDS` warm ones, each of phase 4's BOX files served
   once and equal to it, with the burst wall, micrographs per second,
   the small jobs' nearest-rank p95 accept-to-terminal latency,
   coalesced jobs per chunk and the program-cache hits and misses; (c)
   ``python -m repic_tpu_torch serve`` as a process on the card: a
   ``server_crash`` at the first chunk boundary exits 24 and the
   restart finishes both jobs with the golden bytes; two more restarts
   there, the compile-cache sidecar's replay off and on, each give the
   time to readiness, the replay's wall and the first job's latency; a
   SIGTERM mid-job turns readiness red and exits 0 with the job
   journaled; ``--tenants`` answers 401, 403 and 429;
12. the CNN picker and the host utilities (``tests/golden/
   torch_port_picker/``, ``tests/golden/torch_port_utilities_digests.json``):
   (a) ``python -m repic_tpu_torch pick`` (in this process) with the
   committed JAX-written deep checkpoint on two seeded 4096 x 4096
   micrographs (``utils/synthetic.py: synthetic_micrograph``, particle
   size 180), patch / float32, fcn / float32 and patch / ``--bf16``,
   each twice with byte-identical BOX files; the score maps of the same
   inputs (``infer.score_micrograph_*``) within 1e-4 of the JAX float32
   maps (``--bf16``: 3e-2); JAX's maps through the port's peak picking
   on the card give JAX's BOX bytes, and the port's picks sit at JAX's
   grid cells up to near-ties (at most 1%); prints seconds per
   micrograph, windows per second, peak device memory, the device's
   busy share of a profiled pick and the conv stack's FLOP bound, and
   whether the card's z-scored micrograph and patch resize are the
   CPU's bits; (b) ``greedy_suppress_device`` on the card at P = 1,024
   and 4,096 against the host loop: keep masks equal, both times;
   (c) ``convert`` over the 10017 BOX files through 9 chains (every
   output's sha256 equal to the JAX digests), ``score`` cryolo vs
   topaz rasterized on the card (within rel 1e-6 of
   ``tests/golden/ref_scores_cryolo_vs_topaz_10017.tsv``), ``score
   --match distance`` (``results.txt`` equal to the executed
   reference's) and ``build_subsets`` (split membership equal to the
   JAX digest);
13. the picker's training half and the iterative loop (none reaches a
   CUDA kernel of this repo; ``tests/golden/torch_port_training/``):
   (a) ``python -m repic_tpu_torch fit`` in a process of its own, deep
   architecture, batch 128, :data:`FIT_EPOCHS` epochs, on four seeded
   4096 x 4096 micrographs labelled at their planted centres (box 180)
   and validated on a fifth -- twice in float32, whose checkpoints must
   be byte-identical, and once ``--bf16`` (within 1.5 points of the
   float32 val error); the best val error under :data:`FIT_VAL_LIMIT`;
   prints patches, steps per second, seconds per epoch, peak device
   memory, a step's FLOP bound, and the device's busy share of a
   two-epoch fit in this process under ``torch.profiler``; (b) one
   update on the card from the committed JAX step (parameters, batch,
   labels, dropout mask) within the CPU test's tolerances, the learning
   rates bitwise optax's; (c) ``pick`` with (a)'s checkpoint on two
   held-out micrographs: F1 against the planted centres, candidates per
   micrograph, whether the device NMS ran; (d) ``iter_config`` then
   ``iter_pick`` through the CLI with the builtin deep/wide/slim
   ensemble on 12 micrographs (``--semi_auto`` from the planted
   centres, one round, train 100%, ``--score``): seconds per stage from
   ``iter_pick.log``, the final test-split F1 above 0.5, and a rerun
   that must resume and do nothing;
14. the multi-host layer, every process a fresh interpreter on
   ``cuda:0`` after phase 1 built the kernels: (a) ``synthetic_256``
   as 3 ``consensus --coordination-dir`` host processes sharing one
   output and coordination directory (``--solver lp_device_fused``,
   chunks of :data:`CLUSTER_CHUNK`, the CLI's 2 s heartbeat and 10 s
   timeout), host 1 dying through ``host_crash`` after its second
   chunk (exit 23), then 2 hosts with ``lp_device --pallas`` and no
   fault: both runs' BOX files equal phase 4's, nothing lost or
   quarantined, the survivors' ``work_reassigned`` and
   ``reassigned_from`` counts nonzero, ``report``'s cluster section,
   each host's ``chunk_dispatches`` events against its launches; each
   host's wall, the crash-to-fence time and the reassigned count; (b)
   3 ``serve --fleet-dir`` replica processes (heartbeat 0.2 s, timeout
   1 s, chunks of 1): 10017 fused once undisturbed, then again with the
   replica running it SIGKILLed after its first chunk lands -- the job
   finishes on a survivor under its id with the golden artifacts, one
   completion token, one terminal record and a journaled
   ``job_reassigned`` --; phase 11b's burst split with ``--pallas``
   across the two survivors, every BOX file equal to phase 4's; then
   SIGTERM: every replica exits 0 and no lease is orphaned; the job's
   wall with and without the kill, the burst's wall and micrographs per
   second, each replica's launches off ``/status``; (c)
   ``synthetic_256`` fused in this process with ``use_mesh=True`` over
   ``consensus_mesh()`` (the card count is printed: one card here, so
   a split over several cards is not exercised), its bytes equal to
   phase 4's;
15. the gang and the runtime sanitizers: (a) ``consensus --gang`` as
   one process on ``synthetic_256``, fused and ``lp_device --pallas``:
   phase 4's bytes, every kernel of the setting launched, no chunk
   demoted, the wall; (b) a :data:`GANG_WORLD`-process gang on
   ``cuda:0`` from torchrun's variables (gloo collectives, fused,
   global chunks of :data:`GANG_CHUNK`), the victim dying through
   ``gang_peer_crash`` at its second chunk's collective (exit 27): the
   survivors classify ``peer_dead``, fence it, re-form a two-process
   gang and finish with phase 4's bytes, 0 lost and 0 written twice,
   ``report``'s gang section; the crash-to-re-formation seconds and
   each process's wall; (c) KERNELCHECK on the card over the three
   kernels' ladders (0 violations, and a flip planted in kernel 3's
   output recorded), DISPATCHCHECK over a fused and a ``--pallas`` run
   of ``synthetic_256`` (every window within budget; the largest per
   entry), LOCKCHECK armed from its variable in a served 10017 job's
   daemon process and a cluster run's process (0 cycles, 0 unguarded
   writes, the package's module-level locks among the checked ones);
   (d), run before (c), the same gang launched as the README says,
   ``torchrun --nproc-per-node`` :data:`GANG_WORLD` on ``cuda:0``:
   phase 4's bytes in one epoch;
16. the static analysis layer: (a) ``python -m repic_tpu_torch lint
   repic_tpu_torch --concurrency --spmd --cost --format sarif`` in a
   process of its own under ``-X importtime``: exit 0, 0 results, and
   no ``torch`` module among that process's imports; its wall and the
   results of each pass; (b) ``semantic.run_check`` over the package
   on ``cuda`` in this process: every ``@checked`` entry of the
   registry checked (and its route printed), 0 findings, 0 skips, the
   launch counts of kernels 1-3 reset just before and each above 0
   just after; (c) a divergence planted in kernel 3's contract
   reference on its last rung: RT425 fires and names the entry and the
   rung; (d) each step's seconds.

Times are CUDA-event means over repeated calls after a warm-up: what a
caller of the wrapper waits, host work between launches included.
Phase 2 also prints each kernel's own device time per call, summed
from ``torch.profiler``'s kernel records.
Logs and the report go to ``chiprun_out/chip_smoke/``; the BOX
directories to ``build/chip_smoke/``, deleted at the end.
"""

import filecmp
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
#: the BOX directories the run writes and reads (hundreds of MB; removed
#: when the run ends)
WORK = os.path.join(REPO, "build", "chip_smoke")
EXAMPLES = os.path.join(REPO, "examples", "10017")
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_10017")
BOX = 180
CHUNK = 32
N_SYNTH = 256
DIGESTS = os.path.join(REPO, "tests", "golden", "torch_port_digests.json")
FLAG_DIGESTS = os.path.join(REPO, "tests", "golden",
                            "torch_port_flags_digests.json")
RUNTIME_DIGESTS = os.path.join(REPO, "tests", "golden",
                               "torch_port_runtime_digests.json")
#: warm runs per side of phase 9's prefetch on/off comparison (phases 10
#: and 14 share the time limit)
PREFETCH_PAIRS = 3
#: warm runs per side of phase 10b's telemetry on/off comparison (10
#: before phase 14 shared the time limit, 6 before phase 15: the call
#: at 6 ran 1,078.9 s of its 1,200 s on an H100 at 700 W)
TELEMETRY_PAIRS = 4
TELEMETRY_DIGESTS = os.path.join(REPO, "tests", "golden",
                                 "torch_port_telemetry_digests.json")
SERVE_DIGESTS = os.path.join(REPO, "tests", "golden",
                             "torch_port_serve_digests.json")
#: warm burst rounds after phase 11b's cold one (one, so that the
#: earlier phases keep their depth inside the time limit), and its
#: client threads
SERVE_ROUNDS = 1
SERVE_CLIENTS = 4
#: the status server's paths phase 10 polls
STATUS_PATHS = ("/healthz", "/healthz/ready", "/status", "/metrics")
#: per phase-10 setting: the wrappers whose launches the run must show,
#: and the kernels its profiler trace must name
LAUNCH_KEYS = {"lp_device_fused": ("fused_clique_candidates",
                                   "fused_dual_solve"),
               "lp_device_pallas": ("topk_neighbors", "dual_ascent"),
               "lp_device": ("dual_ascent",)}
TRACE_KERNELS = {"lp_device_fused": ("clique_count_kernel",
                                     "clique_write_kernel",
                                     "dual_solve_kernel"),
                 "lp_device_pallas": ("topk_neighbors_kernel",
                                      "dual_ascent_kernel")}
#: phase 14a's micrographs per chunk (each host's third of the
#: synthetic set is then 6 chunks)
CLUSTER_CHUNK = 16
#: phase 14b's replica heartbeat and timeout (fast, as the reference's
#: fleet chaos test)
FLEET_HB, FLEET_TIMEOUT = "0.2", "1.0"
#: the device of phase 14's child processes: the entry points' default
CHILD_DEVICE = "cuda"
#: micrographs in the warm passes of the two dense configurations (half
#: of each configuration's count since phase 15: the call with the full
#: counts ran 1,078.9 s of its 1,200 s on an H100 at 700 W)
STRESS_WARM = 64
K5_WARM = 512

# H100 SXM peaks (NVIDIA data sheet, at a 700 W limit): HBM3 bytes/s,
# and float32 instructions/s outside the tensor cores.  The data sheet's
# 67 TFLOP/s counts a fused multiply-add as two operations; the bounds
# below count single instructions (add, compare, min, max, divide, no
# fused multiply-add), of which the card issues half as many: 33.5e12/s.
PEAK_BYTES = 3.35e12
PEAK_INSTR = 67e12 / 2


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warm: int = 2) -> float:
    """Host time per call of ``fn`` to issue its work, without waiting
    for the card (the queue is drained before and after)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_busy(fn):
    """One call of ``fn`` under ``torch.profiler``: ``(wall_s, busy_s,
    top)`` where ``busy_s`` is the union of the device's kernel and copy
    intervals and ``top`` the six kernels with the most device time.
    ``busy_s`` is None when the profiler saw no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, en = e.time_range.start, e.time_range.end
        spans.append((s, en))
        by_name[e.name] = by_name.get(e.name, 0.0) + (en - s) / 1e6
    busy, end = 0.0, float("-inf")
    for s, en in sorted(spans):
        if en > end:
            busy += en - max(s, end)
            end = en
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall, (busy / 1e6 if spans else None), top


def device_ms(fn, reps: int, kernel: str):
    """Device time per call of ``fn`` spent in the kernels whose name
    contains ``kernel``, from ``torch.profiler`` over ``reps`` calls
    after a warm-up: the kernels alone, without the host's work between
    launches.  None when the profiler saw no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name)
    return us / 1e3 / reps if us else None


def bound(nbytes: float, ops: float):
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_INSTR
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def ascent_work(valid, k, v, steps):
    """The ascent kernel's bytes (its inputs read once, its outputs
    written once) and operations (per step, each valid clique's k
    gathers, adds and a compare; each vertex's price step), and the
    bytes of its staged clique list read once a step (uint16 ids and
    a float weight per valid clique)."""
    m, c = valid.shape
    n_cl = valid.sum(-1).double().cpu()
    steps = steps.double().cpu()
    nbytes = m * c * (4 * k + 4 + 1) + m * v * 8 + m * 8
    ops = float((steps * (n_cl * (k + 2) + 6.0 * v)).sum())
    staged = float((steps * n_cl).sum()) * (2 * k + 4)
    return nbytes, ops, staged


def compare(name, got, want):
    """Exact equality of every output; returns the max abs float error
    (0.0 when equal)."""
    import torch

    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(
                f"{name} output {i}: {g.dtype}{tuple(g.shape)} vs "
                f"{w.dtype}{tuple(w.shape)}"
            )
        if g.dtype.is_floating_point:
            if g.numel():
                err = max(err, float((g - w).abs().max()))
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"{name} output {i}: {bad} entries differ")
    return err


# -- phase 2 inputs ---------------------------------------------------


def ladder_k1():
    """Kernel 1's cases: ``(label, (xy_a, mask_a, xy_b, mask_b, size_a,
    size_b), threshold)``."""
    import numpy as np
    import torch

    def inputs(n, m, seed):
        rng = np.random.default_rng(seed)
        xa = rng.uniform(0, 2000.0, (n, 2)).astype(np.float32)
        xb = rng.uniform(0, 2000.0, (m, 2)).astype(np.float32)
        ma = rng.uniform(size=n) > 0.15
        mb = rng.uniform(size=m) > 0.15
        return xa, ma, xb, mb

    def card(*arrays):
        return [torch.from_numpy(a).cuda() for a in arrays]

    # the reference ladder; N not a multiple of the 8 anchors per
    # block; M past one staged tile of 1,024
    for n, m in ((64, 128), (96, 256), (40, 70), (61, 300), (37, 2100)):
        yield f"N{n} M{m}", (*card(*inputs(n, m, n + m)), BOX, BOX), 0.3
    xa, ma, xb, mb = inputs(96, 256, 352)
    # ~100 positive IoUs per anchor: kernel 1's buffer keeps its top d
    # mid-scan
    dense = inputs(64, 300, 23)
    dense[2][:20] = dense[2][20:40]
    yield "dense N64 M300", (*card(dense[0] * 0.3, dense[1],
                                   dense[2] * 0.3, dense[3]), BOX, BOX), 0.3
    none_a, none_b = np.zeros_like(ma), np.zeros_like(mb)
    yield "all anchors masked", (*card(xa, none_a, xb, mb), BOX, BOX), 0.3
    yield "all candidates masked", (*card(xa, ma, xb, none_b), BOX,
                                    BOX), 0.3
    # zero IoUs count below 0, masked pairs' -1 below -1
    for thr in (-0.5, -2.0):
        yield f"threshold {thr}", (*card(xa, ma, xb, mb), BOX, BOX), thr
    # enumerate_cliques' batch at K = 4 (3 micrographs): picker 0's
    # box 180 against boxes 150, 200, 180 (host tensors, per item)
    rng = np.random.default_rng(17)
    mk, k, n = 3, 4, 200
    xy = (rng.uniform(0, 1500.0, (mk, 1, n, 2))
          + rng.normal(0, 30.0, (mk, k, n, 2))).astype(np.float32)
    mask = rng.uniform(size=(mk, k, n)) > 0.15
    xy, mask = card(xy, mask)
    b = mk * (k - 1)
    sizes = torch.tensor([180.0, 150.0, 200.0, 180.0])
    yield "K4 per-picker sizes", (
        xy[:, :1].expand(mk, k - 1, n, 2).reshape(b, n, 2),
        mask[:, :1].expand(mk, k - 1, n).reshape(b, n),
        xy[:, 1:].reshape(b, n, 2), mask[:, 1:].reshape(b, n),
        sizes[0].expand(b), sizes[1:].repeat(mk)), 0.3


def ladder_k2():
    import numpy as np
    import torch

    # the reference ladder, then the envelope's upper picker counts
    for k, n in ((3, 64), (3, 96), (2, 40), (4, 24), (5, 16), (6, 12)):
        rng = np.random.default_rng(1000 * k + n)
        base = rng.uniform(0, 1500.0, (n, 2))
        xy = (base[None] + rng.normal(0, 25.0, (k, n, 2))).astype(
            np.float32)
        conf = rng.uniform(0.5, 1.0, (k, n)).astype(np.float32)
        mask = rng.uniform(size=(k, n)) > 0.15
        yield f"K{k} N{n}", [torch.from_numpy(a)[None].cuda()
                             for a in (xy, conf, mask)]
        if (k, n) == (3, 64):
            yield "K3 N64 all masked", [
                torch.from_numpy(a)[None].cuda()
                for a in (xy, conf, np.zeros_like(mask))]


def ladder_k3():
    import numpy as np
    import torch

    from repic_tpu_torch.utils.synthetic import near_tie_packings

    # the reference ladder (V = 64), then two micrographs whose solve
    # state (C = 20000, V = 3072) outgrows shared memory: global scratch
    for c, k, v, m in ((16, 3, 64, 1), (100, 4, 64, 1), (128, 2, 64, 1),
                       (20000, 3, 3072, 2)):
        rng = np.random.default_rng(7 * c + k)
        mv = rng.integers(0, v, (m, c, k)).astype(np.int32)
        w = rng.uniform(0.1, 1.0, (m, c)).astype(np.float32)
        valid = rng.uniform(size=(m, c)) > 0.2
        yield f"C{c} K{k} V{v}", v, [torch.from_numpy(a).cuda()
                                     for a in (mv, w, valid)]
        if (c, k) == (100, 4):
            for what, fill in (("no valid", np.zeros_like(valid)),
                               ("all valid", np.ones_like(valid))):
                yield f"C{c} K{k} V{v} {what}", v, [
                    torch.from_numpy(a).cuda() for a in (mv, w, fill)]
    # candidates a float32 rounding apart: the order of the objective
    # sums decides (one and two levels of window sums)
    for gadgets, background in ((1, 60), (2, 200), (4, 5000)):
        *arrays, v = near_tie_packings(32, gadgets, background, seed=1)
        yield (f"near-tie C{3 * gadgets + background}", v,
               [torch.from_numpy(a).cuda() for a in arrays])


# -- phases 6 and 7: the dense configurations --------------------------


def reset_counts():
    from repic_tpu_torch.ops import iou_pallas, megakernel

    iou_pallas.LAUNCHES = 0
    for key in megakernel.LAUNCHES:
        megakernel.LAUNCHES[key] = 0
    megakernel.DEMOTIONS = 0


def read_counts() -> dict:
    from repic_tpu_torch.ops import iou_pallas, megakernel

    return {"topk_neighbors": iou_pallas.LAUNCHES, **megakernel.LAUNCHES,
            "demotions": megakernel.DEMOTIONS}


def clear_memo():
    from repic_tpu_torch.pipeline import consensus

    consensus._LAST_GOOD_CONFIG.clear()
    consensus._RECENT_REQUIREMENTS.clear()


def accepted_config():
    """The escalation memo's (d, cap, cell_cap, pcap): its one entry,
    or the list of them when chunks of several shapes ran."""
    from repic_tpu_torch.pipeline import consensus

    cfgs = [list(c) for c in consensus._LAST_GOOD_CONFIG.values()]
    return cfgs[0] if len(cfgs) == 1 else cfgs


def run_dir(in_dir, out, box, **kw):
    """``run_consensus_dir`` on the card with the launch counts set to
    0 just before; returns ``(stats, wall_s, counts)``."""
    import torch

    from repic_tpu_torch.pipeline import consensus

    reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    st = consensus.run_consensus_dir(in_dir, out, box, device="cuda", **kw)
    torch.cuda.synchronize()
    return st, time.time() - t, read_counts()


def check_digests(label, out_dir, stats, want):
    """Every micrograph's BOX sha256, row count and clique count equal
    the JAX digest golden."""
    from repic_tpu_torch.utils.synthetic import file_sha256

    bad = []
    for name, w in want.items():
        path = os.path.join(out_dir, name + ".box")
        with open(path) as f:
            rows = sum(1 for _ in f)
        got = {"sha256": file_sha256(path), "rows": rows,
               "num_cliques": stats["clique_counts"].get(name)}
        if got != w:
            bad.append((name, got, w))
    if bad:
        raise AssertionError(
            f"{label}: {len(bad)} of {len(want)} micrographs differ from "
            f"the JAX digests; first: {bad[0]}")
    log(f"  {label}: {len(want)} BOX files equal the JAX digests "
        f"(sha256, rows, cliques)")


def golden_input(cell, golden):
    """Write the cell's golden micrographs; their tree digest must be
    the one the goldens were made from."""
    from repic_tpu_torch.utils.synthetic import tree_sha256, write_cell_dir

    src = os.path.join(WORK, cell + "_golden_in")
    box = write_cell_dir(cell, src, golden["micrographs"])
    if tree_sha256(src) != golden["input_sha256"]:
        raise AssertionError(f"{cell}: generated input differs from the "
                             "golden's (numpy stream or writer changed)")
    return src, box


def warm_pass(cell, m, setting):
    """``m`` micrographs of ``cell`` with the escalation memo left warm
    by the golden runs: the rate, the split, the accepted capacities
    and the peak device memory."""
    import torch

    from repic_tpu_torch.utils.synthetic import write_cell_dir

    src = os.path.join(WORK, f"{cell}_in")
    t = time.time()
    box = write_cell_dir(cell, src, m)
    gen_s = time.time() - t
    torch.cuda.reset_peak_memory_stats()
    st, wall, counts = run_dir(src, os.path.join(WORK, f"{cell}_out"), box,
                               solver=setting)
    peak = torch.cuda.max_memory_allocated()
    res = {
        "micrographs": m, "setting": setting, "generate_s": gen_s,
        "wall_s": wall, "micrographs_per_s": m / wall,
        "load_s": st["load_s"], "compute_s": st["compute_s"],
        "write_s": st["write_s"], "chunks": st["chunks"],
        "chunk": st["chunk"], "capacity": st["capacity"],
        "num_cliques": st["num_cliques"],
        "particles": sum(st["particle_counts"].values()),
        "config": accepted_config(), "peak_device_bytes": peak,
        "launches": counts,
    }
    if len(st["particle_counts"]) != m or res["particles"] <= 0:
        raise AssertionError(f"{cell} warm pass: {st['particle_counts']}")
    log(f"phase {'6' if cell == 'stress_50k' else '7'}: {cell} warm pass, "
        f"{m} micrographs ({setting}): wall {wall:.2f}s = "
        f"{m / wall:.2f} micrographs/s; load {st['load_s']:.3f}s, compute "
        f"{st['compute_s']:.3f}s, write {st['write_s']:.3f}s; "
        f"{st['chunks']} chunks of {st['chunk']} at N = {st['capacity']}; "
        f"(d, cap, cell_cap, pcap) = {res['config']}; peak device memory "
        f"{peak / 2**30:.2f} GiB; {res['particles']} particles")
    return res


def profiled(label, src, box, setting):
    """A warm run of ``src`` under the profiler: the device busy share."""
    from repic_tpu_torch.pipeline import consensus

    out = os.path.join(WORK, label + "_profiled")
    wall, busy, top = device_busy(lambda: consensus.run_consensus_dir(
        src, out, box, solver=setting, device="cuda"))
    if busy is None:
        log(f"  {label}: device busy share not measured (the profiler saw "
            "no device events)")
    else:
        log(f"  {label}: profiled warm run wall {wall:.3f}s, device busy "
            f"{busy:.4f}s = {100 * busy / wall:.1f}%")
        for name, sec in top:
            log(f"    {sec * 1e3:9.3f} ms  {name[:90]}")
    return {"wall_s": wall, "device_busy_s": busy, "top_kernels_s": top}


def phase_stress(golden):
    g = golden["stress_50k"]
    src, box = golden_input("stress_50k", g)
    runs = {}
    for setting in ("lp_device", "greedy"):
        clear_memo()
        out = os.path.join(WORK, "stress_50k_" + setting)
        st, wall, counts = run_dir(src, out, box, solver=setting)
        check_digests(f"stress_50k {setting}", out, st,
                      g["settings"][setting])
        runs[setting] = {"wall_s": wall, "config": accepted_config(),
                         "num_cliques": st["num_cliques"],
                         "compute_s": st["compute_s"], "launches": counts}
        log(f"phase 6: stress_50k {setting}: {g['micrographs']} "
            f"micrographs byte-identical to JAX; wall {wall:.2f}s, "
            f"(d, cap, cell_cap, pcap) = {runs[setting]['config']}")
    # the memo stays warm from here on (same shape, sizes, threshold)
    runs["profiled"] = profiled("stress_50k", src, box, "lp_device")
    runs["warm"] = warm_pass("stress_50k", STRESS_WARM, "lp_device")
    return runs


def phase_k5(golden):
    import numpy as np
    import torch

    from repic_tpu_torch.ops import iou_pallas
    from repic_tpu_torch.parallel.batching import (
        bucket_size, pad_batch, to_device,
    )
    from repic_tpu_torch.utils import box_io

    g = golden["k5_mixed"]
    src, box = golden_input("k5_mixed", g)
    runs = {}
    for setting, solver, pallas in (
        ("lp_device", "lp_device", False),
        ("lp_device_pallas", "lp_device", True),
        ("lp_device_fused", "lp_device_fused", False),
        ("greedy", "greedy", False),
    ):
        clear_memo()
        out = os.path.join(WORK, "k5_mixed_" + setting)
        st, wall, counts = run_dir(src, out, box, solver=solver,
                                   use_pallas=pallas)
        check_digests(f"k5_mixed {setting}", out, st, g["settings"][
            "greedy" if solver == "greedy" else "lp_device"])
        if pallas and counts["topk_neighbors"] <= 0:
            raise AssertionError("k5_mixed --pallas: kernel 1 never launched")
        if solver == "lp_device_fused" and counts["demotions"] != st["chunks"]:
            raise AssertionError(
                f"k5_mixed fused: {counts['demotions']} demotions for "
                f"{st['chunks']} chunks (D^4 is outside the envelope)")
        runs[setting] = {"wall_s": wall, "config": accepted_config(),
                         "chunks": st["chunks"], "chunk": st["chunk"],
                         "launches": counts, "compute_s": st["compute_s"]}
        log(f"phase 7: k5_mixed {setting}: {g['micrographs']} micrographs "
            f"byte-identical to JAX; wall {wall:.2f}s, {st['chunks']} "
            f"chunks, (d, cap, cell_cap, pcap) = {runs[setting]['config']}"
            f", launches {counts}")
    runs["profiled"] = profiled("k5_mixed", src, box, "lp_device")

    # kernel 1 at this chunk's shape, its sizes as enumerate_cliques
    # hands them over: device views of the per-picker sizes
    pickers = box_io.discover_picker_dirs(src)
    names = box_io.micrograph_names(os.path.join(src, pickers[0]))
    loaded = [(nm, box_io.load_micrograph_set(src, pickers, nm))
              for nm in names]
    nb = bucket_size(max(bs.n for _, s in loaded for bs in s))
    m = runs["lp_device_pallas"]["chunk"]
    db = to_device(pad_batch(loaded[:m], pad_micrographs_to=m, capacity=nb),
                   "cuda")
    d = runs["lp_device_pallas"]["config"][0]
    k, n = db.xy.shape[1], db.xy.shape[2]
    b = m * (k - 1)
    sizes = torch.from_numpy(np.asarray(box, np.float32)).cuda()
    args = (
        db.xy[:, :1].expand(m, k - 1, n, 2).reshape(b, n, 2),
        db.mask[:, :1].expand(m, k - 1, n).reshape(b, n),
        db.xy[:, 1:].reshape(b, n, 2), db.mask[:, 1:].reshape(b, n),
        sizes[0].expand(b), sizes[1:].repeat(m),
    )
    got = iou_pallas.topk_neighbors(*args, d=d)
    want = iou_pallas.topk_neighbors_plain(*args, d=d)
    err = compare("topk k5 chunk", got, want)
    pairs = float((args[1].sum(1).double() * args[3].sum(1).double()).sum())
    # as at the main chunk, plus each item's two box sizes
    b_ms, by = bound(b * n * (9 + 9) + b * n * (8 * d + 4) + b * 8,
                     pairs * 14.0)
    runs["k5_chunk"] = {
        "shape": f"M={m} K={k} N={n} d={d}, per-picker sizes on the card",
        "launches": runs["lp_device_pallas"]["launches"]["topk_neighbors"],
        "max_abs_err": err,
        "ms": cuda_ms(lambda: iou_pallas.topk_neighbors(*args, d=d), 20),
        "device_ms": device_ms(lambda: iou_pallas.topk_neighbors(*args, d=d),
                               20, "topk_neighbors_kernel"),
        "plain_ms": cuda_ms(
            lambda: iou_pallas.topk_neighbors_plain(*args, d=d), 5),
        "bound_ms": b_ms, "bound_by": by,
        # the host's side of the same call: the time to issue it (no
        # wait for the card), and the share of that in the two sides'
        # size arguments (the per-picker views made contiguous)
        "issue_ms": host_ms(lambda: iou_pallas.topk_neighbors(*args, d=d),
                            20),
        "size_arg_ms": host_ms(lambda: (
            iou_pallas._size_arg(args[4], b, db.xy.device),
            iou_pallas._size_arg(args[5], b, db.xy.device)), 20),
    }
    kc = runs["k5_chunk"]
    log(f"phase 7: kernel 1 at the k5_mixed chunk ({kc['shape']}): equal "
        f"to its plain version (max abs err {err}); kernel {kc['ms']:.4f} "
        f"ms, device " + ("not measured" if kc["device_ms"] is None else
                          f"{kc['device_ms']:.4f} ms")
        + f", plain {kc['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({by}); "
        f"host issue {kc['issue_ms']:.4f} ms, of it size arguments "
        f"{kc['size_arg_ms']:.4f} ms; "
        f"{kc['launches']} launches in the --pallas run")
    runs["ascent_k5_chunk"] = ascent_at_chunk(
        pad_batch(loaded[:m], pad_micrographs_to=m, capacity=nb), box,
        runs["lp_device"]["launches"]["dual_ascent"])
    runs["warm"] = warm_pass("k5_mixed", K5_WARM, "lp_device")
    return runs


def ascent_at_chunk(batch, box, launches):
    """The ascent kernel on the solver inputs of a staged ``lp_device``
    chunk (its accepted attempt's, captured in a cold run of the
    batch): equal to the plain loop, its time, device time, bound and
    residency."""
    from repic_tpu_torch.ops import megakernel
    from repic_tpu_torch.pipeline import consensus
    from repic_tpu_torch.solver import dual

    captured = []
    real = megakernel.dual_ascent

    def capture(*args, **kw):
        captured.append(args)
        return real(*args, **kw)

    clear_memo()
    megakernel.dual_ascent = capture
    try:
        consensus.run_consensus_batch(batch, box, solver="lp_device",
                                      device="cuda")
    finally:
        megakernel.dual_ascent = real
    mv, w, valid, v = captured[-1]
    m, c, k = mv.shape
    got = real(mv, w, valid, v)
    want = dual.dual_ascent_plain(mv, w, valid, v)
    err = compare("ascent k5 chunk", got, want)
    nbytes, ops, staged = ascent_work(valid, k, v, want[2])
    b_ms, by = bound(nbytes, ops)
    rep = {
        "shape": f"M={m} C={c} K={k} V={v}",
        "residency": list(megakernel.ascent_residency(v, c, k)),
        "valid_cliques_max": int(valid.sum(-1).max()),
        "steps_max": int(want[2].max()),
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: real(mv, w, valid, v), 10),
        "device_ms": device_ms(lambda: real(mv, w, valid, v), 10,
                               "dual_ascent_kernel"),
        "plain_ms": cuda_ms(lambda: dual.dual_ascent_plain(mv, w, valid, v),
                            2, warm=1),
        "bound_ms": b_ms, "bound_by": by,
        # the staged list read once a step at HBM's rate (most of it is
        # read from shared memory and L2)
        "staged_bytes_ms": staged / PEAK_BYTES * 1e3,
    }
    log(f"phase 7: the ascent kernel at the k5_mixed chunk "
        f"({rep['shape']}, {rep['residency']}): equal to the plain loop "
        f"(max abs err {err}); kernel {rep['ms']:.4f} ms, device "
        + ("not measured" if rep["device_ms"] is None else
           f"{rep['device_ms']:.4f} ms")
        + f", plain {rep['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({by}), "
        f"staged bytes at HBM rate {rep['staged_bytes_ms']:.4f} ms")
    return rep


# -- phase 8: the tables, the lp and exact rungs, two phases, stripes --


def cli(*argv):
    """``python -m repic_tpu_torch ARGV`` in this process (its parser
    and command), with the escalation memo cleared as a new process has
    it and the launch counts set to 0 just before; returns ``(stats or
    None, wall_s, counts)`` (stats: the consensus command's JSON line)."""
    import contextlib
    import io

    import torch

    from repic_tpu_torch import main as cli_main

    clear_memo()
    reset_counts()
    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli_main.main([str(a) for a in argv])
    torch.cuda.synchronize()
    wall = time.time() - t
    if rc != 0:
        raise RuntimeError(f"CLI {argv} exited {rc}")
    lines = buf.getvalue().strip().splitlines()
    stats = None
    if argv[0] == "consensus":
        stats = json.loads(lines[-1])
    return stats, wall, read_counts()


def check_outputs(label, out_dir, want, exts=(".box", ".tsv")):
    """Every output file's digest equals the JAX golden's."""
    from repic_tpu_torch.utils.synthetic import output_digests

    got = output_digests(out_dir, exts)
    if got != want:
        bad = sorted(f for f in set(got) | set(want)
                     if got.get(f) != want.get(f))
        raise AssertionError(f"{label}: {len(bad)} of {len(want)} files "
                             f"differ from the JAX digests: {bad[:4]}")


def load_times(src):
    """Seconds to read every BOX file under ``src`` with the native
    parser (``read_box``) and with the line loop, and the file count."""
    from repic_tpu_torch.utils import box_io

    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(src)
                   for f in fs if f.endswith(".box"))
    t = time.time()
    for f in files:
        box_io.read_box(f)
    native_s = time.time() - t
    t = time.time()
    for f in files:
        box_io._read_box_slow(f)
    return {"files": len(files), "native_s": native_s,
            "line_loop_s": time.time() - t}


def phase_flags(synth):
    """Phase 8, through the CLI on the card: the 10017 tables under
    lp_device, lp_device --pallas and lp_device_fused (kernels 1, 2 and
    3 and the ascent kernel must launch, no chunk demoted); --solver exact and lp; get_cliques
    + run_ilp with each backend; --stripes 4 on the stress_50k golden
    micrographs; and the native BOX parser's read times."""
    import torch

    with open(FLAG_DIGESTS) as f:
        gold = json.load(f)
    rep = {"tables": {}, "solvers": {}, "two_phase": {}, "stripes": {}}
    tables_launches = {}
    flag_args = {"multi_out": ["--multi_out"], "get_cc": ["--get_cc"],
                 "multi_out_get_cc": ["--multi_out", "--get_cc"]}
    for key, want in sorted(gold["tables"].items()):
        setting, flags = key.split("/")
        solver = "lp_device_fused" if setting.endswith("fused") \
            else "lp_device"
        extra = ["--pallas"] if setting.endswith("pallas") else []
        out = os.path.join(WORK, "t_" + key.replace("/", "_"))
        st, wall, counts = cli("consensus", EXAMPLES, out, BOX, "--solver",
                               solver, *extra, *flag_args[flags])
        check_outputs(f"10017 {key}", out, want)
        need = (["topk_neighbors", "dual_ascent"] if extra else
                ["fused_clique_candidates", "fused_dual_solve"]
                if solver == "lp_device_fused" else ["dual_ascent"])
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{key}: {k} never launched")
            tables_launches.setdefault(k, {})[key] = counts[k]
        if counts["demotions"]:
            raise AssertionError(f"{key}: {counts['demotions']} demotions")
        rep["tables"][key] = {"wall_s": wall, "compute_s": st["compute_s"],
                              "launches": counts,
                              "cc_rounds": st.get("cc_rounds")}
        log(f"phase 8: 10017 {key}: {len(want)} files equal the JAX "
            f"digests; wall {wall:.3f}s, compute {st['compute_s']:.3f}s, "
            f"launches {counts}, cc rounds {st.get('cc_rounds')}")
    for solver, want in sorted(gold["solvers"].items()):
        out = os.path.join(WORK, "s_" + solver)
        st, wall, _ = cli("consensus", EXAMPLES, out, BOX, "--solver", solver)
        check_outputs(f"10017 --solver {solver}", out, want)
        rungs = st.get("solver_rungs", {})
        if solver == "exact" and set(rungs.values()) != {"exact"}:
            raise AssertionError(f"exact rungs {rungs}")
        rep["solvers"][solver] = {"wall_s": wall,
                                  "compute_s": st["compute_s"]}
        log(f"phase 8: 10017 --solver {solver}: {len(want)} BOX files equal "
            f"the JAX digests; wall {wall:.3f}s, compute "
            f"{st['compute_s']:.3f}s")
    gc_args = {"plain": [], "multi_out": ["--multi_out"],
               "get_cc": ["--get_cc"]}
    for flags, want in sorted(gold["two_phase"].items()):
        out = os.path.join(WORK, "p_" + flags)
        _, wall, _ = cli("get_cliques", EXAMPLES, out, BOX, *gc_args[flags])
        check_outputs(f"get_cliques {flags}", out, want["get_cliques"],
                      (".pickle", "_runtime.tsv"))
        walls = {"get_cliques": wall}
        for backend in ("exact", "greedy", "lp"):
            _, walls[backend], _ = cli("run_ilp", out, BOX, "--backend",
                                       backend)
            check_outputs(f"run_ilp {flags} {backend}", out, want[backend])
        rep["two_phase"][flags] = walls
        log(f"phase 8: get_cliques {flags} + run_ilp exact/greedy/lp equal "
            "the JAX digests; wall " + ", ".join(
                f"{k} {v:.3f}s" for k, v in walls.items()))
    g = gold["stripes"]
    src, box = golden_input(g["cell"], g)
    for solver, want in sorted(g["settings"].items()):
        out = os.path.join(WORK, "g_" + solver)
        torch.cuda.reset_peak_memory_stats()
        st, wall, _ = cli("consensus", src, out, box, "--solver", solver,
                          "--stripes", g["stripes"])
        peak = torch.cuda.max_memory_allocated()
        check_outputs(f"stress_50k --stripes {g['stripes']} {solver}", out,
                      want)
        rep["stripes"][solver] = {"wall_s": wall, "giant": st["giant"],
                                  "peak_device_bytes": peak}
        log(f"phase 8: stress_50k --stripes {g['stripes']} {solver}: "
            f"{g['micrographs']} BOX files equal the JAX digests; wall "
            f"{wall:.2f}s, peak device memory {peak / 2**30:.2f} GiB")
        for name, gs in st["giant"].items():
            log(f"  {name}: {gs['seconds']:.3f}s, stripe capacity "
                f"{gs['stripe_capacity']}, (d, cap, cell_cap, pcap) = "
                f"{gs['config']}")
    rep["load"] = {"synthetic_256": load_times(synth),
                   "stress_50k": load_times(src)}
    for cell, lt in rep["load"].items():
        log(f"phase 8: reading {cell}'s {lt['files']} BOX files: native "
            f"parser {lt['native_s']:.3f}s, line loop "
            f"{lt['line_loop_s']:.3f}s")
    rep["tables_launches"] = tables_launches
    return rep


# -- phase 9: the fault-tolerant runtime --------------------------------


def _spread(values):
    """Median and min-max of ``values``."""
    import statistics

    return {"median": statistics.median(values), "min": min(values),
            "max": max(values)}


def _fault_cli(plan, *argv):
    """:func:`cli` with ``REPIC_TPU_FAULTS`` set to ``plan`` (the CLI
    installs it), the plan cleared after."""
    from repic_tpu_torch.runtime import faults

    os.environ["REPIC_TPU_FAULTS"] = ",".join(plan)
    try:
        return cli(*argv)
    finally:
        del os.environ["REPIC_TPU_FAULTS"]
        faults.clear()


def phase_runtime(synth, phase4_outs):
    """Phase 9: (a) a lenient run of 10017 with an unreadable BOX file
    and a fault plan, then ``--resume`` after the repair, each held to
    the JAX digests; (b) ``--strict`` on the same input fails naming the
    file; (c) ``synthetic_256`` with the chunk prefetch on and off, 10
    alternating pairs per setting, the bytes of phase 4; (d) two
    processes over one capacity-config sidecar in a temporary HOME, the
    second writing the JAX package's second-run bytes."""
    from repic_tpu_torch.utils.synthetic import journal_view, output_digests

    with open(RUNTIME_DIGESTS) as f:
        gold = json.load(f)
    rep = {}
    # (a) lenient, then resumed
    src = os.path.join(WORK, "rt_in")
    shutil.copytree(EXAMPLES, src)
    bad = os.path.join(src, gold["bad_box"])
    with open(bad, "w") as f:
        f.write(gold["bad_text"])
    out = os.path.join(WORK, "rt_out")
    name = os.path.basename(bad)[: -len(".box")]
    for run in ("lenient", "resumed"):
        if run == "resumed":
            shutil.copy(os.path.join(EXAMPLES, gold["bad_box"]), bad)
            st, wall, counts = cli("consensus", src, out, BOX, "--solver",
                                   gold["solver"], "--resume")
        else:
            st, wall, counts = _fault_cli(gold["plan"], "consensus", src,
                                          out, BOX, "--solver",
                                          gold["solver"])
        want = gold[run]
        check_outputs(f"10017 {run}", out, want["boxes"], (".box",))
        if journal_view(out, src) != want["journal"]:
            raise AssertionError(f"10017 {run}: journal differs from JAX's")
        if (sorted(st["quarantined"]) != want["quarantined"]
                or st["resumed"] != want["resumed"]
                or st["journal"] != want["summary"]):
            raise AssertionError(f"10017 {run}: stats {st['quarantined']}, "
                                 f"{st['resumed']}, {st['journal']}")
        for k in ("fused_clique_candidates", "fused_dual_solve"):
            if counts[k] <= 0:
                raise AssertionError(f"10017 {run}: {k} never launched")
        rep[run] = {"wall_s": wall, "launches": counts,
                    "journal": st["journal"], "fallbacks": st["fallbacks"]}
        log(f"phase 9a: 10017 {run}: {len(want['boxes'])} BOX files and the "
            f"journal equal the JAX run's ({st['journal']}); quarantined "
            f"{sorted(st['quarantined'])}, resumed {st['resumed']}; launches "
            f"{counts}; wall {wall:.3f}s")
    # (b) strict fails fast and names the file
    with open(bad, "w") as f:
        f.write(gold["bad_text"])
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "consensus", src,
         os.path.join(WORK, "rt_strict"), str(BOX), "--strict"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    if proc.returncode == 0 or bad not in proc.stderr:
        raise AssertionError(f"--strict: rc {proc.returncode}, stderr "
                             f"{proc.stderr[-400:]}")
    log(f"phase 9b: --strict exits {proc.returncode}: "
        + proc.stderr.strip().splitlines()[-1][:160])
    # (c) prefetch on and off, warm, alternating
    from repic_tpu_torch.pipeline import consensus

    want_bytes = {}
    for setting, ref in phase4_outs.items():
        want_bytes[setting] = {f: open(os.path.join(ref, f), "rb").read()
                               for f in sorted(os.listdir(ref))
                               if f.endswith(".box")}
    rep["prefetch"] = {}
    for setting, solver, pallas in (
        ("lp_device_fused", "lp_device_fused", False),
        ("lp_device_pallas", "lp_device", True),
    ):
        runs = {"on": [], "off": []}
        clear_memo()
        consensus.run_consensus_dir(synth, os.path.join(WORK, "pf_warm"),
                                    BOX, solver=solver, use_pallas=pallas,
                                    device="cuda")
        for i in range(PREFETCH_PAIRS):
            for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                os.environ["REPIC_TPU_NO_PREFETCH"] = (
                    "1" if mode == "off" else "")
                pout = os.path.join(WORK, f"pf_{mode}")
                st, wall, counts = run_dir(synth, pout, BOX, solver=solver,
                                           use_pallas=pallas)
                got = {f: open(os.path.join(pout, f), "rb").read()
                       for f in sorted(os.listdir(pout))
                       if f.endswith(".box")}
                if got != want_bytes[setting]:
                    raise AssertionError(f"prefetch {mode} {setting}: BOX "
                                         "bytes differ from phase 4's")
                runs[mode].append({"wall_s": wall, "load_s": st["load_s"],
                                   "compute_s": st["compute_s"],
                                   "write_s": st["write_s"]})
        os.environ.pop("REPIC_TPU_NO_PREFETCH", None)
        summary = {mode: {k: _spread([r[k] for r in rs]) for k in rs[0]}
                   for mode, rs in runs.items()}
        rep["prefetch"][setting] = {"runs": runs, "summary": summary}
        for mode in ("on", "off"):
            log(f"phase 9c: {setting} prefetch {mode}, {PREFETCH_PAIRS} warm "
                f"runs of {N_SYNTH}: " + "; ".join(
                    f"{k} median {v['median']:.4f}s ({v['min']:.4f}-"
                    f"{v['max']:.4f})" for k, v in summary[mode].items()))
    log(f"phase 9c: prefetch on and off: {4 * PREFETCH_PAIRS} runs' BOX "
        "bytes equal phase 4's")
    # (d) the sidecar, two processes in a temporary HOME
    sc = gold["sidecar"]
    env = dict(os.environ, PYTHONPATH=REPO, HOME=os.path.join(WORK, "home"),
               REPIC_CONSENSUS_CHUNK=str(sc["chunk"]))
    env.pop("REPIC_TPU_NO_CONFIG_CACHE", None)
    for run in ("first", "second"):
        sout = os.path.join(WORK, "sc_" + run)
        proc = subprocess.run(
            [sys.executable, "-m", "repic_tpu_torch", "consensus", EXAMPLES,
             sout, str(BOX)], cwd=REPO, env=env, capture_output=True,
            text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"sidecar run {run}:\n{proc.stderr[-2000:]}")
        check_outputs(f"sidecar {run}", sout, sc[run], (".box",))
    with open(os.path.join(env["HOME"], ".cache", "repic_tpu_torch",
                           "capacity_configs.json")) as f:
        entries = json.load(f)
    if entries != sc["entries"]:
        raise AssertionError(f"sidecar entries {entries} != {sc['entries']}")
    rep["sidecar"] = entries
    log(f"phase 9d: two processes over one sidecar: both runs' BOX files "
        f"equal the JAX digests; sidecar {entries}")
    return rep


# -- phase 10: the observability layer ---------------------------------


def _serve_poll(proc, seen, status_docs):
    """Read the CLI's status-server port from its stderr, then poll
    every path of :data:`STATUS_PATHS` until the process ends; ``seen``
    gets the HTTP codes per path, ``status_docs`` the ``/status``
    documents.  Returns the process's stderr."""
    import http.client
    import urllib.error
    import urllib.request

    err_lines = []
    port = None
    for line in proc.stderr:
        err_lines.append(line)
        m = re.search(r"status server: http://127\.0\.0\.1:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    # keep draining stderr so the child never blocks on a full pipe
    import threading

    drain = threading.Thread(target=lambda: err_lines.extend(proc.stderr),
                             daemon=True)
    drain.start()
    while port is not None and proc.poll() is None:
        for path in STATUS_PATHS:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=2) as r:
                    code, body = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, body = e.code, b""
            except (OSError, http.client.HTTPException):
                # the server is gone, or went mid-response: the run is
                # ending
                continue
            seen.setdefault(path, set()).add(code)
            if path == "/status" and code == 200:
                status_docs.append(json.loads(body))
        time.sleep(0.02)  # the child's HTTP thread shares its GIL
    proc.wait(timeout=600)
    drain.join(timeout=30)
    return "".join(err_lines)


def _cli_served(label, argv, env):
    """``python -m repic_tpu_torch ARGV --status-port 0`` in a process
    of its own, polled while it runs; returns ``(stats, wall_s, seen
    codes, /status documents)``."""
    seen, docs = {}, []
    t = time.time()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repic_tpu_torch", *map(str, argv),
         "--status-port", "0"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    out_lines = []
    import threading

    reader = threading.Thread(target=lambda: out_lines.extend(proc.stdout),
                              daemon=True)
    reader.start()
    err = _serve_poll(proc, seen, docs)
    reader.join(timeout=30)
    wall = time.time() - t
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: exit {proc.returncode}\n{err[-3000:]}")
    return json.loads(out_lines[-1]), wall, seen, docs


def _trace_kernels(prof_dir):
    """The kernel names on the device lanes of the profiler traces
    under ``prof_dir``, and the labels of the lanes with events."""
    from repic_tpu_torch.telemetry.devicetime import device_lanes

    names, lanes = set(), set()
    for d, _, fs in os.walk(prof_dir):
        for f in fs:
            if not f.endswith(".trace.json"):
                continue
            with open(os.path.join(d, f)) as fh:
                evs = json.load(fh).get("traceEvents", [])
            dev = device_lanes(evs)
            busy = {e.get("pid") for e in evs if e.get("ph") == "X"
                    and e.get("pid") in dev}
            lanes |= {str((e.get("args") or {}).get("labels"))
                      for e in evs if e.get("ph") == "M"
                      and e.get("pid") in busy
                      and e.get("name") == "process_labels"}
            names |= {e.get("name") for e in evs if e.get("ph") == "X"
                      and e.get("pid") in dev and e.get("cat") == "kernel"}
    return names, lanes


def phase_observability(synth, phase4_outs):
    """Phase 10: (a) 10017 through the CLI under ``--profile
    --device-time --status-port 0`` (fused and ``--pallas``), polled
    while it runs, its files, telemetry, report, trace and profiler
    trace checked; a chunked fused run for readiness; (b) telemetry on
    against off on ``synthetic_256``, :data:`TELEMETRY_PAIRS` warm
    alternating pairs per setting, the bytes of phase 4; (c) the
    per-stage host/device split of ``k5_mixed``'s and ``stress_50k``'s
    golden directories."""
    import contextlib
    import io

    from repic_tpu_torch import main as cli_main
    from repic_tpu_torch.telemetry import metrics as tmetrics
    from repic_tpu_torch.telemetry import probes as tprobes
    from repic_tpu_torch.telemetry.report import build_report
    from repic_tpu_torch.utils.synthetic import CELLS, telemetry_view
    from repic_tpu_torch.utils.tracing import trace_session

    with open(TELEMETRY_DIGESTS) as f:
        gold = json.load(f)
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("REPIC_CONSENSUS_CHUNK", None)
    rep = {"runs": {}, "launches": {}}
    # (a) the profiled, device-timed, served runs
    for setting, flags in (
        ("lp_device_fused", ["--solver", "lp_device_fused"]),
        ("lp_device_pallas", ["--solver", "lp_device", "--pallas"]),
    ):
        out = os.path.join(WORK, "tlm_" + setting)
        prof = os.path.join(WORK, "prof_" + setting)
        st, wall, seen, docs = _cli_served(
            setting, ["consensus", EXAMPLES, out, BOX, *flags, "--profile",
                      prof, "--device-time"], env)
        gdir = os.path.join(GOLDEN, setting)
        diff = [f for f in sorted(os.listdir(gdir)) if not filecmp.cmp(
            os.path.join(gdir, f), os.path.join(out, f), shallow=False)]
        if diff:
            raise AssertionError(f"phase 10a {setting}: BOX differs: {diff}")
        want = gold[setting]
        files = sorted(f for f in os.listdir(out) if not f.endswith(".box"))
        if files != want["files"]:
            raise AssertionError(f"phase 10a {setting}: files {files}")
        view = telemetry_view(out)
        bad = [k for k in ("metrics", "spans", "trace", "journal")
               if view[k] != want[k]]
        if bad:
            raise AssertionError(
                f"phase 10a {setting}: {bad} differ from the JAX digest: "
                + json.dumps({k: view[k] for k in bad})[:1500])
        for path in STATUS_PATHS:
            if path != "/healthz/ready" and 200 not in seen.get(path, ()):
                raise AssertionError(f"phase 10a {setting}: {path} never "
                                     f"answered 200: {seen}")
        for argv in (["report", out, "--json"], ["trace", out]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main.main(argv)
            if rc != 0:
                raise AssertionError(f"phase 10a {setting}: {argv} -> {rc}")
        report = build_report(out)
        trace = report["device_time"].get("trace")
        launched = sum(v for k, v in st["launches"].items()
                       if k in LAUNCH_KEYS[setting])
        if not trace or not (0 < trace["device_busy_s"] <= trace["wall_s"]) \
                or trace["device_ops"] < launched or launched <= 0:
            raise AssertionError(f"phase 10a {setting}: trace {trace}, "
                                 f"launches {st['launches']}")
        names, lanes = _trace_kernels(prof)
        missing = [k for k in TRACE_KERNELS[setting]
                   if not any(k in nm for nm in names)]
        if missing:
            raise AssertionError(f"phase 10a {setting}: the profiler trace "
                                 f"lacks {missing}; has {sorted(names)}")
        mem = {s["labels"]["stat"]: s["value"] for s in json.load(open(
            os.path.join(out, "_metrics.json")))["metrics"][
                "repic_device_memory_bytes"]["samples"]}
        if not mem.get("bytes_limit") or not mem.get("peak_bytes_in_use"):
            raise AssertionError(f"phase 10a {setting}: device memory {mem}")
        rep["runs"][setting] = {
            "wall_s": wall, "launches": st["launches"], "seen": {
                k: sorted(v) for k, v in seen.items()},
            "status_polls": len(docs), "device_time": report["device_time"],
            "device": report["device"], "device_memory": mem,
            "trace_kernels": sorted(names), "device_lanes": sorted(lanes),
        }
        for k in LAUNCH_KEYS[setting]:
            rep["launches"][k] = st["launches"][k]
        log(f"phase 10a: 10017 {setting} (--profile --device-time "
            f"--status-port 0): 12 BOX files equal the JAX golden; files, "
            f"counters, spans, trace segments and journal trace ids equal "
            f"the JAX digest; HTTP codes {rep['runs'][setting]['seen']} over "
            f"{len(docs)} /status polls; report and trace exit 0; wall "
            f"{wall:.2f}s (process); launches {st['launches']}")
        log(f"  profiler trace: device busy {trace['device_busy_s']:.6f}s of "
            f"{trace['wall_s']:.6f}s wall, {trace['device_ops']} device ops, "
            f"gap {trace['dispatch_gap_s']:.6f}s; device lanes "
            f"{sorted(lanes)}; our kernels " + ", ".join(sorted(
                nm[:60] for nm in names
                if any(k in nm for k in TRACE_KERNELS[setting]))))
        for name, s_ in report["device_time"]["stages"].items():
            log(f"  {name}: host {s_['host_s']:.6f}s, device tail "
                f"{s_['device_tail_s']:.6f}s (device_frac "
                f"{s_['device_frac']:.4f}) over {s_['count']}")
        log(f"  device memory at finish {mem}")
    # readiness: a fused run in chunks of 2 (six chunks), polled
    env_c = dict(env, REPIC_CONSENSUS_CHUNK="2")
    out = os.path.join(WORK, "tlm_chunked")
    st, wall, seen, docs = _cli_served(
        "chunked", ["consensus", EXAMPLES, out, BOX, "--solver",
                    "lp_device_fused"], env_c)
    gdir = os.path.join(GOLDEN, "lp_device_fused")
    if any(not filecmp.cmp(os.path.join(gdir, f), os.path.join(out, f),
                           shallow=False) for f in os.listdir(gdir)):
        raise AssertionError("phase 10a chunked: BOX differs")
    for path in STATUS_PATHS:
        if 200 not in seen.get(path, ()):
            raise AssertionError(f"phase 10a chunked: {path} never answered "
                                 f"200: {seen}")
    done = max(d_.get("micrographs_done", 0) for d_ in docs)
    rep["chunked"] = {"wall_s": wall, "seen": {k: sorted(v)
                                               for k, v in seen.items()},
                      "status_polls": len(docs), "max_done_seen": done}
    log(f"phase 10a: 10017 fused in chunks of 2 (status server polled): "
        f"HTTP codes {rep['chunked']['seen']} over {len(docs)} /status "
        f"polls, up to {done} of 12 micrographs done mid-run; BOX files "
        f"equal the JAX golden")
    # (b) telemetry on and off, warm, alternating
    want_bytes = {}
    for setting, ref in phase4_outs.items():
        want_bytes[setting] = {f: open(os.path.join(ref, f), "rb").read()
                               for f in sorted(os.listdir(ref))
                               if f.endswith(".box")}
    rep["telemetry_on_off"] = {}
    for setting, solver, pallas in (
        ("lp_device_fused", "lp_device_fused", False),
        ("lp_device_pallas", "lp_device", True),
    ):
        runs = {"on": [], "off": []}
        clear_memo()
        run_dir(synth, os.path.join(WORK, "tl_warm"), BOX, solver=solver,
                use_pallas=pallas)
        try:
            for i in range(TELEMETRY_PAIRS):
                for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
                    tmetrics.set_enabled(mode == "on")
                    tout = os.path.join(WORK, f"tl_{mode}")
                    st, wall, _ = run_dir(synth, tout, BOX, solver=solver,
                                          use_pallas=pallas)
                    got = {f: open(os.path.join(tout, f), "rb").read()
                           for f in sorted(os.listdir(tout))
                           if f.endswith(".box")}
                    if got != want_bytes[setting]:
                        raise AssertionError(f"telemetry {mode} {setting}: "
                                             "BOX bytes differ from phase 4's")
                    if os.path.exists(os.path.join(tout, "_events.jsonl")) \
                            != (mode == "on"):
                        raise AssertionError(f"telemetry {mode}: event log")
                    runs[mode].append({"wall_s": wall, "load_s": st["load_s"],
                                       "compute_s": st["compute_s"],
                                       "write_s": st["write_s"]})
        finally:
            tmetrics.set_enabled(True)
        summary = {mode: {k: _spread([r[k] for r in rs]) for k in rs[0]}
                   for mode, rs in runs.items()}
        rep["telemetry_on_off"][setting] = {"runs": runs, "summary": summary}
        for mode in ("on", "off"):
            log(f"phase 10b: {setting} telemetry {mode}, {TELEMETRY_PAIRS} "
                f"warm runs of {N_SYNTH}: " + "; ".join(
                    f"{k} median {v['median']:.4f}s ({v['min']:.4f}-"
                    f"{v['max']:.4f})" for k, v in summary[mode].items()))
    log(f"phase 10b: telemetry on and off: {4 * TELEMETRY_PAIRS} runs' BOX "
        "bytes equal phase 4's")
    # (c) the per-stage split of the dense configurations
    with open(DIGESTS) as f:
        digests = json.load(f)
    rep["split"] = {}
    for cell in ("k5_mixed", "stress_50k"):
        src = os.path.join(WORK, cell + "_golden_in")
        out = os.path.join(WORK, cell + "_devicetime")
        prof = os.path.join(WORK, cell + "_prof")
        with tprobes.device_time(True), trace_session(prof):
            st, wall, counts = run_dir(src, out, CELLS[cell]["box_size"],
                                       solver="lp_device")
        check_digests(f"phase 10c {cell}", out, st,
                      digests[cell]["settings"]["lp_device"])
        dt = build_report(out)["device_time"]
        rep["split"][cell] = {"wall_s": wall, "device_time": dt,
                              "launches": counts}
        log(f"phase 10c: {cell} ({digests[cell]['micrographs']} golden "
            f"micrographs, lp_device, --device-time --profile): wall "
            f"{wall:.3f}s; dispatch gap (est) {dt.get('dispatch_gap_s')}s")
        for name, s_ in dt["stages"].items():
            log(f"  {name}: host {s_['host_s']:.6f}s, device tail "
                f"{s_['device_tail_s']:.6f}s, device_frac "
                f"{s_['device_frac']:.4f}, over {s_['count']}")
        tr = dt.get("trace")
        if tr:
            log(f"  profiler trace: device busy {tr['device_busy_s']:.6f}s "
                f"of {tr['wall_s']:.6f}s, {tr['device_ops']} device ops, "
                f"gap {tr['dispatch_gap_s']:.6f}s")
    return rep


# -- phase 11: the engine and the serve daemon -------------------------


def _p95(values):
    """The nearest-rank 95th percentile (the largest of 16 values)."""
    vals = sorted(values)
    return vals[math.ceil(0.95 * len(vals)) - 1] if vals else None


def _histogram(name):
    """``(sum, count)`` of a registry histogram's unlabelled sample."""
    from repic_tpu_torch import telemetry

    sample = telemetry.histogram(name).samples().get((), {})
    return sample.get("sum", 0.0), sample.get("count", 0)


def _burst(port, job_dirs, options):
    """Submit every job directory from :data:`SERVE_CLIENTS` client
    threads (each submits, then polls to a terminal state); returns the
    wall and each job's document."""
    from concurrent.futures import ThreadPoolExecutor

    from torch_serve_common import run_job

    def one(in_dir):
        return run_job(port, {"in_dir": in_dir, "box_size": BOX,
                              "options": options}, timeout=600)

    t = time.time()
    with ThreadPoolExecutor(max_workers=SERVE_CLIENTS) as ex:
        docs = list(ex.map(one, job_dirs))
    return time.time() - t, docs


def phase_serve(synth, phase4_outs):
    """Phase 11: (a) a ``cuda`` daemon in this process serves 10017 in
    the three golden settings, held to ``tests/golden/torch_port_10017``
    and the JAX daemon's digests; (b) bench_serve's burst mix cut from
    the synthetic set, batch and single, fused and ``--pallas``, a cold
    burst and :data:`SERVE_ROUNDS` warm ones, every BOX file equal to
    phase 4's; (c) ``serve`` as a process: a ``server_crash`` and the
    restart, a SIGTERM drain mid-job, the tenants' 401/403/429."""
    import urllib.error

    from repic_tpu_torch import telemetry
    from repic_tpu_torch.pipeline import consensus
    from repic_tpu_torch.serve.daemon import ConsensusDaemon
    from repic_tpu_torch.telemetry import metrics as tmetrics
    from repic_tpu_torch.utils.synthetic import (
        file_sha256, job_view, journal_view, serve_journal_view,
        split_into_jobs,
    )

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_serve_common import (
        SERVE_SETTINGS, SERVE_WARMUP_BUCKETS, artifact_digests, req,
        run_job, spawn, stop, submit, wait_ready, wait_terminal,
    )

    tmetrics.set_enabled(True)
    rep = {}
    hits = telemetry.counter("repic_program_cache_hits_total")
    misses = telemetry.counter("repic_program_cache_misses_total")

    def fresh():
        clear_memo()
        consensus._PROGRAM_SIGNATURES.clear()

    # (a) 10017 in process, against the goldens and the JAX digests
    with open(SERVE_DIGESTS) as f:
        want = json.load(f)
    fresh()
    wd = os.path.join(WORK, "serve_10017")
    t = time.time()
    d = ConsensusDaemon(wd, port=0, device="cuda", warmup=True,
                        warmup_buckets=SERVE_WARMUP_BUCKETS).start()
    rep["10017"] = {}
    try:
        port = d.server.port
        wait_ready(port, timeout=300)
        rep["ready_s"] = time.time() - t
        for setting, options in SERVE_SETTINGS.items():
            reset_counts()
            t = time.time()
            doc = run_job(port, {"in_dir": EXAMPLES, "box_size": BOX,
                                 "options": options}, timeout=300)
            wall = time.time() - t
            counts = read_counts()
            if doc["state"] != "finished":
                raise AssertionError(f"phase 11a {setting}: {doc}")
            arts = artifact_digests(port, doc["id"])
            gold_dir = os.path.join(GOLDEN, setting)
            gold = {f: file_sha256(os.path.join(gold_dir, f))
                    for f in os.listdir(gold_dir)}
            if arts != gold or arts != want[setting]["artifacts"]:
                raise AssertionError(f"phase 11a {setting}: artifacts "
                                     "differ from the goldens")
            if job_view(doc, REPO) != want[setting]["job"]:
                raise AssertionError(f"phase 11a {setting}: job document "
                                     f"{job_view(doc, REPO)}")
            if journal_view(d.job_dir(doc["id"])) != \
                    want[setting]["journal"]:
                raise AssertionError(f"phase 11a {setting}: run journal")
            need = LAUNCH_KEYS.get(setting, ())
            for key in need:
                if counts[key] <= 0:
                    raise AssertionError(f"phase 11a {setting}: {key} "
                                         "never launched")
            if not need and any(counts[k] for k in (
                    "topk_neighbors", "fused_clique_candidates",
                    "fused_dual_solve", "dual_ascent")):
                raise AssertionError(f"phase 11a {setting}: a kernel "
                                     f"launched: {counts}")
            rep["10017"][setting] = {"wall_s": wall, "launches": counts}
            log(f"phase 11a: 10017 {setting} served on the card: 12 "
                "artifacts (over HTTP) equal the JAX golden, job document "
                f"and run journal equal the JAX daemon's; job wall "
                f"{wall:.3f}s; launches {counts}")
    finally:
        d.drain()
    if serve_journal_view(wd, REPO) != want["serve_journal"]:
        raise AssertionError("phase 11a: the request journal differs from "
                             "the JAX daemon's")
    log(f"phase 11a: request journal equals the JAX daemon's; ready after "
        f"{rep['ready_s']:.2f}s (warmup: kernel libraries, probe chunk, "
        f"bucket {SERVE_WARMUP_BUCKETS})")

    # (b) the burst at real size
    job_dirs = split_into_jobs(synth, os.path.join(WORK, "serve_jobs"))
    small = [j for j in job_dirs if not j.endswith("large")]
    want_bytes = {}
    for setting, ref in phase4_outs.items():
        want_bytes[setting] = {f: open(os.path.join(ref, f), "rb").read()
                               for f in os.listdir(ref)
                               if f.endswith(".box")}
    rep["burst"] = {}
    for setting, options in (
        ("lp_device_fused", SERVE_SETTINGS["lp_device_fused"]),
        ("lp_device_pallas", SERVE_SETTINGS["lp_device_pallas"]),
    ):
        for scheduler in ("batch", "single"):
            fresh()
            wd = os.path.join(WORK, f"serve_{setting}_{scheduler}")
            d = ConsensusDaemon(wd, port=0, device="cuda", warmup=True,
                                scheduler=scheduler, queue_limit=32)
            d.start()
            rounds = []
            try:
                wait_ready(d.server.port, timeout=300)
                for r in range(1 + SERVE_ROUNDS):
                    reset_counts()
                    h0, m0 = hits.value(), misses.value()
                    c0 = _histogram("repic_serve_coalesced_jobs")
                    wall, docs = _burst(d.server.port, job_dirs, options)
                    counts = read_counts()
                    c1 = _histogram("repic_serve_coalesced_jobs")
                    lat = {dd["request"]["in_dir"]:
                           dd["finished_ts"] - dd["accepted_ts"]
                           for dd in docs}
                    bad, served = [], []
                    for dd in docs:
                        if dd["state"] != "finished":
                            raise AssertionError(f"phase 11b: {dd}")
                        jd = d.job_dir(dd["id"])
                        for f in os.listdir(jd):
                            if f.endswith(".box"):
                                served.append(f)
                                with open(os.path.join(jd, f), "rb") as fh:
                                    if fh.read() != want_bytes[setting][f]:
                                        bad.append(f)
                    if bad:
                        raise AssertionError(
                            f"phase 11b {setting} {scheduler}: {len(bad)} "
                            f"BOX files differ from phase 4's: {bad[:5]}")
                    # the jobs together wrote each of phase 4's files once
                    if len(served) != len(set(served)) or \
                            set(served) != set(want_bytes[setting]):
                        raise AssertionError(
                            f"phase 11b {setting} {scheduler}: served "
                            f"{len(served)} BOX files ({len(set(served))} "
                            f"names), phase 4 wrote "
                            f"{len(want_bytes[setting])}")
                    for key in LAUNCH_KEYS[setting]:
                        if counts[key] <= 0:
                            raise AssertionError(f"phase 11b {setting}: "
                                                 f"{key} never launched")
                    chunks = c1[1] - c0[1]
                    rounds.append({
                        "wall_s": wall,
                        "micrographs_per_s": N_SYNTH / wall,
                        "small_p95_s": _p95([lat[j] for j in small]),
                        "large_latency_s": lat[job_dirs[len(job_dirs) // 2]],
                        "coalesced_jobs_per_chunk": (
                            (c1[0] - c0[0]) / chunks if chunks else None),
                        "coalesced_chunks": chunks,
                        "cache_hits": hits.value() - h0,
                        "cache_misses": misses.value() - m0,
                        "launches": counts,
                    })
            finally:
                d.drain()
            cold, warm = rounds[0], rounds[1:]
            best = min(warm, key=lambda x: x["wall_s"])
            rep["burst"][f"{setting}/{scheduler}"] = {
                "cold": cold, "warm": warm, "best_warm": best}
            log(f"phase 11b: {setting} {scheduler}: {len(job_dirs)} jobs, "
                f"{N_SYNTH} micrographs, each of phase 4's BOX files served once "
                f"and equal to it; "
                f"cold {cold['wall_s']:.3f}s ({cold['micrographs_per_s']:.1f}"
                f" mic/s, p95 small {cold['small_p95_s']:.3f}s, hits/misses "
                f"{cold['cache_hits']:.0f}/{cold['cache_misses']:.0f}); "
                f"best warm {best['wall_s']:.3f}s "
                f"({best['micrographs_per_s']:.1f} mic/s, p95 small "
                f"{best['small_p95_s']:.3f}s, hits/misses "
                f"{best['cache_hits']:.0f}/{best['cache_misses']:.0f}); "
                "coalesced jobs per chunk cold "
                f"{cold['coalesced_jobs_per_chunk']}, warm "
                f"{best['coalesced_jobs_per_chunk']}")

    # (c) serve as a process (default device: cuda)
    gold_dir = os.path.join(GOLDEN, "lp_device")
    gold = {f: file_sha256(os.path.join(gold_dir, f))
            for f in os.listdir(gold_dir)}
    sub = {"in_dir": EXAMPLES, "box_size": BOX,
           "options": {"use_mesh": False}}
    wd = os.path.join(WORK, "serve_crash")
    os.makedirs(wd)
    env = {"REPIC_CONSENSUS_CHUNK": "4"}
    # key "chunk:0", once (a spec's last field is its count)
    proc, port = spawn("port", wd, dict(
        env, REPIC_TPU_FAULTS="server_crash:chunk:0:1"),
        ["--scheduler", "single"], warmup=True, timeout=300, device=None)
    try:
        ids = [submit(port, sub)[2]["id"] for _ in range(2)]
        rc = proc.wait(timeout=300)
    finally:
        stop(proc)
    if rc != 24:
        raise AssertionError(f"phase 11c: server_crash exited {rc}")
    proc, port = spawn("port", wd, env, ["--scheduler", "single"],
                       warmup=True, timeout=300, device=None)
    try:
        docs = [wait_terminal(port, i, timeout=300) for i in ids]
        arts = [artifact_digests(port, i) for i in ids]
    finally:
        rc2 = stop(proc)
    if [dd["state"] for dd in docs] != ["finished"] * 2 or arts != [gold] * 2 \
            or not docs[0]["resumed"] or rc2 != 0:
        raise AssertionError(f"phase 11c: recovery {docs}, exit {rc2}")
    rep["crash"] = {"exit": rc, "restart_exit": rc2,
                    "resumed_micrographs":
                        docs[0]["result"]["resumed_micrographs"]}
    log(f"phase 11c: server_crash at the first chunk boundary exited {rc}; "
        f"the restart finished both jobs with 10017's golden bytes (job 1 "
        f"resumed past {rep['crash']['resumed_micrographs']} micrographs); "
        f"exit {rc2}")
    # the sidecar's replay at a restart, off and on, on the crash case's
    # work directory (its programs.json holds the signatures 10017 ran):
    # the time from spawn to readiness, the replay's own wall, and the
    # first new job's accept-to-terminal latency and cache counters
    rep["replay"] = {}
    for mode, args in (("off", ["--compile-cache", "off"]), ("on", [])):
        t = time.time()
        proc, port = spawn("port", wd, env, ["--scheduler", "single", *args],
                           warmup=True, timeout=300, device=None)
        try:
            wait_ready(port, timeout=300)
            ready_s = time.time() - t
            doc = run_job(port, sub, timeout=300)
            arts = artifact_digests(port, doc["id"])
            prom = req(port, "GET", "/metrics")[2]
        finally:
            rc3 = stop(proc)
        if doc["state"] != "finished" or arts != gold or rc3 != 0:
            raise AssertionError(f"phase 11c replay {mode}: {doc}, "
                                 f"exit {rc3}")
        counters = {}
        for line in prom.splitlines():
            for name in ("repic_program_cache_hits_total",
                         "repic_program_cache_misses_total"):
                if line.startswith(name + " "):
                    counters[name] = float(line.split()[1])
        warm_ev = {}
        with open(os.path.join(wd, "_serve_journal.jsonl")) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("event") == "warmup":
                    warm_ev = rec
        rep["replay"][mode] = {
            "ready_s": ready_s,
            "programs_warmed": warm_ev.get("programs_warmed"),
            "replay_wall_s": warm_ev.get("wall_s"),
            "first_job_s": doc["finished_ts"] - doc["accepted_ts"],
            # a counter never incremented is not exposed
            "cache_hits": counters.get("repic_program_cache_hits_total",
                                       0.0),
            "cache_misses": counters.get(
                "repic_program_cache_misses_total", 0.0),
        }
        r = rep["replay"][mode]
        replayed = ("no replay" if mode == "off" else
                    f"{r['programs_warmed']} programs replayed in "
                    f"{r['replay_wall_s']}s")
        log(f"phase 11c: restart with the sidecar replay {mode}: ready "
            f"after {ready_s:.3f}s (from spawn; {replayed}); first job "
            f"{r['first_job_s']:.3f}s, golden bytes, cache hits/misses "
            f"{r['cache_hits']}/{r['cache_misses']}")
    # SIGTERM while the large burst job is in flight: readiness red,
    # exit 0, the job journaled (re-queued past the grace)
    wd = os.path.join(WORK, "serve_drain")
    os.makedirs(wd)
    proc, port = spawn("port", wd, {"REPIC_CONSENSUS_CHUNK": "8"},
                       ["--scheduler", "single", "--drain-grace", "1"],
                       warmup=True, timeout=300, device=None)
    large = job_dirs[len(job_dirs) // 2]
    try:
        wait_ready(port, timeout=300)
        jid = submit(port, {"in_dir": large, "box_size": BOX,
                            "options": {"use_mesh": False}})[2]["id"]
        deadline = time.time() + 300
        while time.time() < deadline:
            doc = json.loads(req(port, "GET", f"/v1/jobs/{jid}")[2])
            if doc.get("progress", {}).get("chunks_done", 0) >= 1 or \
                    doc["state"] not in ("queued", "running"):
                break
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        ready = []
        while proc.poll() is None:
            try:
                ready.append(req(port, "GET", "/healthz/ready",
                                 timeout=2)[0])
            except (urllib.error.URLError, OSError):
                break
            time.sleep(0.01)
    finally:
        rc = stop(proc, timeout=120)
    states = [e.get("state") for e in serve_journal_view(wd, REPO)
              if e.get("job")]
    events = [e.get("event") for e in serve_journal_view(wd, REPO)]
    if rc != 0 or 503 not in ready or states[-1] not in ("queued",
                                                         "finished") \
            or "drain_begin" not in events \
            or events[-1] != "drain_complete":
        raise AssertionError(f"phase 11c drain: exit {rc}, readiness "
                             f"{sorted(set(ready))}, states {states}, "
                             f"events {events}")
    rep["drain"] = {"exit": rc, "readiness": sorted(set(ready)),
                    "states": states}
    log(f"phase 11c: SIGTERM mid-job: readiness {sorted(set(ready))}, exit "
        f"{rc}, the job journaled {states}, journal has drain_begin and "
        "ends drain_complete")
    # tenants: 401, 403, 429
    wd = os.path.join(WORK, "serve_tenants")
    os.makedirs(wd)
    keyfile = os.path.join(wd, "tenants.json")
    with open(keyfile, "w") as f:
        json.dump({"tenants": [
            {"name": "teamA", "keys": ["ka"], "max_open_jobs": 1},
            {"name": "teamB", "keys": ["kb"]}]}, f)
    proc, port = spawn("port", wd, None, ["--tenants", keyfile],
                       warmup=True, timeout=300, device=None)
    try:
        wait_ready(port, timeout=300)
        body = {"in_dir": large, "box_size": BOX,
                "options": {"use_mesh": False}}
        codes = {"none": req(port, "POST", "/v1/jobs", body)[0],
                 "unknown": req(port, "POST", "/v1/jobs", body,
                                key="nope")[0]}
        code, _, doc = submit(port, body, key="ka")
        codes["teamA"] = code
        code, headers, refused = submit(port, body, key="ka")
        codes["teamA_again"] = (code, refused.get("error"),
                                headers.get("Retry-After"))
        codes["teamB_reads_A"] = req(port, "GET", f"/v1/jobs/{doc['id']}",
                                     key="kb")[0]
        codes["teamA_done"] = wait_terminal(port, doc["id"], timeout=300,
                                            key="ka")["state"]
    finally:
        rc = stop(proc)
    if (codes["none"], codes["unknown"], codes["teamA"],
            codes["teamA_again"][:2], codes["teamB_reads_A"],
            codes["teamA_done"], rc) != (
            401, 403, 202, (429, "tenant_open_jobs"), 403, "finished", 0):
        raise AssertionError(f"phase 11c tenants: {codes}, exit {rc}")
    rep["tenants"] = codes
    log(f"phase 11c: --tenants: no key {codes['none']}, unknown key "
        f"{codes['unknown']}, teamA {codes['teamA']}, teamA again "
        f"{codes['teamA_again']}, teamB reading teamA's job "
        f"{codes['teamB_reads_A']}; exit {rc}")
    return rep


# -- phase 12: the CNN picker and the host utilities --------------------

#: the picker's goldens from the JAX package (tests/golden/
#: make_torch_port_golden.py --only picker): checkpoint, score maps, picks
PICKER = os.path.join(REPO, "tests", "golden", "torch_port_picker")
UTILITIES_DIGESTS = os.path.join(REPO, "tests", "golden",
                                 "torch_port_utilities_digests.json")
PICKER_SEEDS = (0, 1)
PICKER_PARTICLE = 180
#: (label, pick flags, mode, compute dtype); the score maps of every
#: setting are held to the JAX float32 maps of their mode
PICK_SETTINGS = (("patch", [], "patch", "float32"),
                 ("fcn", ["--mode", "fcn"], "fcn", "float32"),
                 ("patch_bf16", ["--bf16"], "patch", "bfloat16"))
MAP_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: H100 SXM dense peaks (data sheet, 700 W; a multiply-add is two
#: operations): float32 outside the tensor cores, bfloat16 on them
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
NMS_SIZES = (1024, 4096)
#: the golden generator's convert chains: BOX to each output format,
#: then each STAR / TSV output to each
CONVERT_CHAINS = tuple(
    [("box", o) for o in ("star", "tsv", "box")]
    + [(i, o) for i in ("star", "tsv") for o in ("star", "tsv", "box")])


def picker_flops(mode: str, h: int, w: int, patch: int, step: int = 4):
    """Floating-point operations (a multiply-add is two) of the deep
    architecture's convolutions and FC head for one binned ``(h, w)``
    micrograph: per window in ``patch`` mode, over the shifted resized
    copies in ``fcn`` mode.  Returns ``(flops, windows)``."""
    from repic_tpu_torch.models.cnn import ARCHS

    spec, width = ARCHS["deep"]["conv_spec"], ARCHS["deep"]["fc_width"]

    def backbone(hh, ww):
        macs, cin = 0, 1
        for k, f in spec:
            hh, ww = hh - k + 1, ww - k + 1
            macs += hh * ww * k * k * cin * f
            hh, ww, cin = hh // 2, ww // 2, f
        return macs, hh, ww, cin

    out_h, out_w = (h - patch) // step + 1, (w - patch) // step + 1
    if mode == "patch":
        macs, fh, fw, c = backbone(64, 64)
        per = macs + fh * fw * c * width + width * 2
        return 2.0 * per * out_h * out_w, out_h * out_w
    scale = 64 / patch
    sh, sw = int(round(h * scale)), int(round(w * scale))
    sstep = max(1, int(round(step * scale)))
    n = 16 // sstep
    macs, fh, fw, c = backbone(sh - (n - 1) * sstep, sw - (n - 1) * sstep)
    head = (fh - 1) * (fw - 1) * (4 * c * width + width * 2)
    windows = ((sh - 64) // sstep + 1) * ((sw - 64) // sstep + 1)
    return 2.0 * n * n * (macs + head), windows


def _grid_cells(rows, mode, patch=PICKER_PARTICLE // 3, step=4):
    """BOX rows (corner x, y) -> score-map grid cells (x, y)."""
    import numpy as np

    if mode == "fcn":
        scale = 64 / patch
        step = max(1, int(round(step * scale))) / scale
    xy = np.asarray(rows, float).reshape(-1, 2) + PICKER_PARTICLE / 2
    return np.rint((xy / 3 - patch / 2) / step).astype(int)


def _box_rows(path):
    with open(path) as f:
        return [tuple(float(v) for v in line.split()[:2]) for line in f]


def check_picks_against_jax(got_path, want_path, smap, mode):
    """The port's picks and JAX's on the same grid cells both ways: a
    cell in one set and not the other is excused only where JAX's map
    nearly ties (|d| < 1e-5) inside the window there, for at most 1% of
    picks, and the counts differ by at most 1 + 1%.  Returns
    ``(picks, excused)``."""
    import numpy as np

    patch = PICKER_PARTICLE // 3
    window = max(int(0.6 * patch / 4), 1)
    want = _grid_cells(_box_rows(want_path), mode)
    got = _grid_cells(_box_rows(got_path), mode)
    excused = 0
    for cells, others, side in ((got, want, "port"), (want, got, "JAX")):
        others = {tuple(c) for c in others}
        for x, y in cells:
            if (x, y) in others:
                continue
            win = smap[max(y - window, 0):y + window + 1,
                       max(x - window, 0):x + window + 1].ravel()
            d = np.abs(win[:, None] - win[None, :])
            if not (d[d > 0] < 1e-5).any():
                raise AssertionError(
                    f"{got_path}: {side} pick at cell ({x}, {y}) is missing "
                    "from the other side and has no near-tie")
            excused += 1
    if excused > len(want) // 100:
        raise AssertionError(f"{got_path}: {excused} picks differ from "
                             f"JAX's {len(want)}")
    if abs(len(got) - len(want)) > 1 + len(want) // 100:
        raise AssertionError(f"{got_path}: {len(got)} picks against JAX's "
                             f"{len(want)}")
    return len(got), excused


def row_chunk_readings(infer, sd, img, patch):
    """``score_micrograph_patches`` at the module's row chunk and at 32
    rows per batch: the warm scoring time by CUDA events (one call after
    one warm call), the peak device memory, and the map's largest
    difference from the module default's."""
    import torch

    default, res, base = infer.ROW_CHUNK, {}, None
    try:
        for rows in (default, 32):
            infer.ROW_CHUNK = rows
            infer.score_micrograph_patches(sd, img, patch_size=patch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            got = infer.score_micrograph_patches(sd, img, patch_size=patch)
            t1.record()
            torch.cuda.synchronize()
            base = got if base is None else base
            res[rows] = {"ms": t0.elapsed_time(t1),
                         "peak_bytes": torch.cuda.max_memory_allocated(),
                         "diff": float((got - base).abs().max())}
    finally:
        infer.ROW_CHUNK = default
    return res


def phase_picker():
    """Phase 12a/b: ``pick`` at full width on two 4096 x 4096 micrographs
    in three settings, the score maps against the JAX goldens, JAX's
    maps through the port's peak picking, and the device NMS against
    the host loop."""
    import numpy as np
    import torch

    from repic_tpu_torch.models import infer
    from repic_tpu_torch.models import preprocess as pp
    from repic_tpu_torch.models.checkpoint import (
        load_checkpoint, params_from_jax,
    )
    from repic_tpu_torch.models.cnn import fc_params_as_conv
    from repic_tpu_torch.ops.nms import greedy_suppress_device
    from repic_tpu_torch.utils import mrc
    from repic_tpu_torch.utils.box_io import render_box
    from repic_tpu_torch.utils.synthetic import synthetic_micrograph

    dev = torch.device("cuda")
    ckpt = os.path.join(PICKER, "deep.ckpt")
    golden = dict(np.load(os.path.join(PICKER, "maps.npz")))
    params, meta = load_checkpoint(ckpt)
    sd = {"patch": params_from_jax(params),
          "fcn": params_from_jax(fc_params_as_conv(params))}
    sd = {k: {n: t.to(dev) for n, t in v.items()} for k, v in sd.items()}
    mrc_dir = os.path.join(WORK, "picker_mrc")
    os.makedirs(mrc_dir)
    raws = {}
    for seed in PICKER_SEEDS:
        raws[seed], _ = synthetic_micrograph(seed)
        mrc.write_mrc(os.path.join(mrc_dir, f"mic_{seed}.mrc"), raws[seed])
    patch = PICKER_PARTICLE // 3
    res = {"card": smi(), "settings": {}}

    # the card's preprocessing and resize against the CPU's bits
    raw0 = torch.from_numpy(raws[0])
    img_cpu = pp.preprocess_micrograph(raw0)
    imgs = {seed: pp.preprocess_micrograph(torch.from_numpy(r).to(dev))
            for seed, r in raws.items()}
    res["preprocess_card_equals_cpu"] = bool(
        torch.equal(imgs[0].cpu(), img_cpu))
    windows = img_cpu.unfold(0, patch, 4).unfold(1, patch, 4)[:4].reshape(
        -1, patch, patch)
    b = pp.bytescale(windows)
    res["resize_card_equals_cpu"] = bool(torch.equal(
        pp.resize_patches(b.to(dev), 64).cpu(), pp.resize_patches(b, 64)))
    log(f"phase 12: card vs CPU bits: preprocess "
        f"{res['preprocess_card_equals_cpu']}, patch resize "
        f"{res['resize_card_equals_cpu']}")

    h, w = imgs[0].shape
    for label, flags, mode, dtype in PICK_SETTINGS:
        flops, n_windows = picker_flops(mode, h, w, patch)
        # the score maps against JAX's float32 maps of the same inputs,
        # with cuBLAS's TF32 on process-wide: scoring pins float32 itself
        # and gives the caller's setting back
        errs = []
        for seed in PICKER_SEEDS:
            torch.backends.cuda.matmul.allow_tf32 = True
            if mode == "fcn":
                got = infer.score_micrograph_fcn(
                    sd["fcn"], imgs[seed], patch_size=patch, dtype=dtype)
            else:
                got = infer.score_micrograph_patches(
                    sd["patch"], imgs[seed], patch_size=patch, dtype=dtype)
            if not torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError(f"{label}: scoring did not restore "
                                     "the caller's TF32 setting")
            torch.backends.cuda.matmul.allow_tf32 = False
            want = golden[f"mic_{seed}_{mode}"]
            if tuple(got.shape) != want.shape:
                raise AssertionError(f"{label}: map {tuple(got.shape)} vs "
                                     f"{want.shape}")
            errs.append(float(np.abs(got.cpu().numpy() - want).max()))
        if max(errs) > MAP_TOL[dtype]:
            raise AssertionError(f"{label}: score map max abs err "
                                 f"{max(errs)} > {MAP_TOL[dtype]}")
        # through the CLI, twice: the same bytes
        outs, walls = [], []
        for rep in range(2):
            out = os.path.join(WORK, f"pick_{label}_{rep}")
            torch.cuda.reset_peak_memory_stats()
            _, wall, _ = cli("pick", ckpt, mrc_dir, out, *flags)
            peak_mem = torch.cuda.max_memory_allocated()
            outs.append(out)
            walls.append(wall)
        for seed in PICKER_SEEDS:
            f = f"mic_{seed}.box"
            a, b2 = (open(os.path.join(o, f), "rb").read() for o in outs)
            if a != b2 or not a:
                raise AssertionError(f"{label}: {f} differs between runs")
        entry = {
            "map_max_abs_err": errs, "map_tol": MAP_TOL[dtype],
            "cold_s_per_micrograph": walls[0] / len(PICKER_SEEDS),
            "s_per_micrograph": walls[1] / len(PICKER_SEEDS),
            "windows_per_s": n_windows * len(PICKER_SEEDS) / walls[1],
            "windows": n_windows, "peak_device_bytes": peak_mem,
            "gflop_per_micrograph": flops / 1e9,
            "flop_bound_ms": flops / PEAK_FLOPS[dtype] * 1e3,
        }
        if dtype == "float32":
            # JAX's own map through the port's peak picking on the card:
            # JAX's BOX bytes; the port's picks: JAX's cells up to
            # near-ties
            entry["picks"] = {}
            for seed in PICKER_SEEDS:
                want_path = os.path.join(PICKER, f"picks_{mode}",
                                         f"mic_{seed}.box")
                smap = golden[f"mic_{seed}_{mode}"]
                coords = infer.picks_from_score_map(
                    smap, PICKER_PARTICLE, mode=mode, device=dev)
                text, _ = render_box(coords[:, :2] - PICKER_PARTICLE / 2,
                                     coords[:, 2], PICKER_PARTICLE)
                if text != open(want_path).read():
                    raise AssertionError(f"{label} mic_{seed}: peaks of "
                                         "JAX's map differ from JAX's")
                entry["picks"][seed] = check_picks_against_jax(
                    os.path.join(outs[1], f"mic_{seed}.box"), want_path,
                    smap, mode)
        if label == "patch":
            entry["row_chunks"] = row_chunk_readings(
                infer, sd["patch"], imgs[0], patch)
        raw_t = raws[0]
        wall_p, busy, top = device_busy(lambda: infer.pick_micrograph(
            params, raw_t, PICKER_PARTICLE, mode=mode, dtype=dtype,
            device=dev))
        entry.update(profiled_wall_s=wall_p, device_busy_s=busy,
                     top_kernels_s=top)
        res["settings"][label] = entry
        log(f"phase 12a: {label}: map max abs err {max(errs):.3g} (tol "
            f"{MAP_TOL[dtype]}); {entry['s_per_micrograph']:.3f} s per "
            f"micrograph warm ({entry['cold_s_per_micrograph']:.3f} cold), "
            f"{entry['windows_per_s']:.0f} windows/s; peak device memory "
            f"{peak_mem / 2**30:.2f} GiB; {flops / 1e12:.3f} TFLOP, bound "
            f"{entry['flop_bound_ms']:.2f} ms; repeat run byte-identical"
            + (f"; picks (n, near-tie) {entry['picks']}"
               if "picks" in entry else ""))
        log("  device busy share: " + (
            "not measured (the profiler saw no device events)"
            if busy is None else
            f"{busy:.4f} s of a {wall_p:.4f} s profiled pick = "
            f"{100 * busy / wall_p:.1f}%"))
        for name, sec in top[:4]:
            log(f"    {sec * 1e3:9.3f} ms  {name[:90]}")
        for rows, r in entry.get("row_chunks", {}).items():
            log(f"  row chunk {rows}: scoring {r['ms']:.1f} ms, peak "
                f"device memory {r['peak_bytes'] / 2**30:.2f} GiB, map "
                f"max abs diff from chunk {infer.ROW_CHUNK}: "
                f"{r['diff']:.3g}")

    # 12b: the device NMS against the host loop
    res["nms"] = {}
    for p in NMS_SIZES:
        rng = np.random.default_rng(p)
        yx = rng.integers(0, 8 * int(np.sqrt(p)), size=(p, 2))
        scores = rng.random(p).astype(np.float32)
        thr = 9 / 2.0
        greedy_suppress_device(yx, scores, thr, device=dev)   # warm
        t = time.perf_counter()
        keep_dev = greedy_suppress_device(yx, scores, thr, device=dev)
        dev_s = time.perf_counter() - t
        t = time.perf_counter()
        keep_host = infer.greedy_suppress_host(yx, scores, thr)
        host_s = time.perf_counter() - t
        if not np.array_equal(keep_dev, keep_host):
            raise AssertionError(f"NMS P={p}: device keep mask differs")
        res["nms"][p] = {"device_s": dev_s, "host_s": host_s,
                         "kept": int(keep_host.sum())}
        log(f"phase 12b: NMS P={p}: keep masks equal "
            f"({int(keep_host.sum())} kept); device {dev_s * 1e3:.1f} ms, "
            f"host loop {host_s * 1e3:.1f} ms")
    return res


def phase_utilities():
    """Phase 12c: ``convert``, ``score`` (rasterized on the card, and
    ``--match distance``) and ``build_subsets`` through the CLI, against
    the JAX digests and the executed-reference goldens."""
    import numpy as np

    from repic_tpu_torch.utils.synthetic import (
        output_digests, subsets_membership, write_subsets_fixture,
    )

    with open(UTILITIES_DIGESTS) as f:
        want = json.load(f)
    res = {}
    t = time.time()
    n_files = 0
    for picker in sorted(os.listdir(EXAMPLES)):
        for in_fmt, out_fmt in CONVERT_CHAINS:
            src = (os.path.join(EXAMPLES, picker) if in_fmt == "box" else
                   os.path.join(WORK, "convert", picker, f"box_{in_fmt}"))
            files = sorted(os.path.join(src, f) for f in os.listdir(src)
                           if f.endswith("." + in_fmt))
            out = os.path.join(WORK, "convert", picker,
                               f"{in_fmt}_{out_fmt}")
            cli("convert", *files, out, "-f", in_fmt, "-t", out_fmt, "-b",
                BOX, "--quiet")
            got = output_digests(out, ("." + out_fmt,))
            if got != want["convert"][f"{picker}/{in_fmt}_{out_fmt}"]:
                raise AssertionError(f"convert {picker} {in_fmt}->{out_fmt}"
                                     ": bytes differ from the JAX digests")
            n_files += len(got)
    res["convert"] = {"files": n_files, "wall_s": time.time() - t}
    log(f"phase 12c: convert: {n_files} files in {len(CONVERT_CHAINS)} "
        f"chains x 3 pickers equal the JAX digests "
        f"({res['convert']['wall_s']:.2f} s)")

    golden = {}
    with open(os.path.join(REPO, "tests", "golden",
                           "ref_scores_cryolo_vs_topaz_10017.tsv")) as f:
        next(f)
        for line in f:
            name, *vals = line.split("\t")
            golden[name] = [float(v) for v in vals]
    gt = sorted(os.path.join(EXAMPLES, "crYOLO", f)
                for f in os.listdir(os.path.join(EXAMPLES, "crYOLO")))
    pk = sorted(os.path.join(EXAMPLES, "topaz", f)
                for f in os.listdir(os.path.join(EXAMPLES, "topaz")))
    out = os.path.join(WORK, "score")
    _, wall, _ = cli("score", "-g", *gt, "-p", *pk, "--out_dir", out)
    rows = {}
    with open(os.path.join(out, "particle_set_comp.tsv")) as f:
        next(f)
        for line in f:
            name, *vals = line.split("\t")
            rows[name] = [float(v) for v in vals]
    if sorted(rows) != sorted(golden):
        raise AssertionError("score: micrographs differ from the golden")
    worst = max(float(np.max(np.abs(np.array(rows[k]) - golden[k])
                             / np.maximum(np.abs(golden[k]), 1e-30)))
                for k in golden)
    if worst > 1e-6:
        raise AssertionError(f"score: rel err {worst} > 1e-6")
    res["score"] = {"micrographs": len(rows), "max_rel_err": worst,
                    "wall_s": wall}
    log(f"phase 12c: score (rasterized on cuda): 12 rows within rel "
        f"{worst:.2g} of the executed reference ({wall:.2f} s)")

    fixture = os.path.join(REPO, "tests", "fixtures", "distance")
    with open(os.path.join(REPO, "tests", "golden",
                           "ref_distance_stats.json")) as f:
        stats = json.load(f)
    out = os.path.join(WORK, "distance")
    gt = sorted(os.path.join(fixture, f) for f in os.listdir(fixture)
                if f.endswith(".star"))
    pk = sorted(os.path.join(fixture, f) for f in os.listdir(fixture)
                if f.endswith(".box"))
    cli("score", "-g", *gt, "-p", *pk, "--match", "distance",
        "--gt_format", "star", "--box_size", stats["particle_size"],
        "--dist_rate", stats["rate"], "--out_dir", out)
    if open(os.path.join(out, "results.txt")).read() != open(os.path.join(
            REPO, "tests", "golden", "ref_distance_results.txt")).read():
        raise AssertionError("score --match distance: results.txt differs")
    log("phase 12c: score --match distance: results.txt equals the "
        "executed reference's")

    res["build_subsets"] = {}
    for label, flags in (("default", []), ("ignore_test",
                                           ["--ignore_test"])):
        root = os.path.join(WORK, "subsets_" + label)
        defocus, box_dir, mrc_dir = write_subsets_fixture(root)
        out = os.path.join(root, "out")
        cli("build_subsets", defocus, box_dir, mrc_dir, out, *flags)
        got = subsets_membership(out)
        if got != want["build_subsets"][label]:
            raise AssertionError(f"build_subsets {label}: membership "
                                 "differs from the JAX digest")
        res["build_subsets"][label] = {k: len(v) for k, v in got.items()}
    log(f"phase 12c: build_subsets: split membership equals the JAX "
        f"digest {res['build_subsets']}")
    return res


# -- phase 13: the picker's training half and the iterative loop -------

#: the JAX training goldens (tests/golden/make_torch_port_golden.py
#: --only training): one update step's inputs and outputs
TRAINING = os.path.join(REPO, "tests", "golden", "torch_port_training")
#: seeds of phase 13's 4096 x 4096 micrographs: fit's training and
#: validation sets, 13c's held-out pair, 13d's ensemble data
FIT_TRAIN_SEEDS = (100, 101, 102, 103)
FIT_VAL_SEED = 104
HELD_OUT_SEEDS = (200, 201)
ITER_SEEDS = tuple(range(300, 312))
FIT_BATCH = 128
FIT_EPOCHS = 30
#: the reference test's limit on the planted-blob fixture (the CPU tests
#: reach 0%): the card's best validation error must stay under it
FIT_VAL_LIMIT = 10.0
BF16_MARGIN = 1.5
ITER_F1_LIMIT = 0.5
#: deep-architecture float32 FLOPs of one 64 x 64 window (phase 12's
#: picker_flops per window); a training step is about three forwards
WINDOW_FLOPS = 9.0e6


def _write_labelled(mrc_dir, box_dir, seeds):
    """Seeded 4096 x 4096 micrographs and BOX labels at their planted
    centres (box 180)."""
    import numpy as np

    from repic_tpu_torch.utils import mrc
    from repic_tpu_torch.utils.box_io import write_box
    from repic_tpu_torch.utils.synthetic import synthetic_micrograph

    os.makedirs(mrc_dir, exist_ok=True)
    os.makedirs(box_dir, exist_ok=True)
    n = 0
    for seed in seeds:
        img, centres = synthetic_micrograph(seed)
        mrc.write_mrc(os.path.join(mrc_dir, f"mic_{seed}.mrc"), img)
        write_box(os.path.join(box_dir, f"mic_{seed}.box"),
                  centres.astype(np.float64) - BOX / 2,
                  np.ones(len(centres)), BOX)
        n += len(centres)
    return n


def _fit_process(args, out):
    """``python -m repic_tpu_torch fit ...`` in a process of its own;
    returns ``(stdout, wall_s)``.  A non-zero exit is fatal."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "fit", *map(str, args)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    wall = time.time() - t
    with open(os.path.join(OUT, f"fit_{os.path.basename(out)}.log"),
              "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"phase 13a: fit exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc.stdout, wall


def _fit_readings(model_dir):
    """Steps per second (the train_epoch events after epoch 0), epochs
    run and the allocator's peak from a fit run's telemetry."""
    from repic_tpu_torch.telemetry.events import read_events

    epochs = [e for e in read_events(model_dir)
              if e.get("ev") == "event" and e.get("name") == "train_epoch"]
    rates = [e["steps_per_sec"] for e in epochs if "steps_per_sec" in e]
    mem = {s["labels"]["stat"]: s["value"] for s in json.load(open(
        os.path.join(model_dir, "_metrics.json")))["metrics"].get(
            "repic_device_memory_bytes", {}).get("samples", [])}
    return {"epochs": len(epochs) - 1,
            "steps_per_sec": sorted(rates)[len(rates) // 2] if rates else None,
            "val_error": [e["val_error"] for e in epochs],
            "peak_bytes": mem.get("peak_bytes_in_use")}


def phase_fit():
    """Phase 13a/b/c: ``fit`` at full width in a process of its own, run
    twice for the checkpoint bytes and once in bfloat16; one step from
    the JAX golden on the card; ``pick`` with the trained checkpoint."""
    import torch

    from repic_tpu_torch.models.checkpoint import load_checkpoint
    from repic_tpu_torch.models.data import load_dataset
    from repic_tpu_torch.models.train import TrainConfig, fit

    res = {"card": smi()}
    root = os.path.join(WORK, "fit")
    train = (os.path.join(root, "train_mrc"), os.path.join(root, "train_box"))
    val = (os.path.join(root, "val_mrc"), os.path.join(root, "val_box"))
    n_pos = _write_labelled(*train, FIT_TRAIN_SEEDS)
    _write_labelled(*val, (FIT_VAL_SEED,))
    runs = {}
    for label, flags in (("f32_a", []), ("f32_b", []), ("bf16", ["--bf16"])):
        out = os.path.join(root, label)
        os.makedirs(out)
        model = os.path.join(out, "model.rptpu")
        stdout, wall = _fit_process(
            [*train, model, "--val_mrc_dir", val[0], "--val_label_dir",
             val[1], "--particle_size", BOX, "--batch_size", FIT_BATCH,
             "--max_epochs", FIT_EPOCHS, "--arch", "deep", *flags], out)
        _, meta = load_checkpoint(model)
        runs[label] = {"wall_s": wall, "best_val_error":
                       meta["best_val_error"], "stdout": stdout.strip(),
                       **_fit_readings(out)}
        with open(model, "rb") as f:
            runs[label]["bytes"] = f.read()
    a = runs["f32_a"]
    m = re.search(r"train: (\d+) patches \((\d+) positive\), val: (\d+)",
                  a["stdout"])
    n_train, n_val = int(m.group(1)), int(m.group(3))
    steps_per_epoch = n_train // FIT_BATCH
    step_flops = 3 * FIT_BATCH * WINDOW_FLOPS
    bound_ms = step_flops / PEAK_FLOPS["float32"] * 1e3
    if runs["f32_a"]["bytes"] != runs["f32_b"]["bytes"]:
        raise AssertionError("phase 13a: two float32 fits of one seed wrote "
                             "different checkpoint bytes")
    if a["best_val_error"] > FIT_VAL_LIMIT:
        raise AssertionError(f"phase 13a: best val error "
                             f"{a['best_val_error']} > {FIT_VAL_LIMIT}")
    if runs["bf16"]["best_val_error"] > a["best_val_error"] + BF16_MARGIN:
        raise AssertionError(
            f"phase 13a: bf16 best val error {runs['bf16']['best_val_error']}"
            f" > float32's {a['best_val_error']} + {BF16_MARGIN}")
    for label, r in runs.items():
        r.pop("bytes")
        sps = r["steps_per_sec"]
        log(f"phase 13a: fit {label}: {n_train} train patches ({n_pos} "
            f"planted), {n_val} val, batch {FIT_BATCH}, {r['epochs']} epochs "
            f"x {steps_per_epoch} steps in {r['wall_s']:.1f}s (process); "
            f"{sps} steps/s, {steps_per_epoch / sps if sps else 0:.3f} s per"
            f" epoch; best val error {r['best_val_error']:.3f}%; peak "
            f"{(r['peak_bytes'] or 0) / 2**20:.0f} MiB")
    log(f"phase 13a: checkpoint bytes equal over two float32 runs; a step's "
        f"FLOP bound {step_flops / 1e9:.3f} GFLOP = {bound_ms:.4f} ms at "
        f"{PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s float32 against "
        f"{1e3 / a['steps_per_sec']:.3f} ms measured ({res['card']})")

    # the device's busy share of a two-epoch fit in this process
    dev = torch.device("cuda")
    t = time.time()
    tr = load_dataset(*train, BOX, device=dev)
    va = load_dataset(*val, BOX, seed=1235, device=dev)
    load_s = time.time() - t
    wall, busy, top = device_busy(lambda: fit(
        *tr, *va, TrainConfig(batch_size=FIT_BATCH, max_epochs=2,
                              verbose=False), device=dev))
    if busy is None:
        raise AssertionError("phase 13a: the profiler saw no device work")
    res["profiled"] = {"load_s": load_s, "wall_s": wall, "busy_s": busy,
                       "busy_share": busy / wall, "top_kernels_s": top}
    log(f"phase 13a: two epochs in this process under torch.profiler: "
        f"device busy {busy:.3f}s of {wall:.3f}s ({100 * busy / wall:.1f}%);"
        f" loading the 5 micrographs' patches {load_s:.2f}s; top "
        + ", ".join(f"{k[:40]} {v:.3f}s" for k, v in top[:3]))
    res.update(runs=runs, n_train=n_train, n_val=n_val,
               step_flops=step_flops, step_bound_ms=bound_ms)

    res["step"] = phase_train_step()
    res["pick"] = phase_trained_pick(os.path.join(root, "f32_a",
                                                  "model.rptpu"))
    return res


def phase_train_step():
    """Phase 13b: one update on the card from the committed JAX golden's
    parameters, batch, labels and dropout mask, at the CPU test's
    tolerances; the learning rates bitwise."""
    import numpy as np
    import torch

    from repic_tpu_torch.models.checkpoint import params_from_jax
    from repic_tpu_torch.models.cnn import PickerCNN
    from repic_tpu_torch.models.infer import _fp32_flags
    from repic_tpu_torch.models.train import learning_rate, train_step

    g = dict(np.load(os.path.join(TRAINING, "step.npz")))

    def tree(prefix):
        out = {}
        for k, v in g.items():
            if k.startswith(prefix):
                *path, leaf = k[len(prefix):].split("/")
                node = out
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = v
        return out

    dev = torch.device("cuda")
    model = PickerCNN(device="meta")
    model.load_state_dict({k: v.to(dev) for k, v in params_from_jax(
        tree("params/")).items()}, assign=True)
    model.requires_grad_(True)
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    lr = learning_rate(0, 0.01, 8, 0.95)
    lr_ok = lr.tobytes() == g["lr"].tobytes() and all(
        np.array([learning_rate(c, 0.01, ds, 0.95)
                  for c in (0, ds - 1, ds, 10 * ds)]).tobytes()
        == g[f"lr/{ds}"].tobytes() for ds in (1, 8, 24, 184))
    if not lr_ok:
        raise AssertionError("phase 13b: learning rates differ from optax's")
    with _fp32_flags():
        loss, logits = train_step(
            model, momentum, torch.from_numpy(g["batch"]).to(dev),
            torch.from_numpy(g["labels"].astype(np.int64)).to(dev), lr,
            dropout_mask=torch.from_numpy(g["mask"]).to(dev))
    torch.cuda.synchronize()
    loss_rel = abs(float(loss) / float(g["loss"]) - 1)
    logit_err = float(np.abs(logits.cpu().numpy() - g["logits"]).max())
    want_p = params_from_jax(tree("updated/"))
    want_t = params_from_jax(tree("trace/"))
    p_err = max(float((p.detach().cpu() - want_p[k]).abs().max())
                for k, p in model.named_parameters())
    t_err = max(float((momentum[k].cpu() - want_t[k]).abs().max()
                      / want_t[k].abs().max()) for k in momentum)
    res = {"loss_rel": loss_rel, "logits_max_abs": logit_err,
           "params_max_abs": p_err, "momentum_max_rel": t_err}
    if loss_rel >= 1e-6 or logit_err >= 1e-5 or p_err >= 1e-6 \
            or t_err >= 1e-4:
        raise AssertionError(f"phase 13b: the card's step vs the JAX golden:"
                             f" {res}")
    log(f"phase 13b: one step on the card from the JAX golden: loss rel "
        f"{loss_rel:.3g}, logits {logit_err:.3g}, parameters "
        f"{p_err:.3g}, momentum {t_err:.3g} of each leaf's max; learning "
        "rates bitwise optax's")
    return res


def phase_trained_pick(model):
    """Phase 13c: ``pick`` with 13a's checkpoint on two held-out
    micrographs: F1 against the planted centres (``score``, rasterized
    on the card), the candidates (local maxima) per micrograph, and
    whether the device NMS ran."""
    import numpy as np
    import torch
    from scipy import ndimage

    from repic_tpu_torch.models import infer
    from repic_tpu_torch.models import preprocess as pp
    from repic_tpu_torch.models.checkpoint import (
        load_checkpoint, params_from_jax,
    )
    from repic_tpu_torch.ops import nms
    from repic_tpu_torch.utils.scoring import score_box_files
    from repic_tpu_torch.utils import mrc

    root = os.path.join(WORK, "held_out")
    mrc_dir, gt_dir = os.path.join(root, "mrc"), os.path.join(root, "gt")
    _write_labelled(mrc_dir, gt_dir, HELD_OUT_SEEDS)
    out = os.path.join(root, "picks")
    calls = []
    device_nms = nms.greedy_suppress_device

    def counted(yx, *a, **k):
        calls.append(len(yx))
        return device_nms(yx, *a, **k)

    nms.greedy_suppress_device = counted
    try:
        _, wall, _ = cli("pick", model, mrc_dir, out)
    finally:
        nms.greedy_suppress_device = device_nms
    names = sorted(f[:-4] for f in os.listdir(mrc_dir))
    gt = [os.path.join(gt_dir, f"{n}.box") for n in names]
    picked = [os.path.join(out, f"{n}.box") for n in names]
    rows = score_box_files(gt, picked, device="cuda")
    strong = score_box_files(gt, picked, conf_thresh=0.5, device="cuda")
    params, _ = load_checkpoint(model)
    sd = {k: v.cuda() for k, v in params_from_jax(params).items()}
    patch = BOX // 3
    window = max(int(0.6 * patch / infer.STEP_SIZE), 1)
    res = {"wall_s": wall, "device_nms_calls": calls, "micrographs": {}}
    for name, row, row_strong in zip(names, rows, strong):
        img = pp.preprocess_micrograph(torch.from_numpy(np.ascontiguousarray(
            mrc.read_mrc(os.path.join(mrc_dir, f"{name}.mrc")),
            np.float32)).cuda())
        smap = infer.score_micrograph_patches(sd, img, patch_size=patch)
        mask = infer.local_maxima_mask(smap, window).cpu().numpy()
        _, candidates = ndimage.label(mask)
        picks = sum(1 for _ in open(os.path.join(out, f"{name}.box")))
        res["micrographs"][name] = {
            "precision": row[1], "recall": row[2], "f1": row[3],
            "f1_score_above_half": row_strong[3],
            "candidates": int(candidates), "picks": picks}
        if picks == 0:
            raise AssertionError(f"phase 13c: no pick in {name}")
    f1 = float(np.mean([r[3] for r in rows]))
    f1_strong = float(np.mean([r[3] for r in strong]))
    res.update(mean_f1=f1, mean_f1_score_above_half=f1_strong)
    reached = bool(calls)
    res["device_nms_reached"] = reached
    log(f"phase 13c: pick with the trained checkpoint on {len(names)} "
        f"held-out micrographs in {wall:.2f}s: mean F1 {f1:.3f} against "
        f"the planted centres ({f1_strong:.3f} for the picks scored above "
        f"0.5); " + "; ".join(
            f"{n}: {r['candidates']} candidates, {r['picks']} picks, F1 "
            f"{r['f1']:.3f}" for n, r in res["micrographs"].items())
        + f"; device NMS {'reached' if reached else 'not reached'} "
        f"(from {nms.DEVICE_NMS_MIN_P} candidates; calls {calls})")
    return res


def _stage_seconds(log_text):
    """Seconds per stage of an ``iter_pick.log``: predict and fit per
    picker, consensus per split."""
    out = {}
    for line in log_text.splitlines():
        m = re.search(r"\] (predict (\S+)/\S+|consensus/(\S+)|round \d+ fit "
                      r"(\S+)).*\((\d+\.\d+)s\)$", line)
        if m:
            key = (f"predict {m.group(2)}" if m.group(2) else
                   f"consensus" if m.group(3) else f"fit {m.group(4)}")
            out[key] = round(out.get(key, 0.0) + float(m.group(5)), 3)
    return out


def phase_iterative():
    """Phase 13d: ``iter_config`` and ``iter_pick`` through the CLI with
    the builtin deep/wide/slim ensemble on 12 seeded 4096 x 4096
    micrographs: semi-automatic round 0 from the planted centres, one
    retraining round at the CLI's defaults, scored against the centres;
    then the same command again, which must resume and do nothing."""
    import numpy as np

    root = os.path.join(WORK, "iterative")
    data, labels = os.path.join(root, "mrc"), os.path.join(root, "labels")
    _write_labelled(data, labels, ITER_SEEDS)
    cfg = os.path.join(root, "iter_config.json")
    out = os.path.join(root, "run")
    cli("iter_config", data, BOX, 750, "builtin", "builtin", 4, 8,
        "--cryolo_env", "builtin", "--deep_env", "builtin", "--topaz_env",
        "builtin", "--out_file_path", cfg)
    argv = ("iter_pick", cfg, 1, 100, "--out_dir", out, "--semi_auto",
            "--manual_label_dir", labels, "--score", labels)
    _, wall, _ = cli(*argv)
    log_text = open(os.path.join(out, "iter_pick.log")).read()
    state = json.load(open(os.path.join(out, "state.json")))
    with open(os.path.join(state["rounds"][-1]["consensus"]["test"],
                           "particle_set_comp.tsv")) as f:
        next(f)
        f1s = [float(line.split("\t")[3]) for line in f]
    splits = {s: len(os.listdir(os.path.join(out, "data", s)))
              for s in ("train", "val", "test")}
    _, rerun_wall, _ = cli(*argv)
    rerun_log = open(os.path.join(out, "iter_pick.log")).read()[
        len(log_text):]
    state_again = json.load(open(os.path.join(out, "state.json")))
    f1 = float(np.mean(f1s))
    res = {"wall_s": wall, "rerun_wall_s": rerun_wall, "splits": splits,
           "stage_s": _stage_seconds(log_text), "test_f1": f1s,
           "mean_f1": f1}
    with open(os.path.join(OUT, "iter_pick.log"), "w") as f:
        f.write(log_text + rerun_log)
    if min(splits.values()) < 2:
        raise AssertionError(f"phase 13d: splits {splits}")
    if f1 <= ITER_F1_LIMIT:
        raise AssertionError(f"phase 13d: final mean F1 {f1} <= "
                             f"{ITER_F1_LIMIT}")
    if ("resuming: rounds 0..1 already complete" not in rerun_log
            or re.search(r"\] (predict|round \d+ fit|consensus/)", rerun_log)
            or state_again["rounds"] != state["rounds"]):
        raise AssertionError(f"phase 13d: the rerun was not a resume that "
                             f"does nothing: {rerun_log[-1500:]}")
    log(f"phase 13d: iter_pick (builtin deep/wide/slim, 1 round, train "
        f"100%, splits {splits}) in {wall:.1f}s; seconds per stage "
        f"{res['stage_s']}; final test-split mean F1 {f1:.3f}; the rerun "
        f"resumed and did nothing in {rerun_wall:.2f}s")
    return res


# -- A/B passes: one tree's directory runs, for a before/after ----------

#: warm synthetic_256 pairs (prefetch on, off) per --passes process
PASS_REPS = 5
#: where --passes writes its inputs once and every later process reuses
#: them (one tree's generator, the same seeds)
AB_INPUTS = os.path.join(REPO, "build", "chip_smoke_ab")


# -- phase 14: the cluster runtime, the serving fleet, the mesh ---------


def _child_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=REPO, REPIC_TPU_NO_CONFIG_CACHE="1")
    for var in ("REPIC_TPU_FAULTS", "REPIC_TPU_HOST_ID",
                "REPIC_TPU_HOST_RANK", "REPIC_TPU_NUM_HOSTS",
                "REPIC_CONSENSUS_CHUNK", "REPIC_TPU_REPLICA_ID"):
        env.pop(var, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _need_launches(label, counts, keys):
    """Fail unless every kernel of ``keys`` launched in ``counts``."""
    missing = [k for k in keys if counts.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched: {counts}")


def _same_boxes(label, out, ref):
    """Every BOX file of ``ref`` (phase 4's) in ``out``, byte for byte,
    and no other."""
    want = sorted(f for f in os.listdir(ref) if f.endswith(".box"))
    got = sorted(f for f in os.listdir(out) if f.endswith(".box"))
    if got != want:
        raise AssertionError(f"{label}: {len(got)} BOX files, phase 4 "
                             f"wrote {len(want)}")
    diff = [f for f in want if not filecmp.cmp(
        os.path.join(out, f), os.path.join(ref, f), shallow=False)]
    if diff:
        raise AssertionError(f"{label}: {len(diff)} BOX files differ from "
                             f"phase 4's: {diff[:5]}")
    return len(want)


def _cluster_run(label, synth, out, hosts, solver, pallas, faults=None):
    """``hosts`` consensus host processes over ``out`` (also the
    coordination directory); returns per rank ``(rc, stats or None,
    wall, output tail)``."""
    os.makedirs(out, exist_ok=True)
    procs = []
    for rank in range(hosts):
        env = _child_env(REPIC_TPU_HOST_ID=f"h{rank}",
                         REPIC_TPU_HOST_RANK=rank,
                         REPIC_TPU_NUM_HOSTS=hosts,
                         REPIC_CONSENSUS_CHUNK=CLUSTER_CHUNK)
        if faults and rank in faults:
            env["REPIC_TPU_FAULTS"] = faults[rank]
        cmd = [sys.executable, "-m", "repic_tpu_torch", "consensus", synth,
               out, str(BOX), "--solver", solver, "--coordination-dir", out,
               "--device", CHILD_DEVICE]
        if pallas:
            cmd.append("--pallas")
        log_path = os.path.join(OUT, f"phase14_{label}_h{rank}.log")
        fh = open(log_path, "w")
        procs.append((subprocess.Popen(cmd, stdout=fh, stderr=fh, env=env,
                                       cwd=REPO), time.time(), fh,
                      log_path))
    results = []
    ends = {}
    try:
        deadline = time.time() + 300
        while len(ends) < len(procs):
            if time.time() > deadline:
                raise AssertionError(f"phase 14a {label}: hosts still "
                                     "running after 300 s")
            for i, (proc, _t, _fh, _p) in enumerate(procs):
                if i not in ends and proc.poll() is not None:
                    ends[i] = time.time()
            time.sleep(0.05)
        for i, (proc, t0, fh, log_path) in enumerate(procs):
            fh.close()
            with open(log_path) as f:
                text = f.read()
            stats = None
            for line in reversed(text.strip().splitlines()):
                if line.startswith("{"):
                    stats = json.loads(line)
                    break
            results.append((proc.returncode, stats, ends[i] - t0,
                            text[-3000:]))
    finally:
        for proc, _t, fh, _p in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    return results


def _host_dispatches(out):
    """Per host: its journal's ``chunk_dispatches`` events and their
    dispatch total."""
    from repic_tpu_torch.runtime.journal import _read_entries

    per = {}
    for path in sorted(os.listdir(out)):
        if path.startswith("_journal.") and path.endswith(".jsonl"):
            host = path[len("_journal."):-len(".jsonl")]
            ev = [e for e in _read_entries(os.path.join(out, path))
                  if e.get("event") == "chunk_dispatches"]
            per[host] = {"events": len(ev),
                         "dispatches": sum(e["dispatches"] for e in ev),
                         "micrographs": sum(e["micrographs"] for e in ev),
                         "entries": sorted({e["entry"] for e in ev})}
    return per


def phase_cluster(synth, phase4_outs):
    """Phase 14a: ``synthetic_256`` as 3 cluster hosts with one crash,
    then 2 hosts with ``--pallas``."""
    from repic_tpu_torch.runtime.cluster import CRASH_EXIT_CODE
    from repic_tpu_torch.runtime.journal import (
        DONE_STATUSES, merged_latest, read_all_journals,
    )
    from repic_tpu_torch.telemetry.report import build_report, format_report

    rep = {}
    launches = {k: 0 for k in ("topk_neighbors", "fused_clique_candidates",
                               "fused_dual_solve", "dual_ascent")}
    runs = (
        ("cluster3", 3, "lp_device_fused", False,
         {1: "host_crash:after_chunk:1:1"}, "lp_device_fused"),
        ("cluster2_pallas", 2, "lp_device", True, None, "lp_device_pallas"),
    )
    for label, hosts, solver, pallas, faults, ref in runs:
        out = os.path.join(WORK, label)
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.time()
        results = _cluster_run(label, synth, out, hosts, solver, pallas,
                               faults)
        wall = time.time() - t0
        for rank, (rc, stats, hwall, tail) in enumerate(results):
            want = CRASH_EXIT_CODE if faults and rank in faults else 0
            if rc != want:
                raise AssertionError(f"phase 14a {label}: host {rank} "
                                     f"exited {rc}, expected {want}:\n{tail}")
            if rc == 0 and not str(stats.get("device", "")).startswith(
                    CHILD_DEVICE):
                raise AssertionError(f"phase 14a {label}: host {rank} ran "
                                     f"on {stats.get('device')}")
        n = _same_boxes(f"phase 14a {label}", out, phase4_outs[ref])
        merged = merged_latest(out)
        lost = [nm for nm, e in merged.items()
                if e.get("status") not in DONE_STATUSES]
        if len(merged) != N_SYNTH or lost:
            raise AssertionError(f"phase 14a {label}: {len(merged)} "
                                 f"micrographs journaled, not done: "
                                 f"{lost[:5]}")
        entries = read_all_journals(out)
        reassigned_ev = [e for e in entries
                         if e.get("event") == "work_reassigned"]
        provenance = [e for e in merged.values() if e.get("reassigned_from")]
        run_launches = {k: 0 for k in launches}
        for rc, stats, _w, _t in results:
            if stats is not None:
                for k, v in stats["launches"].items():
                    run_launches[k] += v
                    launches[k] += v
        _need_launches(f"phase 14a {label}", run_launches,
                       LAUNCH_KEYS["lp_device_pallas" if pallas
                                   else "lp_device_fused"])
        disp = _host_dispatches(out)
        for rank, (rc, stats, _w, _t) in enumerate(results):
            d = disp.get(f"h{rank}")
            if d is None or d["events"] == 0:
                raise AssertionError(f"phase 14a {label}: host {rank} "
                                     "journaled no chunk_dispatches")
            # one fetch per accepted chunk: the rest are the launches
            # of every host, the crashed one's too, and at most the
            # process's own (escalated attempts are not counted)
            in_events = d["dispatches"] - d["events"]
            _need_launches(f"phase 14a {label} host {rank}'s "
                           "chunk_dispatches", {"events": in_events},
                           ("events",))
            if stats is not None and in_events > sum(
                    stats["launches"].values()):
                raise AssertionError(
                    f"phase 14a {label}: host {rank}'s chunk_dispatches "
                    f"{d} against its launches {stats['launches']}")
        info = {"hosts": hosts, "wall_s": wall,
                "host_walls_s": [r[2] for r in results],
                "exit_codes": [r[0] for r in results],
                "launches": run_launches, "chunk_dispatches": disp,
                "box_files": n}
        if faults:
            if not reassigned_ev or not provenance:
                raise AssertionError(f"phase 14a {label}: reassigned "
                                     f"events {len(reassigned_ev)}, "
                                     f"provenance {len(provenance)}")
            if any(e.get("status") == "quarantined"
                   for e in merged.values()):
                raise AssertionError(f"phase 14a {label}: quarantined")
            crashed = [e for e in entries if e.get("host") == "h1"
                       and "name" in e]
            fenced = [e for e in entries if e.get("event") == "host_fenced"]
            if not crashed or not fenced:
                raise AssertionError(f"phase 14a {label}: crashed host "
                                     f"records {len(crashed)}, fences "
                                     f"{len(fenced)}")
            crash_to_fence = fenced[0]["ts"] - max(e["ts"] for e in crashed)
            report = build_report(out)
            text = format_report(report)
            if "cluster" not in report or "cluster hosts:" not in text:
                raise AssertionError(f"phase 14a {label}: report has no "
                                     "cluster section")
            info.update(reassigned=len(provenance),
                        reassigned_events=len(reassigned_ev),
                        crash_to_fence_s=crash_to_fence,
                        report_cluster=report["cluster"])
            log(f"phase 14a: {label}: host walls "
                + ", ".join(f"h{i} {r[2]:.2f}s (rc {r[0]})"
                            for i, r in enumerate(results))
                + f"; crash to fence {crash_to_fence:.2f}s; reassigned "
                f"{len(provenance)} micrographs in {len(reassigned_ev)} "
                f"takeover(s); report's cluster section: suspects "
                f"{report['cluster']['suspects']}, fences "
                f"{report['cluster']['fences']}")
        log(f"phase 14a: {label} ({hosts} hosts, {solver}"
            f"{' --pallas' if pallas else ''}): {n} BOX files equal phase "
            f"4's, none lost; wall {wall:.2f}s; launches {run_launches}; "
            f"chunk_dispatches per host "
            + ", ".join(f"{h}: {d['events']} chunks, {d['dispatches']} "
                        "dispatches" for h, d in disp.items()))
        rep[label] = info
        shutil.rmtree(out, ignore_errors=True)
    rep["launches"] = launches
    return rep


def _fleet_replica(fleet, rid, extra_env=None):
    """``serve --fleet-dir`` as a process on the card (its default
    device); returns ``(proc, port, log path)`` once ``_serve.json``
    names it."""
    wd = os.path.join(WORK, f"fleet_wd_{rid}")
    os.makedirs(wd, exist_ok=True)
    env = _child_env(REPIC_CONSENSUS_CHUNK=1, **(extra_env or {}))
    log_path = os.path.join(OUT, f"phase14_replica_{rid}.log")
    fh = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repic_tpu_torch", "serve", wd, "--port",
         "0", "--no-warmup", "--fleet-dir", fleet, "--replica-id", rid,
         "--heartbeat-interval", FLEET_HB, "--replica-timeout",
         FLEET_TIMEOUT, "--queue-limit", "64", "--device", CHILD_DEVICE],
        stdout=fh, stderr=fh, env=env, cwd=REPO)
    fh.close()
    deadline = time.time() + 120
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"phase 14b: replica {rid} exited "
                                 f"{proc.returncode} at startup:\n"
                                 + open(log_path).read()[-3000:])
        try:
            with open(os.path.join(wd, "_serve.json")) as f:
                info = json.load(f)
            if info.get("pid") == proc.pid:
                return proc, info["port"], log_path
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"phase 14b: replica {rid} never started")


def _fleet_entries(fleet):
    from repic_tpu_torch.runtime.journal import _read_entries

    out = []
    for f in sorted(os.listdir(fleet)):
        if f.startswith("_serve_journal") and f.endswith(".jsonl"):
            out.extend(_read_entries(os.path.join(fleet, f)))
    return out


def phase_fleet(synth, phase4_outs):
    """Phase 14b: three fleet replicas, a SIGKILL mid-job, the burst,
    the drain."""
    from repic_tpu_torch.serve.fleet import FleetMember
    from repic_tpu_torch.serve.jobs import TERMINAL_STATES
    from repic_tpu_torch.utils.synthetic import split_into_jobs

    from torch_serve_common import req, wait_terminal

    rep = {}
    fleet = os.path.join(WORK, "fleet")
    shutil.rmtree(fleet, ignore_errors=True)
    gold_dir = os.path.join(GOLDEN, "lp_device_fused")
    gold = {f: open(os.path.join(gold_dir, f), "rb").read()
            for f in os.listdir(gold_dir)}
    submit = {"in_dir": EXAMPLES, "box_size": BOX,
              "options": {"use_mesh": False, "solver": "lp_device_fused"}}

    def check_golden(jid, label):
        jd = os.path.join(fleet, "jobs", jid)
        got = {f: open(os.path.join(jd, f), "rb").read()
               for f in os.listdir(jd) if f.endswith(".box")}
        if got != gold:
            raise AssertionError(f"phase 14b {label}: artifacts differ "
                                 "from tests/golden/torch_port_10017")

    procs, ports, logs = {}, {}, {}
    t0 = time.time()
    try:
        for rid in ("r1", "r2", "r3"):
            procs[rid], ports[rid], logs[rid] = _fleet_replica(fleet, rid)
        rep["start_s"] = time.time() - t0
        # the undisturbed job
        t = time.time()
        code, _, body = req(ports["r1"], "POST", "/v1/jobs", submit)
        if code != 202:
            raise AssertionError(f"phase 14b: submit {code} {body}")
        doc = wait_terminal(ports["r2"], json.loads(body)["id"],
                            timeout=300)
        rep["job_wall_s"] = time.time() - t
        if doc["state"] != "finished":
            raise AssertionError(f"phase 14b: {doc}")
        check_golden(doc["id"], "undisturbed job")
        # the job with its runner killed after the first chunk lands
        runner = jid = None
        for attempt in range(1, 4):
            alive = [r for r, p in procs.items() if p.poll() is None]
            t = time.time()
            code, _, body = req(ports[alive[0]], "POST", "/v1/jobs", submit)
            if code != 202:
                raise AssertionError(f"phase 14b: submit {code} {body}")
            jid = json.loads(body)["id"]
            job_dir = os.path.join(fleet, "jobs", jid)
            runner = None
            deadline = time.time() + 120
            while time.time() < deadline and runner is None:
                if os.path.isdir(job_dir) and any(
                        f.endswith(".box") for f in os.listdir(job_dir)):
                    for e in reversed(_fleet_entries(fleet)):
                        if e.get("job") == jid and e.get("state") == \
                                "running":
                            runner = e["replica"]
                            break
                if runner is None:
                    time.sleep(0.002)
            if runner not in procs:
                raise AssertionError(f"phase 14b: no replica ran {jid}")
            procs[runner].kill()
            procs[runner].wait()
            t_kill = time.time()
            if not os.path.exists(os.path.join(fleet, f"_done.{jid}.json")):
                break
            # the runner finished before the kill landed: replace it
            if attempt == 3:
                raise AssertionError("phase 14b: never caught a replica "
                                     "mid-job")
            procs.pop(runner)
            rid = f"r{attempt + 3}"
            procs[rid], ports[rid], logs[rid] = _fleet_replica(fleet, rid)
        survivors = [r for r in procs if r != runner]
        doc = wait_terminal(ports[survivors[0]], jid, timeout=300)
        rep["killed_job_wall_s"] = time.time() - t
        rep["kill_to_finish_s"] = time.time() - t_kill
        rep["kill_attempts"] = attempt
        if doc["state"] != "finished" or doc["id"] != jid or \
                doc["replica"] not in survivors:
            raise AssertionError(f"phase 14b: after the kill {doc}")
        check_golden(jid, "killed job")
        entries = _fleet_entries(fleet)
        terminal = [e for e in entries if e.get("job") == jid
                    and "event" not in e
                    and e.get("state") in TERMINAL_STATES]
        moved = [e for e in entries if e.get("event") == "job_reassigned"
                 and e.get("job") == jid]
        tokens = [f for f in os.listdir(fleet) if f == f"_done.{jid}.json"]
        if len(terminal) != 1 or len(moved) != 1 or len(tokens) != 1:
            raise AssertionError(f"phase 14b: terminal records "
                                 f"{len(terminal)}, job_reassigned "
                                 f"{len(moved)}, tokens {len(tokens)}")
        log(f"phase 14b: 10017 fused on a 3-replica fleet: {rep['job_wall_s']:.2f}s "
            f"undisturbed; with replica {runner} SIGKILLed after its first "
            f"chunk (attempt {attempt}) {rep['killed_job_wall_s']:.2f}s, "
            f"{rep['kill_to_finish_s']:.2f}s from the kill to the finish on "
            f"{doc['replica']}; artifacts equal the golden, one completion "
            "token, one terminal record, job_reassigned journaled")
        # the burst over the two survivors
        job_dirs = split_into_jobs(synth, os.path.join(WORK, "fleet_jobs"))
        ref = phase4_outs["lp_device_pallas"]
        opts = {"use_mesh": False, "solver": "lp_device",
                "use_pallas": True}
        t = time.time()
        ids = []
        for i, in_dir in enumerate(job_dirs):
            code, _, body = req(ports[survivors[i % 2]], "POST", "/v1/jobs",
                                {"in_dir": in_dir, "box_size": BOX,
                                 "options": opts})
            if code != 202:
                raise AssertionError(f"phase 14b burst: submit {code} "
                                     f"{body}")
            ids.append(json.loads(body)["id"])
        served = []
        for i, j in enumerate(ids):
            d = wait_terminal(ports[survivors[(i + 1) % 2]], j, timeout=600)
            if d["state"] != "finished":
                raise AssertionError(f"phase 14b burst: {d}")
            jd = os.path.join(fleet, "jobs", j)
            for f in os.listdir(jd):
                if f.endswith(".box"):
                    served.append(f)
                    if not filecmp.cmp(os.path.join(jd, f),
                                       os.path.join(ref, f), shallow=False):
                        raise AssertionError(f"phase 14b burst: {f} differs "
                                             "from phase 4's")
        burst_wall = time.time() - t
        if sorted(served) != sorted(f for f in os.listdir(ref)
                                    if f.endswith(".box")):
            raise AssertionError(f"phase 14b burst: {len(served)} BOX files")
        rep["burst"] = {"jobs": len(ids), "wall_s": burst_wall,
                        "micrographs_per_s": N_SYNTH / burst_wall}
        # each replica's launches, then the drain
        per = {}
        for r in survivors:
            code, _, body = req(ports[r], "GET", "/status")
            per[r] = json.loads(body)["launches"]
        rep["replica_launches"] = per
        rcs = {}
        for r in survivors:
            procs[r].send_signal(signal.SIGTERM)
        for r in survivors:
            rcs[r] = procs[r].wait(timeout=120)
        rep["drain_exit_codes"] = rcs
        if any(rcs.values()):
            raise AssertionError(f"phase 14b: drain exit codes {rcs}")
        orphans = FleetMember(fleet, "probe").orphaned_leases()
        if orphans:
            raise AssertionError(f"phase 14b: orphaned leases {orphans}")
        for r in survivors:
            if f"[device {CHILD_DEVICE}" not in open(logs[r]).read():
                raise AssertionError(f"phase 14b: replica {r} not on "
                                     f"{CHILD_DEVICE}")
        launches = {k: sum(p.get(k, 0) for p in per.values())
                    for k in ("topk_neighbors", "fused_clique_candidates",
                              "fused_dual_solve", "dual_ascent")}
        _need_launches("phase 14b: the survivors", launches, launches)
        for r, counts in per.items():
            _need_launches(f"phase 14b: replica {r}",
                           {"any": sum(counts.values())}, ("any",))
        rep["launches"] = launches
        log(f"phase 14b: burst of {len(ids)} jobs ({N_SYNTH} micrographs, "
            f"--pallas) over the two survivors: {burst_wall:.2f}s = "
            f"{N_SYNTH / burst_wall:.1f} micrographs/s, every BOX file "
            f"equal to phase 4's; SIGTERM: exit codes {rcs}, 0 orphaned "
            f"leases; survivors' launches {per}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(os.path.join(WORK, "fleet_jobs"), ignore_errors=True)
    return rep


def phase_mesh(synth, phase4_outs):
    """Phase 14c: the in-process run over ``consensus_mesh()``."""
    import torch

    from repic_tpu_torch.parallel.mesh import consensus_mesh
    from repic_tpu_torch.pipeline import consensus

    mesh = consensus_mesh()
    out = os.path.join(WORK, "mesh")
    clear_memo()
    reset_counts()
    t = time.time()
    st = consensus.run_consensus_dir(synth, out, BOX,
                                     solver="lp_device_fused",
                                     use_mesh=True, device="cuda")
    wall = time.time() - t
    counts = read_counts()
    n = _same_boxes("phase 14c", out, phase4_outs["lp_device_fused"])
    shutil.rmtree(out, ignore_errors=True)
    log(f"phase 14c: synthetic_256 fused over consensus_mesh() = "
        f"{[str(d) for d in mesh]} (torch.cuda.device_count() = "
        f"{torch.cuda.device_count()}): {n} BOX files equal phase 4's; "
        f"chunk {st['chunk']}, wall {wall:.2f}s, launches {counts}")
    return {"mesh": [str(d) for d in mesh],
            "device_count": torch.cuda.device_count(), "wall_s": wall,
            "chunk": st["chunk"], "launches": counts}


# -- phase 15: the gang and the runtime sanitizers ---------------------

#: phase 15b's gang: processes, global micrographs per chunk, the victim
GANG_WORLD = 3
GANG_CHUNK = 32
GANG_VICTIM = 2


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def phase_gang_of_one(synth, phase4_outs):
    """Phase 15a: ``consensus --gang`` as one process on the 256 set,
    fused and ``--pallas``: phase 4's bytes, every kernel of the
    setting launched, no chunk demoted."""
    rep = {}
    for setting, flags, need in (
        ("lp_device_fused", ["--solver", "lp_device_fused"],
         ("fused_clique_candidates", "fused_dual_solve")),
        ("lp_device_pallas", ["--solver", "lp_device", "--pallas"],
         ("topk_neighbors", "dual_ascent")),
    ):
        out = os.path.join(WORK, "gang1_" + setting)
        t = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repic_tpu_torch", "consensus", synth,
             out, str(BOX), "--gang", *flags], cwd=REPO, env=_child_env(),
            capture_output=True, text=True, timeout=600)
        wall = time.time() - t
        if proc.returncode != 0:
            raise AssertionError(f"phase 15a {setting}: exit "
                                 f"{proc.returncode}: {proc.stderr[-3000:]}")
        st = _last_json(proc.stdout)
        n = _same_boxes(f"phase 15a {setting}", out, phase4_outs[setting])
        _need_launches(f"phase 15a {setting}", st["launches"], need)
        if st["demotions"] or st["gang"]["faults"] or \
                st["gang"]["mode"] != "gang":
            raise AssertionError(f"phase 15a {setting}: demotions "
                                 f"{st['demotions']}, gang {st['gang']}")
        shutil.rmtree(out, ignore_errors=True)
        rep[setting] = {"wall_s": wall, "launches": st["launches"],
                        "chunks": st["chunks"], "gang": st["gang"],
                        "compute_s": st["compute_s"]}
        log(f"phase 15a: gang of one, {setting}: {n} BOX files equal "
            f"phase 4's; {st['chunks']} chunks, no demotion; wall "
            f"{wall:.2f}s (process), compute {st['compute_s']:.3f}s; "
            f"launches {st['launches']}")
    return rep


def phase_gang_chaos(synth, phase4_outs):
    """Phase 15b: a three-process gang on ``cuda:0`` (torchrun's
    variables, gloo collectives, fused, global chunks of
    :data:`GANG_CHUNK`); the victim dies through ``gang_peer_crash`` at
    its second chunk's collective; the survivors re-form and finish
    with phase 4's bytes."""
    from repic_tpu_torch.parallel.gang import GANG_CRASH_EXIT_CODE
    from repic_tpu_torch.runtime.journal import (
        DONE_STATUSES, merged_latest, read_all_journals,
    )
    from repic_tpu_torch.telemetry.report import build_report

    out = os.path.join(WORK, "gang3")
    os.makedirs(out, exist_ok=True)
    port = _free_port()
    procs = []
    for rank in range(GANG_WORLD):
        env = _child_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                         WORLD_SIZE=GANG_WORLD, RANK=rank, LOCAL_RANK=0,
                         REPIC_TPU_HOST_ID=f"g{rank}",
                         REPIC_TPU_HOST_RANK=rank,
                         REPIC_TPU_NUM_HOSTS=GANG_WORLD,
                         REPIC_CONSENSUS_CHUNK=GANG_CHUNK)
        if rank == GANG_VICTIM:
            env["REPIC_TPU_FAULTS"] = "gang_peer_crash:gchunk:1:1:1"
        cmd = [sys.executable, "-m", "repic_tpu_torch", "consensus", synth,
               out, str(BOX), "--solver", "lp_device_fused", "--gang",
               "--coordination-dir", out, "--heartbeat-interval", "0.2",
               "--host-timeout", "2", "--gang-watchdog-floor", "1",
               "--gang-watchdog-factor", "3", "--gang-reform-timeout", "60",
               "--device", CHILD_DEVICE]
        log_path = os.path.join(OUT, f"phase15b_g{rank}.log")
        fh = open(log_path, "w")
        procs.append((subprocess.Popen(cmd, stdout=fh, stderr=fh, env=env,
                                       cwd=REPO), time.time(), fh,
                      log_path))
    ends = {}
    try:
        deadline = time.time() + 300
        while len(ends) < len(procs):
            if time.time() > deadline:
                raise AssertionError("phase 15b: gang still running "
                                     "after 300 s")
            for i, (proc, _t, _fh, _p) in enumerate(procs):
                if i not in ends and proc.poll() is not None:
                    ends[i] = time.time()
            time.sleep(0.02)
    finally:
        for proc, _t, fh, _p in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    results = []
    for i, (proc, t0, _fh, log_path) in enumerate(procs):
        with open(log_path) as f:
            text = f.read()
        results.append((proc.returncode, _last_json(text), ends[i] - t0,
                        text[-3000:]))
    rc_victim = results[GANG_VICTIM][0]
    if rc_victim != GANG_CRASH_EXIT_CODE:
        raise AssertionError(f"phase 15b: victim exited {rc_victim}: "
                             f"{results[GANG_VICTIM][3]}")
    survivors = [r for r in range(GANG_WORLD) if r != GANG_VICTIM]
    for rank in survivors:
        rc, st, _w, tail = results[rank]
        if rc != 0 or st is None:
            raise AssertionError(f"phase 15b: survivor g{rank} exited "
                                 f"{rc}: {tail}")
        if st["gang"]["faults"] < 1 or st["gang"]["mode"] != "gang":
            raise AssertionError(f"phase 15b: survivor g{rank}: "
                                 f"{st['gang']}")
        _need_launches(f"phase 15b survivor g{rank}", st["launches"],
                       ("fused_clique_candidates", "fused_dual_solve"))
        if st["demotions"]:
            raise AssertionError(f"phase 15b: g{rank} demoted "
                                 f"{st['demotions']} chunks")
    entries = read_all_journals(out)
    events = [e for e in entries if "event" in e]
    faults_ = [e for e in events if e["event"] == "gang_fault"]
    reformed = [e for e in events if e["event"] == "gang_reformed"]
    victim = f"g{GANG_VICTIM}"
    if not faults_ or any(e.get("kind") != "peer_dead"
                          or e.get("dead") != [victim] for e in faults_):
        raise AssertionError(f"phase 15b: faults {faults_}")
    if {e["host"] for e in faults_} != {f"g{r}" for r in survivors}:
        raise AssertionError(f"phase 15b: fault hosts {faults_}")
    if not reformed or any(e["world"] != GANG_WORLD - 1
                           or victim in e["members"] for e in reformed):
        raise AssertionError(f"phase 15b: re-formations {reformed}")
    if not os.path.exists(os.path.join(out, f"_fence.{victim}.json")):
        raise AssertionError("phase 15b: the victim was not fenced")
    merged = merged_latest(out)
    names = sorted(f[:-4] for f in os.listdir(phase4_outs[
        "lp_device_fused"]) if f.endswith(".box"))
    lost = [n for n in names if merged.get(n, {}).get("status")
            not in DONE_STATUSES]
    ok_records = {}
    for e in entries:
        if "name" in e and e.get("status") in DONE_STATUSES:
            ok_records[e["name"]] = ok_records.get(e["name"], 0) + 1
    twice = sorted(n for n, c in ok_records.items() if c > 1)
    if lost or twice or len(merged) != len(names):
        raise AssertionError(f"phase 15b: lost {lost[:5]}, written twice "
                             f"{twice[:5]}, merged {len(merged)}")
    n = _same_boxes("phase 15b", out, phase4_outs["lp_device_fused"])
    report = build_report(out)["gang"]
    if (report["faults"] != len(survivors)
            or len({e["gang_epoch"] for e in faults_}) != 1
            or report["reformations"] < 1 or report["degraded"]
            or report["final_epoch"] != max(e["gang_epoch"]
                                            for e in reformed)):
        raise AssertionError(f"phase 15b: report gang section {report}")
    crash_to_reform = min(e["ts"] for e in reformed) - ends[GANG_VICTIM]
    walls = {f"g{r}": results[r][2] for r in range(GANG_WORLD)}
    launches = {k: sum(results[r][1]["launches"][k] for r in survivors)
                for k in results[survivors[0]][1]["launches"]}
    shutil.rmtree(out, ignore_errors=True)
    log(f"phase 15b: {GANG_WORLD}-process gang on cuda:0 (gloo), fused, "
        f"chunks of {GANG_CHUNK}: g{GANG_VICTIM} died at its second "
        f"chunk's collective (exit {rc_victim}); both survivors classified "
        f"peer_dead, fenced it and re-formed a {GANG_WORLD - 1}-process "
        f"gang; {n} BOX files equal phase 4's, 0 lost, 0 written twice; "
        f"report gang: faults {report['faults']} (one fault, epoch "
        f"{faults_[0]['gang_epoch']}, journaled by each survivor), "
        f"reformations {report['reformations']}, final epoch "
        f"{report['final_epoch']}; crash to re-formation "
        f"{crash_to_reform:.2f}s; walls "
        + ", ".join(f"{h} {w:.2f}s" for h, w in walls.items())
        + f"; survivors' launches {launches}")
    return {"crash_to_reform_s": crash_to_reform, "walls_s": walls,
            "report": report, "launches": launches}


def phase_gang_torchrun(synth, phase4_outs):
    """Phase 15d: the gang as the README launches it, ``torchrun
    --nproc-per-node`` :data:`GANG_WORLD` on ``cuda:0`` (the agent's own
    store at ``MASTER_PORT``, which the gang's first epoch joins),
    fused, uninterrupted: phase 4's bytes, one epoch, no fault."""
    import glob

    out = os.path.join(WORK, "gang_torchrun")
    logs = os.path.join(WORK, "gang_torchrun_logs")
    t = time.time()
    # each rank's standard output to a file of its own: the ranks' long
    # result lines must not interleave
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         str(GANG_WORLD), "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "--log-dir", logs, "--redirects", "1",
         "-m", "repic_tpu_torch", "consensus", synth, out,
         str(BOX), "--solver", "lp_device_fused", "--gang",
         "--gang-reform-timeout", "60"],
        cwd=REPO, env=_child_env(REPIC_CONSENSUS_CHUNK=GANG_CHUNK),
        capture_output=True, text=True, timeout=300)
    wall = time.time() - t
    stats = []
    for path in sorted(glob.glob(os.path.join(logs, "**", "stdout.log"),
                                 recursive=True)):
        with open(path) as f:
            st = _last_json(f.read())
        if st is not None:
            stats.append(st)
    with open(os.path.join(OUT, "phase15d_torchrun.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0 or len(stats) != GANG_WORLD:
        raise AssertionError(f"phase 15d: torchrun exit {proc.returncode}, "
                             f"{len(stats)} results: {proc.stderr[-3000:]}")
    for st in stats:
        g = st["gang"]
        if (g["world"], g["mode"], g["faults"], g["epoch"]) != \
                (GANG_WORLD, "gang", 0, 1) or st["demotions"]:
            raise AssertionError(f"phase 15d: rank {g['rank']}: {g}, "
                                 f"demotions {st['demotions']}")
    launches = {k: sum(st["launches"][k] for st in stats)
                for k in stats[0]["launches"]}
    _need_launches("phase 15d", launches,
                   ("fused_clique_candidates", "fused_dual_solve"))
    n = _same_boxes("phase 15d", out, phase4_outs["lp_device_fused"])
    for path in (out, logs):
        shutil.rmtree(path, ignore_errors=True)
    log(f"phase 15d: torchrun --nproc-per-node {GANG_WORLD} on cuda:0, "
        f"fused: {n} BOX files equal phase 4's, ranks "
        f"{sorted(st['gang']['rank'] for st in stats)} in one epoch, no "
        f"fault; wall {wall:.2f}s (launcher); launches {launches}")
    return {"wall_s": wall, "launches": launches}


def phase_sanitizers(synth, phase4_outs):
    """Phase 15c: KERNELCHECK over the four kernels' ladders on the
    card (and a planted divergence caught), DISPATCHCHECK over a fused
    and a ``--pallas`` run of the 256 set, LOCKCHECK armed from its
    variable in a served 10017 job's daemon process and in a cluster
    run's process."""
    import dataclasses

    from repic_tpu_torch.analysis import (
        contracts, dispatchcheck, kernelcheck,
    )
    from repic_tpu_torch.pipeline import consensus

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_serve_common import run_job, spawn, stop

    rep = {}
    # KERNELCHECK on the card
    with kernelcheck.scoped():
        kernelcheck.reset()
        kernelcheck.install()
        t = time.time()
        probed = kernelcheck.run_registered(device="cuda")
        k_s = time.time() - t
        clean = kernelcheck.violations()
        rungs = sum(len(e.contract.kernel.ladder)
                    for e in contracts.registry().values()
                    if e.contract.kernel is not None)
        if probed != 4 or clean:
            raise AssertionError(f"phase 15c: KERNELCHECK probed {probed}: "
                                 + kernelcheck.report_text())
        # a divergence planted in this phase only: one valid slot of
        # kernel 3's output flipped
        entry = contracts.registry()[
            "repic_tpu_torch.ops.megakernel.fused_dual_solve"]
        contract, kc = entry.contract, entry.contract.kernel

        def perturbed(*args):
            picked = kc.run(*args).clone()
            slot = int(args[2].nonzero()[0])
            picked[slot] = ~picked[slot]
            return picked

        entry.contract = dataclasses.replace(
            contract, kernel=dataclasses.replace(kc, run=perturbed))
        try:
            kernelcheck.run_registered(("repic_tpu_torch.ops.megakernel",),
                                       device="cuda")
        finally:
            entry.contract = contract
        planted = [v for v in kernelcheck.violations()
                   if v["kind"] == "kernel-divergence"]
        if len(planted) != len(kc.ladder):
            raise AssertionError("phase 15c: the planted divergence: "
                                 + kernelcheck.report_text())
    log(f"phase 15c: KERNELCHECK on cuda: {probed} kernels, {rungs} ladder "
        f"rungs against their unfused paths, 0 violations ({k_s:.2f}s); "
        f"the planted flip in kernel 3 recorded on all {len(planted)} of "
        f"its rungs: {planted[0]['detail']}")
    rep["kernelcheck"] = {"kernels": probed, "rungs": rungs, "seconds": k_s,
                          "planted_recorded": len(planted)}
    # DISPATCHCHECK over the 256 set, fused and --pallas
    rep["dispatchcheck"] = {}
    for setting, solver, pallas in (
        ("lp_device_fused", "lp_device_fused", False),
        ("lp_device_pallas", "lp_device", True),
    ):
        out = os.path.join(WORK, "dispatch_" + setting)
        with dispatchcheck.scoped():
            dispatchcheck.reset()
            dispatchcheck.install()
            clear_memo()
            consensus.run_consensus_dir(synth, out, BOX, solver=solver,
                                        use_pallas=pallas, device="cuda")
            wins = dispatchcheck.windows()
            bad = dispatchcheck.violations()
        _same_boxes(f"phase 15c dispatch {setting}", out,
                    phase4_outs[setting])
        shutil.rmtree(out, ignore_errors=True)
        if bad or not wins:
            raise AssertionError(f"phase 15c: DISPATCHCHECK {setting}: "
                                 f"{bad or 'no windows'}")
        largest = {}
        for w in wins:
            e = w["entry"].rsplit(".", 1)[-1]
            largest[e] = max(largest.get(e, 0), w["dispatches"])
        budgets = {w["entry"].rsplit(".", 1)[-1]: w["budget"] for w in wins}
        rep["dispatchcheck"][setting] = {"windows": len(wins),
                                         "largest": largest,
                                         "budgets": budgets}
        log(f"phase 15c: DISPATCHCHECK, 256 set {setting}: {len(wins)} "
            f"chunk windows within budget; largest window per entry "
            f"{largest} (budgets {budgets})")
    # LOCKCHECK over a served job and a cluster run, each a CLI process
    # armed from the variable before the package's imports, so its
    # module-level locks are checked too
    module_locks = _module_lock_sites()
    need = {site for site in module_locks if site.rsplit(":", 1)[0] in (
        "repic_tpu_torch.telemetry.server", "repic_tpu_torch.runtime.faults",
        "repic_tpu_torch._build")}
    rep["lockcheck"] = {}
    wd = os.path.join(WORK, "lockcheck_serve")
    os.makedirs(wd, exist_ok=True)
    proc, port = spawn("port", wd, {"REPIC_TPU_LOCKCHECK": "1"},
                       timeout=120, device=None)
    try:
        doc = run_job(port, {"in_dir": EXAMPLES, "box_size": BOX,
                             "options": {"use_mesh": False,
                                         "solver": "lp_device_fused"}},
                      timeout=300)
        proc.send_signal(signal.SIGTERM)
        text = proc.communicate(timeout=120)[0]
    finally:
        stop(proc)
    if doc["state"] != "finished":
        raise AssertionError(f"phase 15c: LOCKCHECK serve job {doc}")
    runs = {"serve": (proc.returncode, text)}
    out = os.path.join(WORK, "lockcheck_cluster")
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "consensus", synth, out,
         str(BOX), "--solver", "lp_device_fused", "--coordination-dir", out,
         "--heartbeat-interval", "0.2", "--host-timeout", "2.0"],
        cwd=REPO, env=_child_env(REPIC_TPU_LOCKCHECK=1),
        capture_output=True, text=True, timeout=600)
    runs["cluster"] = (proc.returncode, proc.stderr)
    _same_boxes("phase 15c lockcheck cluster", out,
                phase4_outs["lp_device_fused"])
    for path in (wd, out):
        shutil.rmtree(path, ignore_errors=True)
    for run, (rc, text) in runs.items():
        lines = text.splitlines()
        sites = set()
        for line in lines:
            if line.startswith("LOCKCHECK checked lock sites"):
                sites = set(line.split(": ", 1)[1].split(", "))
        if rc != 0 or "LOCKCHECK: no violations" not in lines \
                or not need <= sites:
            raise AssertionError(
                f"phase 15c: LOCKCHECK {run}: exit {rc}, module-level "
                f"sites missing {sorted(need - sites)}:\n" + text[-3000:])
        rep["lockcheck"][run] = {
            "sites": len(sites),
            "module_level": sorted(sites & module_locks)}
        log(f"phase 15c: LOCKCHECK armed from the variable over the "
            f"{run} run (a cuda CLI process): {len(sites)} checked lock "
            f"sites, {len(sites & module_locks)} of the package's "
            f"{len(module_locks)} module-level ones among them "
            f"{sorted(sites & module_locks)}, 0 cycles, 0 unguarded "
            "writes")
    return rep


# -- phase 16: the static analysis layer ------------------------------

#: the SARIF results of phase 16a by pass, from the rule ID's family
LINT_PASSES = (("per-file (RT004, RT2xx)", ("RT0", "RT2")),
               ("concurrency (RT3xx)", ("RT3",)),
               ("spmd (RT40x)", ("RT4",)),
               ("cost (RT5xx)", ("RT5",)))


def phase_analysis():
    """Phase 16: the port's ``lint`` in a process of its own (clean,
    torch never imported), ``check`` on the card in this one (every
    entry, 0 findings, 0 skips, kernels 1-3 launched by it), and a
    divergence planted in kernel 3's contract reference that RT425
    names."""
    import dataclasses

    from repic_tpu_torch.analysis import contracts
    from repic_tpu_torch.analysis.kernels import run_kernel_checks
    from repic_tpu_torch.analysis.semantic import run_check

    rep = {"seconds": {}}
    # (a) the lint gate, SARIF, in a process of its own
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "repic_tpu_torch",
         "lint", "repic_tpu_torch", "--concurrency", "--spmd", "--cost",
         "--format", "sarif"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    lint_s = rep["seconds"]["a"] = time.time() - t
    imported = {line.rsplit("|", 1)[-1].strip().split(".")[0]
                for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line}
    try:
        results = json.loads(proc.stdout)["runs"][0]["results"]
    except (ValueError, KeyError, IndexError):
        results = None
    if proc.returncode != 0 or results != [] or "torch" in imported \
            or "repic_tpu_torch" not in imported:
        raise AssertionError(
            f"phase 16a: lint exit {proc.returncode}, results "
            f"{results if results is None else len(results)}, torch "
            f"imported {'torch' in imported}:\n{proc.stdout[-2000:]}")
    per_pass = {name: sum(1 for r in results
                          if r["ruleId"].startswith(prefixes))
                for name, prefixes in LINT_PASSES}
    rep["lint"] = {"exit": proc.returncode, "results": len(results),
                   "per_pass": per_pass, "torch_imported": False,
                   "modules_imported": len(imported)}
    log(f"phase 16a: lint repic_tpu_torch --concurrency --spmd --cost "
        f"--format sarif in its own process: exit 0, {len(results)} "
        f"results {per_pass}; torch not among its {len(imported)} "
        f"imported top-level modules; wall {lint_s:.2f}s")
    # (b) check on the card, the kernels' launches counted around it
    t = time.time()
    reset_counts()
    report = run_check([os.path.join(REPO, "repic_tpu_torch")],
                       device="cuda")
    counts = read_counts()
    check_s = rep["seconds"]["b"] = time.time() - t
    registered = sorted(k for k in contracts.registry()
                        if k.startswith("repic_tpu_torch."))
    checked = sorted(c["entry"] for c in report.checked)
    if report.findings or report.skipped or checked != registered:
        raise AssertionError(
            "phase 16b: check on cuda: "
            + "; ".join(f.format() for f in report.findings)
            + f" skipped {report.skipped}; checked {checked} of "
            f"{registered}")
    _need_launches("phase 16b", counts, ("topk_neighbors",
                                         "fused_clique_candidates",
                                         "fused_dual_solve", "dual_ascent"))
    routes = {c["entry"].rsplit(".", 1)[-1]: c["route"]
              for c in report.checked}
    rep["check"] = {"checked": len(checked), "findings": 0, "skipped": 0,
                    "routes": routes, "launches": counts}
    log(f"phase 16b: check repic_tpu_torch on cuda: {len(checked)} "
        f"entries checked, 0 findings, 0 skips; routes {routes}; kernel "
        f"launches during it {counts}; {check_s:.2f}s")
    # (c) a divergence planted in kernel 3's reference on its last rung
    t = time.time()
    entry = contracts.registry()[
        "repic_tpu_torch.ops.megakernel.fused_dual_solve"]
    kc = entry.contract.kernel
    last = dict(kc.ladder[-1])

    def flipped(*args):
        picked = kc.reference(*args).clone()
        if picked.shape[-1] == last["C"]:
            flat = picked.view(-1)
            flat[0] = ~flat[0]
        return picked

    broken = dataclasses.replace(entry, contract=dataclasses.replace(
        entry.contract, kernel=dataclasses.replace(kc, reference=flipped)))
    found = []
    run_kernel_checks(broken, "repic_tpu_torch/ops/megakernel.py", found,
                      lambda r: r == "RT425", device="cuda")
    rep["seconds"]["c"] = time.time() - t
    if [f.rule for f in found] != ["RT425"] \
            or "fused_dual_solve" not in found[0].message \
            or f"rung {last}" not in found[0].message:
        raise AssertionError("phase 16c: the planted divergence: "
                             + "; ".join(f.format() for f in found))
    rep["planted"] = found[0].message
    log(f"phase 16c: a flip planted in kernel 3's contract reference on "
        f"rung {last}: {found[0].rule} {found[0].message}")
    log("phase 16d: seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in rep["seconds"].items()))
    return rep


def _module_lock_sites() -> set:
    """``module:line`` of every module-level lock of the package."""
    found = set()
    root = os.path.join(REPO, "repic_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            mod = os.path.relpath(path[:-3], REPO).replace(os.sep, ".")
            mod = mod[:-len(".__init__")] if mod.endswith(".__init__") \
                else mod
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    if re.match(r"_?\w+ = threading\.R?Lock\(\)", line):
                        found.add(f"{mod}:{i}")
    return found


def passes(tree: str) -> int:
    """``--passes TREE``: time the directory runs of the port in ``TREE``
    (a checkout, such as the parent commit unpacked with ``git archive``)
    on the card, and print one JSON line with each run's wall,
    ``load_s``, ``compute_s`` and ``write_s``: ``synthetic_256`` with
    ``lp_device_fused``, one cold run then :data:`PASS_REPS` warm pairs
    with the chunk prefetch on and off (in turns), and two
    ``stress_50k`` passes of :data:`STRESS_WARM` micrographs from a cold
    memo, prefetch on then off (``REPIC_TPU_NO_PREFETCH``; a tree
    without the prefetch runs the same serial loop both times).  Run
    parent, new, new, parent in one call to compare two trees."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu_torch import _build
    from repic_tpu_torch.pipeline import consensus
    from repic_tpu_torch.utils.synthetic import (
        CELLS, write_cell_dir, write_synthetic_dir,
    )

    if not consensus.__file__.startswith(tree):
        raise AssertionError(f"imported {consensus.__file__}, not {tree}")
    _build.build_all()
    synth = os.path.join(AB_INPUTS, "synthetic_in")
    stress = os.path.join(AB_INPUTS, "stress_in")
    done = os.path.join(AB_INPUTS, "written")
    if not os.path.exists(done):
        shutil.rmtree(AB_INPUTS, ignore_errors=True)
        write_synthetic_dir(synth, n_micrographs=N_SYNTH, seed=0)
        write_cell_dir("stress_50k", stress, STRESS_WARM)
        open(done, "w").close()
    out = os.path.join(AB_INPUTS, "out")
    keys = ("load_s", "compute_s", "write_s")
    res = {"tree": tree, "card": smi(),
           "synthetic_256": {"cold": None, "on": [], "off": []},
           "stress_50k": {}}

    def timed(src, box, solver, prefetch):
        os.environ["REPIC_TPU_NO_PREFETCH"] = "" if prefetch else "1"
        st, wall, _ = run_dir(src, out, box, solver=solver)
        return {"wall_s": wall, **{k: st[k] for k in keys}}

    clear_memo()
    res["synthetic_256"]["cold"] = timed(synth, BOX, "lp_device_fused", True)
    for i in range(PASS_REPS):
        for mode in (("on", "off") if i % 2 == 0 else ("off", "on")):
            res["synthetic_256"][mode].append(
                timed(synth, BOX, "lp_device_fused", mode == "on"))
    for mode in ("on", "off"):
        clear_memo()
        res["stress_50k"][mode] = {
            "micrographs": STRESS_WARM,
            **timed(stress, CELLS["stress_50k"]["box_size"], "lp_device",
                    mode == "on")}
    os.environ.pop("REPIC_TPU_NO_PREFETCH", None)
    shutil.rmtree(out, ignore_errors=True)
    log(json.dumps(res))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # the capacity-config sidecar stays off (phase 9d turns it on in a
    # temporary HOME): a run must not start from capacities another
    # process left in $HOME, since they decide bytes
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu_torch import _build
    from repic_tpu_torch.ops import cliques, iou_pallas, megakernel
    from repic_tpu_torch.parallel.batching import (
        bucket_size, pad_batch, to_device,
    )
    from repic_tpu_torch.pipeline import consensus
    from repic_tpu_torch.solver import dual
    from repic_tpu_torch.utils import box_io
    from repic_tpu_torch.utils.synthetic import write_synthetic_dir

    t_main = time.time()
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    card = smi()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    # -- phase 1: build ---------------------------------------------
    t = time.time()
    _build.build_all()
    log(f"phase 1: built {len(_build.KERNELS)} kernel sources in "
        f"{time.time() - t:.1f}s")
    spills = []
    for name, text in _build.BUILD_LOGS.items():
        with open(os.path.join(OUT, f"ptxas_{name}.txt"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(f"{name}: {line.strip()}")
    if spills:
        raise AssertionError("ptxas reports spills:\n" + "\n".join(spills))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 2: kernels against their plain versions ---------------
    errs = {"topk_neighbors": 0.0, "fused_clique_candidates": 0.0,
            "fused_dual_solve": 0.0}
    # d = 1 to 32: kernel 1's buffered positives and zeros apart; 48:
    # its per-warp list in the output row
    for label, args, thr in ladder_k1():
        for d in (1, 4, 8, 16, 24, 32, 48):
            got = iou_pallas.topk_neighbors(*args, d=d, threshold=thr)
            want = iou_pallas.topk_neighbors_plain(*args, d=d,
                                                   threshold=thr)
            torch.cuda.synchronize()
            errs["topk_neighbors"] = max(
                errs["topk_neighbors"],
                compare(f"topk {label} d{d}", got, want))
    for label, (xy, conf, mask) in ladder_k2():
        k, n = xy.shape[1:3]
        # d = 1, 4, 8: lane lists of 8 slots; 16: of 16; 24: the per-warp
        # list in memory
        for d in (1, 4, 8, 16, 24):
            if min(d, n) ** (k - 1) > 4096:
                continue
            kw = dict(threshold=0.3, max_neighbors=d, clique_capacity=1024)
            got = megakernel.fused_clique_candidates(
                xy, conf, mask, BOX, **kw)
            want = megakernel.fused_clique_candidates_plain(
                xy, conf, mask, BOX, **kw)
            torch.cuda.synchronize()
            errs["fused_clique_candidates"] = max(
                errs["fused_clique_candidates"],
                compare(f"cliques {label} d{d}", got, want))
    for label, v, (mv, w, valid) in ladder_k3():
        got = megakernel.fused_dual_solve(mv, w, valid, v)
        want = megakernel.fused_dual_solve_plain(mv, w, valid, v)
        torch.cuda.synchronize()
        compare("dual " + label, [got], [want])
        compare("dual steps " + label, [megakernel.SOLVE_CHAIN[:, 0]],
                [dual.solve_dual_decomposition(mv, w, valid, v).iterations])
    # the ascent kernel on its contract's ladder (shared, split and
    # global residency), at the stop tolerance and at one that rows
    # reach at different steps
    from repic_tpu_torch.analysis import contracts

    akc = contracts.registry()[
        "repic_tpu_torch.ops.megakernel.dual_ascent"].contract.kernel
    errs["dual_ascent"] = 0.0
    for rung in akc.ladder:
        arrays, akw = akc.make_inputs(dict(rung))
        args = [a.to(dev)[None] for a in arrays]
        for tol in (dual.DEFAULT_TOL, 0.05):
            got = megakernel.dual_ascent(*args, akw["num_vertices"], tol=tol)
            want = dual.dual_ascent_plain(*args, akw["num_vertices"],
                                          tol=tol)
            torch.cuda.synchronize()
            errs["dual_ascent"] = max(errs["dual_ascent"], compare(
                f"ascent {rung} tol {tol}", got, want))
    log("phase 2: contract ladders equal (kernels 1-3, the ascent "
        f"kernel; residency launches {megakernel.ASCENT_RESIDENCY})")

    # the main path's chunk: 32 micrographs of the synthetic set
    synth = os.path.join(WORK, "synthetic_in")
    write_synthetic_dir(synth, n_micrographs=N_SYNTH, seed=0)
    pickers = box_io.discover_picker_dirs(synth)
    names = box_io.micrograph_names(os.path.join(synth, pickers[0]))
    loaded = [(nm, box_io.load_micrograph_set(synth, pickers, nm))
              for nm in names[:CHUNK]]
    nb = bucket_size(max(bs.n for _, s in loaded for bs in s))
    batch = pad_batch(loaded, pad_micrographs_to=CHUNK, capacity=nb)
    db = to_device(batch, dev)
    consensus.run_consensus_batch(batch, BOX, solver="lp_device",
                                  device=dev)
    d, cap = accepted_config()[:2]
    clear_memo()
    m, k, n = batch.xy.shape[:3]
    log(f"chunk shape: M={m} K={k} N={n}; main-path capacities "
        f"D={d} C={cap}")
    times = {}

    # kernel 1 at the chunk shape (every anchor-pair of the chunk), with
    # the sizes as the main path hands them over for one box size: a
    # Python number each (enumerate_cliques passes it through)
    b = m * (k - 1)
    a1 = (
        db.xy[:, :1].expand(m, k - 1, n, 2).reshape(b, n, 2).contiguous(),
        db.mask[:, :1].expand(m, k - 1, n).reshape(b, n).contiguous(),
        db.xy[:, 1:].reshape(b, n, 2).contiguous(),
        db.mask[:, 1:].reshape(b, n).contiguous(),
        float(BOX), float(BOX),
    )
    # the unmasked pairs: the only ones whose IoU the outputs need (a
    # masked pair is the constant -1)
    pairs = float((a1[1].sum(1).double() * a1[3].sum(1).double()).sum())
    got = iou_pallas.topk_neighbors(*a1, d=d)
    want = iou_pallas.topk_neighbors_plain(*a1, d=d)
    errs["topk_neighbors"] = max(errs["topk_neighbors"],
                                 compare("topk chunk", got, want))
    # per anchor and picker, the neighbours above the threshold that
    # the clique join of kernel 2 must combine (at most d)
    above = want[2].view(m, k - 1, n).double().clamp(max=d)
    times["topk_neighbors"] = (
        cuda_ms(lambda: iou_pallas.topk_neighbors(*a1, d=d), 20),
        cuda_ms(lambda: iou_pallas.topk_neighbors_plain(*a1, d=d), 5),
        # per unmasked pair: 2 x (min, max, sub, clamp), mul, sub, div,
        # mask, compare, count
        bound(b * n * (9 + 9) + b * n * (8 * d + 4), pairs * 14.0),
    )

    # kernel 2 at the chunk shape
    kw = dict(threshold=0.3, max_neighbors=d, clique_capacity=cap)
    got = megakernel.fused_clique_candidates(
        db.xy, db.conf, db.mask, BOX, **kw)
    want = megakernel.fused_clique_candidates_plain(
        db.xy, db.conf, db.mask, BOX, **kw)
    errs["fused_clique_candidates"] = max(
        errs["fused_clique_candidates"],
        compare("cliques chunk", got, want))
    e = k * (k - 1) // 2
    n_valid = float(want[7].sum())
    c2 = want[0].shape[1]
    # the join combines each anchor's above-threshold neighbours, one
    # per other picker: gather k - 1 members, the IoU of each edge
    # between them, a compare per edge
    walk = float(above.prod(1).sum())
    ops2 = (pairs * 14.0                          # neighbour IoU scan
            + walk * ((k - 1) + 14.0 * (e - k + 1) + e)
            + n_valid * (k * k + e * e + 3 * e))   # medians, degrees
    # inputs xy, conf, mask; outputs member_idx, valid, w, confidence,
    # rep_slot, rep_xy, pid per row, and num_valid, max_adjacency
    bytes2 = (m * k * n * (8 + 4 + 1) + m * c2 * (4 * k + 1 + 4 * 4 + 8)
              + m * 8)
    times["fused_clique_candidates"] = (
        cuda_ms(lambda: megakernel.fused_clique_candidates(
            db.xy, db.conf, db.mask, BOX, **kw), 10),
        cuda_ms(lambda: megakernel.fused_clique_candidates_plain(
            db.xy, db.conf, db.mask, BOX, **kw), 3),
        bound(bytes2, ops2),
    )

    # kernel 3 at the chunk shape: the solver inputs the main path
    # hands it (compacted cliques of this chunk)
    cs = cliques.compact_cliques(
        megakernel.fused_cliqueset(db.xy, db.conf, db.mask, BOX, **kw), cap)
    vid, nv = consensus.pack_cliques_for_solver(cs.member_idx, cs.valid, n)
    got = megakernel.fused_dual_solve(vid, cs.w, cs.valid, nv)
    chain = megakernel.SOLVE_CHAIN.cpu()
    stats = dual.solve_dual_decomposition(vid, cs.w, cs.valid, nv)
    compare("dual chunk", [got], [stats.picked])
    compare("dual steps chunk", [chain[:, 0].to(dev)], [stats.iterations])
    c3 = vid.shape[1]
    steps = chain[:, 0]
    rounds = chain[:, 1:7]
    chain_report = {
        "ascent_steps_sum": int(steps.sum()),
        "ascent_steps_max": int(steps.max()),
        "greedy_rounds_per_fixpoint_mean": float(rounds.double().mean()),
        "greedy_rounds_per_fixpoint_max": int(rounds.max()),
        "greedy_rounds_per_solve_mean": float(rounds.sum(1).double().mean()),
        "barriers_per_solve_mean": float(chain[:, 7].double().mean()),
        "barriers_per_solve_max": int(chain[:, 7].max()),
    }
    log("kernel 3 chain at the chunk: " + json.dumps(chain_report))
    # per ascent step: the reduced cost of each valid clique (k loads
    # and adds, a compare) and the price step of each vertex (sub, mul,
    # add, max, the change and its max); each of the six greedy passes
    # reads each valid clique's k members once (priority max, index
    # min, selection, use: 6 per member); three objective sums
    n_cl = cs.valid.sum(-1).double()
    ops3 = (float((stats.iterations.double()
                   * (n_cl * (k + 2) + 6.0 * nv)).sum())
            + float(n_cl.sum()) * (6 * 6.0 * k + 3))
    bytes3 = m * c3 * (4 * k + 4 + 1) + m * c3
    times["fused_dual_solve"] = (
        cuda_ms(lambda: megakernel.fused_dual_solve(
            vid, cs.w, cs.valid, nv), 10),
        cuda_ms(lambda: megakernel.fused_dual_solve_plain(
            vid, cs.w, cs.valid, nv), 2, warm=1),
        bound(bytes3, ops3),
    )
    # the ascent kernel on the same solver inputs
    got = megakernel.dual_ascent(vid, cs.w, cs.valid, nv)
    want = dual.dual_ascent_plain(vid, cs.w, cs.valid, nv)
    errs["dual_ascent"] = max(errs["dual_ascent"],
                              compare("ascent chunk", got, want))
    a_bytes, a_ops, _staged = ascent_work(cs.valid, k, nv, want[2])
    times["dual_ascent"] = (
        cuda_ms(lambda: megakernel.dual_ascent(vid, cs.w, cs.valid, nv), 10),
        cuda_ms(lambda: dual.dual_ascent_plain(vid, cs.w, cs.valid, nv), 2,
                warm=1),
        bound(a_bytes, a_ops),
    )
    log(f"phase 2: chunk-shape kernels equal their plain versions "
        f"(dual iterations {stats.iterations.tolist()[:4]}...)")
    # the kernels' own device time per call (CUDA-event times above
    # include the host's work between launches when it is the longer)
    dev_ms = {
        "topk_neighbors": device_ms(
            lambda: iou_pallas.topk_neighbors(*a1, d=d), 20,
            "topk_neighbors_kernel"),
        "fused_clique_candidates": device_ms(
            lambda: megakernel.fused_clique_candidates(
                db.xy, db.conf, db.mask, BOX, **kw), 10, "clique_"),
        "fused_dual_solve": device_ms(
            lambda: megakernel.fused_dual_solve(vid, cs.w, cs.valid, nv),
            10, "dual_solve_kernel"),
        "dual_ascent": device_ms(
            lambda: megakernel.dual_ascent(vid, cs.w, cs.valid, nv),
            10, "dual_ascent_kernel"),
    }
    for name, (ms, plain_ms, (b_ms, by)) in times.items():
        dm = dev_ms[name]
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({by}); device time per call "
            + ("not measured" if dm is None else f"{dm:.4f} ms"))

    # -- phase 3: examples/10017 through the CLI vs the JAX goldens ---
    env = dict(os.environ, PYTHONPATH=REPO)
    cli_runs = {}
    for setting, flags in (
        ("lp_device", ["--solver", "lp_device"]),
        ("lp_device_pallas", ["--solver", "lp_device", "--pallas"]),
        ("lp_device_fused", ["--solver", "lp_device_fused"]),
    ):
        out = os.path.join(WORK, "e10017_" + setting)
        t = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repic_tpu_torch", "consensus",
             EXAMPLES, out, str(BOX), *flags],
            cwd=REPO, env=env, capture_output=True, text=True,
        )
        wall = time.time() - t
        if proc.returncode != 0:
            raise RuntimeError(f"CLI {setting} failed:\n{proc.stderr}")
        st = json.loads(proc.stdout.strip().splitlines()[-1])
        gold = os.path.join(GOLDEN, setting)
        files = sorted(os.listdir(gold))
        diff = [f for f in files if not filecmp.cmp(
            os.path.join(gold, f), os.path.join(out, f), shallow=False)]
        if diff or len(files) != 12:
            raise AssertionError(f"10017 {setting}: BOX differs: {diff}")
        cli_runs[setting] = {"wall_s": wall, "launches": st["launches"],
                             "compute_s": st["compute_s"]}
        log(f"phase 3: 10017 {setting}: 12 BOX files byte-identical to "
            f"the JAX golden; wall {wall:.2f}s (process), compute "
            f"{st['compute_s']:.3f}s, launches {st['launches']}")

    # -- phase 4: the 256-micrograph directory, in process -----------
    launches = {}
    outs = {}
    rates = {}
    for setting, solver, pallas in (
        ("lp_device_fused", "lp_device_fused", False),
        ("lp_device_pallas", "lp_device", True),
    ):
        out = os.path.join(WORK, "synthetic_" + setting)
        walls = []
        for _ in range(2):   # cold, then warm
            clear_memo()
            st, wall, counts = run_dir(synth, out, BOX, solver=solver,
                                       use_pallas=pallas)
            walls.append(wall)
            demoted = counts.pop("demotions")
        # a third run under the profiler: the device's busy share
        wall_p, busy, top = device_busy(lambda: consensus.run_consensus_dir(
            synth, out, BOX, solver=solver, use_pallas=pallas,
            device="cuda"))
        if st["chunks"] != N_SYNTH // CHUNK or demoted:
            raise AssertionError(
                f"{setting}: chunks {st['chunks']}, demotions {demoted}")
        need = (["topk_neighbors", "dual_ascent"] if pallas else
                ["fused_clique_candidates", "fused_dual_solve"])
        for key in need:
            if counts[key] <= 0:
                raise AssertionError(f"{setting}: {key} never launched")
            launches[key] = counts[key]
        outs[setting] = out
        rates[setting] = {
            "cold_s": walls[0], "warm_s": walls[1],
            "micrographs_per_s": N_SYNTH / walls[1],
            "num_cliques": st["num_cliques"], "launches": counts,
            "warm_load_s": st["load_s"], "warm_compute_s": st["compute_s"],
            "warm_write_s": st["write_s"],
            "profiled_wall_s": wall_p, "device_busy_s": busy,
            "top_kernels_s": top,
        }
        log(f"phase 4: {setting}: {N_SYNTH} micrographs, {st['chunks']} "
            f"chunks, cold {walls[0]:.2f}s, warm {walls[1]:.2f}s = "
            f"{N_SYNTH / walls[1]:.1f} micrographs/s; launches {counts}; "
            f"demotions {demoted}; cliques {st['num_cliques']}")
        log(f"  warm split: load {st['load_s']:.3f}s, compute (device "
            f"program + fetch) {st['compute_s']:.3f}s, write "
            f"{st['write_s']:.3f}s")
        if busy is None:
            log("  device busy share: not measured (the profiler saw no "
                "device events)")
        else:
            log(f"  profiled run: wall {wall_p:.3f}s, device busy "
                f"{busy:.4f}s = {100 * busy / wall_p:.1f}% of its wall, "
                f"{100 * busy / walls[1]:.1f}% of the warm wall")
            for name, sec in top:
                log(f"    {sec * 1e3:9.3f} ms  {name[:90]}")
    a, b_ = outs["lp_device_fused"], outs["lp_device_pallas"]
    boxes = sorted(f for f in os.listdir(a) if f.endswith(".box"))
    if len(boxes) != N_SYNTH:
        raise AssertionError(f"expected {N_SYNTH} BOX files, got "
                             f"{len(boxes)}")
    diff = [f for f in boxes if not filecmp.cmp(
        os.path.join(a, f), os.path.join(b_, f), shallow=False)]
    if diff:
        raise AssertionError(f"fused vs staged+pallas differ: {diff[:5]}")
    for f in boxes[:8]:
        for line in open(os.path.join(a, f)):
            x, y, s1, s2, wgt = line.split("\t")
            if not (0.0 < float(wgt) <= 1.0) or s1 != str(BOX):
                raise AssertionError(f"{f}: bad row {line!r}")
    log("phase 4: fused and staged+pallas BOX outputs byte-identical")

    phase_s = {"1-4": time.time() - t_main}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        phase_s[name] = time.time() - t
        log(f"  (phase {name}: {phase_s[name]:.1f}s; "
            f"{time.time() - t_main:.1f}s since the start)")
        return out

    # -- phases 6 and 7: the dense configurations --------------------
    with open(DIGESTS) as f:
        golden = json.load(f)
    stress = timed("6", phase_stress, golden)
    k5 = timed("7", phase_k5, golden)

    # -- phase 8: the flags, the rungs, the two-phase CLI, stripes ----
    phase8 = timed("8", phase_flags, synth)

    # -- phase 9: the fault-tolerant runtime --------------------------
    phase9 = timed("9", phase_runtime, synth, outs)

    # -- phase 10: the observability layer ----------------------------
    phase10 = timed("10", phase_observability, synth, outs)

    # -- phase 11: the engine and the serve daemon --------------------
    phase11 = timed("11", phase_serve, synth, outs)

    # -- phase 12: the CNN picker and the host utilities --------------
    phase12 = {"picker": timed("12ab", phase_picker),
               "utilities": timed("12c", phase_utilities)}

    # -- phase 13: the training half and the iterative loop -----------
    phase13 = {"fit": timed("13abc", phase_fit),
               "iterative": timed("13d", phase_iterative)}

    # -- phase 14: the cluster runtime, the serving fleet, the mesh ---
    sys.path.insert(0, os.path.join(REPO, "tests"))
    phase14 = {"cluster": timed("14a", phase_cluster, synth, outs),
               "fleet": timed("14b", phase_fleet, synth, outs),
               "mesh": timed("14c", phase_mesh, synth, outs)}

    # -- phase 15: the gang and the runtime sanitizers ----------------
    phase15 = {"gang_of_one": timed("15a", phase_gang_of_one, synth, outs),
               "gang_chaos": timed("15b", phase_gang_chaos, synth, outs),
               "gang_torchrun": timed("15d", phase_gang_torchrun, synth,
                                      outs),
               "sanitizers": timed("15c", phase_sanitizers, synth, outs)}

    # -- phase 16: the static analysis layer --------------------------
    phase16 = timed("16", phase_analysis)

    # -- phase 5: report -------------------------------------------
    replaces = {
        "topk_neighbors": "repic_tpu/ops/iou_pallas.py:397",
        "fused_clique_candidates": "repic_tpu/ops/megakernel.py:662",
        "fused_dual_solve": "repic_tpu/ops/megakernel.py:846",
        # the staged program's ascent loop (lax.while_loop)
        "dual_ascent": "repic_tpu/solver/dual.py:174",
    }
    sources = {
        "topk_neighbors": "repic_tpu_torch/csrc/neighbors.cu",
        "fused_clique_candidates": "repic_tpu_torch/csrc/cliques.cu",
        "fused_dual_solve": "repic_tpu_torch/csrc/dual.cu",
        "dual_ascent": "repic_tpu_torch/csrc/ascent.cu",
    }
    kernels = []
    for name in ("topk_neighbors", "fused_clique_candidates",
                 "fused_dual_solve", "dual_ascent"):
        ms, plain_ms, (b_ms, by) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        })
    kernels[0]["k5_chunk"] = k5["k5_chunk"]
    kernels[3]["k5_chunk"] = k5["ascent_k5_chunk"]
    kernels[3]["residency_launches"] = dict(megakernel.ASCENT_RESIDENCY)
    for entry in kernels:
        name = entry["name"]
        # launches on phase 8's 10017 tables runs, per run
        entry["tables_launches"] = phase8["tables_launches"].get(name, {})
        # launches in phase 10a's profiled, device-timed 10017 run
        entry["telemetry_launches"] = phase10["launches"].get(name, 0)
        # launches in phase 11a's served 10017 jobs, per setting
        entry["serve_launches"] = {
            setting: r["launches"].get(name, 0)
            for setting, r in phase11["10017"].items()}
        # launches in phase 14's host and replica processes (their own
        # counters: the hosts' stats, the survivors' /status)
        entry["cluster_launches"] = phase14["cluster"]["launches"][name]
        entry["fleet_launches"] = phase14["fleet"]["launches"][name]
        # launches in phase 15's gang processes (their own counters):
        # the gang of one per setting, the chaos gang's survivors, the
        # torchrun gang's ranks
        entry["gang_launches"] = {
            **{setting: r["launches"].get(name, 0)
               for setting, r in phase15["gang_of_one"].items()},
            "chaos_survivors": phase15["gang_chaos"]["launches"].get(
                name, 0),
            "torchrun": phase15["gang_torchrun"]["launches"].get(name, 0),
        }
        # launches in phase 16b's check of the package on the card
        entry["check_launches"] = phase16["check"]["launches"][name]
    report = {"card": card, "kernels": kernels, "device_ms": dev_ms,
              "cli_10017": cli_runs,
              "synthetic_256": rates, "dual_chain": chain_report,
              "stress_50k": stress, "k5_mixed": k5, "phase8": phase8,
              "phase9": phase9, "phase10": phase10, "phase11": phase11,
              "phase12": phase12, "phase13": phase13, "phase14": phase14,
              "phase15": phase15, "phase16": phase16,
              "phase_seconds": phase_s}
    with open(os.path.join(OUT, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--passes":
        sys.exit(passes(sys.argv[2]))
    try:
        sys.exit(main())
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
