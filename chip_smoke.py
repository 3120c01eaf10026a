#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``repic_tpu_torch``).

Needs one CUDA GPU (an H100; the kernels are built for ``sm_90a``) and
the CUDA toolkit; imports no JAX.  Run from the repository root:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit; build the three kernels
   (one ``nvcc`` per source, all at once), print ptxas's register and
   spill lines, and fail if any kernel spills;
2. hold each kernel against its plain PyTorch version on the card —
   on the reference kernels' contract ladders (kernel 1 at d = 1, 4,
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
5. after phases 6 to 10, print the ``{"kernels": [...]}`` line
   (launches, kernel and plain times, bound, max abs error; kernel 1's
   entry carries its k5_mixed chunk as ``k5_chunk``), the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``;
6. ``stress_50k`` (the dense-field configuration: 50,000 particles x
   4 pickers, box 180; the spatial path with the anchor-chunked
   assembly): write the seed-0 field as BOX files, run
   ``run_consensus_dir`` (spatial auto) with ``lp_device`` and
   ``greedy`` on the golden micrographs and hold every BOX file's
   sha256, row count and clique count to the JAX digests
   (``tests/golden/torch_port_digests.json``); then a warm pass over
   the configuration's :data:`STRESS_WARM` = 128 micrographs with
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
   its time, device time and bound; then a warm pass over the
   configuration's :data:`K5_WARM` = 1,024 micrographs;
8. the rest of the flags, through the CLI's parser and commands in this
   process (the escalation memo cleared and the launch counts set to 0
   before each run), each output file held to the JAX digests
   (``tests/golden/torch_port_flags_digests.json``): ``consensus
   --multi_out``, ``--get_cc`` and both on 10017 under ``lp_device``,
   ``lp_device --pallas`` (kernel 1 must launch) and
   ``lp_device_fused`` (kernels 2 and 3 must launch, no chunk
   demoted); ``--solver exact`` and ``--solver lp``; ``get_cliques``
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
   and the dispatch gap.

Times are CUDA-event means over repeated calls after a warm-up: what a
caller of the wrapper waits, host work between launches included.
Phase 2 also prints each kernel's own device time per call, summed
from ``torch.profiler``'s kernel records.
Logs and the report go to ``chiprun_out/chip_smoke/``; the BOX
directories to ``build/chip_smoke/``, deleted at the end.
"""

import filecmp
import json
import os
import re
import shutil
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
#: warm runs per side of phase 9's prefetch on/off comparison (phase 10
#: shares the time limit)
PREFETCH_PAIRS = 5
#: warm runs per side of phase 10b's telemetry on/off comparison
TELEMETRY_PAIRS = 10
TELEMETRY_DIGESTS = os.path.join(REPO, "tests", "golden",
                                 "torch_port_telemetry_digests.json")
#: the status server's paths phase 10 polls
STATUS_PATHS = ("/healthz", "/healthz/ready", "/status", "/metrics")
#: per phase-10 setting: the wrappers whose launches the run must show,
#: and the kernels its profiler trace must name
LAUNCH_KEYS = {"lp_device_fused": ("fused_clique_candidates",
                                   "fused_dual_solve"),
               "lp_device_pallas": ("topk_neighbors",)}
TRACE_KERNELS = {"lp_device_fused": ("clique_count_kernel",
                                     "clique_write_kernel",
                                     "dual_solve_kernel"),
                 "lp_device_pallas": ("topk_neighbors_kernel",)}
#: micrographs in the warm passes of the two dense configurations
#: (each configuration's full count)
STRESS_WARM = 128
K5_WARM = 1024

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
    runs["warm"] = warm_pass("k5_mixed", K5_WARM, "lp_device")
    return runs


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
    3 must launch, no chunk demoted); --solver exact and lp; get_cliques
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
        need = (["topk_neighbors"] if extra else
                ["fused_clique_candidates", "fused_dual_solve"]
                if solver == "lp_device_fused" else [])
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
            except OSError:
                continue  # the server is gone: the run is ending
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


# -- A/B passes: one tree's directory runs, for a before/after ----------

#: warm synthetic_256 pairs (prefetch on, off) per --passes process
PASS_REPS = 5
#: where --passes writes its inputs once and every later process reuses
#: them (one tree's generator, the same seeds)
AB_INPUTS = os.path.join(REPO, "build", "chip_smoke_ab")


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
    log("phase 2: contract ladders equal (kernels 1-3)")

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
        need = (["topk_neighbors"] if pallas else
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

    # -- phases 6 and 7: the dense configurations --------------------
    with open(DIGESTS) as f:
        golden = json.load(f)
    stress = phase_stress(golden)
    k5 = phase_k5(golden)

    # -- phase 8: the flags, the rungs, the two-phase CLI, stripes ----
    phase8 = phase_flags(synth)

    # -- phase 9: the fault-tolerant runtime --------------------------
    phase9 = phase_runtime(synth, outs)

    # -- phase 10: the observability layer ----------------------------
    phase10 = phase_observability(synth, outs)

    # -- phase 5: report -------------------------------------------
    replaces = {
        "topk_neighbors": "repic_tpu/ops/iou_pallas.py:397",
        "fused_clique_candidates": "repic_tpu/ops/megakernel.py:662",
        "fused_dual_solve": "repic_tpu/ops/megakernel.py:846",
    }
    sources = {
        "topk_neighbors": "repic_tpu_torch/csrc/neighbors.cu",
        "fused_clique_candidates": "repic_tpu_torch/csrc/cliques.cu",
        "fused_dual_solve": "repic_tpu_torch/csrc/dual.cu",
    }
    kernels = []
    for name in ("topk_neighbors", "fused_clique_candidates",
                 "fused_dual_solve"):
        ms, plain_ms, (b_ms, by) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
        })
    kernels[0]["k5_chunk"] = k5["k5_chunk"]
    for entry in kernels:
        # launches on phase 8's 10017 tables runs, per run
        entry["tables_launches"] = phase8["tables_launches"].get(
            entry["name"], {})
        # launches in phase 10a's profiled, device-timed 10017 run
        entry["telemetry_launches"] = phase10["launches"][entry["name"]]
    report = {"card": card, "kernels": kernels, "device_ms": dev_ms,
              "cli_10017": cli_runs,
              "synthetic_256": rates, "dual_chain": chain_report,
              "stress_50k": stress, "k5_mixed": k5, "phase8": phase8,
              "phase9": phase9, "phase10": phase10}
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
