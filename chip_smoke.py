#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``repic_tpu_torch``).

Needs one CUDA GPU (an H100; the kernels are built for ``sm_90a``) and
the CUDA toolkit; imports no JAX.  Run from the repository root:

    python3 chip_smoke.py

Phases, each fatal on failure:

1. print the card's name and power limit; build the three kernels
   (one ``nvcc`` per source, all at once);
2. hold each kernel against its plain PyTorch version on the card —
   on the reference kernels' contract ladders and at the main path's
   chunk shape (32 micrographs of the synthetic set): integer and
   boolean outputs equal, floats equal (tolerance 0);
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
5. print the ``{"kernels": [...]}`` line (launches, kernel and plain
   times, bound, max abs error), the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Times are CUDA-event means over repeated calls after a warm-up.
Everything long goes to ``chiprun_out/chip_smoke/``.
"""

import filecmp
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "chip_smoke")
EXAMPLES = os.path.join(REPO, "examples", "10017")
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_10017")
BOX = 180
CHUNK = 32
N_SYNTH = 256

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
    import numpy as np
    import torch

    for n, m in ((64, 128), (96, 256), (40, 70)):
        rng = np.random.default_rng(n + m)
        xa = rng.uniform(0, 2000.0, (n, 2)).astype(np.float32)
        xb = rng.uniform(0, 2000.0, (m, 2)).astype(np.float32)
        ma = rng.uniform(size=n) > 0.15
        mb = rng.uniform(size=m) > 0.15
        yield f"N{n} M{m}", [torch.from_numpy(a).cuda()
                             for a in (xa, ma, xb, mb)]


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
    # candidates a float32 rounding apart: the order of the objective
    # sums decides (one and two levels of window sums)
    for gadgets, background in ((1, 60), (2, 200), (4, 5000)):
        *arrays, v = near_tie_packings(32, gadgets, background, seed=1)
        yield (f"near-tie C{3 * gadgets + background}", v,
               [torch.from_numpy(a).cuda() for a in arrays])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
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
    card = smi()
    log("card:", card)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    # -- phase 1: build ---------------------------------------------
    t = time.time()
    _build.build_all()
    log(f"phase 1: built {len(_build.KERNELS)} kernel sources in "
        f"{time.time() - t:.1f}s")
    for name, text in _build.BUILD_LOGS.items():
        with open(os.path.join(OUT, f"ptxas_{name}.txt"), "w") as f:
            f.write(text)
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    # -- phase 2: kernels against their plain versions ---------------
    errs = {"topk_neighbors": 0.0, "fused_clique_candidates": 0.0,
            "fused_dual_solve": 0.0}
    # d = 8 and 4 are the reference ladders' (register top-D lists);
    # d = 24 takes the kernels' in-memory lists for d > 16
    for label, (xa, ma, xb, mb) in ladder_k1():
        args = (xa, ma, xb, mb, BOX, BOX)
        for d in (8, 24):
            got = iou_pallas.topk_neighbors(*args, d=d, threshold=0.3)
            want = iou_pallas.topk_neighbors_plain(*args, d=d,
                                                   threshold=0.3)
            torch.cuda.synchronize()
            errs["topk_neighbors"] = max(
                errs["topk_neighbors"],
                compare(f"topk {label} d{d}", got, want))
    for label, (xy, conf, mask) in ladder_k2():
        k, n = xy.shape[1:3]
        for d in (4, 24):
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
    log("phase 2: contract ladders equal (kernels 1-3)")

    # the main path's chunk: 32 micrographs of the synthetic set
    synth = os.path.join(OUT, "synthetic_in")
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
    d, cap = next(iter(consensus._LAST_GOOD_CONFIG.values()))[:2]
    consensus._LAST_GOOD_CONFIG.clear()
    consensus._RECENT_REQUIREMENTS.clear()
    m, k, n = batch.xy.shape[:3]
    log(f"chunk shape: M={m} K={k} N={n}; main-path capacities "
        f"D={d} C={cap}")
    times = {}

    # kernel 1 at the chunk shape (every anchor-pair of the chunk)
    b = m * (k - 1)
    a1 = (
        db.xy[:, :1].expand(m, k - 1, n, 2).reshape(b, n, 2).contiguous(),
        db.mask[:, :1].expand(m, k - 1, n).reshape(b, n).contiguous(),
        db.xy[:, 1:].reshape(b, n, 2).contiguous(),
        db.mask[:, 1:].reshape(b, n).contiguous(),
        BOX, BOX,
    )
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
        # per pair: 2 x (min, max, sub, clamp), mul, sub, div, mask,
        # compare, count
        bound(b * n * (9 + 9) + b * n * (8 * d + 4), b * n * n * 14.0),
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
    ops2 = (m * (k - 1) * n * n * 14.0            # neighbour IoU scan
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
    stats = dual.solve_dual_decomposition(vid, cs.w, cs.valid, nv)
    compare("dual chunk", [got], [stats.picked])
    c3 = vid.shape[1]
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
    for name, (ms, plain_ms, (b_ms, by)) in times.items():
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.5f} ms ({by})")

    # -- phase 3: examples/10017 through the CLI vs the JAX goldens ---
    env = dict(os.environ, PYTHONPATH=REPO)
    cli_runs = {}
    for setting, flags in (
        ("lp_device", ["--solver", "lp_device"]),
        ("lp_device_pallas", ["--solver", "lp_device", "--pallas"]),
        ("lp_device_fused", ["--solver", "lp_device_fused"]),
    ):
        out = os.path.join(OUT, "e10017_" + setting)
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
        out = os.path.join(OUT, "synthetic_" + setting)
        walls = []
        for _ in range(2):   # cold, then warm
            consensus._LAST_GOOD_CONFIG.clear()
            consensus._RECENT_REQUIREMENTS.clear()
            iou_pallas.LAUNCHES = 0
            for key in megakernel.LAUNCHES:
                megakernel.LAUNCHES[key] = 0
            megakernel.DEMOTIONS = 0
            torch.cuda.synchronize()
            t = time.time()
            st = consensus.run_consensus_dir(
                synth, out, BOX, solver=solver, use_pallas=pallas,
                device="cuda")
            torch.cuda.synchronize()
            walls.append(time.time() - t)
            counts = {"topk_neighbors": iou_pallas.LAUNCHES,
                      **megakernel.LAUNCHES}
            demoted = megakernel.DEMOTIONS
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
    report = {"card": card, "kernels": kernels, "cli_10017": cli_runs,
              "synthetic_256": rates}
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
    sys.exit(main())
