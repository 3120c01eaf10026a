"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU: it carries the ``cuda`` marker and
takes the ``cuda_device`` fixture, which skips it, with a reason, where
there is none.  The file imports no JAX and does not need the suite's
``conftest.py`` (which does), so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -q

The plain versions are themselves held to the JAX package by the other
``tests/test_torch_*.py`` files on the CPU.
"""

import os

# the capacity-config sidecar stays off: a run must not start from the
# capacities a run of another process left in $HOME (they decide bytes)
os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repic_tpu_torch.ops import iou_pallas as tk  # noqa: E402
from repic_tpu_torch.ops import megakernel as tmk  # noqa: E402
from repic_tpu_torch.pipeline import consensus as tcons  # noqa: E402
from repic_tpu_torch.runtime.journal import read_journal  # noqa: E402
from repic_tpu_torch.utils.synthetic import near_tie_packings  # noqa: E402
from torch_port_common import (  # noqa: F401,E402
    GOLDEN_DIR, SETTINGS, clique_inputs, cuda_device, n, neighbor_inputs,
    solve_inputs, t, write_box_dir,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "10017")
BOX = 180.0
# the reference kernels' contract ladders and constants
NEIGHBOR_LADDER = [(64, 128), (96, 256), (40, 70)]
CLIQUE_LADDER = [(3, 64), (3, 96), (2, 40), (4, 24)]
SOLVE_LADDER = [(16, 3), (100, 4), (128, 2)]
PROBE_D, PROBE_CAP, SOLVE_V = 4, 1024, 64


# d = 1 to 32: positive IoUs buffered and ranked, the first zeros kept
# apart; 48: the per-warp list in the output row
@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 4, 8, 16, 24, 32, 48])
@pytest.mark.parametrize("na,mb_", NEIGHBOR_LADDER)
def test_neighbors_kernel_matches_plain(cuda_device, na, mb_, d):
    xa, ma, xb, mb = neighbor_inputs(na, mb_)
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    before = tk.LAUNCHES
    got = tk.topk_neighbors(*args, BOX, BOX, d=d)
    assert tk.LAUNCHES == before + 1
    want = tk.topk_neighbors_plain(*args, BOX, BOX, d=d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


def _neighbors_equal(args, sa, sb, d, threshold=0.3):
    got = tk.topk_neighbors(*args, sa, sb, d=d, threshold=threshold)
    want = tk.topk_neighbors_plain(*args, sa, sb, d=d, threshold=threshold)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24])
@pytest.mark.parametrize("masked", ["anchors", "candidates"])
def test_neighbors_kernel_all_masked_matches_plain(cuda_device, masked, d):
    """Every anchor masked (blocks skip the staging) or every candidate
    masked (empty compacted tiles): empty rows, zero counts."""
    xa, ma, xb, mb = neighbor_inputs(96, 256)
    if masked == "anchors":
        ma = np.zeros_like(ma)
    else:
        mb = np.zeros_like(mb)
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    want = _neighbors_equal(args, BOX, BOX, d)
    assert (n(want[0]) == -1).all() and (n(want[2]) == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [-0.5, -2.0])
def test_neighbors_kernel_negative_thresholds_match_plain(cuda_device,
                                                          threshold):
    """Zero IoUs count below 0; masked pairs' -1 counts below -1."""
    xa, ma, xb, mb = neighbor_inputs(40, 70)
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    for d in (8, 24):
        _neighbors_equal(args, BOX, BOX, d, threshold)


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["host", "card", "host per item"])
def test_neighbors_kernel_per_item_sizes_match_plain(cuda_device, how):
    """enumerate_cliques' batch at K = 4: anchors of picker 0 (box 180)
    against pickers 1-3 (boxes 150, 200, 180), three micrographs; the
    sizes on the host (copied by the wrapper), on the card, or different
    for every item."""
    m, k, n_p = 3, 4, 200
    rng = np.random.default_rng(17)
    base = rng.uniform(0, 1500.0, (m, 1, n_p, 2))
    xy = (base + rng.normal(0, 30.0, (m, k, n_p, 2))).astype(np.float32)
    mask = rng.uniform(size=(m, k, n_p)) > 0.15
    b = m * (k - 1)
    xyt, mt = t(xy, cuda_device), t(mask, cuda_device)
    args = (
        xyt[:, :1].expand(m, k - 1, n_p, 2).reshape(b, n_p, 2),
        mt[:, :1].expand(m, k - 1, n_p).reshape(b, n_p),
        xyt[:, 1:].reshape(b, n_p, 2),
        mt[:, 1:].reshape(b, n_p),
    )
    sizes = torch.tensor([180.0, 150.0, 200.0, 180.0])
    sa, sb = sizes[0].expand(b), sizes[1:].repeat(m)
    if how == "card":
        sa, sb = sa.to(cuda_device), sb.to(cuda_device)
    elif how == "host per item":
        sb = sb + torch.arange(b, dtype=torch.float32)
    for d in (4, 16, 24):
        _neighbors_equal(args, sa, sb, d)


@pytest.mark.cuda
@pytest.mark.parametrize("na,mb_", [(61, 300), (37, 2100), (200, 1024)])
def test_neighbors_kernel_ragged_and_tiled_match_plain(cuda_device, na,
                                                       mb_):
    """N not a multiple of the anchors per block; M past one staged tile
    (1,024 candidates) and exactly one tile."""
    xa, ma, xb, mb = neighbor_inputs(na, mb_)
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    for d in (8, 16, 48):
        _neighbors_equal(args, BOX, BOX, d)


@pytest.mark.cuda
def test_neighbors_kernel_dense_field_matches_plain(cuda_device):
    """About 100 positive IoUs per anchor: the per-warp buffer keeps
    its top d mid-scan, many times over."""
    rng = np.random.default_rng(23)
    xa = rng.uniform(0, 600.0, (64, 2)).astype(np.float32)
    xb = rng.uniform(0, 600.0, (300, 2)).astype(np.float32)
    xb[:20] = xb[20:40]                      # equal IoUs, other indices
    ma = rng.uniform(size=64) > 0.1
    mb = rng.uniform(size=300) > 0.1
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    for d in (1, 8, 32, 48):
        _neighbors_equal(args, BOX, BOX, d)


@pytest.mark.cuda
def test_neighbors_kernel_makes_no_host_copy(cuda_device):
    """Scalar box sizes travel as kernel arguments: a profiled call
    shows the kernel on the card and no host-to-device copy (which the
    same check does see where there is one)."""
    from torch.profiler import ProfilerActivity, profile

    xa, ma, xb, mb = neighbor_inputs(64, 128)
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    tk.topk_neighbors(*args, BOX, BOX, d=8)      # build and load
    torch.cuda.synchronize()

    def names(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [e.name for e in prof.events()]

    seen = names(lambda: tk.topk_neighbors(*args, BOX, BOX, d=8))
    assert any("topk_neighbors_kernel" in x for x in seen), seen
    assert not [x for x in seen if "HtoD" in x], seen
    control = names(lambda: torch.as_tensor(BOX, device=cuda_device))
    assert [x for x in control if "HtoD" in x], control


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,n_p,d",
    [(k, n_p, PROBE_D) for k, n_p in CLIQUE_LADDER]
    # d = 1 and 16: the smallest and largest lane lists of the warp
    # merge; d = 24: the per-warp list in memory, inside the envelope
    # (D^(K-1) <= 4096); then the envelope's upper picker counts
    + [(3, 64, 1), (3, 96, 16), (4, 24, 16), (3, 64, 24), (3, 96, 24),
       (2, 40, 24), (5, 16, 4), (6, 12, 4)],
)
def test_candidates_kernel_matches_plain(cuda_device, k, n_p, d):
    xy, conf, mask = clique_inputs(k, n_p)
    args = [t(a, cuda_device)[None] for a in (xy, conf, mask)]
    kw = dict(threshold=0.3, max_neighbors=d, clique_capacity=PROBE_CAP)
    before = tmk.LAUNCHES["fused_clique_candidates"]
    got = tmk.fused_clique_candidates(*args, BOX, **kw)
    assert tmk.LAUNCHES["fused_clique_candidates"] == before + 1
    want = tmk.fused_clique_candidates_plain(*args, BOX, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.cuda
def test_candidates_kernel_all_masked_matches_plain(cuda_device):
    """No real particle in the micrograph: no clique, zero probes."""
    xy, conf, mask = clique_inputs(3, 64)
    args = [t(a, cuda_device)[None]
            for a in (xy, conf, np.zeros_like(mask))]
    kw = dict(threshold=0.3, max_neighbors=8, clique_capacity=PROBE_CAP)
    got = tmk.fused_clique_candidates(*args, BOX, **kw)
    want = tmk.fused_clique_candidates_plain(*args, BOX, **kw)
    assert int(n(want[7])[0]) == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "c,k,v",
    [(c, k, SOLVE_V) for c, k in SOLVE_LADDER]
    # solve state past shared memory: the kernel's global scratch
    + [(20000, 3, 3072)],
)
def test_dual_solve_kernel_matches_plain(cuda_device, c, k, v):
    mv, w, valid = (t(a, cuda_device)[None]
                    for a in solve_inputs(c, k, v))
    before = tmk.LAUNCHES["fused_dual_solve"]
    got = tmk.fused_dual_solve(mv, w, valid, v)
    assert tmk.LAUNCHES["fused_dual_solve"] == before + 1
    want = tmk.fused_dual_solve_plain(mv, w, valid, v)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [False, True])
def test_dual_solve_kernel_validity_edges_match_plain(cuda_device, fill):
    """No valid clique (empty worklists from the start) and every
    clique valid."""
    mv, w, valid = solve_inputs(100, 4)
    valid = np.full_like(valid, fill)
    args = [t(a, cuda_device)[None] for a in (mv, w, valid)]
    got = tmk.fused_dual_solve(*args, SOLVE_V)
    want = tmk.fused_dual_solve_plain(*args, SOLVE_V)
    np.testing.assert_array_equal(n(got), n(want))
    assert n(got).any() == fill


@pytest.mark.cuda
@pytest.mark.parametrize("gadgets,background", [(1, 60), (2, 200), (4, 5000)])
def test_dual_solve_kernel_near_ties_match_plain(cuda_device, gadgets,
                                                 background):
    """Candidates a rounding apart: the kernel's float32 objective sums
    must take the plain version's order (C = 63 and 206 take one level
    of window sums, C = 5012 two)."""
    *arrays, v = near_tie_packings(32, gadgets, background, seed=1)
    mv, w, valid = (t(a, cuda_device) for a in arrays)
    got = tmk.fused_dual_solve(mv, w, valid, v)
    want = tmk.fused_dual_solve_plain(mv, w, valid, v)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.cuda
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_card_run_matches_goldens(cuda_device, tmp_path, setting):
    solver, pallas = SETTINGS[setting]
    tcons.run_consensus_dir(EXAMPLES, str(tmp_path), int(BOX),
                            solver=solver, use_pallas=pallas,
                            device=cuda_device)
    for f in sorted(os.listdir(os.path.join(GOLDEN_DIR, setting))):
        with open(os.path.join(GOLDEN_DIR, setting, f), "rb") as a, \
                open(tmp_path / f, "rb") as b:
            assert a.read() == b.read(), f


_CLIQUE_FIELDS = ("member_idx", "valid", "w", "confidence", "rep_slot",
                  "rep_xy", "num_valid", "max_adjacency", "max_cell_count",
                  "max_partial")


def _same_cliques(got, want):
    for f in _CLIQUE_FIELDS:
        np.testing.assert_array_equal(n(getattr(got, f)),
                                      n(getattr(want, f)), err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("assembly", ["chunked", "staged"])
def test_bucketed_enumeration_on_card_matches_cpu(cuda_device, assembly):
    """The spatial search and the chunked / staged assemblies are torch
    ops: the card gives the CPU's bits (mixed box sizes, K = 5)."""
    from repic_tpu_torch.ops import cliques as tc

    items = [clique_inputs(5, 60, seed=s) for s in (1, 2)]
    arrays = [np.stack([it[j] for it in items]) for j in range(3)]
    sizes = np.asarray([180.0, 200.0, 220.0, 160.0, 180.0], np.float32)
    kw = dict(max_neighbors=6 if assembly == "staged" else 3, grid=8,
              cell_capacity=8, clique_capacity=4096, anchor_chunk=16)
    got = tc.enumerate_cliques_bucketed(
        *[t(a, cuda_device) for a in arrays], t(sizes, cuda_device), **kw)
    want = tc.enumerate_cliques_bucketed(*[t(a) for a in arrays], sizes,
                                         **kw)
    _same_cliques(got, want)
    assert (int(want.max_partial.max()) > 0) == (assembly == "staged")


@pytest.mark.cuda
def test_staged_join_with_kernel_1_per_picker_sizes(cuda_device):
    """K = 5 with per-picker sizes on the card: the staged join takes
    kernel 1's lists (one launch) and gives the plain matrix path's
    cliques."""
    from repic_tpu_torch.ops import cliques as tc

    items = [clique_inputs(5, 60, seed=s) for s in (3, 4)]
    arrays = [t(np.stack([it[j] for it in items]), cuda_device)
              for j in range(3)]
    sizes = t(np.asarray([180.0, 200.0, 220.0, 160.0, 180.0], np.float32),
              cuda_device)
    kw = dict(max_neighbors=6, clique_capacity=4096)
    before = tk.LAUNCHES
    got = tc.enumerate_cliques(*arrays, sizes, use_pallas=True, **kw)
    assert tk.LAUNCHES == before + 1
    want = tc.enumerate_cliques(*arrays, sizes, **kw)
    _same_cliques(got, want)
    assert int(want.max_partial.max()) > 0


@pytest.mark.cuda
def test_kernel_1_serves_d_past_the_reference_cap(cuda_device):
    """256 < d <= MAX_D: the clique enumeration keeps kernel 1 (one
    launch, no warning) and gives its plain version's cliques."""
    import warnings

    from repic_tpu_torch.ops import cliques as tc

    xy, conf, mask = clique_inputs(2, 320, seed=5)
    kw = dict(max_neighbors=300)
    before = tk.LAUNCHES
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tc.enumerate_cliques(
            *[t(a, cuda_device)[None] for a in (xy, conf, mask)], BOX,
            use_pallas=True, **kw)
    assert tk.LAUNCHES == before + 1
    want = tc.enumerate_cliques(*[t(a)[None] for a in (xy, conf, mask)],
                                BOX, use_pallas=True, **kw)
    _same_cliques(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,v", [(300, 3, 120), (2000, 4, 600)])
def test_lp_rounding_on_card_matches_cpu(cuda_device, c, k, v):
    """The lp rung's torch ops on the card pick as on the CPU (which
    is held to the JAX package), also on near-tie packings."""
    from repic_tpu_torch.ops.solver import solve_lp_rounding

    rng = np.random.default_rng(c)
    mv = rng.integers(0, v, (4, c, k)).astype(np.int32)
    w = rng.uniform(0.01, 1.0, (4, c)).astype(np.float32)
    valid = rng.uniform(size=(4, c)) > 0.1
    cases = [(mv, w, valid, v), near_tie_packings(8, 2, 200, seed=c)]
    for a, b, vl, nv in cases:
        want = solve_lp_rounding(t(a), t(b), t(vl), nv)
        got = solve_lp_rounding(t(a, cuda_device), t(b, cuda_device),
                                t(vl, cuda_device), nv)
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4, 5])
def test_components_on_card_match_cpu(cuda_device, k):
    from repic_tpu_torch.ops.components import connected_component_labels

    xs, _, ms = zip(*(clique_inputs(k, 256, seed=k + i) for i in range(3)))
    xy, mask = np.stack(xs), np.stack(ms)
    sizes = np.linspace(150.0, 210.0, k).astype(np.float32)
    for box in (BOX, sizes):
        want = connected_component_labels(t(xy), t(mask), (
            t(box) if isinstance(box, np.ndarray) else box))
        got = connected_component_labels(
            t(xy, cuda_device), t(mask, cuda_device),
            t(box, cuda_device) if isinstance(box, np.ndarray) else box)
        lab_w, nm_w, r_w = want
        lab_g, nm_g, r_g = got
        np.testing.assert_array_equal(n(nm_g), n(nm_w))
        np.testing.assert_array_equal(n(lab_g)[n(nm_g)], n(lab_w)[n(nm_w)])
        assert r_g == r_w


def _box_bytes(out):
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out)) if f.endswith(".box")}


@pytest.mark.cuda
def test_config_sidecar_is_off_on_the_card(cuda_device):
    """This file runs without the suite's conftest: the guard above
    keeps the sidecar off, so the goldens' capacities hold."""
    assert tcons._config_cache_path() is None


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["lp_device_fused", "lp_device"])
def test_engine_with_prefetch_gives_the_cpu_bytes(cuda_device, tmp_path,
                                                  monkeypatch, solver):
    """10017 in chunks of 4 (three chunks, the worker one ahead) on the
    card, prefetch on and off: the CPU run's bytes and journal."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "4")
    runs = {}
    for label, device, prefetch in (("cpu", "cpu", "1"),
                                    ("on", cuda_device, ""),
                                    ("off", cuda_device, "1")):
        monkeypatch.setenv("REPIC_TPU_NO_PREFETCH", prefetch)
        tcons._LAST_GOOD_CONFIG.clear()
        tcons._RECENT_REQUIREMENTS.clear()
        out = str(tmp_path / label)
        st = tcons.run_consensus_dir(EXAMPLES, out, int(BOX), solver=solver,
                                     device=device)
        assert st["chunks"] == 3
        runs[label] = (_box_bytes(out), [
            (e["name"], e["status"], e["particles"])
            for e in read_journal(out) if "name" in e])
    assert runs["on"] == runs["cpu"] and runs["off"] == runs["cpu"]
    assert len(runs["cpu"][0]) == 12


@pytest.mark.cuda
def test_real_card_oom_is_classed_and_halves(cuda_device, tmp_path,
                                             monkeypatch):
    """A too-large allocation on the card raises the allocator's
    ``torch.cuda.OutOfMemoryError``; the engine classes it ``oom``,
    halves the chunk and writes the bytes of a run that never ran out."""
    from repic_tpu_torch.runtime.ladder import classify_error

    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(1 << 50, dtype=torch.uint8, device=cuda_device)
    assert classify_error(ei.value) == "oom"
    data = write_box_dir(tmp_path, m=4)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "4")
    tcons._LAST_GOOD_CONFIG.clear()
    tcons._RECENT_REQUIREMENTS.clear()
    ref = str(tmp_path / "ref")
    tcons.run_consensus_dir(data, ref, 64, device=cuda_device)
    real = tcons.run_consensus_batch
    calls = []

    def hungry(batch, *a, **kw):
        calls.append(batch.xy.shape[0])
        if batch.xy.shape[0] > 2:
            torch.empty(1 << 50, dtype=torch.uint8, device=cuda_device)
        return real(batch, *a, **kw)

    monkeypatch.setattr(tcons, "run_consensus_batch", hungry)
    tcons._LAST_GOOD_CONFIG.clear()
    tcons._RECENT_REQUIREMENTS.clear()
    out = str(tmp_path / "out")
    st = tcons.run_consensus_dir(data, out, 64, device=cuda_device,
                                 strict=True)
    assert calls == [4, 2, 2] and st["chunk"] == 2
    halved = [e for e in read_journal(out) if e.get("event") == "chunk_halved"]
    assert [e["chunk"] for e in halved] == [2]
    assert st["journal"] == {"retried": 4}
    chunked = str(tmp_path / "chunked")
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    monkeypatch.setattr(tcons, "run_consensus_batch", real)
    tcons._LAST_GOOD_CONFIG.clear()
    tcons._RECENT_REQUIREMENTS.clear()
    tcons.run_consensus_dir(data, chunked, 64, device=cuda_device)
    assert _box_bytes(out) == _box_bytes(chunked)


# -- the telemetry probes on the card --------------------------------------


def _solve_batch(cuda_device, m=32):
    """Kernel 3's largest contract input, ``m`` times: milliseconds of
    device work."""
    c, k, v = 20000, 3, 3072
    arrays = [solve_inputs(c, k, v, seed=s) for s in range(m)]
    return [t(np.stack(a), cuda_device) for a in zip(*arrays)] + [v]


@pytest.mark.cuda
def test_sync_device_waits_for_a_queued_kernel(cuda_device, tmp_path):
    """``sync_device`` drains a queued kernel-3 launch; under
    ``--device-time`` a span around a launch records the device tail."""
    from repic_tpu_torch.telemetry import events as tevents
    from repic_tpu_torch.telemetry import probes as tprobes

    *args, v = _solve_batch(cuda_device)
    tmk.fused_dual_solve(*args, v)  # the build and a warm launch
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_device)
    tmk.fused_dual_solve(*args, v)
    waited = tprobes.sync_device()
    assert waited > 0 and stream.query()
    log = tevents.EventLog(str(tmp_path / "_events.jsonl"))
    prev = tevents.set_current_log(log)
    try:
        with tprobes.device_time(True), tevents.span("solve"):
            tmk.fused_dual_solve(*args, v)
    finally:
        tevents.set_current_log(prev)
        log.close()
    (rec,) = tevents.read_events(str(tmp_path))
    assert rec["device_tail_s"] > 0
    assert rec["dur_s"] >= rec["host_s"] + rec["device_tail_s"] - 1e-6


@pytest.mark.cuda
def test_device_memory_reads_the_allocator(cuda_device):
    from repic_tpu_torch.telemetry import probes as tprobes

    x = torch.ones(1 << 20, device=cuda_device)
    mem = tprobes.device_memory()
    assert mem["bytes_in_use"] >= x.nbytes
    assert mem["peak_bytes_in_use"] >= mem["bytes_in_use"]
    assert mem["bytes_limit"] >= 16 << 30
    count, nbytes = tprobes.live_buffers()
    assert count >= 1 and nbytes >= x.nbytes
    snap = tprobes.snapshot()
    assert snap["device_memory"] == tprobes.device_memory()


@pytest.mark.cuda
def test_parse_trace_dir_on_a_real_profiler_trace(cuda_device, tmp_path):
    """One kernel-2 launch under ``torch.profiler``: the trace file's
    device ops are the profiler's own CUDA events, on a device lane,
    and its device busy time is their union within 10%.  A session in
    which the profiler itself recorded no CUDA activity (CUPTI
    sometimes delivers none in a process that profiled before) is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    from torch.profiler import tensorboard_trace_handler

    from repic_tpu_torch.telemetry.devicetime import parse_trace_dir

    xy, conf, mask = clique_inputs(3, 1024)
    args = [t(a, cuda_device)[None] for a in (xy, conf, mask)]
    kw = dict(threshold=0.3, max_neighbors=8, clique_capacity=4096)
    tmk.fused_clique_candidates(*args, BOX, **kw)
    torch.cuda.synchronize()
    for attempt in range(3):
        trace_dir = str(tmp_path / f"prof{attempt}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     on_trace_ready=tensorboard_trace_handler(trace_dir)
                     ) as p:
            tmk.fused_clique_candidates(*args, BOX, **kw)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in p.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    out = parse_trace_dir(trace_dir)
    assert out["device_ops"] == len(spans) >= 1
    assert out["device_busy_s"] == pytest.approx(busy / 1e6, rel=0.10)


# -- the serve daemon on the card ------------------------------------


@pytest.mark.cuda
def test_served_fused_job_gives_the_cpu_daemons_bytes(cuda_device,
                                                      tmp_path):
    """A daemon on ``cuda`` serves one fused ``mini10017`` job: its
    artifacts equal the CPU daemon's byte for byte, and kernels 2 and 3
    launched on the card for it."""
    from torch_serve_common import (
        FIXTURE, artifact_digests, fresh, run_job, running,
    )

    body = {"in_dir": FIXTURE, "box_size": 180,
            "options": {"use_mesh": False, "solver": "lp_device_fused"}}
    digests = {}
    for device in ("cpu", "cuda"):
        fresh("port")
        before = dict(tmk.LAUNCHES)
        with running("port", str(tmp_path / device), warmup=False,
                     device=device) as d:
            doc = run_job(d.server.port, body, timeout=300)
            assert doc["state"] == "finished", doc
            digests[device] = artifact_digests(d.server.port, doc["id"])
        launched = {k: tmk.LAUNCHES[k] - before[k] for k in before}
        if device == "cuda":
            assert all(v >= 1 for v in launched.values()), launched
        else:
            assert not any(launched.values()), launched
    assert len(digests["cuda"]) == 3
    assert digests["cuda"] == digests["cpu"]


@pytest.mark.cuda
def test_warmup_on_cuda_loads_the_kernel_libraries(cuda_device):
    from repic_tpu_torch import _build
    from repic_tpu_torch.pipeline import engine

    info = engine.warmup(3, 64, device="cuda")
    assert set(_build.KERNELS) <= set(_build._LIBS)
    assert info["num_pickers"] == 3 and info["capacity"] == 64


@pytest.mark.cuda
def test_cuda_daemon_without_visible_card_raises_before_binding(
        cuda_device, tmp_path):
    """With ``CUDA_VISIBLE_DEVICES=""`` a ``cuda`` daemon raises at
    construction: no port bound, no ``_serve.json``."""
    import subprocess
    import sys

    wd = str(tmp_path / "wd")
    code = (
        "import sys\n"
        "from repic_tpu_torch.serve.daemon import ConsensusDaemon\n"
        "try:\n"
        f"    ConsensusDaemon({wd!r}, port=0, device='cuda')\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
        "    sys.exit(3)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO),
    )
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "CUDA" in proc.stdout
    assert not os.path.exists(os.path.join(wd, "_serve.json"))


# -- the CNN picker and the host utilities on the card -------------------

PICKER = os.path.join(REPO, "tests", "golden", "torch_port_picker")


def _picker_params(device):
    from repic_tpu_torch.models.checkpoint import (
        load_checkpoint, params_from_jax,
    )
    from repic_tpu_torch.models.cnn import fc_params_as_conv

    params, _ = load_checkpoint(os.path.join(PICKER, "deep.ckpt"))
    return params, {
        "patch": {k: v.to(device)
                  for k, v in params_from_jax(params).items()},
        "fcn": {k: v.to(device) for k, v in params_from_jax(
            fc_params_as_conv(params)).items()},
    }


@pytest.mark.cuda
def test_micrograph_preprocess_on_card_is_the_cpus_bits(cuda_device):
    from repic_tpu_torch.models import preprocess as pp
    from repic_tpu_torch.utils.synthetic import synthetic_micrograph

    raw, _ = synthetic_micrograph(0)
    got = pp.preprocess_micrograph(torch.from_numpy(raw).to(cuda_device))
    want = pp.preprocess_micrograph(torch.from_numpy(raw))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [16, 48, 60, 80, 96])
def test_patch_resize_on_card_gives_the_cpus_levels(cuda_device, size):
    """Up through the card's antialiased bilinear kernel, down through
    the weight matrices: the rounded uint8 levels of the CPU (which are
    the reference's), the floats within 1e-4."""
    from repic_tpu_torch.models import preprocess as pp

    rng = np.random.default_rng(size)
    b = pp.bytescale(torch.from_numpy(
        (rng.normal(size=(256, size, size)) * 3).astype(np.float32)))
    want = pp.resize_patches(b, 64)
    got = pp.resize_patches(b.to(cuda_device), 64).cpu()
    assert torch.equal(torch.round(got), torch.round(want))
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("tf32_matmul", [False, True])
@pytest.mark.parametrize("mode", ["patch", "fcn"])
def test_score_maps_on_card_match_the_jax_goldens(cuda_device, mode,
                                                 tf32_matmul):
    """The 4096 x 4096 micrograph of seed 0: float32 within 1e-4 of the
    JAX map, bfloat16 within 3e-2, whatever the caller's cuBLAS TF32
    setting (which scoring gives back)."""
    from repic_tpu_torch.models import infer
    from repic_tpu_torch.models import preprocess as pp
    from repic_tpu_torch.utils.synthetic import synthetic_micrograph

    _, sd = _picker_params(cuda_device)
    raw, _ = synthetic_micrograph(0)
    img = pp.preprocess_micrograph(torch.from_numpy(raw).to(cuda_device))
    want = np.load(os.path.join(PICKER, "maps.npz"))[f"mic_0_{mode}"]
    fn = (infer.score_micrograph_fcn if mode == "fcn"
          else infer.score_micrograph_patches)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32_matmul
    try:
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
            got = fn(sd[mode], img, patch_size=60, dtype=dtype).cpu().numpy()
            assert torch.backends.cuda.matmul.allow_tf32 == tf32_matmul
            assert got.shape == want.shape
            assert float(np.abs(got - want).max()) <= tol, dtype
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["patch", "fcn"])
def test_peaks_of_the_jax_map_on_card_give_jax_picks(cuda_device, mode):
    from repic_tpu_torch.models import infer
    from repic_tpu_torch.utils.box_io import render_box

    smap = np.load(os.path.join(PICKER, "maps.npz"))[f"mic_1_{mode}"]
    coords = infer.picks_from_score_map(smap, 180, mode=mode,
                                        device=cuda_device)
    text, _ = render_box(coords[:, :2] - 90, coords[:, 2], 180)
    with open(os.path.join(PICKER, f"picks_{mode}", "mic_1.box")) as f:
        assert text == f.read()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1024, 4096])
def test_device_nms_on_card_equals_the_host_loop(cuda_device, p):
    from repic_tpu_torch.models.infer import greedy_suppress_host
    from repic_tpu_torch.ops.nms import greedy_suppress_device

    rng = np.random.default_rng(p)
    yx = rng.integers(0, 8 * int(np.sqrt(p)), size=(p, 2))
    scores = rng.random(p).astype(np.float32)
    np.testing.assert_array_equal(
        greedy_suppress_device(yx, scores, 4.5, device=cuda_device),
        greedy_suppress_host(yx, scores, 4.5))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["patch", "fcn"])
def test_pick_cli_on_card_is_repeatable_and_the_cpus(cuda_device, tmp_path,
                                                     mode):
    from repic_tpu_torch.main import main as cli
    from repic_tpu_torch.utils import mrc

    rng = np.random.default_rng(3)
    mrc_dir = tmp_path / "mrc"
    mrc_dir.mkdir()
    for i in range(2):
        mrc.write_mrc(str(mrc_dir / f"m{i}.mrc"),
                      rng.normal(size=(1024, 1024)).astype(np.float32))
    ckpt = os.path.join(PICKER, "deep.ckpt")
    runs = {}
    for tag, extra in (("a", []), ("b", []), ("cpu", ["--device", "cpu"])):
        out = tmp_path / tag
        cli(["pick", ckpt, str(mrc_dir), str(out), "--mode", mode, *extra])
        runs[tag] = {f: (out / f).read_text() for f in ("m0.box", "m1.box")}
    assert runs["a"] == runs["b"]
    for f, text in runs["a"].items():
        got = [line.split()[:2] for line in text.splitlines()]
        want = [line.split()[:2] for line in runs["cpu"][f].splitlines()]
        assert sorted(got) == sorted(want), f


@pytest.mark.cuda
def test_segmentation_scores_on_card_equal_the_cpus(cuda_device):
    from repic_tpu_torch.utils.scoring import get_segmentation_scores
    from repic_tpu_torch.utils.table import Table

    rng = np.random.default_rng(5)

    def boxes(n):
        return Table(dict(zip("xywh", (rng.integers(-20, 4000, n),
                                       rng.integers(-20, 4000, n),
                                       np.full(n, 180), np.full(n, 180)))))

    for _ in range(3):
        gt, pk = boxes(900), boxes(700)
        assert get_segmentation_scores(
            gt, pk, mrc_w=4096, mrc_h=4096, device=cuda_device
        ) == get_segmentation_scores(gt, pk, mrc_w=4096, mrc_h=4096,
                                     device="cpu")


# -- the picker's training half ------------------------------------------

TRAINING = os.path.join(REPO, "tests", "golden", "torch_port_training")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,shape", [(0, (400, 430)), (2, (400, 430)),
                                        (0, (256, 256)), (1, (800, 800)),
                                        (0, (3710, 3838))])
def test_zscore_on_card_equals_the_cpus(cuda_device, seed, shape):
    """The summation-order rule gives the card the CPU's bits (and so
    the reference's), the micrograph's z-score and the patches'."""
    from repic_tpu_torch.models import preprocess as pp

    raw = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    assert torch.equal(pp.preprocess_micrograph(t(raw, cuda_device)).cpu(),
                       pp.preprocess_micrograph(t(raw)))
    p = np.random.default_rng(seed).normal(size=(64, 40, 40)) * 3
    p = p.astype(np.float32)
    assert torch.equal(pp.prepare_patches(t(p, cuda_device), 64).cpu(),
                       pp.prepare_patches(t(p), 64))


@pytest.mark.cuda
def test_tree_sum_on_card_equals_the_cpus(cuda_device):
    from repic_tpu_torch.models.preprocess import tree_sum

    rng = np.random.default_rng(0)
    for shape in [(h, w) for h in (1, 2, 7, 16, 21, 29, 32)
                  for w in (1, 2, 5, 8, 9, 32)] + [(63, 63), (2559, 4),
                                                   (45, 223), (1365, 1365)]:
        x = (rng.standard_normal(shape)
             * np.exp2(rng.uniform(-12, 12, shape))).astype(np.float32)
        assert torch.equal(tree_sum(t(x, cuda_device)).cpu(),
                           tree_sum(t(x))), shape


@pytest.mark.cuda
def test_train_step_on_card_matches_the_jax_golden(cuda_device):
    """One update from the committed JAX step's parameters, batch and
    mask, at the CPU test's tolerances; the learning rate bitwise."""
    from repic_tpu_torch.models.checkpoint import params_from_jax
    from repic_tpu_torch.models.cnn import PickerCNN
    from repic_tpu_torch.models.infer import _fp32_flags
    from repic_tpu_torch.models.train import learning_rate, train_step
    from torch_port_common import unflat_tree

    g = dict(np.load(os.path.join(TRAINING, "step.npz")))
    model = PickerCNN(device="meta")
    model.load_state_dict({k: v.to(cuda_device) for k, v in params_from_jax(
        unflat_tree(g, "params/")).items()}, assign=True)
    model.requires_grad_(True)
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    lr = learning_rate(0, 0.01, 8, 0.95)
    assert lr.tobytes() == g["lr"].tobytes()
    with _fp32_flags():
        loss, logits = train_step(
            model, momentum, t(g["batch"], cuda_device),
            t(g["labels"].astype(np.int64), cuda_device), lr,
            dropout_mask=t(g["mask"], cuda_device))
    assert abs(float(loss) / float(g["loss"]) - 1) < 1e-6
    np.testing.assert_allclose(n(logits), g["logits"], atol=1e-5)
    want_p = params_from_jax(unflat_tree(g, "updated/"))
    want_t = params_from_jax(unflat_tree(g, "trace/"))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(n(p), want_p[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(
            n(momentum[k]), want_t[k].numpy(), rtol=0,
            atol=1e-4 * float(want_t[k].abs().max()), err_msg=k)


@pytest.mark.cuda
def test_fit_on_card_repeats_its_bits(cuda_device, tmp_path):
    """Two fits of one seed on the card give the same parameters (TF32
    off, deterministic cuDNN, weight gradients as GEMMs), and learn the
    planted particles."""
    from repic_tpu_torch.models.data import load_dataset
    from repic_tpu_torch.models.train import TrainConfig, fit
    from repic_tpu_torch.utils import mrc
    from repic_tpu_torch.utils.box_io import write_box
    from repic_tpu_torch.utils.synthetic import synthetic_micrograph

    dirs = {}
    for split, seeds in (("train", (7, 8)), ("val", (9,))):
        mrc_dir, box_dir = tmp_path / f"{split}_mrc", tmp_path / f"{split}_box"
        mrc_dir.mkdir()
        box_dir.mkdir()
        for seed in seeds:
            img, centres = synthetic_micrograph(seed, size=1024)
            mrc.write_mrc(str(mrc_dir / f"m{seed}.mrc"), img)
            write_box(str(box_dir / f"m{seed}.box"),
                      centres.astype(np.float64) - 90, np.ones(len(centres)),
                      180)
        dirs[split] = (str(mrc_dir), str(box_dir))
    train = load_dataset(*dirs["train"], 180, device=cuda_device)
    val = load_dataset(*dirs["val"], 180, seed=1235, device=cuda_device)
    assert train[0].shape == load_dataset(*dirs["train"], 180,
                                          device="cpu")[0].shape
    runs = [fit(*train, *val, TrainConfig(batch_size=32, max_epochs=4,
                                          verbose=False), device=cuda_device)
            for _ in range(2)]
    from torch_port_common import flat_tree

    again = flat_tree(runs[1].params)
    for k, v in flat_tree(runs[0].params).items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    assert runs[0].history == runs[1].history
    assert runs[0].best_val_error <= 10.0


# -- the cluster runtime and the serving fleet on the card ------------


@pytest.mark.cuda
def test_two_host_cluster_on_card_gives_the_golden_bytes(cuda_device,
                                                         tmp_path):
    """Two ``consensus --coordination-dir`` host processes on ``cuda:0``
    over one output directory, fused in chunks of 2: the 10017 BOX
    files equal the JAX golden, each host journaled its share with
    ``chunk_dispatches`` events, and kernels 2 and 3 launched in each."""
    import json
    import subprocess
    import sys

    from repic_tpu_torch.runtime.journal import DONE_STATUSES, merged_latest

    out = str(tmp_path / "o")
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, REPIC_CONSENSUS_CHUNK="2",
                   REPIC_TPU_HOST_ID=f"h{rank}", REPIC_TPU_HOST_RANK=str(rank),
                   REPIC_TPU_NUM_HOSTS="2", REPIC_TPU_NO_CONFIG_CACHE="1")
        env.pop("REPIC_TPU_FAULTS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repic_tpu_torch", "consensus", EXAMPLES,
             out, "180", "--solver", "lp_device_fused", "--coordination-dir",
             out], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    stats = []
    for p in procs:
        so, se = p.communicate(timeout=300)
        assert p.returncode == 0, se[-2000:]
        stats.append(json.loads(so.strip().splitlines()[-1]))
    gold = os.path.join(GOLDEN_DIR, "lp_device_fused")
    for f in os.listdir(gold):
        with open(os.path.join(gold, f), "rb") as a, \
                open(os.path.join(out, f), "rb") as b:
            assert a.read() == b.read(), f
    merged = merged_latest(out)
    assert len(merged) == 12
    assert all(e["status"] in DONE_STATUSES for e in merged.values())
    for rank, st in enumerate(stats):
        assert st["device"].startswith("cuda")
        assert st["launches"]["fused_clique_candidates"] >= 1
        assert st["launches"]["fused_dual_solve"] >= 1
        ev = [e for e in _host_events(out, f"h{rank}")
              if e.get("event") == "chunk_dispatches"]
        assert ev and all(e["dispatches"] >= 3 for e in ev)


def _host_events(out, host):
    from repic_tpu_torch.runtime.journal import _read_entries

    return _read_entries(os.path.join(out, f"_journal.{host}.jsonl"))


@pytest.mark.cuda
def test_one_replica_fleet_job_on_card(cuda_device, tmp_path):
    """A one-replica fleet (``fleet_dir``) on ``cuda`` serves 10017
    fused: the golden artifacts, one completion token, no lease left
    after the drain, and the kernels' launches on ``/status``."""
    import json

    from repic_tpu_torch.serve.daemon import ConsensusDaemon
    from repic_tpu_torch.serve.fleet import FleetMember
    from repic_tpu_torch.utils.synthetic import file_sha256
    from torch_serve_common import artifact_digests, req, run_job

    fleet = str(tmp_path / "fleet")
    d = ConsensusDaemon(str(tmp_path / "wd"), port=0, warmup=False,
                        device="cuda", fleet_dir=fleet, replica_id="r1",
                        heartbeat_interval_s=0.2, replica_timeout_s=1.0)
    d.start()
    try:
        doc = run_job(d.server.port, {
            "in_dir": EXAMPLES, "box_size": 180,
            "options": {"use_mesh": False, "solver": "lp_device_fused"}},
            timeout=300)
        assert doc["state"] == "finished" and doc["replica"] == "r1", doc
        gold = os.path.join(GOLDEN_DIR, "lp_device_fused")
        assert artifact_digests(d.server.port, doc["id"]) == {
            f: file_sha256(os.path.join(gold, f)) for f in os.listdir(gold)}
        assert os.path.exists(os.path.join(fleet, f"_done.{doc['id']}.json"))
        status = json.loads(req(d.server.port, "GET", "/status")[2])
        assert status["fleet"]["replicas"]["r1"]["rung"] == "live"
        assert status["launches"]["fused_clique_candidates"] >= 1
    finally:
        d.drain()
    assert FleetMember(fleet, "probe").orphaned_leases() == []


@pytest.mark.cuda
def test_kernelcheck_on_card_clean(cuda_device):
    """KERNELCHECK on the card: the three CUDA kernels themselves
    against their unfused paths over every ladder rung, 0 violations;
    the same run with one kernel's output perturbed records it."""
    import dataclasses

    from repic_tpu_torch.analysis import contracts, kernelcheck

    before = tcons.launch_counts()
    with kernelcheck.scoped():
        kernelcheck.reset()
        assert kernelcheck.run_registered(device=cuda_device.type) == 3
        assert kernelcheck.violations() == [], kernelcheck.report_text()
        entry = contracts.registry()[
            "repic_tpu_torch.ops.megakernel.fused_dual_solve"]
        contract, kc = entry.contract, entry.contract.kernel

        def perturbed(*args):
            picked = kc.run(*args).clone()
            picked[0] = ~picked[0]
            return picked

        entry.contract = dataclasses.replace(
            contract, kernel=dataclasses.replace(kc, run=perturbed))
        try:
            kernelcheck.run_registered(("repic_tpu_torch.ops.megakernel",),
                                       device=cuda_device.type)
        finally:
            entry.contract = contract
        assert any(v["kind"] == "kernel-divergence"
                   for v in kernelcheck.violations())
    after = tcons.launch_counts()
    assert all(after[k] > before[k] for k in after), (before, after)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["lp_device_fused", "lp_device_pallas"])
def test_gang_of_one_on_card_matches_goldens(cuda_device, tmp_path,
                                             setting):
    """``run_consensus_dir(gang=...)`` as a gang of one on the card: the
    JAX package's BOX bytes, every kernel of the setting launched, no
    fused chunk demoted."""
    from repic_tpu_torch.parallel.gang import GangConfig

    solver, pallas = SETTINGS[setting]
    before, demoted = tcons.launch_counts(), tmk.DEMOTIONS
    stats = tcons.run_consensus_dir(EXAMPLES, str(tmp_path), int(BOX),
                                    solver=solver, use_pallas=pallas,
                                    device=cuda_device, gang=GangConfig())
    assert stats["gang"]["mode"] == "gang" and stats["gang"]["faults"] == 0
    assert stats["device"].startswith("cuda")
    for f in sorted(os.listdir(os.path.join(GOLDEN_DIR, setting))):
        with open(os.path.join(GOLDEN_DIR, setting, f), "rb") as a, \
                open(tmp_path / f, "rb") as b:
            assert a.read() == b.read(), f
    after = tcons.launch_counts()
    need = (["topk_neighbors"] if pallas
            else ["fused_clique_candidates", "fused_dual_solve"])
    assert all(after[k] > before[k] for k in need), (before, after)
    assert tmk.DEMOTIONS == demoted
