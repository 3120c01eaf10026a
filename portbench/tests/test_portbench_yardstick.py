"""The yardstick: generators deterministic for their seed, the FLOP
count of the picker, and the plain references against the program's
CPU path at tiny sizes."""

import numpy as np
import pytest

from portbench import compare, synth, work
from portbench.reference import consensus as ref_consensus
from portbench.reference import picker as ref_picker

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3, -5]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gen", ["density_10017", "box_tree", "micrograph",
                                 "dense_field"])
def test_generators_repeat_for_their_seed(gen, seed):
    def draw(s):
        rng = np.random.default_rng(synth.rng_seed(s, 0))
        if gen == "micrograph":
            return [synth.micrograph(rng, size=256, particles=(5, 9))]
        kw = {"box_tree": {"n_per": 30}, "density_10017": {},
              "dense_field": {"n": 50}}[gen]
        return synth.generator(gen)(rng, pickers=3, **kw)

    a, b, c = draw(seed), draw(seed), draw(seed + 1)
    for (x, y), (u, v) in zip(a, b):
        assert np.array_equal(x, u) and np.array_equal(y, v)
    assert any(not np.array_equal(x, u) for (x, _), (u, _) in zip(a, c))


def test_density_of_10017():
    rng = np.random.default_rng(synth.rng_seed(3, 0))
    for xy, conf in synth.density_10017(rng, pickers=3):
        assert 600 <= len(xy) <= 950 and xy.dtype == np.float32
        assert np.all(xy == np.round(xy)) and np.all(conf > 0)


def test_patch_mode_flops_reproduce_0_962_tflop():
    assert work.patch_windows(4096, 180) == 106_929
    assert round(work.pick_flops(4096, 180, "patch") / 1e12, 3) == 0.962
    # the fcn count depends on its own grid only
    assert 0 < work.pick_flops(4096, 180, "fcn") < work.pick_flops(
        4096, 180, "patch")
    assert work.share_of_peak(67e12, 1.0) == pytest.approx(100.0)


def _batch(mics, n):
    from repic_tpu_torch.parallel.batching import PaddedBatch

    m, k = len(mics), len(mics[0])
    xy = np.zeros((m, k, n, 2), np.float32)
    conf = np.zeros((m, k, n), np.float32)
    mask = np.zeros((m, k, n), bool)
    counts = np.zeros((m, k), np.int32)
    for i, mic in enumerate(mics):
        for p, (pxy, pc) in enumerate(mic):
            xy[i, p, :len(pxy)], conf[i, p, :len(pxy)] = pxy, pc
            mask[i, p, :len(pxy)] = True
            counts[i, p] = len(pxy)
    return PaddedBatch(xy, conf, mask, tuple(f"m{i}" for i in range(m)),
                       counts)


@pytest.mark.parametrize("k,sizes", [(3, [180.0] * 3),
                                     (5, [180.0, 200.0, 220.0, 160.0,
                                          180.0])])
def test_consensus_reference_equals_the_program_on_the_cpu(k, sizes):
    from repic_tpu_torch.pipeline.consensus import run_consensus_batch

    rng = np.random.default_rng(synth.rng_seed(11 + k, 0))
    mics = [synth.box_tree(rng, pickers=k, n_per=50, lo=0.0, hi=700.0)
            for _ in range(3)]
    batch = _batch(mics, 64)
    box = np.asarray(sizes, np.float32) if k == 5 else 180.0
    _, packed = run_consensus_batch(batch, box, threshold=0.3,
                                    solver="lp_device", device="cpu",
                                    full=True)
    for i, mic in enumerate(mics):
        ref = ref_consensus.consensus([v[0] for v in mic],
                                      [v[1] for v in mic], sizes, 0.3)
        assert len(ref.members) > 10 and ref.picked.any()
        got = compare.consensus_numbers(compare.decode_full(packed[i], k),
                                        ref)
        assert got["clique_diff"] == got["conflicts"] == 0
        assert got["picks_diff"] == 0
        assert got["value_gap"] == got["objective_gap"] == 0.0


def test_picker_reference_agrees_with_the_program_on_the_cpu():
    import torch

    from portbench.kinds.pick import make_weights
    from repic_tpu_torch.models import infer

    rng = np.random.default_rng(synth.rng_seed(5, 0))
    img, _ = synth.micrograph(rng, size=768, particles=(20, 30))
    tree = make_weights(5, "cpu")
    prep = ref_picker.preprocess(img, "cpu")
    from repic_tpu_torch.models import preprocess as pp

    port_prep = pp.preprocess_micrograph(torch.from_numpy(img))
    assert torch.allclose(port_prep.double(), prep, atol=1e-5)
    for mode in ("patch", "fcn"):
        captured = {}
        orig = (infer.score_micrograph_fcn if mode == "fcn"
                else infer.score_micrograph_patches)

        def keep(*a, _orig=orig, **kw):
            captured["map"] = _orig(*a, **kw)
            return captured["map"]

        attr = orig.__name__
        setattr(infer, attr, keep)
        try:
            picks = infer.pick_micrograph(tree, img, 180, mode=mode,
                                          device="cpu")
        finally:
            setattr(infer, attr, orig)
        rmap = ref_picker.score_map(img, tree, 180, mode=mode)
        rpicks = ref_picker.peaks(rmap, 180, mode=mode)
        pmap = captured["map"].double().numpy()
        assert pmap.shape == rmap.shape
        # a window whose min-max scaling rounds one pixel to the other
        # level moves by up to a few 1e-4; the map as a whole by ~1e-7
        assert np.abs(pmap - rmap).max() < 2e-3
        assert np.abs(pmap - rmap).mean() < 1e-6
        got = compare.pick_numbers(pmap, rmap, picks[:, :2], rpicks[:, :2],
                                   12.0)
        assert got["unmatched"] <= max(1, len(rpicks) // 20)


@pytest.mark.parametrize("name", ["empiar10017", "k5_mixed"])
def test_chunk_is_the_programs_for_a_32_gb_budget(name, monkeypatch):
    """Each configuration's chunk is what the program's own memory
    model gives for REPIC_CONSENSUS_CHUNK_BYTES=32e9."""
    import json
    import os

    from repic_tpu_torch.pipeline.consensus import _auto_chunk

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = json.load(open(os.path.join(root, "configs", name + ".json")))
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK_BYTES", "32e9")
    assert _auto_chunk(cfg["micrographs"], len(cfg["pickers"]),
                       cfg["n_pad"]) == cfg["chunk"]


def test_trace_reading_names_idle_gaps():
    """Busy time is the union of device intervals inside the steps; a
    gap is named by the step span and the innermost host event (a CUDA
    call before its operator) at its middle."""
    from portbench import trace

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.step",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10,
         "dur": 30},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 32, "dur": 6},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 50, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 60, "dur": 60},
    ]
    r = trace.read_events(ev)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(70e-6)
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"portbench.step/cudaLaunchKernel": 30e-6})
    assert [n for n, _ in r["device_ops"]] == ["m", "k2", "k1"]


def test_the_window_runs_whole_passes():
    """The window ends on a pass boundary at or after its seconds, so
    every run does the same work."""
    from portbench import run

    class Fake:
        cycle = 3
        n = 0

        def step(self):
            self.n += 1
            return 2

    for seconds in (0.0, 0.001):
        cell = Fake()
        w = run.run_window(cell, seconds, lambda: None)
        assert w["steps"] % 3 == 0 and w["units"] == 2 * w["steps"]
        assert w["seconds"] >= seconds


def test_generators_by_name():
    """The frozen generators keep their functions; another name is a
    file of ``portbench/generators/``."""
    assert synth.generator("box_tree") is synth.box_tree
    assert synth.generator("density_10017") is synth.density_10017
    assert callable(synth.generator("dense_field"))
    with pytest.raises(ValueError, match="no_such_field"):
        synth.generator("no_such_field")
