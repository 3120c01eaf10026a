"""The plain consensus reference without anything of N x N: bit for bit,
in order, the dense form's cliques, weights, confidences,
representatives and picks, in float32 and in bfloat16; bounded memory
on a dense field; and the program's bucketed path against it."""

import json
import os
import tracemalloc

import numpy as np
import pytest

import dense_reference
from portbench import compare, synth
from portbench.reference import consensus as ref_consensus

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as f:
        return json.load(f)


def _corpus_mic(name, seed):
    """One micrograph of a configuration's generator and sizes."""
    cfg = _config(name)
    rng = np.random.default_rng(synth.rng_seed(seed, 0))
    k = len(cfg["pickers"])
    mic = synth.generator(cfg["generator"])(rng, pickers=k,
                                            **cfg["generator_args"])
    return mic, np.broadcast_to(np.float32(cfg["box_size"]), (k,))


def _case(case):
    if case.startswith(("k5_mixed", "empiar10017")):
        name, seed = case.split(":")
        return _corpus_mic(name, int(seed))
    rng = np.random.default_rng(synth.rng_seed(4, 0))
    dense = synth.generator("dense_field")
    if case == "dense_field_4500":
        return dense(rng, pickers=4, n=4500), [180.0] * 4
    if case == "mixed_sizes":
        # neighbours 150 px apart overlap past the threshold at 240 px
        return (dense(rng, pickers=4, n=2000, jitter=25.0),
                [150.0, 180.0, 210.0, 240.0])
    # crowded, off the origin into negative coordinates, mixed sizes
    return (synth.box_tree(rng, pickers=5, n_per=60, lo=-300.0, hi=400.0),
            [180.0, 200.0, 220.0, 160.0, 180.0])


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


CASES = ([f"k5_mixed:{s}" for s in (1, 2, 3)]
         + [f"empiar10017:{s}" for s in (1, 2, 3)]
         + ["dense_field_4500", "mixed_sizes", "crowded_negative"])


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_the_reference_equals_the_dense_form(case, precision):
    mic, sizes = _case(case)
    xy, conf = [v[0] for v in mic], [v[1] for v in mic]
    dense = dense_reference.consensus(xy, conf, sizes, 0.3,
                                      precision=precision)
    got = ref_consensus.consensus(xy, conf, sizes, 0.3,
                                  precision=precision)
    assert len(dense.w) > 10 and dense.picked.any()
    for field in ref_consensus.Cliques._fields:
        a, b = getattr(dense, field), getattr(got, field)
        assert a.shape == b.shape and a.dtype == b.dtype, field
        assert np.array_equal(_bits(a), _bits(b)), field


def test_greedy_rounds_equal_the_loop():
    """The greedy packing in rounds takes the rows that the loop over
    them one at a time takes, on packings full of shared vertices."""
    rng = np.random.default_rng(7)
    for trial in range(20):
        c, k, v = int(rng.integers(1, 400)), int(rng.integers(1, 6)), 60
        mv = np.stack([rng.integers(0, v // k, c) + p * (v // k)
                       for p in range(k)], 1)
        prio = np.round(rng.uniform(-1, 1, c), 1).astype(np.float32)
        alive = rng.uniform(size=c) < 0.8
        assert np.array_equal(ref_consensus.greedy(mv, prio, alive, v),
                              dense_reference.greedy(mv, prio, alive, v))


def test_memory_on_a_20000_particle_field():
    """One float32 array of 20,000 x 20,000 would be 1.6 GB."""
    rng = np.random.default_rng(synth.rng_seed(9, 0))
    mic = synth.generator("dense_field")(rng, pickers=4, n=20_000)
    tracemalloc.start()
    try:
        got = ref_consensus.consensus([v[0] for v in mic],
                                      [v[1] for v in mic], [180.0] * 4, 0.3)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert len(got.w) >= 19_000 and got.picked.any()
    assert peak < 200e6, peak


def test_dense_field_is_the_stress_field():
    """``dense_field`` draws ``synthesize(1, k, n, seed)``'s values,
    rounded as the stress BOX files round them."""
    from repic_tpu_torch.utils.synthetic import synthesize

    mic = synth.generator("dense_field")(np.random.default_rng(5),
                                         pickers=4, n=1000)
    xy, conf, _ = synthesize(1, 4, 1000, seed=5)
    for p, (pxy, pconf) in enumerate(mic):
        assert pxy.dtype == pconf.dtype == np.float32
        assert np.abs(pxy - xy[0, p]).max() <= 0.0051
        assert np.abs(pconf - conf[0, p]).max() <= 5.1e-7


def test_clique_keys_past_4096_particles():
    """Members above 4,096 name their own cliques: two sets that differ
    there differ in the numbers."""
    members = np.array([[5000, 1, 2], [1, 2, 3]], np.int64)
    ref = ref_consensus.Cliques(
        members, np.ones(2, np.float32), np.ones(2, np.float32),
        np.zeros(2, np.int64), np.zeros((2, 2), np.float32),
        np.ones(2, bool))
    port = dict(members=np.array([[904, 2, 2], [1, 2, 3]], np.int64),
                w=ref.w, confidence=ref.confidence, rep_slot=ref.rep_slot,
                rep_xy=ref.rep_xy, picked=ref.picked,
                valid=np.ones(2, bool))
    got = compare.consensus_numbers(port, ref)
    assert got["clique_diff"] == 2 and got["picks_diff"] == 2
    port["members"] = members
    got = compare.consensus_numbers(port, ref)
    assert got["clique_diff"] == got["picks_diff"] == 0


def test_the_programs_bucketed_path_on_the_cpu():
    """``run_consensus_batch`` on one 4,500-particle dense field (past
    the program's spatial threshold, so its bucketed neighbour search
    runs) against the reference: exact."""
    from repic_tpu_torch.parallel.batching import PaddedBatch
    from repic_tpu_torch.pipeline.consensus import (
        SPATIAL_THRESHOLD,
        run_consensus_batch,
    )

    mic, sizes = _case("dense_field_4500")
    k, n = len(mic), len(mic[0][0])
    assert n > SPATIAL_THRESHOLD
    batch = PaddedBatch(np.stack([v[0] for v in mic])[None],
                        np.stack([v[1] for v in mic])[None],
                        np.ones((1, k, n), bool), ("m0",),
                        np.full((1, k), n, np.int32))
    _, packed = run_consensus_batch(batch, 180.0, threshold=0.3,
                                    solver="lp_device", device="cpu",
                                    full=True)
    ref = ref_consensus.consensus([v[0] for v in mic], [v[1] for v in mic],
                                  sizes, 0.3)
    got = compare.consensus_numbers(compare.decode_full(packed[0], k), ref)
    assert got["cliques"] == n and got["picks"] == n
    assert got["clique_diff"] == got["conflicts"] == got["picks_diff"] == 0
    assert got["value_gap"] == got["objective_gap"] == 0.0
