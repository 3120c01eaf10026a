"""The port's staged join, anchor-chunked assembly and escalation
against the JAX package's.

Seeded numpy inputs go through both packages; integers and booleans
must be equal, floats (``w``, ``confidence``, ``rep_xy``) bitwise
equal:

* the staged join at K = 3, 4 and 5 (scalar and mixed box sizes, with
  and without kernel 1's plain version, partial buffers that fit and
  that overflow), and the anchor-chunked assembly with small anchor
  blocks, N not a multiple of them, and a capacity under the count;
* the neighbour kernel's d cap (its own ``MAX_D``, not the
  reference's 256): a loud warning and the matrix path past it;
* ``escalate_capacities`` on probe vectors, and the escalation memo's
  lower-median rule over repeat batches;
* ``tests/fixtures/mini_k5`` against ``tests/golden/ref_cliques_k5.json``
  (the executed reference) and against JAX, with ``max_partial > 0``
  as the witness that the staged join ran; its BOX bytes through
  ``run_consensus_dir``;
* the k = 5 mixed-size batch of ``tests/test_mixed_e2e.py`` on the
  dense and the spatial paths;
* the port on the CPU reproduces the committed ``k5_mixed`` digests
  (first chunk, 16 micrographs) that ``chip_smoke.py`` holds the card
  to.
"""

import filecmp
import functools
import json
import os
import warnings

import jax
import numpy as np
import pytest

from repic_tpu.ops import cliques as jc
from repic_tpu.parallel.batching import PaddedBatch as JBatch
from repic_tpu.pipeline import consensus as jcons
from repic_tpu_torch.ops import cliques as tc
from repic_tpu_torch.ops import iou_pallas as tk
from repic_tpu_torch.parallel.batching import PaddedBatch, pad_batch
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.utils import box_io, synthetic
from torch_port_common import clique_inputs, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_K5 = os.path.join(REPO, "tests", "fixtures", "mini_k5")
K5_GOLDEN = os.path.join(REPO, "tests", "golden", "ref_cliques_k5.json")
DIGESTS = os.path.join(REPO, "tests", "golden", "torch_port_digests.json")
SIZES = np.asarray(synthetic.MIXED_SIZES, np.float32)

FIELDS = ("member_idx", "valid", "w", "confidence", "rep_slot", "rep_xy",
          "num_valid", "max_adjacency", "max_cell_count", "max_partial")


def bits(x):
    x = n(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def assert_same(got, want, err=""):
    assert got.shape == np.shape(want), err
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=err)


def _enumerate_both(xy, conf, mask, box, **kw):
    want = jax.jit(functools.partial(jc.enumerate_cliques, **kw))(
        xy, conf, mask, box)
    got = tc.enumerate_cliques(t(xy)[None], t(conf)[None], t(mask)[None],
                               box, **kw)
    for f in FIELDS:
        assert_same(n(getattr(got, f))[0], getattr(want, f), f)
    return want


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("k,d,pcap", [
    (3, 17, None), (4, 8, None), (4, 8, 24), (5, 6, None), (5, 6, 16),
])
def test_staged_join_matches_reference(k, d, pcap, use_pallas):
    """D^(K-1) > 256 with a capacity stages the join; a partial
    capacity under the stage counts (``pcap``) overflows, and
    ``max_partial`` reports it."""
    xy, conf, mask = clique_inputs(k, 40, seed=3 * k + d)
    box = SIZES[:k] if k == 5 else 180.0
    want = _enumerate_both(xy, conf, mask, box, max_neighbors=d,
                           clique_capacity=2048, partial_capacity=pcap,
                           use_pallas=use_pallas)
    assert int(want.num_valid) > 0 and int(want.max_partial) > 0
    if pcap is not None:
        assert int(want.max_partial) > pcap


@pytest.mark.parametrize("n_p,chunk,cap", [
    (96, 32, 4096), (100, 32, 4096), (50, 16, 32), (37, 8, 1000),
])
def test_chunked_assembly_matches_reference(n_p, chunk, cap):
    """N > ``anchor_chunk`` runs the chunked assembly: blocks of 32, 16
    or 8 anchors, N = 100 and 37 not multiples of them, and at cap 32
    fewer slots than cliques (the final weight compaction drops the
    lightest)."""
    k = 3 if n_p != 37 else 2
    xy, conf, mask = clique_inputs(k, n_p)
    want = _enumerate_both(xy, conf, mask, 180.0, max_neighbors=4,
                           clique_capacity=cap, anchor_chunk=chunk)
    assert int(want.max_partial) == 0
    if cap == 32:
        assert int(want.num_valid) > cap


def test_pallas_d_cap_warns_and_takes_the_matrix_path():
    """Past the neighbour kernel's own cap (``MAX_D`` = 1024) the
    matrix path runs, with a loud warning."""
    xy, conf, mask = clique_inputs(2, 1030, seed=5)
    args = (t(xy)[None], t(conf)[None], t(mask)[None], 180.0)
    d = tk.MAX_D + 1
    with pytest.warns(UserWarning, match="exceeds the neighbour kernel"):
        got = tc.enumerate_cliques(*args, max_neighbors=d, use_pallas=True)
    want = tc.enumerate_cliques(*args, max_neighbors=d)
    for f in FIELDS:
        assert_same(n(getattr(got, f)), n(getattr(want, f)), f)


def test_pallas_keeps_the_kernel_past_the_reference_cap():
    """The reference hands its kernel d <= 256 only (a TPU compile-time
    bound) and warns past it, taking the matrix path; the port keeps
    kernel 1 up to its own ``MAX_D``, silently.  Every field equals the
    reference's matrix path bit for bit except ``member_idx`` of the
    invalid rows: the kernel's empty list slots hold index 0 where the
    matrix path's sort holds the remaining columns in order (the
    reference's own kernel does the same at d <= 256)."""
    xy, conf, mask = clique_inputs(2, 300, seed=5)
    with pytest.warns(UserWarning, match="exceeds the Pallas kernel"):
        want = jax.jit(functools.partial(
            jc.enumerate_cliques, max_neighbors=257, use_pallas=True))(
            xy, conf, mask, 180.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tc.enumerate_cliques(t(xy)[None], t(conf)[None],
                                   t(mask)[None], 180.0, max_neighbors=257,
                                   use_pallas=True)
    valid = np.asarray(want.valid)
    assert 0 < valid.sum() < valid.size
    for f in FIELDS:
        g, w = n(getattr(got, f))[0], np.asarray(getattr(want, f))
        if f == "member_idx":
            g, w = g[valid], w[valid]
        assert_same(g, w, f)


def test_escalate_capacities_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        probes = rng.integers(0, 5000, 4)
        caps = [int(x) for x in rng.integers(1, 5000, 4)]
        has_grid = bool(rng.integers(0, 2))
        assert tcons.escalate_capacities(probes, *caps, has_grid=has_grid) \
            == jcons.escalate_capacities(probes, *caps, has_grid=has_grid)


def _clear_memos():
    for mod in (jcons, tcons):
        mod._LAST_GOOD_CONFIG.clear()
        mod._RECENT_REQUIREMENTS.clear()


def _k_batch(seed, k=3, n_p=40, spread=1500.0):
    """One micrograph of k jittered pickers; a small ``spread`` makes a
    dense outlier."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, spread, (n_p, 2))
    xy = (base[None, None] + rng.normal(0, 20.0, (1, k, n_p, 2)))
    conf = rng.uniform(0.2, 1.0, (1, k, n_p))
    mask = np.ones((1, k, n_p), bool)
    nb = 64
    pad = [(0, 0), (0, 0), (0, nb - n_p)]
    return (np.pad(xy, pad + [(0, 0)]).astype(np.float32),
            np.pad(conf, pad).astype(np.float32), np.pad(mask, pad),
            ("m0",), np.full((1, k), n_p, np.int32))


def test_memo_follows_the_lower_median_like_reference():
    """Repeat batches of one shape: the accepted (d, cap, cell_cap,
    pcap) after each equals the reference's, through a dense outlier
    (escalated locally, not promoted) and a second one (two of the
    last three: promoted)."""
    _clear_memos()
    for seed, spread in ((1, 1500.0), (2, 200.0), (3, 200.0)):
        batch = _k_batch(seed, spread=spread)
        _, jp = jcons.run_consensus_batch(JBatch(*batch), 180.0,
                                          use_mesh=False, packed_probe=True)
        _, tp = tcons.run_consensus_batch(PaddedBatch(*batch), 180.0,
                                          device="cpu")
        assert_same(tp, jp)
        assert list(tcons._LAST_GOOD_CONFIG.items()) == list(
            jcons._LAST_GOOD_CONFIG.items())
        assert tcons._RECENT_REQUIREMENTS == jcons._RECENT_REQUIREMENTS


@pytest.fixture(scope="module")
def k5_golden():
    with open(K5_GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def mini_k5(k5_golden):
    loaded = [(name, box_io.load_micrograph_set(
        MINI_K5, k5_golden["pickers"], name))
        for name in k5_golden["micrographs"]]
    batch = pad_batch(loaded)
    box = float(k5_golden["box_size"])
    _clear_memos()
    res, packed = tcons.run_consensus_batch(batch, box, device="cpu")
    _, jpacked = jcons.run_consensus_batch(
        JBatch(*batch), box, use_mesh=False, packed_probe=True)
    return batch, res, packed, jpacked


def test_mini_k5_runs_the_staged_join(mini_k5):
    _, res, packed, jpacked = mini_k5
    assert int(res.max_partial.max()) > 0
    assert_same(packed, jpacked)


def test_mini_k5_clique_sets_match_reference_golden(k5_golden, mini_k5):
    """Membership exact, ``w`` within 1e-5 and confidence within 1e-6 of
    the executed reference (the assertions of tests/test_k5_golden.py:
    the reference computes in float64)."""
    batch, res, _, _ = mini_k5
    for i, (name, gd) in enumerate(k5_golden["micrographs"].items()):
        assert batch.names[i] == name
        valid = n(res.valid)[i]
        mine = {
            tuple(sorted((p, int(j)) for p, j in enumerate(row))): (wv, cv)
            for row, wv, cv in zip(n(res.member_idx)[i][valid],
                                   n(res.w)[i][valid],
                                   n(res.confidence)[i][valid])
        }
        ref = {tuple(sorted(map(tuple, m))): (gd["w"][j], gd["conf"][j])
               for j, m in enumerate(gd["members"])}
        assert len(mine) == len(gd["members"])
        assert set(mine) == set(ref), f"{name}: membership differs"
        for key, (wv, cv) in ref.items():
            np.testing.assert_allclose(mine[key][0], wv, atol=1e-5)
            np.testing.assert_allclose(mine[key][1], cv, atol=1e-6)


def _boxes(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".box"))


@pytest.fixture(scope="module")
def mini_k5_jax_boxes(tmp_path_factory, k5_golden):
    root = tmp_path_factory.mktemp("jax_k5")
    out = {}
    for solver in ("lp_device", "greedy"):
        _clear_memos()
        d = str(root / solver)
        jcons.run_consensus_dir(MINI_K5, d, float(k5_golden["box_size"]),
                                use_mesh=False, solver=solver)
        out[solver] = d
    return out


@pytest.mark.parametrize("setting,solver,pallas", [
    ("lp_device", "lp_device", False),
    ("lp_device", "lp_device", True),
    ("lp_device", "lp_device_fused", False),
    ("greedy", "greedy", False),
])
def test_mini_k5_box_bytes_match_jax(mini_k5_jax_boxes, k5_golden, tmp_path,
                                     setting, solver, pallas):
    """The port's ``lp_device`` (with and without kernel 1's plain
    version) and ``lp_device_fused`` write JAX's ``lp_device`` bytes;
    ``greedy`` JAX's ``greedy`` bytes."""
    _clear_memos()
    tcons.run_consensus_dir(MINI_K5, str(tmp_path),
                            float(k5_golden["box_size"]), solver=solver,
                            use_pallas=pallas, device="cpu")
    want = mini_k5_jax_boxes[setting]
    assert _boxes(str(tmp_path)) == _boxes(want) != []
    for f in _boxes(want):
        assert filecmp.cmp(os.path.join(want, f), str(tmp_path / f),
                           shallow=False), f


def _mixed_e2e_batch():
    """The 2-micrograph batch of tests/test_mixed_e2e.py: 8 separated
    clusters of one particle per picker, sizes 180/120, plus decoys."""
    k = 5
    sizes = np.asarray([180.0, 120.0, 180.0, 120.0, 180.0], np.float32)
    rng = np.random.default_rng(42)
    loaded = []
    for i in range(2):
        pts = [[] for _ in range(k)]
        cfs = [[] for _ in range(k)]
        centers = rng.uniform(200, 3600, size=(8, 2))
        centers = centers[np.lexsort((centers[:, 1], centers[:, 0]))]
        centers[:, 0] = np.linspace(200, 3400, 8)
        for c in centers:
            for p in range(k):
                jit = 30.0 if sizes[p] == 180.0 else 4.0
                pts[p].append(c + rng.normal(0, jit, 2))
                cfs[p].append(rng.uniform(0.2, 1.0))
        for c in centers[:2]:
            for p in (1, 3):
                pts[p].append(c + rng.normal(0, 12, 2) + 30.0)
                cfs[p].append(rng.uniform(0.2, 1.0))
        sets = [box_io.BoxSet(
            xy=np.asarray(pts[p], np.float32),
            conf=np.asarray(cfs[p], np.float32),
            wh=np.full((len(pts[p]), 2), sizes[p], np.float32),
        ) for p in range(k)]
        loaded.append((f"m{i}", sets))
    return pad_batch(loaded), sizes


@pytest.mark.parametrize("spatial", [False, True])
def test_mixed_e2e_batch_matches_reference(spatial):
    batch, sizes = _mixed_e2e_batch()
    _clear_memos()
    _, jp = jcons.run_consensus_batch(JBatch(*batch), sizes, use_mesh=False,
                                      spatial=spatial, max_neighbors=4,
                                      packed_probe=True)
    _, tp = tcons.run_consensus_batch(batch, sizes, spatial=spatial,
                                      max_neighbors=4, device="cpu")
    assert_same(tp, jp)
    assert list(tcons._LAST_GOOD_CONFIG.items()) == list(
        jcons._LAST_GOOD_CONFIG.items())
    assert (tcons._packed_probes(tp)[:, tcons._HEAD_NC] > 0).all()


@pytest.mark.parametrize("setting", ["lp_device", "greedy"])
def test_k5_digests_reproduced_on_cpu(tmp_path, setting):
    """The first chunk of the ``k5_mixed`` digest golden (16 of its 32
    micrographs: one chunk at N = 768, the same first visit) through
    the port on the CPU; micrograph i of the generator does not depend
    on how many follow it."""
    with open(DIGESTS) as f:
        golden = json.load(f)["k5_mixed"]
    src = tmp_path / "in"
    box = synthetic.write_cell_dir("k5_mixed", str(src), 16)
    _clear_memos()
    out = tmp_path / "out"
    stats = tcons.run_consensus_dir(str(src), str(out), box, solver=setting,
                                    device="cpu")
    assert stats["chunks"] == 1 and stats["capacity"] == 768
    for i in range(16):
        name = f"mic_{i:04d}"
        path = out / (name + ".box")
        got = {"sha256": synthetic.file_sha256(str(path)),
               "rows": len(path.read_text().splitlines()),
               "num_cliques": stats["clique_counts"][name]}
        assert got == golden["settings"][setting][name], name
    (key, cfg), = tcons._LAST_GOOD_CONFIG.items()
    assert cfg[0] == 12 and cfg[0] ** 4 > 256     # the staged join ran
