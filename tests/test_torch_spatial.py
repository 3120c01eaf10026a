"""The port's spatial (bucketed) neighbour search against the JAX
package's.

Seeded numpy inputs go through ``repic_tpu.ops.spatial`` and
``repic_tpu_torch.ops.spatial`` (the port batched over a leading
micrograph axis, each item held to its own reference call).  Integers
and booleans must be equal, floats bitwise equal:

* ``bucket_particles``: table, cell coordinates and densest-cell count,
  with cells that overflow, masked rows, coordinates clipped at both
  borders and particles on cell edges;
* ``bucketed_neighbor_iou`` and ``bucketed_topk_neighbors``: grid-
  aligned ties (equal IoUs, which keep the lower candidate position),
  mixed box sizes, an anchor chunk that does not divide N, d past 9B;
* ``enumerate_cliques_bucketed`` at K = 2 to 5 with mixed box sizes,
  through the product, anchor-chunked and staged assemblies;
* the cell and spatial probes, and ``run_consensus_batch`` with
  ``spatial=True`` at small N and chosen automatically at N = 4,500;
* ``run_consensus_dir`` BOX bytes on a small directory through the
  spatial path, and ``--spatial`` through the CLI;
* the port on the CPU reproduces the committed ``stress_50k`` digests
  (``tests/golden/torch_port_digests.json``) that ``chip_smoke.py``
  holds the card to.
"""

import filecmp
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repic_tpu.ops import cliques as jc
from repic_tpu.ops import spatial as js
from repic_tpu.parallel.batching import PaddedBatch as JBatch
from repic_tpu.pipeline import consensus as jcons
from repic_tpu_torch.ops import cliques as tc
from repic_tpu_torch.ops import spatial as ts
from repic_tpu_torch.parallel.batching import PaddedBatch, bucket_size
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.utils import synthetic
from torch_port_common import clique_inputs, n, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "tests", "fixtures", "mini10017")
DIGESTS = os.path.join(REPO, "tests", "golden", "torch_port_digests.json")
SIZES = np.asarray(synthetic.MIXED_SIZES, np.float32)


def bits(x):
    """Integer view of a float32 array, so equality is bitwise."""
    x = n(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def assert_same(got, want, err=""):
    assert got.shape == np.shape(want), err
    np.testing.assert_array_equal(bits(got), bits(want), err_msg=err)


def field(m: int, seed: int, extent=2000.0):
    """``m`` particle sets: uniform points, a fifth on cell corners of
    a 180 grid (cell edges and equal-IoU ties), points past both
    borders, 15% masked."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-60.0, extent, (m, 300, 2)).astype(np.float32)
    xy[:, :60] = np.round(xy[:, :60] / 180.0) * 180.0
    xy[:, 60:64] = [[-400.0, 50.0], [5000.0, 10.0], [90.0, 9000.0],
                    [-1.0, -1.0]]
    mask = rng.uniform(size=(m, 300)) > 0.15
    return xy, mask


@pytest.mark.parametrize("cap", [1, 2, 4, 64])
def test_bucket_particles_matches_reference(cap):
    xy, mask = field(2, cap)
    got = ts.bucket_particles(t(xy), t(mask), 180.0, grid=11,
                              cell_capacity=cap)
    for i in range(2):
        want = js.bucket_particles(jnp.asarray(xy[i]), jnp.asarray(mask[i]),
                                   180.0, grid=11, cell_capacity=cap)
        assert_same(n(got.table)[i], want.table, "table")
        assert_same(n(got.cell_ij)[i], want.cell_ij, "cell_ij")
        assert int(got.max_count[i]) == int(want.max_count)
    # capacity 1 still counts the densest cell in full: overflow shows
    assert int(got.max_count.max()) > 1


def test_bucket_particles_all_masked():
    xy, mask = field(1, 5)
    got = ts.bucket_particles(t(xy), t(np.zeros_like(mask)), 180.0,
                              grid=11, cell_capacity=4)
    want = js.bucket_particles(jnp.asarray(xy[0]), jnp.zeros(300, bool),
                               180.0, grid=11, cell_capacity=4)
    assert_same(n(got.table)[0], want.table)
    assert int(got.max_count[0]) == int(want.max_count) == 0


def test_grid_size_matches_reference():
    for extent, box in ((2000.0, 180.0), (0.0, 180.0), (179.99, 180.0),
                        (360.0, 180.0), (1e7, 180.0), (3000.0, 220.0)):
        assert ts.grid_size(extent, box) == js.grid_size(extent, box)


def _tables(xa, ma, xb, mb, cap, grid=12):
    jt = [js.bucket_particles(jnp.asarray(x[0]), jnp.asarray(m_[0]), 220.0,
                              grid=grid, cell_capacity=cap)
          for x, m_ in ((xa, ma), (xb, mb))]
    tt = [ts.bucket_particles(t(x), t(m_), 220.0, grid=grid,
                              cell_capacity=cap)
          for x, m_ in ((xa, ma), (xb, mb))]
    return jt, tt


@pytest.mark.parametrize("cap", [2, 8])
@pytest.mark.parametrize("d", [1, 5, 40])
def test_bucketed_topk_neighbors_matches_reference(cap, d):
    """Mixed box sizes 180 against 200; anchor chunks of 64 over N =
    300 (the last block short); the cell-corner fifth of each set
    repeats the other set's, so many IoUs tie exactly."""
    xa, ma = field(1, 10 + d)
    xb, mb = field(1, 20 + d)
    xb[:, :60] = xa[:, :60]
    (ja, jb), (ta, tb) = _tables(xa, ma, xb, mb, cap)
    want = js.bucketed_topk_neighbors(
        jnp.asarray(xa[0]), jnp.asarray(ma[0]), ja, jnp.asarray(xb[0]),
        jnp.asarray(mb[0]), jb, 180.0, 200.0, threshold=0.1, d=d, chunk=64)
    got = ts.bucketed_topk_neighbors(
        t(xa), t(ma), ta, t(xb), t(mb), tb, 180.0, 200.0,
        threshold=0.1, d=d, chunk=64)
    for g, w, name in zip(got, want, ("iou", "idx", "adjacency")):
        assert_same(n(g)[0], w, name)
    assert n(got[0]).shape[-1] == min(d, 9 * cap)


def test_bucketed_neighbor_iou_matches_reference():
    xa, ma = field(1, 31)
    xb, mb = field(1, 32)
    (ja, jb), (ta, tb) = _tables(xa, ma, xb, mb, 4)
    want = js.bucketed_neighbor_iou(
        jnp.asarray(xa[0]), jnp.asarray(ma[0]), ja, jnp.asarray(xb[0]),
        jnp.asarray(mb[0]), jb, 180.0, 220.0)
    got = ts.bucketed_neighbor_iou(t(xa), t(ma), ta, t(xb), t(mb), tb,
                                   180.0, 220.0)
    assert_same(n(got[0])[0], want[0], "iou")
    assert_same(n(got[1])[0], want[1], "idx")


FIELDS = ("member_idx", "valid", "w", "confidence", "rep_slot", "rep_xy",
          "num_valid", "max_adjacency", "max_cell_count", "max_partial")


def assert_same_cliques(got, want, m=0):
    for f in FIELDS:
        assert_same(n(getattr(got, f))[m], getattr(want, f), f)


@pytest.mark.parametrize("k,assembly", [
    (2, "product"), (2, "chunked"), (3, "product"), (3, "chunked"),
    (3, "staged"), (4, "product"), (4, "chunked"), (4, "staged"),
    (5, "chunked"), (5, "staged"),
])
def test_enumerate_cliques_bucketed_matches_reference(k, assembly):
    """Mixed box sizes (the first k of 180, 200, 220, 160, 180); the
    cells are the largest box wide.  The staged join runs where
    D^(K-1) > 256 with a capacity (d = 17, 7, 6 at K = 3, 4, 5); the
    chunked assembly with blocks of 16 anchors."""
    xy, conf, mask = clique_inputs(k, 60, seed=k)
    d = {3: 17, 4: 7, 5: 6}[k] if assembly == "staged" else 4
    kw = dict(max_neighbors=d, grid=8, cell_capacity=8)
    if assembly == "chunked":
        kw.update(clique_capacity=4096, anchor_chunk=16)
    elif assembly == "staged":
        kw.update(clique_capacity=4096)
    want = jax.jit(functools.partial(jc.enumerate_cliques_bucketed, **kw))(
        xy, conf, mask, SIZES[:k])
    got = tc.enumerate_cliques_bucketed(
        t(xy)[None], t(conf)[None], t(mask)[None], SIZES[:k], **kw)
    assert int(want.num_valid) > 0
    assert_same_cliques(got, want)
    assert (int(want.max_partial) > 0) == (assembly == "staged")


def test_enumerate_cliques_bucketed_equals_dense():
    """The bucketed lists give the dense path's clique set, weights and
    representatives (scalar box); the row order may differ, as the two
    lists order tied zero IoUs differently."""
    items = [clique_inputs(3, 64, seed=s) for s in (1, 2)]
    xy, conf, mask = (t(np.stack([it[j] for it in items])) for j in range(3))
    dense = tc.enumerate_cliques(xy, conf, mask, 180.0, max_neighbors=6)
    bucketed = tc.enumerate_cliques_bucketed(
        xy, conf, mask, 180.0, max_neighbors=6, grid=9, cell_capacity=16)

    def rows(cs, m):
        v = n(cs.valid)[m]
        return sorted(zip(map(tuple, n(cs.member_idx)[m][v].tolist()),
                          bits(n(cs.w)[m][v]).tolist(),
                          map(tuple, bits(n(cs.rep_xy)[m][v]).tolist())))

    for m in range(2):
        assert rows(bucketed, m) == rows(dense, m) != []
    assert_same(n(bucketed.num_valid), n(dense.num_valid))


def _batch(xy, conf, mask):
    m, k = xy.shape[:2]
    return (xy, conf, mask, tuple(f"m{i}" for i in range(m)),
            mask.sum(-1).astype(np.int32))


def _stress_batch(m, k, n_p, seed, spacing=150.0):
    xy, conf, mask = synthetic.synthesize(m, k, n_p, seed=seed,
                                          spacing=spacing)
    nb = bucket_size(n_p)

    def pad(a):
        width = [(0, 0)] * a.ndim
        width[2] = (0, nb - n_p)
        return np.pad(a, width)

    return _batch(pad(xy), pad(conf), pad(mask))


def _clear_memos():
    for mod in (jcons, tcons):
        mod._LAST_GOOD_CONFIG.clear()
        mod._RECENT_REQUIREMENTS.clear()


def _run_both(batch, box, **kw):
    """Both packages' ``run_consensus_batch`` from empty memos: the
    packed outputs (probes and BOX fields) and the accepted configs."""
    _clear_memos()
    _, jp = jcons.run_consensus_batch(JBatch(*batch), box, use_mesh=False,
                                      packed_probe=True, **kw)
    _, tp = tcons.run_consensus_batch(PaddedBatch(*batch), box,
                                      device="cpu", **kw)
    jcfg = list(jcons._LAST_GOOD_CONFIG.items())
    tcfg = list(tcons._LAST_GOOD_CONFIG.items())
    return jp, tp, jcfg, tcfg


def test_probes_match_reference():
    xy, conf, mask, *_ = _stress_batch(2, 3, 400, seed=4, spacing=60.0)
    grid = ts.grid_size(float(xy.max()) + 180.0, 180.0)
    cell = tcons.cell_probe(t(xy), t(mask), 180.0, grid)
    want = jcons._make_cell_probe(grid)(xy, mask, 180.0)
    assert_same(n(cell), want, "cell")
    cap = tcons._next_bucket(max(int(cell.max()), 2))
    adj = tcons.spatial_probe(t(xy), t(mask), 180.0, grid, cap, 0.3)
    want = jcons._make_spatial_probe(grid, cap, 0.3)(xy, mask, 180.0)
    assert_same(n(adj), want, "adjacency")
    assert int(adj.max()) > 1


@pytest.mark.parametrize("solver", ["lp_device", "greedy"])
@pytest.mark.parametrize("k,spacing", [(3, 150.0), (4, 60.0)])
def test_run_consensus_batch_spatial_matches_reference(k, spacing, solver):
    """``spatial=True`` at N = 300 (bucket 384); spacing 60 puts several
    neighbours above the threshold, so the probes and escalation do
    real work."""
    batch = _stress_batch(2, k, 300, seed=k, spacing=spacing)
    jp, tp, jcfg, tcfg = _run_both(batch, 180.0, spatial=True,
                                   solver=solver)
    assert_same(tp, jp)
    assert tcfg == jcfg and tcfg[0][0][-1] is True


def test_run_consensus_batch_auto_spatial_at_4500():
    """N = 4,500 particles per picker (bucket 6,144) passes the 4,096
    threshold, so ``spatial=None`` selects the bucketed search."""
    batch = _stress_batch(1, 3, 4500, seed=9)
    jp, tp, jcfg, tcfg = _run_both(batch, 180.0, spatial=None)
    assert_same(tp, jp)
    assert tcfg == jcfg
    (key, (d, cap, cell_cap, pcap)), = tcfg
    assert key[-1] is True and cell_cap < 64


def test_pallas_is_ignored_on_the_spatial_path():
    batch = _stress_batch(1, 3, 200, seed=2)
    _clear_memos()
    with pytest.warns(UserWarning, match="--pallas is ignored"):
        _, with_flag = tcons.run_consensus_batch(
            PaddedBatch(*batch), 180.0, spatial=True, use_pallas=True,
            device="cpu")
    _clear_memos()
    _, plain = tcons.run_consensus_batch(PaddedBatch(*batch), 180.0,
                                         spatial=True, device="cpu")
    assert_same(with_flag, plain)


def _boxes(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".box"))


def _assert_same_boxes(got_dir, want_dir):
    want = _boxes(want_dir)
    assert want and _boxes(got_dir) == want
    diff = [f for f in want if not filecmp.cmp(
        os.path.join(got_dir, f), os.path.join(want_dir, f), shallow=False)]
    assert not diff, f"BOX files differ: {diff}"


@pytest.fixture(scope="module")
def spatial_jax_outputs(tmp_path_factory):
    """The JAX package's BOX output on mini10017 with ``spatial=True``."""
    root = tmp_path_factory.mktemp("jax_spatial")
    out = {}
    for solver in ("lp_device", "greedy"):
        _clear_memos()
        d = str(root / solver)
        jcons.run_consensus_dir(MINI, d, 180, use_mesh=False, spatial=True,
                                solver=solver)
        out[solver] = d
    return out


@pytest.mark.parametrize("solver", ["lp_device", "greedy"])
def test_run_consensus_dir_spatial_box_bytes(spatial_jax_outputs, tmp_path,
                                             solver):
    _clear_memos()
    stats = tcons.run_consensus_dir(MINI, str(tmp_path), 180, spatial=True,
                                    solver=solver, device="cpu")
    assert stats["num_cliques"] > 0
    _assert_same_boxes(str(tmp_path), spatial_jax_outputs[solver])


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )


def test_cli_spatial_flag(spatial_jax_outputs, tmp_path):
    """``--spatial on`` takes the bucketed path (the JAX package's
    ``spatial=True`` bytes); ``off`` and ``auto`` (mini10017 is below
    the threshold) the dense one; other values are refused."""
    on = tmp_path / "on"
    proc = _cli("consensus", MINI, str(on), "180", "--spatial", "on",
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    _assert_same_boxes(str(on), spatial_jax_outputs["lp_device"])
    for value in ("off", "auto"):
        out = tmp_path / value
        proc = _cli("consensus", MINI, str(out), "180", "--spatial", value,
                    "--device", "cpu")
        assert proc.returncode == 0, proc.stderr
        assert json.loads(proc.stdout.strip().splitlines()[-1])[
            "num_cliques"] > 0
    _assert_same_boxes(str(tmp_path / "off"), str(tmp_path / "auto"))
    proc = _cli("consensus", MINI, str(tmp_path / "x"), "180", "--spatial",
                "maybe", "--device", "cpu")
    assert proc.returncode != 0 and "invalid choice" in proc.stderr


@pytest.mark.parametrize("setting", ["lp_device", "greedy"])
def test_stress_digests_reproduced_on_cpu(tmp_path, setting):
    """The port reproduces the committed JAX digests of the
    ``stress_50k`` cell (2 micrographs, N = 65,536, the spatial path
    with the anchor-chunked assembly) on the CPU."""
    with open(DIGESTS) as f:
        golden = json.load(f)["stress_50k"]
    src = tmp_path / "in"
    box = synthetic.write_cell_dir("stress_50k", str(src),
                                   golden["micrographs"])
    assert synthetic.tree_sha256(str(src)) == golden["input_sha256"]
    _clear_memos()
    out = tmp_path / "out"
    stats = tcons.run_consensus_dir(str(src), str(out), box, solver=setting,
                                    device="cpu")
    for name, want in golden["settings"][setting].items():
        path = out / (name + ".box")
        got = {"sha256": synthetic.file_sha256(str(path)),
               "rows": len(path.read_text().splitlines()),
               "num_cliques": stats["clique_counts"][name]}
        assert got == want, name
    (key, cfg), = tcons._LAST_GOOD_CONFIG.items()
    assert key[0] == (1, 4, 65536, 2) and key[-1] is True
