"""The port's striped (giant-micrograph) path against the JAX package's.

* ``build_stripes``: every array exactly equal.
* ``run_consensus_giant``: every output array bitwise equal to the
  reference's (dense and bucketed search, greedy and lp solve), and the
  clique set equal to the unstriped one for S = 1, 2, 4 and 7; the
  mixed-size K = 5 ensemble; more stripes than anchors (empty stripes).
* ``run_consensus_dir(stripes=4)``: BOX files byte-identical to the
  JAX package's, and to the unstriped run.
* ``stress_50k`` (two 50,000-particle micrographs, 4 pickers) with
  ``stripes=4``: the committed JAX digests that ``chip_smoke.py``
  holds the card to.
* The flag checks: ``--stripes`` with ``--multi_out``, ``--get_cc`` or
  ``exact`` and ``--stripes 0`` raise before anything is deleted;
  ``--pallas`` warns; ``auto`` does not stripe on one device.
"""

import json
import os

import numpy as np
import pytest

from repic_tpu.pipeline import giant as jgiant
from repic_tpu.utils.box_io import BoxSet as JBoxSet
from repic_tpu_torch.parallel.batching import pad_batch
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.pipeline import giant as tgiant
from repic_tpu_torch.utils.box_io import BoxSet, write_box
from repic_tpu_torch.utils.synthetic import (
    output_digests,
    tree_sha256,
    write_cell_dir,
)
from tests.golden.make_torch_port_golden import FLAGS_DIGESTS, run_jax_flags
from tests.test_torch_tables import assert_same_outputs, clear_memo

BOX = 180.0
FIELDS = ("member_idx", "w", "confidence", "rep_xy", "rep_slot", "valid",
          "picked")


def _field(n, k=3, seed=0, spacing=150.0, jitter=12.0):
    """Cluster-structured dense field, one BoxSet per picker."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    base = (np.stack([gx, gy], -1).reshape(-1, 2)[:n].astype(np.float32)
            * spacing + spacing)
    sets = []
    for _ in range(k):
        xy = base + rng.normal(0, jitter, base.shape).astype(np.float32)
        conf = rng.uniform(0.05, 1.0, size=n).astype(np.float32)
        sets.append(BoxSet(xy=xy, conf=conf,
                           wh=np.full((n, 2), BOX, np.float32)))
    return sets


def _k5_mixed():
    sizes = np.asarray([180.0, 120.0, 180.0, 120.0, 180.0], np.float32)
    rng = np.random.default_rng(21)
    base = rng.uniform(200, 9000, size=(400, 2)).astype(np.float32)
    sets = [BoxSet(
        xy=base + rng.normal(0, 8, base.shape).astype(np.float32),
        conf=rng.uniform(0.05, 1.0, size=400).astype(np.float32),
        wh=np.full((400, 2), sizes[p], np.float32),
    ) for p in range(5)]
    return sets, sizes


def _keys(member, k):
    return {tuple((p, int(row[p])) for p in range(k)) for row in member}


def _jax(sets, box, **kw):
    return jgiant.run_consensus_giant(
        [JBoxSet(*s) for s in sets], box, use_mesh=False, **kw)


@pytest.mark.parametrize("n,k,s", [(1200, 3, 4), (300, 4, 7), (12, 3, 16),
                                   (500, 2, 1)])
def test_build_stripes_equal(n, k, s):
    sets = _field(n, k=k, seed=n)
    want = jgiant.build_stripes([JBoxSet(*x) for x in sets], s, 180.0)
    got = tgiant.build_stripes(sets, s, 180.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("solver", ["greedy", "lp"])
@pytest.mark.parametrize("n,spatial", [(1200, False), (5200, True)],
                         ids=["dense", "bucketed"])
def test_giant_matches_reference(n, spatial, solver):
    sets = _field(n)
    want = _jax(sets, BOX, n_stripes=4, spatial=spatial, solver=solver)
    got = tgiant.run_consensus_giant(sets, BOX, n_stripes=4,
                                     spatial=spatial, solver=solver,
                                     device="cpu")
    assert got["num_cliques"] == want["num_cliques"] > 0
    assert got["stripe_capacity"] == want["stripe_capacity"]
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)


@pytest.mark.parametrize("s", [1, 2, 4, 7])
def test_striped_clique_set_equals_unstriped(s):
    sets = _field(1200, seed=3)
    batch = pad_batch([("m0", sets)], pad_micrographs_to=1)
    clear_memo()
    res, _ = tcons.run_consensus_batch(batch, BOX, spatial=False,
                                       solver="greedy", device="cpu")
    valid = res.valid[0].numpy()
    base = res.member_idx[0].numpy()[valid]
    g = tgiant.run_consensus_giant(sets, BOX, n_stripes=s, spatial=False,
                                   device="cpu")
    assert _keys(g["member_idx"][g["valid"]], 3) == _keys(base, 3)
    assert g["num_cliques"] == int(valid.sum())
    # the global solve: the same consensus as the unstriped packing
    picked = res.picked[0].numpy()[valid]
    assert _keys(g["member_idx"][g["picked"]], 3) == _keys(base[picked], 3)


def test_mixed_k5_matches_reference():
    sets, sizes = _k5_mixed()
    one = tgiant.run_consensus_giant(sets, sizes, n_stripes=1,
                                     spatial=False, device="cpu")
    got = tgiant.run_consensus_giant(sets, sizes, n_stripes=8,
                                     spatial=False, device="cpu")
    want = _jax(sets, sizes, n_stripes=8, spatial=False)
    assert _keys(got["member_idx"][got["valid"]], 5) == \
        _keys(one["member_idx"][one["valid"]], 5)
    assert got["num_cliques"] == one["num_cliques"] > 0
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)


def test_empty_and_tiny_stripes():
    sets = _field(12, seed=9)
    got = tgiant.run_consensus_giant(sets, BOX, n_stripes=16, spatial=False,
                                     device="cpu")
    base = tgiant.run_consensus_giant(sets, BOX, n_stripes=1, spatial=False,
                                      device="cpu")
    want = _jax(sets, BOX, n_stripes=16, spatial=False)
    assert _keys(got["member_idx"][got["valid"]], 3) == \
        _keys(base["member_idx"][base["valid"]], 3)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(want[f]), err_msg=f)


@pytest.fixture(scope="module")
def field_dir(tmp_path_factory):
    src = tmp_path_factory.mktemp("giant_in")
    for m in range(2):
        for p, s in enumerate(_field(1500, seed=40 + m)):
            d = src / f"picker{p}"
            d.mkdir(exist_ok=True)
            write_box(str(d / f"mic{m}.box"), s.xy, s.conf, int(BOX))
    return str(src)


@pytest.mark.parametrize("solver", ["lp_device", "lp"])
def test_striped_dir_matches_jax(field_dir, tmp_path, solver):
    want = str(tmp_path / "jax")
    run_jax_flags(field_dir, want, int(BOX), solver=solver, stripes=4)
    got = str(tmp_path / "port")
    stats = tcons.run_consensus_dir(field_dir, got, int(BOX), solver=solver,
                                    stripes=4, device="cpu")
    assert stats["stripes"] == 4 and set(stats["giant"]) == {"mic0", "mic1"}
    assert_same_outputs(got, want)
    if solver == "lp_device":
        # the striped path solves greedy: the unstriped greedy bytes
        clear_memo()
        plain = str(tmp_path / "plain")
        tcons.run_consensus_dir(field_dir, plain, int(BOX), solver="greedy",
                                device="cpu")
        assert_same_outputs(got, plain)


def test_flag_checks(field_dir, tmp_path):
    out = tmp_path / "x"
    out.mkdir()
    (out / "keep").write_text("x")
    for kw, match in (
        (dict(stripes=4, multi_out=True), "multi_out"),
        (dict(stripes=4, get_cc=True), "multi_out"),
        (dict(stripes=4, solver="exact"), "exact"),
        (dict(stripes=0), "stripes"),
    ):
        with pytest.raises(ValueError, match=match):
            tcons.run_consensus_dir(field_dir, str(out), int(BOX),
                                    device="cpu", **kw)
        assert (out / "keep").exists()
    with pytest.warns(UserWarning, match="striped"):
        st = tcons.run_consensus_dir(field_dir, str(tmp_path / "w"),
                                     int(BOX), stripes=4, use_pallas=True,
                                     device="cpu")
    assert st["stripes"] == 4
    st = tcons.run_consensus_dir(field_dir, str(tmp_path / "a"), int(BOX),
                                 stripes="auto", device="cpu")
    assert "stripes" not in st and st["chunks"] == 1
    assert os.path.exists(tmp_path / "a" / "mic0.box")



@pytest.fixture(scope="module")
def stress_golden(tmp_path_factory):
    with open(FLAGS_DIGESTS) as f:
        g = json.load(f)["stripes"]
    src = str(tmp_path_factory.mktemp("stress") / "in")
    box = write_cell_dir(g["cell"], src, g["micrographs"])
    assert tree_sha256(src) == g["input_sha256"]
    return g, src, box


@pytest.mark.parametrize("solver", ["lp_device", "lp"])
def test_stress_stripes_meet_committed_digests(stress_golden, tmp_path,
                                               solver):
    g, src, box = stress_golden
    stats = tcons.run_consensus_dir(src, str(tmp_path), box, solver=solver,
                                    stripes=g["stripes"], device="cpu")
    # stripes of ~12,500 anchors + halo: the bucketed search
    assert all(v["stripe_capacity"] > tcons.SPATIAL_THRESHOLD
               for v in stats["giant"].values())
    assert output_digests(str(tmp_path)) == g["settings"][solver]
