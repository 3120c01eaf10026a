"""The port's training-data loaders (``repic_tpu_torch.models.data``)
against the JAX package's, on the CPU: every array and label bit for
bit (``patch_norm="global"``, off the default chain, within 1e-6), the
numpy sampling in the same order, the warnings and errors in
the reference's words.  Inputs: ``tests/test_train.py``'s fixture (800 x
800 micrographs, particle size 120) and micrographs whose binned size
showed the z-score's summation-order fault before it was closed (800 x
800 from ``default_rng(1)``, 1200 x 1290, binned 400 x 430).
"""

import logging
import os
import pickle
import shutil

import numpy as np
import pytest

from repic_tpu.models import data as jdata
from repic_tpu_torch.models import data as tdata
from repic_tpu_torch.utils import mrc
from repic_tpu_torch.utils.box_io import write_box
from test_train import PARTICLE, make_micrograph
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    from tests.golden.make_torch_port_golden import write_training_fixture

    return write_training_fixture(str(tmp_path_factory.mktemp("data")))


def _pair(root, stem, img, centers, particle=PARTICLE):
    os.makedirs(root / "mrc", exist_ok=True)
    os.makedirs(root / "lbl", exist_ok=True)
    mrc.write_mrc(str(root / "mrc" / f"{stem}.mrc"), img)
    write_box(str(root / "lbl" / f"{stem}.box"), centers - particle / 2,
              np.ones(len(centers)), particle)


@pytest.mark.parametrize("split,seed", [("train", 1234), ("val", 1235)])
def test_load_dataset_bitwise(fixture_dirs, split, seed):
    got = tdata.load_dataset(*fixture_dirs[split], PARTICLE, seed=seed,
                             device="cpu")
    want = jdata.load_dataset(*fixture_dirs[split], PARTICLE, seed=seed)
    _equal(got, want)
    assert got[0].shape[1:] == (64, 64, 1)
    assert got[1].sum() * 2 == len(got[1])


def test_global_patch_norm_close(fixture_dirs):
    """``patch_norm="global"`` resizes the z-scored floats without the
    uint8 levels, and the upsampling's sums round apart from XLA's by an
    ulp: within 1e-6, labels equal."""
    got = tdata.load_dataset(*fixture_dirs["val"], PARTICLE,
                             patch_norm="global", device="cpu")
    want = jdata.load_dataset(*fixture_dirs["val"], PARTICLE,
                              patch_norm="global")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("shape,seed", [((800, 800), 1), ((1200, 1290), 2)],
                         ids=["800x800", "1200x1290"])
def test_loaders_bitwise_where_the_zscore_order_mattered(tmp_path, shape,
                                                         seed):
    """Noise from the seeds whose z-score summed out of XLA's order
    before the fault was closed, with particles planted on a grid."""
    rng = np.random.default_rng(seed)
    img = rng.normal(size=shape).astype(np.float32)
    ys, xs = np.mgrid[200:shape[0] - 150:170, 200:shape[1] - 150:170]
    centers = np.column_stack([xs.ravel(), ys.ravel()]).astype(np.float64)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    for cx, cy in centers:
        img += (4.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                             / (2 * 30.0 ** 2))).astype(np.float32)
    _pair(tmp_path, "m0", img, centers)
    args = (str(tmp_path / "mrc"), str(tmp_path / "lbl"), PARTICLE)
    _equal(tdata.load_dataset(*args, device="cpu"), jdata.load_dataset(*args))
    r = np.random.default_rng(5)
    pos, neg = tdata.extract_micrograph_patches(
        img, centers, PARTICLE, np.random.default_rng(5), device="cpu")
    _equal((pos, neg),
           jdata.extract_micrograph_patches(img, centers, PARTICLE, r))


def test_extract_patches_same_draws(rng):
    img, centers = make_micrograph(rng)
    r_port, r_jax = np.random.default_rng(3), np.random.default_rng(3)
    got = tdata.extract_micrograph_patches(img, centers, PARTICLE, r_port,
                                           device="cpu")
    want = jdata.extract_micrograph_patches(img, centers, PARTICLE, r_jax)
    _equal(got, want)
    # the generators drew the same numbers in the same order
    assert r_port.integers(1 << 30) == r_jax.integers(1 << 30)
    p = 2 * (int(PARTICLE / 3) // 2)
    assert got[0].shape == (len(centers), p, p) == got[1].shape
    only_pos = tdata.extract_micrograph_patches(
        img, centers, PARTICLE, r_port, produce_negative=False,
        device="cpu")
    assert only_pos[1].shape == (0, p, p)


def test_boundary_coordinates_dropped(rng):
    img, _ = make_micrograph(rng, n_particles=0)
    centers = np.array([[2.0, 2.0], [300.0, 300.0]])
    pos, neg = tdata.extract_micrograph_patches(
        img, centers, PARTICLE, np.random.default_rng(0), device="cpu")
    assert len(pos) == len(neg) == 1


def test_negative_shortfall_warned_in_the_reference_words(caplog):
    rng = np.random.default_rng(13)
    img = rng.normal(0, 1, size=(200, 200)).astype(np.float32)
    g = np.arange(40, 600 - 40, 12)
    centers = np.array([(x, y) for x in g for y in g], np.float64)
    with caplog.at_level(logging.WARNING):
        got = tdata.extract_micrograph_patches(
            img, centers, PARTICLE, np.random.default_rng(1), max_tries=5,
            device="cpu")
        want = jdata.extract_micrograph_patches(
            img, centers, PARTICLE, np.random.default_rng(1), max_tries=5)
    _equal(got, want)
    msgs = {r.name: r.getMessage() for r in caplog.records
            if "negative sampling" in r.getMessage()}
    assert msgs["repic_tpu_torch.models.data"] == msgs[
        "repic_tpu.models.data"]
    assert len(got[1]) < len(got[0])


def test_missing_pairs_error_text(tmp_path):
    (tmp_path / "mrc").mkdir()
    (tmp_path / "box").mkdir()
    args = (str(tmp_path / "mrc"), str(tmp_path / "box"), PARTICLE)
    with pytest.raises(FileNotFoundError) as want:
        jdata.load_dataset(*args)
    with pytest.raises(FileNotFoundError) as got:
        tdata.load_dataset(*args, device="cpu")
    assert str(got.value) == str(want.value)
    (tmp_path / "mrc" / "a.mrc").write_bytes(b"")
    with pytest.raises(FileNotFoundError):
        tdata.extract_dataset(*args, str(tmp_path / "x.pickle"),
                              device="cpu")


def test_label_discovery_equals_jax(tmp_path):
    for name in ("mic1.box", "mic1_deeppicker.box", "mic1.star",
                 "mic2_deeppicker.star", "mic2.star", "mic3_deeppicker.box",
                 "mic4.txt"):
        (tmp_path / name).write_text("")
    got = tdata._discover_labels(str(tmp_path))
    assert got == jdata._discover_labels(str(tmp_path))
    assert got["mic1"].endswith("mic1.box")
    assert got["mic2"].endswith("mic2.star")


def _write_star(path, centers, fmt, name=None):
    with open(path, "wt") as f:
        f.write("\ndata_\n\nloop_\n")
        if name:
            f.write("_rlnMicrographName #1\n_rlnCoordinateX #2\n"
                    "_rlnCoordinateY #3\n")
        else:
            f.write("_rlnCoordinateX #1\n_rlnCoordinateY #2\n")
        for cx, cy in centers:
            lead = f"{name}\t" if name else ""
            f.write(f"{lead}{cx:{fmt}}\t{cy:{fmt}}\n")


def test_star_labels_and_suffix_bitwise(tmp_path):
    img, centers = make_micrograph(np.random.default_rng(11))
    centers = np.round(centers)
    _pair(tmp_path, "m0", img, centers)
    os.makedirs(tmp_path / "star")
    _write_star(tmp_path / "star" / "m0.star", centers, ".6f")
    os.makedirs(tmp_path / "suffix")
    _write_star(tmp_path / "suffix" / "m0_deeppicker.star", centers, ".2f")
    for lbl in ("lbl", "star", "suffix"):
        args = (str(tmp_path / "mrc"), str(tmp_path / lbl), PARTICLE)
        _equal(tdata.load_dataset(*args, device="cpu"),
               jdata.load_dataset(*args))
    np.testing.assert_array_equal(
        tdata._centers_from_star(str(tmp_path / "star" / "m0.star")),
        jdata._centers_from_star(str(tmp_path / "star" / "m0.star")))


def test_relion_star_source_bitwise(tmp_path, caplog):
    img, centers = make_micrograph(np.random.default_rng(21))
    centers = np.round(centers)
    _pair(tmp_path, "m0", img, centers)
    star = tmp_path / "particles.star"
    _write_star(star, centers, ".1f", name="path/to/m0.mrc")
    with open(star, "at") as f:   # a micrograph that is not there
        f.write("other/m9.mrc\t400.0\t400.0\n")
    args = (str(star), str(tmp_path / "mrc"), PARTICLE)
    with caplog.at_level(logging.WARNING):
        got = tdata.load_dataset_relion_star(*args, device="cpu")
        want = jdata.load_dataset_relion_star(*args)
    _equal(got, want)
    assert sum("m9.mrc not found; skipped" in r.getMessage()
               for r in caplog.records) == 2
    bad = tmp_path / "bad.star"
    _write_star(bad, centers, ".1f")
    with pytest.raises(ValueError) as e_want:
        jdata.load_dataset_relion_star(str(bad), str(tmp_path), PARTICLE)
    with pytest.raises(ValueError) as e_got:
        tdata.load_dataset_relion_star(str(bad), str(tmp_path), PARTICLE,
                                       device="cpu")
    assert str(e_got.value) == str(e_want.value)


def test_extracted_source_bitwise(tmp_path):
    img, centers = make_micrograph(np.random.default_rng(21))
    _pair(tmp_path, "m0", img, np.round(centers))
    args = (str(tmp_path / "mrc"), str(tmp_path / "lbl"), PARTICLE)
    got_n = tdata.extract_dataset(*args, str(tmp_path / "molA.pickle"),
                                  device="cpu")
    want_n = jdata.extract_dataset(*args, str(tmp_path / "jaxA.pickle"))
    assert got_n == want_n and got_n[0] == got_n[1] > 0
    with open(tmp_path / "molA.pickle", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jaxA.pickle", "rb") as f:
        want = pickle.load(f)
    for g, w in zip(got, want):
        _equal(g, w)
    shutil.copy(tmp_path / "molA.pickle", tmp_path / "molB.pickle")
    for cap in (None, 3):
        _equal(
            tdata.load_dataset_extracted(
                str(tmp_path), "molA.pickle;molB.pickle",
                per_molecule_cap=cap, device="cpu"),
            jdata.load_dataset_extracted(
                str(tmp_path), "molA.pickle;molB.pickle",
                per_molecule_cap=cap))


@pytest.mark.parametrize("select", [0.5, 50.0, 101.0])
def test_prepicked_source_bitwise(tmp_path, select):
    img, centers = make_micrograph(np.random.default_rng(21))
    _pair(tmp_path, "m0", img, np.round(centers))
    scores = np.linspace(0.1, 0.9, len(centers))
    rows = [[float(x), float(y), float(s), "m0.mrc"]
            for (x, y), s in zip(np.round(centers), scores)]
    rows.append([300.0, 300.0, 0.99, "gone.mrc"])
    results = tmp_path / "autopick_results.pickle"
    with open(results, "wb") as f:
        pickle.dump([rows], f)
    args = (str(tmp_path / "mrc"), str(results), PARTICLE)
    _equal(tdata.load_dataset_prepicked(*args, select=select, device="cpu"),
           jdata.load_dataset_prepicked(*args, select=select))


def test_shuffle_in_unison_equals_jax():
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    labels = np.arange(20) % 2
    _equal(tdata.shuffle_in_unison(data, labels, np.random.default_rng(4)),
           jdata.shuffle_in_unison(data, labels, np.random.default_rng(4)))


def test_no_positive_patches_error_text(tmp_path):
    img, _ = make_micrograph(np.random.default_rng(1), n_particles=0)
    _pair(tmp_path, "m0", img, np.array([[1.0, 1.0]]))
    args = (str(tmp_path / "mrc"), str(tmp_path / "lbl"), PARTICLE)
    with pytest.raises(ValueError) as want:
        jdata.load_dataset(*args)
    with pytest.raises(ValueError) as got:
        tdata.load_dataset(*args, device="cpu")
    assert str(got.value) == str(want.value)


def test_loaders_default_to_cuda(fixture_dirs):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tdata.load_dataset(*fixture_dirs["val"], PARTICLE)

