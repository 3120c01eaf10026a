"""The port's ``score`` against the JAX package's, on the CPU: the cases
of ``tests/test_scoring.py`` and ``tests/test_distance_golden.py``.
Mask scores are the reference's float32 numbers bit for bit; the
executed-reference goldens hold at rtol 1e-6 (mask) and byte for byte
(``results.txt``)."""

import glob
import json
import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

from repic_tpu.utils import scoring as J
from repic_tpu_torch.utils import scoring as T
from repic_tpu_torch.utils.table import Table
from tests.test_scoring import _oracle
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(os.path.dirname(HERE), "examples", "10017")
FIXTURE = os.path.join(HERE, "fixtures", "distance")
GOLDEN = os.path.join(HERE, "golden", "ref_distance_results.txt")
STATS = os.path.join(HERE, "golden", "ref_distance_stats.json")
SCORES = os.path.join(HERE, "golden", "ref_scores_cryolo_vs_topaz_10017.tsv")


def _tables(boxes, conf=None):
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    cols = dict(zip("xywh", boxes.T))
    if conf is not None:
        cols["conf"] = np.asarray(conf, np.float64)
    df = pd.DataFrame({k: v for k, v in cols.items()})
    return Table(cols), df


def _scores(gt, pk, **kw):
    (tg, dg), (tp, dp) = gt, pk
    got = T.get_segmentation_scores(tg, tp, device="cpu", **kw)
    want = J.get_segmentation_scores(dg, dp, **kw)
    assert got == want   # float32 arithmetic, bit for bit
    return got


def test_identical_disjoint_and_clipped():
    boxes = [(10, 10, 20, 20), (50, 50, 20, 20)]
    assert _scores(_tables(boxes), _tables(boxes), mrc_w=100,
                   mrc_h=100)[:3] == (1.0, 1.0, 1.0)
    got = _scores(_tables([(0, 0, 10, 10)]), _tables([(50, 50, 10, 10)]),
                  mrc_w=100, mrc_h=100)
    assert got[:3] == (0.0, 0.0, 0.0) and got[3] == pytest.approx(0.01)
    got = _scores(_tables([(90, 90, 20, 20)]), _tables([(90, 90, 20, 20)]),
                  mrc_w=100, mrc_h=100)
    assert got[0] == got[1] == 1.0


@pytest.mark.parametrize("trial", range(5))
def test_random_boxes_match_jax_and_the_oracle(trial):
    rng = np.random.default_rng(trial)
    h = w = 400
    n_gt, n_pk = rng.integers(3, 40, size=2)

    def boxes(n):
        return np.column_stack([rng.integers(-20, w - 10, n),
                                rng.integers(-20, h - 10, n),
                                rng.integers(5, 60, n),
                                rng.integers(5, 60, n)])

    gt, pk = boxes(n_gt), boxes(n_pk)
    got = _scores(_tables(gt), _tables(pk), mrc_w=w, mrc_h=h)
    keep = lambda b: b[(b[:, 0] >= 0) & (b[:, 1] >= 0)]  # noqa: E731
    np.testing.assert_allclose(got, _oracle(keep(gt), keep(pk), h, w),
                               rtol=1e-6)


def test_threshold_inferred_dims_and_empty_gt():
    gt = _tables([(0, 0, 10, 10)])
    pk = _tables([(0, 0, 10, 10), (50, 50, 10, 10)], conf=[0.2, 0.9])
    assert _scores(gt, pk, conf_thresh=0.5, mrc_w=100,
                   mrc_h=100)[:2] == (0.0, 0.0)
    got = _scores(_tables([(10, 10, 20, 20)]), _tables([(10, 10, 20, 20)]))
    assert got[3] == pytest.approx(400 / 900)
    got = _scores(_tables(np.zeros((0, 4))), _tables([(0, 0, 10, 10)]),
                  mrc_w=50, mrc_h=50)
    assert got[1] == 0.0


def test_rasterize_union_matches_jax():
    rng = np.random.default_rng(9)
    boxes = np.column_stack([
        rng.integers(-5, 60, 30), rng.integers(-5, 60, 30),
        rng.integers(1, 20, 30), rng.integers(1, 20, 30)]).astype(np.int32)
    valid = rng.random(30) > 0.2
    want = np.asarray(J.rasterize_union(boxes, valid, 64, 72))
    got = T.rasterize_union(torch.from_numpy(boxes), torch.from_numpy(valid),
                            64, 72)
    np.testing.assert_array_equal(got.numpy(), want)


def test_match_by_stem():
    args = (["/gt/Mic_A.box", "/gt/mic_b.box"],
            ["/p/mic_a_picked.box", "/p/other.box"])
    assert T.match_by_stem(*args) == J.match_by_stem(*args)


def test_golden_scores_match_executed_reference():
    golden = {}
    with open(SCORES) as f:
        next(f)
        for line in f:
            name, *vals = line.split("\t")
            golden[name] = [float(v) for v in vals]
    gt = sorted(glob.glob(os.path.join(EXAMPLES, "crYOLO", "*.box")))
    pk = sorted(glob.glob(os.path.join(EXAMPLES, "topaz", "*.box")))
    rows = T.score_box_files(gt, pk, device="cpu")
    assert rows == J.score_box_files(gt, pk)
    assert len(rows) == len(golden) == 12
    for stem, *vals in rows:
        np.testing.assert_allclose(vals, golden[stem], rtol=1e-6,
                                   err_msg=stem)


def test_cli_mask_mode_writes_the_jax_tsv(tmp_path):
    from repic_tpu.main import build_parser as jax_parser
    from repic_tpu_torch.main import build_parser

    gt = sorted(glob.glob(os.path.join(EXAMPLES, "crYOLO", "*.box")))
    pk = sorted(glob.glob(os.path.join(EXAMPLES, "topaz", "*.box")))
    argv = ["score", "-g", *gt, "-p", *pk, "-c", "0.3"]
    jargs = jax_parser().parse_args(argv + ["--out_dir", str(tmp_path / "j")])
    jargs.func(jargs)
    targs = build_parser().parse_args(
        argv + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"])
    targs._module.main(targs)
    name = "particle_set_comp.tsv"
    assert (tmp_path / "t" / name).read_bytes() == (
        tmp_path / "j" / name).read_bytes()


def test_cli_star_gt_against_box_picks(tmp_path):
    from repic_tpu_torch.main import build_parser

    (tmp_path / "m1.star").write_text(
        "data_\n\nloop_\n_rlnCoordinateX #1\n_rlnCoordinateY #2\n"
        "_rlnAutopickFigureOfMerit #3\n20.0\t20.0\t1.0\n")
    (tmp_path / "m1.box").write_text("10\t10\t20\t20\t0.9\n")
    args = build_parser().parse_args([
        "score", "-g", str(tmp_path / "m1.star"), "-p",
        str(tmp_path / "m1.box"), "--gt_format", "star", "--box_size", "20",
        "--out_dir", str(tmp_path / "out"), "--device", "cpu"])
    args._module.main(args)
    vals = (tmp_path / "out" / "particle_set_comp.tsv").read_text(
        ).splitlines()[1].split("\t")
    assert vals[0] == "m1" and float(vals[1]) == float(vals[3]) == 1.0


def test_score_defaults_to_cuda(tmp_path):
    from repic_tpu_torch.main import build_parser

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    (tmp_path / "m1.box").write_text("10\t10\t20\t20\t0.9\n")
    args = build_parser().parse_args(
        ["score", "-g", str(tmp_path / "m1.box"), "-p",
         str(tmp_path / "m1.box"), "--out_dir", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        args._module.main(args)


# ------------------------------------------------------ distance mode


def _fixture_files():
    return (sorted(glob.glob(os.path.join(FIXTURE, "*.star"))),
            sorted(glob.glob(os.path.join(FIXTURE, "*.box"))))


def test_results_txt_matches_executed_reference(tmp_path, capsys):
    with open(STATS) as f:
        stats = json.load(f)
    gt, picks = _fixture_files()
    T.main(SimpleNamespace(
        g=gt, p=picks, c=None, height=None, width=None, verbose=False,
        out_dir=str(tmp_path), gt_format="star", pckr_format="box",
        box_size=stats["particle_size"], match="distance",
        dist_rate=stats["rate"], device="cpu"))
    assert (tmp_path / "results.txt").read_text() == open(GOLDEN).read()
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("(threshold 0.5)")][0]
    assert f"precision:{stats['precision_05']:.6f}" in line
    got = T.score_distance_files(gt, picks, stats["particle_size"],
                                 rate=stats["rate"])
    assert got == J.score_distance_files(gt, picks, stats["particle_size"],
                                         rate=stats["rate"])


@pytest.mark.parametrize("picks,refs,radius", [
    ([(5.0, 0.0)], [(0.0, 0.0), (7.0, 0.0)], 6.0),
    ([(3.0, 0.0), (-3.0, 0.0)], [(0.0, 0.0)], 4.0),
    ([(8.0, 0.0)], [(0.0, 0.0)], 8.0),
    ([(7.999, 0.0)], [(0.0, 0.0)], 8.0),
    ([(0.0, 0.0)], [(1.0, 0.0), (2.0, 0.0)], 5.0),
    (np.zeros((0, 2)), [(0.0, 0.0)], 5.0),
])
def test_greedy_center_match_cases(picks, refs, radius):
    from repic_tpu.utils.matching import greedy_center_match as jg
    from repic_tpu_torch.utils.matching import greedy_center_match as tg

    for g, w in zip(tg(picks, refs, radius), jg(picks, refs, radius)):
        np.testing.assert_array_equal(g, w)


def test_analysis_degenerate_and_tie_order():
    from repic_tpu.utils.matching import analyze_distance_matches as ja
    from repic_tpu_torch.utils.matching import analyze_distance_matches as ta

    for per in (
        [(np.zeros((0, 2)), np.zeros(0), [(0.0, 0.0)])],
        [([(1.0, 1.0)], [0.9], np.zeros((0, 2)))],
        [([(0.0, 0.0)], [0.7], [(1.0, 0.0)]),
         ([(100.0, 100.0)], [0.7], [(300.0, 300.0)])],
    ):
        assert ta(per, particle_size=40) == ja(per, particle_size=40)
