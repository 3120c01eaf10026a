"""``correct`` fails where it should: the control (the reference in
bfloat16, or the program's own bfloat16 path) and the timed path broken
underneath, at sizes a test run holds, on the CPU.  A run past the
harness's look for a chip."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import compare, run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**33 + 17

TINY = {
    "k5_mixed.consensus": {"micrographs": 4, "chunk": 2, "n_pad": 64,
                           "generator_args": {"n_per": 50, "lo": 0.0,
                                              "hi": 700.0}},
    "empiar10017.consensus": {"micrographs": 4, "chunk": 2, "n_pad": 128,
                              "generator_args": {"field": 900.0, "grid": 8,
                                                 "boxes": [80, 120]}},
    "empiar10017.pick_patch": {"micrograph_px": 768,
                               "picker": {"micrographs": 2,
                                          "blobs": [20, 30]}},
    "empiar10017.pick_fcn": {"micrograph_px": 768,
                             "picker": {"micrographs": 2,
                                        "blobs": [20, 30]}},
}


def tiny_spec(cell):
    """The cell's configuration and traffic files, cut to a test's size
    (the cells outside BENCHMARK.json are tested as well)."""
    config, traffic = cell.split(".")
    pb = os.path.join(ROOT, "portbench")
    spec = {"cell": {"chips": 1}, "end_to_end": [], "per_layer": [],
            "config": json.load(open(os.path.join(pb, "configs",
                                                  config + ".json"))),
            "traffic": json.load(open(os.path.join(pb, "traffic",
                                                   traffic + ".json")))}
    for key, val in TINY[cell].items():
        if isinstance(val, dict):
            spec["config"][key].update(val)
        else:
            spec["config"][key] = val
    return spec


def run_cpu(cell, seconds=0.5):
    result, rows = run.run(tiny_spec(cell), cell, SEED, seconds, False,
                           device="cpu")
    return result["correct"], {n: v for n, v, _ in rows}


@pytest.fixture(autouse=True)
def _root(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("REPIC_TPU_NO_CONFIG_CACHE", "1")


CONSENSUS = ["k5_mixed.consensus", "empiar10017.consensus"]
PICK = ["empiar10017.pick_patch", "empiar10017.pick_fcn"]


@pytest.mark.parametrize("cell", CONSENSUS + PICK)
def test_the_control_fails(cell):
    spec = tiny_spec(cell)
    kind = run.kind_module(spec["traffic"])
    c = kind.Cell(spec["config"], spec["traffic"], SEED, "cpu")
    c.setup()
    c.release()
    ok, _ = compare.judge(c.control_numbers(), compare.load_limits(cell))
    assert not ok


@pytest.mark.parametrize("cell", CONSENSUS)
def test_a_sound_consensus_run_is_correct(cell):
    ok, numbers = run_cpu(cell)
    assert ok, numbers


def _half_left_out(program):
    """The chunk program run on the first half of the chunk only; the
    other half comes back empty."""
    def broken(xy, conf, mask, box, **kw):
        m = xy.shape[0] // 2
        res = program(xy[:m], conf[:m], mask[:m], box, **kw)
        return type(res)(*[torch.cat([t, torch.zeros_like(t)])
                           for t in res])
    return broken


def _answer_altered(pack):
    """One picked clique of every micrograph dropped where the packed
    result is made."""
    def broken(res):
        picked = res.picked.clone()
        first = torch.argmax(picked.int(), dim=1)
        picked[torch.arange(picked.shape[0]), first] = False
        return pack(res._replace(picked=picked))
    return broken


@pytest.mark.parametrize("cell", CONSENSUS)
@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered",
                                   "state_unchanged"])
def test_a_broken_consensus_path_is_not_correct(cell, fault, monkeypatch):
    from repic_tpu_torch.pipeline import consensus as pc
    from repic_tpu_torch.solver import dual

    if fault == "half_left_out":
        monkeypatch.setattr(pc, "consensus_over_mesh",
                            _half_left_out(pc.consensus_over_mesh))
    elif fault == "answer_altered":
        monkeypatch.setattr(pc, "_pack_full_result",
                            _answer_altered(pc._pack_full_result))
    else:
        # the dual ascent's step returns the prices unchanged
        monkeypatch.setattr(dual, "price_step", lambda lam, eta, ax: lam)
    ok, numbers = run_cpu(cell)
    assert not ok, numbers


@pytest.mark.parametrize("cell", PICK)
@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_a_broken_picker_path_is_not_correct(cell, fault, monkeypatch):
    from repic_tpu_torch.models import infer

    name = ("score_micrograph_fcn" if cell.endswith("fcn")
            else "score_micrograph_patches")
    orig = getattr(infer, name)

    def broken(*a, **kw):
        out = orig(*a, **kw).clone()
        if fault == "half_left_out":
            out[out.shape[0] // 2:] = 0.0
        else:
            out[out.shape[0] // 2, out.shape[1] // 2] += 0.05
        return out

    monkeypatch.setattr(infer, name, broken)
    ok, numbers = run_cpu(cell)
    assert not ok, numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["k5_mixed.consensus"])
def test_readings_on_the_card(cell, capsys):
    """One seed of the program and the control at the cell's own size
    (``portbench/readings.py``); the control fails, the program passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    from portbench import readings

    assert readings.main(["--workload", cell, "--seeds", str(SEED),
                          "--control"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = compare.load_limits(cell)
    assert compare.judge(line["program"], limits)[0]
    assert not compare.judge(line["control"], limits)[0]
    assert np.isfinite(list(line["program"].values())).all()
