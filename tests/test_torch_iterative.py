"""The port's iterative ensemble loop (``repic_tpu_torch.pipeline.
iterative``, ``commands/iter_pick.py``) against the JAX package's, on
the CPU.

``build_splits``, ``seed_round0_from_manual``, ``consensus_round`` and
``measure_balance`` give the JAX package's files and bytes; the five
resume cases of ``tests/test_iterative_resume.py`` (with its recording
stub pickers) give the same calls, the same ``state.json`` and the same
``iter_pick.log`` once the run directories, timestamps and stage
seconds are taken out, and the same consensus BOX bytes; one builtin
run (semi-automatic round 0, one retraining round of 2 epochs, three
pickers deep/wide/slim) recovers the planted particles at a mean
consensus F1 above 0.5, the reference test's limit.
"""

import glob
import json
import os
import re

import numpy as np
import pytest

from repic_tpu.pipeline import iterative as jit_
from repic_tpu_torch.pipeline import iterative as tit
from test_iterative_resume import FakePicker
from test_train import PARTICLE, make_micrograph, write_pair
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """``tests/test_iterative.py``'s dataset: 8 micrographs of 800 x
    800, 10 planted particles each, with full manual labels."""
    root = tmp_path_factory.mktemp("iterdata")
    data_dir, label_dir = root / "mrc", root / "labels"
    data_dir.mkdir()
    label_dir.mkdir()
    rng = np.random.default_rng(21)
    for i in range(8):
        img, centers = make_micrograph(rng, size=800, n_particles=10)
        write_pair((str(data_dir), str(label_dir)), f"mic{i}", img, centers)
    return str(data_dir), str(label_dir)


def _links(split_dirs):
    return {s: sorted((f, os.readlink(os.path.join(d, f)))
                      for f in os.listdir(d))
            for s, d in split_dirs.items()}


def _tree_bytes(root, exts=(".box", ".tsv")):
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"),
                                 recursive=True)):
        if path.endswith(exts) and not path.endswith("_runtime.tsv"):
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("train_size", [100, 50, 25])
def test_build_splits_equal_jax(dataset, tmp_path, train_size):
    data_dir, _ = dataset
    got = tit.build_splits(data_dir, str(tmp_path / "p"),
                           train_size=train_size, seed=3)
    want = jit_.build_splits(data_dir, str(tmp_path / "j"),
                             train_size=train_size, seed=3)
    assert _links(got) == _links(want)
    assert len(_links(got)["train"]) == max(round(2 * train_size / 100), 1)


def test_build_splits_defocus_and_rerun(dataset, tmp_path):
    data_dir, _ = dataset
    defocus = os.path.join(data_dir, "defocus.txt")
    rng = np.random.default_rng(3)
    with open(defocus, "wt") as f:
        for i in range(8):
            d = 10000 + 1000 * float(rng.uniform())
            f.write(f"mic{i}.mrc\t{d:.1f}\t{d + 50:.1f}\n")
    try:
        got = tit.build_splits(data_dir, str(tmp_path / "p"))
        want = jit_.build_splits(data_dir, str(tmp_path / "j"))
    finally:
        os.remove(defocus)
    assert _links(got) == _links(want)
    # a rerun with a smaller train_size keeps no stale link
    got = tit.build_splits(data_dir, str(tmp_path / "p"), train_size=50)
    assert len(os.listdir(got["train"])) == 1
    with pytest.raises(FileNotFoundError, match="no .mrc files"):
        tit.build_splits(str(tmp_path), str(tmp_path / "o"))


def test_seed_round0_bytes_equal_jax(dataset, tmp_path):
    data_dir, label_dir = dataset
    splits = tit.build_splits(data_dir, str(tmp_path / "s"))
    for fraction in (0.5, 0.01):
        got = tit.seed_round0_from_manual(
            label_dir, splits, str(tmp_path / f"p{fraction}"),
            fraction=fraction, seed=4, box_size=PARTICLE)
        want = jit_.seed_round0_from_manual(
            label_dir, splits, str(tmp_path / f"j{fraction}"),
            fraction=fraction, seed=4, box_size=PARTICLE)
        assert list(got) == list(want) == ["train", "val", "test"]
        assert _tree_bytes(str(tmp_path / f"p{fraction}")) == _tree_bytes(
            str(tmp_path / f"j{fraction}"))
    rows = [len(open(f).readlines())
            for f in glob.glob(str(tmp_path / "p0.5" / "consensus" / "*"
                                   / "*.box"))]
    assert rows and set(rows) == {5}


def _fake_predictions(dataset, root):
    """Three recording pickers' BOX files for every split."""
    data_dir, _ = dataset
    splits = tit.build_splits(data_dir, str(root / "s"))
    calls = []
    pickers = [FakePicker(n, PARTICLE, calls) for n in ("a", "b", "c")]
    for split, d in splits.items():
        for p in pickers:
            p.predict(d, str(root / "pred" / split / p.name))
    # a picker that disagrees on one micrograph, and an empty file
    with open(root / "pred" / "test" / "c" / sorted(
            os.listdir(root / "pred" / "test" / "c"))[0], "wt") as f:
        f.write(f"400\t420\t{PARTICLE}\t{PARTICLE}\t0.5\n")
    open(root / "pred" / "val" / "b" / sorted(
        os.listdir(root / "pred" / "val" / "b"))[0], "wt").close()
    return {s: str(root / "pred" / s) for s in splits}


def test_consensus_round_and_balance_equal_jax(dataset, tmp_path):
    preds = _fake_predictions(dataset, tmp_path)
    outs = {}
    for name, mod, kw in (("p", tit, {"device": "cpu"}), ("j", jit_, {})):
        state = mod.IterativeState(out_dir=str(tmp_path))
        outs[name] = mod.consensus_round(
            preds, str(tmp_path / name), PARTICLE, state,
            num_particles=3, **kw)
    assert _tree_bytes(str(tmp_path / "p")) == _tree_bytes(
        str(tmp_path / "j"))
    assert len(_tree_bytes(str(tmp_path / "p"))) == 8
    for split in ("train", "val", "test"):
        assert tit.measure_balance(outs["p"][split], 4) == (
            jit_.measure_balance(outs["j"][split], 4))
    assert tit.measure_balance(outs["p"]["train"], 0) is None


def test_consensus_round_empty_split(tmp_path):
    pdir = tmp_path / "pred"
    for picker in ("p1", "p2"):
        (pdir / picker).mkdir(parents=True)
    state = tit.IterativeState(out_dir=str(tmp_path))
    out = tit.consensus_round({"train": str(pdir)}, str(tmp_path / "r"),
                              180, state, device="cpu")
    assert "train" in out


# --------------------------------------------------------------- resume


@pytest.fixture
def env(tmp_path, monkeypatch):
    data_dir = tmp_path / "mrc"
    data_dir.mkdir()
    for i in range(8):
        (data_dir / f"mic{i}.mrc").write_bytes(b"\x00" * 32)
    calls = {"port": [], "jax": []}
    for key, mod in (("port", tit), ("jax", jit_)):
        monkeypatch.setattr(
            mod.pickers_mod, "build_pickers",
            lambda config, key=key: [
                FakePicker(n, int(config["box_size"]), calls[key])
                for n in ("cryolo", "deep", "topaz")])
    config = {"data_dir": str(data_dir), "box_size": 48}
    return config, tmp_path, calls


_STAMP = re.compile(r"^\[\d{4}-\d\d-\d\d \d\d:\d\d:\d\d\] ", re.M)
_SECONDS = re.compile(r"\(\d+\.\d+s\)")


def _run_both(env, **kw):
    """One ``run_iterative`` per package with the same arguments, each
    in its own run directory; returns their states."""
    config, root, _ = env
    return (tit.run_iterative(config, out_dir=str(root / "port"),
                              device="cpu", **kw),
            jit_.run_iterative(config, out_dir=str(root / "jax"), **kw))


def _assert_same_runs(env):
    config, root, calls = env

    def view(key):
        out = str(root / key)

        def sub(text):
            return text.replace(out, "OUT")

        call_list = [tuple(sub(c) if isinstance(c, str) else c for c in call)
                     for call in calls[key]]
        state = sub(open(os.path.join(out, "state.json")).read())
        log = _SECONDS.sub("(S)", _STAMP.sub("", sub(open(
            os.path.join(out, "iter_pick.log")).read())))
        return call_list, json.loads(state), log, _tree_bytes(out)

    got, want = view("port"), view("jax")
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3] and got[3]


def _clear(calls):
    for v in calls.values():
        v.clear()


def test_resume_continues_without_retraining(env):
    config, root, calls = env
    _run_both(env, num_iter=1, train_size=100)
    _assert_same_runs(env)
    _clear(calls)
    got, _ = _run_both(env, num_iter=3, train_size=100)
    assert len(got.rounds) == 4
    fits = [c for c in calls["port"] if c[1] == "fit"]
    assert len(fits) == 6
    models = os.path.join(str(root / "port"), "round_1", "models")
    assert all(f[2] == os.path.join(models, f"{f[0]}.rptpu")
               for f in fits[:3])
    _assert_same_runs(env)
    assert "resuming: rounds 0..1 already complete" in open(
        root / "port" / "iter_pick.log").read()


def test_resume_noop_when_all_rounds_done(env):
    config, root, calls = env
    _run_both(env, num_iter=1, train_size=100)
    _clear(calls)
    got, want = _run_both(env, num_iter=1, train_size=100)
    assert len(got.rounds) == len(want.rounds) == 2
    assert calls == {"port": [], "jax": []}
    _assert_same_runs(env)


def test_fingerprint_mismatch_restarts(env):
    config, root, calls = env
    _run_both(env, num_iter=1, train_size=100)
    _clear(calls)
    got, _ = _run_both(env, num_iter=1, train_size=100, seed=7)
    assert len(got.rounds) == 2
    assert len([c for c in calls["port"] if c[1] == "fit"]) == 3
    _assert_same_runs(env)


def test_no_resume_flag_restarts(env):
    config, root, calls = env
    _run_both(env, num_iter=1, train_size=100)
    _clear(calls)
    _run_both(env, num_iter=1, train_size=100, resume=False)
    assert len([c for c in calls["port"] if c[1] == "fit"]) == 3
    _assert_same_runs(env)


def test_resume_ignores_rounds_with_missing_outputs(env):
    import shutil

    config, root, calls = env
    _run_both(env, num_iter=1, train_size=100)
    for key in ("port", "jax"):
        shutil.rmtree(root / key / "round_1" / "consensus")
    _clear(calls)
    got, _ = _run_both(env, num_iter=1, train_size=100)
    assert len(got.rounds) == 2
    assert len([c for c in calls["port"] if c[1] == "fit"]) == 3
    _assert_same_runs(env)


def test_iter_pick_cli(env, tmp_path):
    """The command over a config file: the run of ``run_iterative``,
    the reference's exits for a missing file or key, and the card by
    default."""
    import torch

    from repic_tpu_torch.main import main as cli

    config, root, calls = env
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(config))
    cli(["iter_pick", str(cfg), "1", "100", "--out_dir", str(root / "c"),
         "--device", "cpu"])
    assert len(json.load(open(root / "c" / "state.json"))["rounds"]) == 2
    with pytest.raises(SystemExit, match="config file not found"):
        cli(["iter_pick", str(tmp_path / "nope.json"), "1", "100",
             "--device", "cpu"])
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(SystemExit, match="missing required key 'data_dir'"):
        cli(["iter_pick", str(tmp_path / "bad.json"), "1", "100",
             "--device", "cpu"])
    with pytest.raises(SystemExit, match="semi_auto requires"):
        cli(["iter_pick", str(cfg), "1", "100", "--semi_auto",
             "--out_dir", str(root / "d"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli(["iter_pick", str(cfg), "1", "100"])


# ------------------------------------------------------------- builtin


def test_iterative_end_to_end_builtin(dataset, tmp_path):
    """Semi-automatic round 0 from the manual labels, one retraining
    round (2 epochs, batch 16) of the three builtin pickers, consensus
    and scoring on the CPU: the final round's test split recovers the
    planted particles at a mean F1 above 0.5."""
    data_dir, label_dir = dataset
    config = {
        "data_dir": data_dir, "box_size": PARTICLE, "exp_particles": 10,
        "cryolo_env": "builtin", "deep_env": "builtin",
        "topaz_env": "builtin",
    }
    out_dir = str(tmp_path / "run")
    state = tit.run_iterative(
        config, num_iter=1, train_size=100, out_dir=out_dir,
        semi_auto=True, manual_label_dir=label_dir, semi_auto_fraction=1.0,
        score_gt_dir=label_dir,
        picker_overrides={"max_epochs": 2, "batch_size": 16},
        device="cpu",
    )
    assert len(state.rounds) == 2
    final = state.rounds[-1]["consensus"]
    assert glob.glob(os.path.join(final["test"], "*.box"))
    log = open(os.path.join(out_dir, "iter_pick.log")).read()
    assert "round 1 fit cryolo" in log and "score round_1/test" in log
    for picker in ("cryolo", "deep", "topaz"):
        assert os.path.exists(os.path.join(
            out_dir, "round_1", "models", f"{picker}.rptpu"))
    with open(os.path.join(final["test"], "particle_set_comp.tsv")) as fh:
        next(fh)
        f1s = [float(line.split("\t")[3]) for line in fh]
    assert np.mean(f1s) > 0.5
    # a rerun resumes and does nothing
    again = tit.run_iterative(
        config, num_iter=1, train_size=100, out_dir=out_dir,
        semi_auto=True, manual_label_dir=label_dir, semi_auto_fraction=1.0,
        score_gt_dir=label_dir, device="cpu")
    assert again.rounds == state.rounds
