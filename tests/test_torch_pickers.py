"""The port's picker adapters (``repic_tpu_torch.pipeline.pickers``)
against the JAX package's, on the CPU: the same configuration gives the
same command lines and crYOLO config bytes; run against stub ``conda``,
crYOLO, DeepPicker and Topaz executables (``tests/
test_pickers_integration.py``'s) both write the same BOX bytes and
logs; the Topaz table <-> BOX conversions write the same bytes, the
header-only table too; ``build_pickers`` builds the same ensemble; the
builtin picker picks what the JAX one picks with the committed JAX
``fit`` checkpoint (positions equal, scores within 1e-5).
"""

import dataclasses
import json
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from repic_tpu.pipeline import pickers as jp
from repic_tpu_torch.pipeline import pickers as tp
from repic_tpu_torch.utils.box_io import read_box
from test_pickers_integration import BOX, _box_dir, _script
from test_pickers_integration import stub_env  # noqa: F401  (fixture)
from test_train import PARTICLE, make_micrograph
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINING = os.path.join(REPO, "tests", "golden", "torch_port_training")


def _both(cls_name, **kw):
    return getattr(tp, cls_name)(**kw), getattr(jp, cls_name)(**kw)


def _dir_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# ------------------------------------------------------- command lines


def test_command_lines_equal_jax(tmp_path):
    for f in ("b.mrc", "a.mrc", "notes.txt"):
        (tmp_path / f).write_text("")
    cry = _both("CryoloPicker", name="cryolo", conda_env="cryolo",
                particle_size=180, model_path="/models/gmodel.h5")
    deep = _both("DeepPickerExternal", name="deep", conda_env="deep",
                 particle_size=180, deep_dir="/srv/DeepPicker",
                 model_path="/models/demo_type3", batch_size=512)
    topaz = _both("TopazPicker", name="topaz", conda_env="topaz",
                  particle_size=180, scale=4, radius=8)
    calls = [
        (cry, "predict_cmd", ("/mrc", "/out", "/work/config.json")),
        (cry, "fit_cmd", ("/work/config.json",)),
        (deep, "predict_cmd", ("/mrc", "/out/STAR")),
        (deep, "fit_cmd", ("/train", "/val", "/out/model")),
        (topaz, "preprocess_cmd", (str(tmp_path), "/down")),
        (topaz, "predict_cmd", (str(tmp_path), "/out/extracted.txt")),
        (topaz, "fit_cmd", ("/down", "/targets.txt", "/out/model", 400)),
    ]
    for (port, ref), method, args in calls:
        assert getattr(port, method)(*args) == getattr(ref, method)(*args)
    for p in topaz:
        p.model_path, p.balance = "/models/topaz.sav", 0.0625
    for method, args in (("predict_cmd", (str(tmp_path), "/o.txt")),
                         ("fit_cmd", ("/d", "/t.txt", "/m", 300))):
        got, want = (getattr(p, method)(*args) for p in topaz)
        assert got == want
    # no model configured: empty strings, as the reference passes them
    bare = _both("DeepPickerExternal", name="deep", conda_env="deep",
                 particle_size=64)
    assert bare[0].fit_cmd("a", "b", "c") == bare[1].fit_cmd("a", "b", "c")


@pytest.mark.parametrize("train", [None, ("/tmrc", "/tbox", "/vmrc", "/vbox",
                                          "/out/w.h5")])
def test_cryolo_config_bytes_equal_jax(tmp_path, train):
    port, ref = _both("CryoloPicker", name="cryolo", conda_env="cryolo",
                      particle_size=180)
    port._write_config(str(tmp_path / "port.json"), str(tmp_path), train)
    ref._write_config(str(tmp_path / "jax.json"), str(tmp_path), train)
    assert (tmp_path / "port.json").read_bytes() == (
        tmp_path / "jax.json").read_bytes()
    cfg = json.loads((tmp_path / "port.json").read_text())
    assert cfg["model"]["anchors"] == [180, 180]
    assert ("train" in cfg) == (train is not None)


def test_external_base_and_missing_pieces_raise(tmp_path, monkeypatch):
    base = tp.ExternalPicker(name="x", conda_env="nope", particle_size=180)
    with pytest.raises(tp.PickerError):
        base.predict("in", "out")
    with pytest.raises(tp.PickerError):
        base.fit()
    with pytest.raises(tp.PickerError, match="no model"):
        tp.DeepPickerExternal(name="deep", conda_env="deep",
                              particle_size=180, deep_dir="/x").predict(
            str(tmp_path), str(tmp_path / "o"))
    with pytest.raises(tp.PickerError, match="deep_dir"):
        tp.DeepPickerExternal(name="deep", conda_env="deep",
                              particle_size=180).predict("a", "b")
    with pytest.raises(tp.PickerError, match="no model weights"):
        tp.CryoloPicker(name="cryolo", conda_env="c",
                        particle_size=180).predict("a", "b")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(tp.PickerError, match="conda not available"):
        tp.CryoloPicker(name="cryolo", conda_env="c", particle_size=180,
                        model_path="w.h5")._run(["anything"])


# ---------------------------------------------- the stub executables


def _run_both(stub_env, cls_name, op, **kw):
    """Run ``op`` of the port's and the JAX adapter on the same stubs;
    returns the two output trees' bytes and results."""
    outs = []
    for pkg in (tp, jp):
        picker = getattr(pkg, cls_name)(**kw)
        root = stub_env / pkg.__name__.split(".")[0]
        root.mkdir(exist_ok=True)
        if op == "predict":
            result = picker.predict(str(stub_env / "mrc"),
                                    str(root / "picks"))
        else:
            train_box = _box_dir(root, "train_box", [(80, 80), (120, 160)])
            val_box = _box_dir(root, "val_box", [(80, 80)])
            work = root / "work"
            work.mkdir()
            picker.fit(str(stub_env / "mrc"), train_box,
                       str(stub_env / "mrc"), val_box,
                       str(work / "model.out"))
            result = os.path.basename(picker.model_path)
        tree = _dir_bytes(str(root))
        # the logs name the run's own directories
        tree = {k: v.replace(str(root).encode(), b"ROOT")
                for k, v in tree.items()}
        outs.append((result, tree))
    return outs


@pytest.mark.parametrize("cls_name,kw", [
    ("CryoloPicker", {"model_path": "weights.h5"}),
    ("TopazPicker", {"scale": 4, "radius": 8}),
    ("DeepPickerExternal", {"deep_dir": "DEEP", "model_path": "m.ckpt"}),
], ids=["cryolo", "topaz", "deep"])
@pytest.mark.parametrize("op", ["predict", "fit"])
def test_stub_runs_write_the_jax_bytes(stub_env, cls_name, kw, op):  # noqa: F811
    kw = dict(kw)
    if kw.get("deep_dir") == "DEEP":
        kw["deep_dir"] = str(stub_env / "DeepPicker")
    if cls_name == "TopazPicker":
        kw["balance"] = 0.125
    (got, got_tree), (want, want_tree) = _run_both(
        stub_env, cls_name, op, name=cls_name.lower(),
        conda_env=f"{cls_name.lower()}_env", particle_size=BOX, **kw)
    assert got == want
    assert got_tree == want_tree
    assert any(k.endswith(".box") or k.endswith(".out") for k in got_tree)


def test_failing_binary_raises_with_log(stub_env):  # noqa: F811
    _script(stub_env / "bin" / "cryolo_predict.py",
            "import sys; sys.stderr.write('boom: no GPU')\nsys.exit(3)\n",
            interpreter=sys.executable)
    p = tp.CryoloPicker(name="cryolo", conda_env="cryolo_env",
                        particle_size=BOX, model_path="weights.h5")
    with pytest.raises(tp.PickerError, match="boom: no GPU"):
        p.predict(str(stub_env / "mrc"), str(stub_env / "picks"))
    assert "boom" in (stub_env / "picks" / "cryolo_predict.log").read_text()


def test_extra_env_reaches_the_command(stub_env):  # noqa: F811
    record = stub_env / "env.txt"
    _script(stub_env / "bin" / "conda",
            f'echo "$REPIC_TEST_VAR" > {record}\n')
    p = tp.CryoloPicker(name="cryolo", conda_env="c", particle_size=BOX,
                        extra_env={"REPIC_TEST_VAR": 42})
    p._run(["x"])
    assert record.read_text().strip() == "42"


# ------------------------------------------------ Topaz's table and BOX


@pytest.mark.parametrize("table", [
    "image_name\tx_coord\ty_coord\tscore\na\t100\t200\t0.9\n"
    "a\t7\t9\t0.25\nc\t1\t2\t-3.5\n",
    "image_name\tx_coord\ty_coord\tscore\n",
    "image_name\tx_coord\ty_coord\n0001\t10\t20\n0001\t30\t40\n",
    "",
], ids=["rows", "header-only", "numeric-names", "empty"])
def test_topaz_table_box_round_trip_bytes(tmp_path, table):
    mrc = tmp_path / "mrc"
    mrc.mkdir()
    for stem in ("a", "b", "0001"):
        (mrc / f"{stem}.mrc").write_bytes(b"")
    tsv = tmp_path / "ex.txt"
    tsv.write_text(table)
    results = {}
    for name, pkg in (("port", tp), ("jax", jp)):
        out = tmp_path / f"{name}_box"
        n = pkg._topaz_tsv_to_box(str(tsv), str(out), 64, 4, str(mrc))
        back = pkg._box_dir_to_topaz_tsv(str(out), str(tmp_path / f"{name}.txt"),
                                         64, 4)
        results[name] = (n, back, _dir_bytes(str(out)),
                         (tmp_path / f"{name}.txt").read_bytes())
    assert results["port"] == results["jax"]
    assert results["port"][2]["b.box"] == b""


def test_convert_predictions_to_box_bytes(tmp_path):
    """CBOX and STAR outputs to BOX files, with the placeholders."""
    mrc = tmp_path / "mrc"
    mrc.mkdir()
    for stem in ("m1", "m2", "m3"):
        (mrc / f"{stem}.mrc").write_bytes(b"")
    pred = tmp_path / "pred"
    pred.mkdir()
    (pred / "m1.star").write_text(
        "data_\n\nloop_\n_rlnCoordinateX #1\n_rlnCoordinateY #2\n"
        "_rlnAutopickFigureOfMerit #3\n100.0\t120.0\t0.95\n"
        "200.5\t220.25\t0.65\n")
    (pred / "m2.star").write_text(
        "data_\n\nloop_\n_rlnCoordinateX #1\n_rlnCoordinateY #2\n")
    results = {}
    for name, pkg in (("port", tp), ("jax", jp)):
        out = tmp_path / name
        out.mkdir()
        n = pkg._convert_predictions_to_box(str(pred), "star", str(out), 40,
                                            str(mrc))
        results[name] = (n, _dir_bytes(str(out)))
    assert results["port"] == results["jax"]
    assert results["port"][0] == 2


def test_stage_star_labels_equal_jax(tmp_path):
    mrc = tmp_path / "mrc"
    mrc.mkdir()
    (mrc / "mic_a.mrc").write_bytes(b"\0")
    box = _box_dir(tmp_path, "box", [(80, 80), (10, 12)])
    trees = []
    for pkg in (tp, jp):
        out = tmp_path / pkg.__name__.split(".")[0]
        pkg._stage_star_labels(str(mrc), box, str(out))
        trees.append(_dir_bytes(str(out)))
        assert (out / "mic_a.mrc").is_symlink()
    assert trees[0] == trees[1]


# ----------------------------------------------------------- ensemble


def _fields(p):
    return type(p).__name__, {
        f.name: getattr(p, f.name) for f in dataclasses.fields(p)
        if f.name != "device"}


@pytest.mark.parametrize("config", [
    {"box_size": 180},
    {"box_size": 180, "cryolo_model": "init.rptpu"},
    {"box_size": 180, "cryolo_model": "g.h5"},
    {"box_size": 180, "cryolo_model": "init.rptpu", "deep_model": "d.rptpu",
     "compute_dtype": "bfloat16", "topaz_arch": "deep"},
    {"box_size": 180, "cryolo_env": "builtin", "deep_env": "builtin",
     "topaz_env": "topaz", "topaz_scale": 4, "topaz_rad": 9},
    {"box_size": 64, "cryolo_env": "cryolo", "cryolo_model": "m.h5",
     "deep_env": "deep", "deep_dir": "/d", "deep_model": "x",
     "deep_batch_size": 7, "topaz_env": "builtin"},
], ids=range(6))
def test_build_pickers_equals_jax(config):
    got = [_fields(p) for p in tp.build_pickers(config)]
    want = [_fields(p) for p in jp.build_pickers(config)]
    assert got == want
    assert [g[1]["name"] for g in got] == ["cryolo", "deep", "topaz"]


def test_iter_config_json_equals_jax(tmp_path, capsys):
    from repic_tpu.commands import iter_config as j_ic
    from repic_tpu_torch.commands import iter_config as t_ic

    for bf16 in (False, True):
        outs = []
        for mod, name in ((t_ic, "port"), (j_ic, "jax")):
            out = tmp_path / f"{name}.json"
            mod.main(SimpleNamespace(
                data_dir=str(tmp_path), box_size=180, exp_particles=100,
                cryolo_model="builtin", deep_dir="builtin", topaz_scale=4,
                topaz_rad=8, cryolo_env="builtin", deep_env="builtin",
                topaz_env="builtin", out_file_path=str(out), bf16=bf16))
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]
        assert json.loads(outs[0])["compute_dtype"] == (
            "bfloat16" if bf16 else "float32")
    with pytest.raises(AssertionError, match="does not exist"):
        t_ic.main(SimpleNamespace(
            data_dir=str(tmp_path / "nope"), box_size=1, exp_particles=1,
            cryolo_model="builtin", deep_dir="builtin", topaz_scale=4,
            topaz_rad=8, cryolo_env="builtin", deep_env="builtin",
            topaz_env="builtin", out_file_path="x", bf16=False))


def test_iter_config_cli_writes_the_jax_file(tmp_path, monkeypatch):
    from repic_tpu.main import main as jax_cli
    from repic_tpu_torch.main import main as cli

    monkeypatch.setenv("PATH", str(tmp_path))   # no conda
    argv = [str(tmp_path), "180", "300", "builtin", "builtin", "4", "8",
            "--topaz_env", "builtin"]
    cli(["iter_config", *argv, "--out_file_path", str(tmp_path / "p.json")])
    jax_cli(["iter_config", *argv, "--out_file_path",
             str(tmp_path / "j.json")])
    assert (tmp_path / "p.json").read_bytes() == (
        tmp_path / "j.json").read_bytes()


# ------------------------------------------------------ builtin picker


def test_builtin_picker_requires_model(tmp_path):
    p = tp.BuiltinPicker(name="b", particle_size=PARTICLE, device="cpu")
    with pytest.raises(tp.PickerError, match="no model available"):
        p.predict(str(tmp_path), str(tmp_path / "o"))


def test_builtin_predict_picks_what_jax_picks(tmp_path):
    """The committed JAX ``fit`` checkpoint through both builtin pickers
    on two held-out micrographs: the same rows but for the scores
    (within 1e-5); a micrograph that cannot be read is quarantined with
    an empty BOX file when lenient, and fails the round otherwise."""
    from repic_tpu_torch.utils import mrc as tmrc

    mrc_dir = tmp_path / "mrc"
    mrc_dir.mkdir()
    for seed in (98, 99):
        img, _ = make_micrograph(np.random.default_rng(seed))
        tmrc.write_mrc(str(mrc_dir / f"m{seed}.mrc"), img)
    ckpt = os.path.join(TRAINING, "fit.ckpt")
    got = tp.BuiltinPicker(name="deep", particle_size=PARTICLE,
                           model_path=ckpt, device="cpu")
    want = jp.BuiltinPicker(name="deep", particle_size=PARTICLE,
                            model_path=ckpt)
    n_got = got.predict(str(mrc_dir), str(tmp_path / "port"))
    n_want = want.predict(str(mrc_dir), str(tmp_path / "jax"))
    assert n_got == n_want > 0
    for seed in (98, 99):
        rows = [np.loadtxt(tmp_path / d / f"m{seed}.box", ndmin=2)
                for d in ("port", "jax")]
        np.testing.assert_array_equal(rows[0][:, :4], rows[1][:, :4])
        np.testing.assert_allclose(rows[0][:, 4], rows[1][:, 4], atol=1e-5)
    (mrc_dir / "bad.mrc").write_bytes(b"not an mrc")
    with pytest.raises(tp.PickerError, match="failed to pick"):
        got.predict(str(mrc_dir), str(tmp_path / "strict"))
    got.lenient = True
    with pytest.warns(RuntimeWarning, match="quarantined micrograph bad"):
        got.predict(str(mrc_dir), str(tmp_path / "lenient"))
    assert read_box(str(tmp_path / "lenient" / "bad.box")).n == 0


def test_builtin_defaults_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    p = tp.BuiltinPicker(name="b", particle_size=PARTICLE,
                         model_path=os.path.join(TRAINING, "fit.ckpt"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        p.predict(str(tmp_path), str(tmp_path / "o"))
    shutil.rmtree(tmp_path / "o", ignore_errors=True)
