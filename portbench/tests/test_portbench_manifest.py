"""The manifest and the files it names: every cell, configuration,
traffic mix, metric and limit resolves by name; a new one is found
without an edit; the manifest keeps to the benchmark's contract."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    return run.load_manifest(ROOT)


def test_every_cell_resolves(manifest, monkeypatch):
    monkeypatch.chdir(ROOT)
    for cell in manifest["workloads"]:
        spec = run.resolve(manifest, cell["name"])
        assert spec["traffic"]["kind"] in ("consensus", "pick")
        kind = run.kind_module(spec["traffic"])
        assert hasattr(kind, "Cell")
        names = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert spec["per_layer"]
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(run.load_reader(m["name"]))
        limits = json.load(open(os.path.join(
            ROOT, "portbench", "limits", cell["name"] + ".json")))
        assert limits["limits"]


def test_manifest_keeps_to_the_contract(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    need = ((2 + 14 * cells) * (manifest["run_seconds"] + 60)
            + cells * 2 * 90 + 1200)
    assert need <= 43200
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    cells_by_name = {w["name"]: w for w in manifest["workloads"]}
    configs = {c["name"] for c in manifest["configs"]}
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"]
                   for w in manifest["workloads"])
    pairs = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for cell in m.get("workloads", []):
            assert cell in cells_by_name
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in manifest["workloads"]:
        reported = [m for m in manifest["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    assert len(json.dumps(manifest)) < 64 * 1024


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path):
    """Copy the benchmark, add configurations, a traffic mix, a
    generator, a metric and cells as new files and manifest entries
    only, resolve them from the copy, and run the small dense field
    (its generator the new file) there on the CPU."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                      "k5_mixed.json")))
    cfg.update(name="k4_mixed", pickers=cfg["pickers"][:4],
               box_size=cfg["box_size"][:4])
    (tmp_path / "portbench" / "configs" / "k4_mixed.json").write_text(
        json.dumps(cfg))
    traffic = json.load(open(os.path.join(ROOT, "portbench", "traffic",
                                          "consensus.json")))
    traffic["solver"] = "greedy"
    (tmp_path / "portbench" / "traffic" / "consensus_greedy.json"
     ).write_text(json.dumps(traffic))
    (tmp_path / "portbench" / "metrics" / "consensus.chunks.py").write_text(
        "def read(ctx):\n    return ctx['trace']['steps']\n")
    (tmp_path / "portbench" / "limits" / "k4_mixed.consensus_greedy.json"
     ).write_text(json.dumps({"limits": {"packing_conflicts": 0}}))
    # a dense field whose generator comes as a new file
    shutil.copy(os.path.join(ROOT, "portbench", "generators",
                             "dense_field.py"),
                tmp_path / "portbench" / "generators" / "dense_grid.py")
    dense = dict(name="dense_small", pickers=["a", "b", "c", "d"],
                 box_size=180, threshold=0.3, generator="dense_grid",
                 generator_args={"n": 300}, corpus_seed=0, n_pad=300,
                 micrographs=4, chunk=2, precision="float32")
    (tmp_path / "portbench" / "configs" / "dense_small.json").write_text(
        json.dumps(dense))
    limits = json.load(open(os.path.join(ROOT, "portbench", "limits",
                                         "k5_mixed.consensus.json")))
    (tmp_path / "portbench" / "limits" / "dense_small.consensus.json"
     ).write_text(json.dumps(limits))
    for name, traffic in (("k4_mixed", "consensus_greedy"),
                          ("dense_small", "consensus")):
        man["configs"].append({"name": name, "source": "x",
                               "file": f"portbench/configs/{name}.json",
                               "reduced": [], "why": "x"})
        man["workloads"].append({"name": f"{name}.{traffic}",
                                 "config": name, "traffic": traffic,
                                 "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "consensus.chunks", "unit": "chunks",
                             "better": "higher", "source": "program_counter",
                             "layer": "chunk program",
                             "moves": "consensus_mic_per_s",
                             "workloads": ["k4_mixed.consensus_greedy"]})
    for m in man["end_to_end"]:
        if m["name"] == "consensus_mic_per_s":
            m["workloads"] += ["k4_mixed.consensus_greedy",
                               "dense_small.consensus"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import os\n"
        "from portbench import run, compare\n"
        "s = run.resolve(run.load_manifest(), 'k4_mixed.consensus_greedy')\n"
        "assert s['config']['name'] == 'k4_mixed'\n"
        "assert s['traffic']['solver'] == 'greedy'\n"
        "names = [m['name'] for m in s['per_layer']]\n"
        "assert 'consensus.chunks' in names, names\n"
        "ctx = {'trace': {'steps': 3}}\n"
        "assert run.read_metrics([m for m in s['per_layer'] if m['name'] =="
        " 'consensus.chunks'], ctx)['consensus.chunks']['value'] == 3\n"
        "assert run.kind_module(s['traffic']).Cell\n"
        "assert compare.load_limits('k4_mixed.consensus_greedy')\n"
        "from portbench import synth\n"
        "assert run.HERE.startswith(os.getcwd())\n"
        "assert synth.generator('dense_grid').__module__ =="
        " 'portbench.generators.dense_grid'\n"
        "s = run.resolve(run.load_manifest(), 'dense_small.consensus')\n"
        "r, rows = run.run(s, 'dense_small.consensus', 2**33 + 5, 0.2,"
        " False, device='cpu')\n"
        "assert r['correct'], rows\n"
        "assert r['attempted'] >= 4 and r['failed'] == 0, r\n"
        "assert set(r['metrics']) == {'consensus_mic_per_s', 'setup_s'}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT,
                              "REPIC_TPU_NO_CONFIG_CACHE": "1"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_run_refuses_without_a_card(monkeypatch, capsys):
    """No card, or fewer than the cell asks for: a non-zero exit and no
    result line."""
    import torch

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "k5_mixed.consensus", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_run_fails_in_a_directory_of_only_the_benchmark(tmp_path):
    """With only BENCHMARK.json and the benchmark's folder the run
    cannot import the program and exits non-zero with no result."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from portbench import run\n"
            "sys.exit(run.main(['--workload', 'k5_mixed.consensus', "
            "'--seed', '1', '--seconds', '1', '--trace', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0
    assert "repic_tpu_torch" in out.stderr
    assert out.stdout == ""
