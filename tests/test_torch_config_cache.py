"""The port's capacity-config sidecar against ``repic_tpu``'s.

The cases of ``tests/test_config_cache.py``: ``run_consensus_batch``
persists each accepted ``(max_neighbors, clique_capacity,
cell_capacity, partial_capacity)`` to
``~/.cache/repic_tpu_torch/capacity_configs.json`` (the reference's
format, a file of its own), a new process starts from it, a corrupt
sidecar is ignored, ``REPIC_TPU_NO_CACHE`` / ``REPIC_TPU_NO_CONFIG_CACHE``
turn it off, and two processes writing at once keep each other's
entries.  Capacities decide bytes, so a second run of a directory must
write the reference's second-run bytes: checked on a seeded directory,
with the two sidecars equal entry for entry.  The suite runs with the
cache off (``tests/conftest.py``); these tests point ``HOME`` at a
temporary directory and turn it on.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from repic_tpu.pipeline import consensus as jcons
from repic_tpu_torch.parallel.batching import pad_batch
from repic_tpu_torch.pipeline import consensus as C
from repic_tpu_torch.utils.box_io import BoxSet
from torch_port_common import write_box_dir
from torch_runtime_common import assert_same_run, run_jax_dir, run_port_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sidecar(home, package="repic_tpu_torch"):
    return os.path.join(str(home), ".cache", package,
                        "capacity_configs.json")


def _run_once(tmp_home, monkeypatch, seed=7):
    monkeypatch.setenv("HOME", str(tmp_home))
    monkeypatch.delenv("REPIC_TPU_NO_CONFIG_CACHE", raising=False)
    rng = np.random.default_rng(seed)
    mics = []
    for i in range(2):
        pickers = []
        for _ in range(3):
            n = 40
            xy = rng.uniform(0, 2000, size=(n, 2)).astype(np.float32)
            conf = rng.uniform(0.1, 1.0, size=(n,)).astype(np.float32)
            wh = np.full((n, 2), 180.0, np.float32)
            pickers.append(BoxSet(xy=xy, conf=conf, wh=wh))
        mics.append((f"m{i}", pickers))
    return C.run_consensus_batch(pad_batch(mics), 180.0, device="cpu")


def _snapshot(mod):
    return (dict(mod._LAST_GOOD_CONFIG),
            {k: list(v) for k, v in mod._RECENT_REQUIREMENTS.items()},
            mod._CONFIG_CACHE_LOADED, dict(mod._LAST_PERSISTED))


def _restore(mod, saved):
    mod._LAST_GOOD_CONFIG.clear()
    mod._LAST_GOOD_CONFIG.update(saved[0])
    mod._RECENT_REQUIREMENTS.clear()
    mod._RECENT_REQUIREMENTS.update(saved[1])
    mod._CONFIG_CACHE_LOADED = saved[2]
    mod._LAST_PERSISTED.clear()
    mod._LAST_PERSISTED.update(saved[3])


def _fresh_process(mod):
    """The module state a new process starts with."""
    mod._LAST_GOOD_CONFIG.clear()
    mod._RECENT_REQUIREMENTS.clear()
    mod._LAST_PERSISTED.clear()
    mod._CONFIG_CACHE_LOADED = False


@pytest.fixture
def clean_config_state():
    """Both packages' config memos and latches reset, and restored."""
    saved = [(mod, _snapshot(mod)) for mod in (C, jcons)]
    for mod, _ in saved:
        mod._RECENT_REQUIREMENTS.clear()
        mod._LAST_PERSISTED.clear()
        mod._CONFIG_CACHE_LOADED = False
    yield
    for mod, snap in saved:
        _restore(mod, snap)


def test_sidecar_written_and_reloaded(tmp_path, monkeypatch,
                                      clean_config_state):
    _run_once(tmp_path, monkeypatch)
    entries = json.load(open(_sidecar(tmp_path)))
    assert len(entries) >= 1
    for e in entries:
        shape, sizes, threshold, spatial = e["key"]
        key = (tuple(shape), tuple(sizes), float(threshold), bool(spatial))
        if key in C._LAST_GOOD_CONFIG:
            assert tuple(e["cfg"]) == C._LAST_GOOD_CONFIG[key]
    _fresh_process(C)
    C._load_persisted_configs()
    for e in entries:
        shape, sizes, threshold, spatial = e["key"]
        key = (tuple(shape), tuple(sizes), float(threshold), bool(spatial))
        assert C._LAST_GOOD_CONFIG.get(key) == tuple(e["cfg"])


@pytest.mark.parametrize(
    "garbage",
    ["{not json", "{}", "[1, 2]", '[{"nokey": 1}]', '"a string"'],
)
def test_corrupt_sidecar_is_ignored(tmp_path, monkeypatch,
                                    clean_config_state, garbage):
    path = _sidecar(tmp_path)
    os.makedirs(os.path.dirname(path))
    with open(path, "w") as f:
        f.write(garbage)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("REPIC_TPU_NO_CONFIG_CACHE", raising=False)
    C._LAST_GOOD_CONFIG.clear()
    C._CONFIG_CACHE_LOADED = False
    C._load_persisted_configs()  # must not raise
    assert C._CONFIG_CACHE_LOADED
    assert _run_once(tmp_path, monkeypatch) is not None
    entries = json.load(open(path))
    assert isinstance(entries, list) and entries
    assert all(isinstance(e, dict) and "key" in e for e in entries)


def test_opt_outs_disable_persistence(tmp_path, monkeypatch,
                                      clean_config_state):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("REPIC_TPU_NO_CONFIG_CACHE", "1")
    assert C._config_cache_path() is None
    monkeypatch.delenv("REPIC_TPU_NO_CONFIG_CACHE")
    monkeypatch.setenv("REPIC_TPU_NO_CACHE", "1")
    assert C._config_cache_path() is None
    monkeypatch.delenv("REPIC_TPU_NO_CACHE")
    assert C._config_cache_path() == _sidecar(tmp_path)


_N_KEYS = 12

_WRITER_CODE = """
import os, sys, time
tag, start_file = sys.argv[1], sys.argv[2]
from repic_tpu_torch.pipeline import consensus as C
deadline = time.time() + 60
while not os.path.exists(start_file):
    if time.time() > deadline:
        sys.exit(3)
    time.sleep(0.001)
for i in range({n}):
    key = ((2, 3, 8, int(tag), i), (180.0,), 0.3, False)
    C._persist_config(key, (8, 1024, 64, 1024))
""".format(n=_N_KEYS)


def test_concurrent_persist_loses_no_updates(tmp_path):
    """Two processes interleaving read-merge-replace cycles keep each
    other's entries (``file_lock`` around the cycle)."""
    env = os.environ.copy()
    env["HOME"] = str(tmp_path)
    env.pop("REPIC_TPU_NO_CONFIG_CACHE", None)
    env.pop("REPIC_TPU_NO_CACHE", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    start_file = str(tmp_path / "go")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WRITER_CODE, tag, start_file],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )
        for tag in ("1", "2")
    ]
    time.sleep(0.2)
    with open(start_file, "w") as f:
        f.write("go")
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-2000:]
    entries = json.load(open(_sidecar(tmp_path)))
    keys = {tuple(e["key"][0]) for e in entries}
    assert keys == {(2, 3, 8, tag, i) for tag in (1, 2)
                    for i in range(_N_KEYS)}


def test_second_run_writes_the_reference_bytes(tmp_path, monkeypatch,
                                               clean_config_state):
    """Two runs of one directory, each as a new process (the in-process
    memo dropped, the sidecar kept): the second starts from the first's
    capacities and writes the reference's second-run bytes; the two
    packages' sidecars hold the same entries."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("REPIC_TPU_NO_CONFIG_CACHE", raising=False)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    data = write_box_dir(tmp_path, m=5, n=40)
    for run in ("first", "second"):
        for mod in (C, jcons):
            _fresh_process(mod)
        out, j_out = str(tmp_path / f"{run}_port"), str(tmp_path / f"{run}_jax")
        stats, _ = run_port_dir(data, out, 64, clear_memo=False)
        j_stats, _ = run_jax_dir(data, j_out, 64, clear_memo=False)
        assert_same_run((out, stats), (j_out, j_stats))
        got = json.load(open(_sidecar(tmp_path / "home")))
        want = json.load(open(_sidecar(tmp_path / "home", "repic_tpu")))
        assert got == want and got


def test_port_meets_committed_sidecar_digests(tmp_path, monkeypatch,
                                              clean_config_state):
    """``chip_smoke.py`` phase 9's sidecar runs on the CPU: 10017 twice
    in chunks of 4, each as a new process over one sidecar, write the
    JAX package's digests, and the sidecar its entries."""
    from repic_tpu_torch.utils.synthetic import output_digests

    with open(os.path.join(REPO, "tests", "golden",
                           "torch_port_runtime_digests.json")) as f:
        gold = json.load(f)["sidecar"]
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("REPIC_TPU_NO_CONFIG_CACHE", raising=False)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", str(gold["chunk"]))
    for run in ("first", "second"):
        _fresh_process(C)
        out = str(tmp_path / run)
        C.run_consensus_dir(os.path.join(REPO, "examples", "10017"), out,
                            180, device="cpu")
        assert output_digests(out, (".box",)) == gold[run], run
    assert json.load(open(_sidecar(tmp_path / "home"))) == gold["entries"]
