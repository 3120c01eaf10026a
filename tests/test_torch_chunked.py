"""The port's memory-bounded chunking against ``repic_tpu``'s.

The cases of ``tests/test_chunked_consensus.py``: a chunked run writes
the single batch's bytes, and the reference's, with
``REPIC_CONSENSUS_CHUNK`` set; the chunk estimator; OOM halving (a
chunk that runs out of memory is retried at half size, with the
reference's chunk sequence, paddings and memo updates, so the bytes
are the reference's); and ``get_cliques``' artifacts with and without
chunks.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from repic_tpu.pipeline import consensus as jcons
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.runtime.journal import read_journal
from tests.golden.make_torch_port_golden import run_jax_get_cliques
from torch_port_common import write_box_dir
from torch_runtime_common import assert_same_run, run_jax_dir, run_port_dir


def _data(tmp_path, m=5):
    return write_box_dir(tmp_path, m=m, n=40)


def _read_all(out):
    return {f: open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out)) if f.endswith(".box")}


@pytest.mark.parametrize("chunk", ["2", "3"])
def test_chunked_equals_single_batch(tmp_path, monkeypatch, chunk):
    data = _data(tmp_path)
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    single, _ = run_port_dir(data, str(tmp_path / "single"), 64)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", chunk)
    out, j_out = str(tmp_path / "chunked"), str(tmp_path / "jax")
    stats, _ = run_port_dir(data, out, 64)
    j_stats, _ = run_jax_dir(data, j_out, 64)
    assert_same_run((out, stats), (j_out, j_stats))
    assert stats["chunk"] == j_stats["chunk"] == int(chunk)
    assert stats["chunks"] == -(-5 // int(chunk))
    assert stats["num_cliques"] == single["num_cliques"]
    assert stats["particle_counts"] == single["particle_counts"]
    assert _read_all(out) == _read_all(str(tmp_path / "single"))


def test_auto_chunk_estimator():
    # a small workload: one chunk covers it
    assert tcons._auto_chunk(12, 3, 1024) >= 12
    # a dense 1,024-micrograph workload: well below 1,024
    c = tcons._auto_chunk(1024, 5, 1024)
    assert 1 <= c < 1024 and c & (c - 1) == 0
    assert tcons._auto_chunk(1024, 5, 65536) == 1


def test_oom_halving(tmp_path, monkeypatch):
    """A chunk that runs out of memory is retried at half size: the
    same batch sizes tried, the same bytes, as the reference."""
    data = _data(tmp_path, m=8)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "4")
    sizes = {}
    outs = {}
    for name, mod, run in (("port", tcons, run_port_dir),
                           ("jax", jcons, run_jax_dir)):
        real = mod.run_consensus_batch
        calls = sizes.setdefault(name, [])

        def fake(batch, *a, _real=real, _calls=calls, **k):
            _calls.append(batch.xy.shape[0])
            if batch.xy.shape[0] > 2:
                raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory")
            return _real(batch, *a, **k)

        monkeypatch.setattr(mod, "run_consensus_batch", fake)
        out = str(tmp_path / name)
        outs[name] = (out, run(data, out, 64)[0])
    assert_same_run(outs["port"], outs["jax"])
    assert sizes["port"] == sizes["jax"] == [4, 2, 2, 2, 2]
    out, stats = outs["port"]
    assert stats["chunk"] == 2 and len(_read_all(out)) == 8
    halved = [e for e in read_journal(out) if e.get("event") == "chunk_halved"]
    assert [e["chunk"] for e in halved] == [2]


def test_real_oom_error_type_halves(tmp_path, monkeypatch):
    """``torch.cuda.OutOfMemoryError`` (the card's allocator) walks the
    halving rung like the reference's RESOURCE_EXHAUSTED."""
    import torch

    data = _data(tmp_path, m=4)
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "4")
    real = tcons.run_consensus_batch
    calls = []

    def fake(batch, *a, **k):
        calls.append(batch.xy.shape[0])
        if batch.xy.shape[0] > 1:
            raise torch.cuda.OutOfMemoryError("CUDA error: allocator")
        return real(batch, *a, **k)

    monkeypatch.setattr(tcons, "run_consensus_batch", fake)
    stats, _ = run_port_dir(data, str(tmp_path / "o"), 64, strict=True)
    assert calls == [4, 2, 1, 1, 1, 1] and stats["chunk"] == 1
    assert len(stats["particle_counts"]) == 4


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True)])
def test_two_phase_cli_chunked_parity(tmp_path, monkeypatch, flags):
    """``get_cliques``' artifacts are the same whole or in chunks (the
    particle ids keep their order across chunk boundaries), and equal
    the reference's."""
    from repic_tpu_torch.commands import get_cliques

    multi_out, get_cc = flags
    data = _data(tmp_path)

    def run(out, chunk=None):
        if chunk:
            monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", str(chunk))
        else:
            monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
        tcons._LAST_GOOD_CONFIG.clear()
        tcons._RECENT_REQUIREMENTS.clear()
        get_cliques.main(SimpleNamespace(
            in_dir=data, out_dir=str(tmp_path / out), box_size=64,
            multi_out=multi_out, get_cc=get_cc, max_neighbors=16,
            no_mesh=True, device="cpu"))
        return tmp_path / out

    whole, chunked = run("whole"), run("chunked", chunk=2)
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    ref = tmp_path / "jax"
    run_jax_get_cliques(data, str(ref), 64, multi_out=multi_out,
                        get_cc=get_cc)
    pickles = sorted(p.name for p in whole.glob("*.pickle"))
    assert pickles and pickles == sorted(p.name for p in ref.glob("*.pickle"))
    for name in pickles:
        a = pickle.load(open(whole / name, "rb"))
        for other in (chunked, ref):
            b = pickle.load(open(other / name, "rb"))
            if name.endswith("constraint_matrix.pickle"):
                assert a.shape == b.shape and (a != b).nnz == 0
            elif name.endswith("consensus_coords.pickle"):
                assert a == b
            else:
                assert np.array_equal(a, b)
