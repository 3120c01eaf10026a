"""The port's device mesh and process group
(``repic_tpu_torch.parallel.mesh``, ``.distributed``) and the chunk
arithmetic over a mesh, held to the JAX package.

The cases of ``tests/test_sharding.py`` and the non-slow case of
``test_distributed.py``, on the CPU: a mesh here is four CPU devices
(``consensus_mesh([cpu] * 4)``), over which a chunk runs one slice per
device; the sharded run must equal the one-device run bit for bit and
end in the JAX package's bytes.  ``_auto_chunk`` must equal the
reference's for 1-8 devices over a grid of sizes.  One case forms a
real two-rank ``gloo`` group in two processes.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repic_tpu_torch.parallel import distributed, mesh as tmesh
from repic_tpu_torch.parallel.batching import bucket_size, pad_batch
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.utils.box_io import BoxSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "10017")
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_10017")
CPU4 = [torch.device("cpu")] * 4


def _random_sets(rng, k, n_per, spread=1500.0):
    return [
        BoxSet(
            xy=rng.uniform(0, spread, size=(n_per, 2)).astype(np.float32),
            conf=rng.uniform(0.1, 1.0, size=n_per).astype(np.float32),
            wh=np.zeros((n_per, 2), np.float32),
        )
        for _ in range(k)
    ]


def _micros(m, n=30, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"m{i}", _random_sets(rng, 3, n + i)) for i in range(m)]


def test_consensus_mesh_devices():
    """No card: the default mesh is the CPU alone, memoized; given
    devices are kept in their order."""
    if not torch.cuda.is_available():
        assert tmesh.consensus_mesh() == (torch.device("cpu"),)
    assert tmesh.consensus_mesh() is tmesh.consensus_mesh()
    assert tmesh.consensus_mesh(CPU4) == tuple(CPU4)
    assert tmesh.micrograph_pspec() == (tmesh.MICROGRAPH_AXIS,)
    assert tmesh.mesh_axis_names() == ("micrographs",)


def test_bucket_size_equals_reference():
    from repic_tpu.parallel.batching import bucket_size as jbucket

    for n in range(1, 3000, 7):
        assert bucket_size(n) == jbucket(n), n


def test_batch_padding_to_mesh():
    from repic_tpu.parallel.batching import pad_batch as jpad

    micros = _micros(5)
    batch = pad_batch(micros, pad_micrographs_to=8)
    want = jpad(micros, pad_micrographs_to=8)
    assert batch.xy.shape[0] == 8 and batch.num_micrographs == 5
    assert not batch.mask[5:].any()
    for f in ("xy", "conf", "mask"):
        np.testing.assert_array_equal(getattr(batch, f), getattr(want, f))


@pytest.mark.parametrize("solver,pallas", [
    ("lp_device", False), ("lp_device_fused", False), ("lp_device", True),
    ("greedy", False),
])
def test_sharded_equals_single_device(solver, pallas):
    """One chunk of 8 over four CPU devices (two rows each) against the
    same chunk on one: the packed result is bitwise equal."""
    batch = pad_batch(_micros(7), pad_micrographs_to=8)
    kw = dict(solver=solver, use_pallas=pallas, device="cpu")
    res_m, packed_m = tcons.run_consensus_batch(batch, 180.0, mesh=CPU4,
                                                **kw)
    res_1, packed_1 = tcons.run_consensus_batch(batch, 180.0, **kw)
    np.testing.assert_array_equal(packed_m, packed_1)
    for f in tcons.ConsensusResult._fields:
        assert torch.equal(getattr(res_m, f), getattr(res_1, f)), f


def test_padded_micrographs_produce_no_cliques():
    batch = pad_batch(_micros(1), pad_micrographs_to=8)
    res, _ = tcons.run_consensus_batch(batch, 180.0, mesh=CPU4,
                                       device="cpu")
    assert (res.num_cliques[1:] == 0).all()
    assert not res.picked[1:].any()


def test_output_layout_over_the_mesh():
    """``shard_over_micrographs`` slices contiguously, one slice per
    device; ``make_batched_consensus(mesh=)`` concatenates in
    micrograph order and equals :func:`consensus_one`."""
    batch = pad_batch(_micros(6, n=16), pad_micrographs_to=8)
    xy, conf, mask = (torch.from_numpy(getattr(batch, f))
                      for f in ("xy", "conf", "mask"))
    sx, sc, sm = tmesh.shard_over_micrographs(CPU4, xy, conf, mask)
    assert [t.shape[0] for t in sx] == [2, 2, 2, 2]
    assert torch.equal(torch.cat(sx), xy) and torch.equal(torch.cat(sm),
                                                          mask)
    assert tmesh.slice_bounds(7, 4) == [(0, 2), (2, 4), (4, 6), (6, 7)]
    assert tmesh.slice_bounds(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    fn = tcons.make_batched_consensus(mesh=CPU4, max_neighbors=16,
                                      clique_capacity=1024)
    got = fn(xy, conf, mask, 180.0)
    want = tcons.consensus_one(xy, conf, mask, 180.0, max_neighbors=16,
                               clique_capacity=1024)
    for f in tcons.ConsensusResult._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("chunk", [None, "3"], ids=["auto", "chunk3"])
def test_mesh_directory_run_equals_jax_bytes(tmp_path, monkeypatch, chunk):
    """10017 fused over four CPU devices -- one chunk, or chunks of 3
    rounded up to the mesh (4) -- writes the JAX package's BOX files
    byte for byte (``tests/golden/torch_port_10017``)."""
    monkeypatch.setenv("REPIC_TPU_NO_CONFIG_CACHE", "1")
    if chunk:
        monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", chunk)
    out = str(tmp_path / "o")
    stats = tcons.run_consensus_dir(EXAMPLES, out, 180, device="cpu",
                                    solver="lp_device_fused", mesh=CPU4)
    assert stats["chunk"] % 4 == 0
    want_dir = os.path.join(GOLDEN, "lp_device_fused")
    for f in sorted(os.listdir(want_dir)):
        with open(os.path.join(want_dir, f), "rb") as a, \
                open(os.path.join(out, f), "rb") as b:
            assert a.read() == b.read(), f


def test_auto_chunk_equals_reference(monkeypatch):
    from repic_tpu.pipeline.consensus import _auto_chunk as jauto

    for explicit in (None, "1", "5", "64"):
        if explicit is None:
            monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
        else:
            monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", explicit)
        for n_dev in range(1, 9):
            for n in (1, 2, 3, 7, 8, 12, 31, 256, 1000):
                for k, nb in ((3, 64), (3, 1024), (5, 4096), (2, 96)):
                    assert (tcons._auto_chunk(n, k, nb, n_dev)
                            == jauto(n, k, nb, n_dev)), (explicit, n_dev,
                                                         n, k, nb)


def test_plan_request_over_a_mesh_equals_reference():
    """The engine's plan with ``n_dev`` devices: the reference's chunk
    sizes and padded micrograph counts."""
    from repic_tpu.pipeline import engine as jengine
    from repic_tpu_torch.pipeline import engine as tengine

    micros = _micros(13, n=20)
    for n_dev in (1, 2, 3, 4, 8):
        got = tengine.plan_request(micros, 180, n_dev=n_dev)
        want = jengine.plan_request(micros, 180, n_dev=n_dev)
        assert (got.chunk, got.n_dev, got.capacity) == (
            want.chunk, want.n_dev, want.capacity)
        assert [(c.names, c.micrographs) for c in got.chunks] == [
            (c.names, c.micrographs) for c in want.chunks]


def test_distributed_single_process_noop(monkeypatch):
    """``initialize()`` outside a multi-process launch creates no group
    and returns False; there is then no runtime identity."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.runtime_identity() is None
    assert distributed.shutdown() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False


def test_env_int_error_text_equals_reference(monkeypatch):
    from repic_tpu.parallel import distributed as jdist

    monkeypatch.setenv("WORLD_SIZE", "two")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "two")
    with pytest.raises(ValueError) as got:
        distributed.initialize()
    with pytest.raises(ValueError) as want:
        jdist._env_int("JAX_NUM_PROCESSES")
    assert str(got.value).replace("repic_tpu_torch", "repic_tpu").replace(
        "WORLD_SIZE", "JAX_NUM_PROCESSES") == str(want.value)


def test_shard_for_process_partitions_equal_reference():
    from repic_tpu.parallel import distributed as jdist

    for n_items in (0, 1, 5, 10, 13):
        items = list(range(n_items))
        for count in (1, 2, 3, 4):
            shards = [distributed.shard_for_process(items, i, count)
                      for i in range(count)]
            assert [x for s in shards for x in s] == items
            assert shards == [jdist.shard_for_process(items, i, count)
                              for i in range(count)]
            for i in range(count):
                assert (distributed.local_row_quota(len(shards[i]), 2)
                        == jdist.local_row_quota(len(shards[i]), 2))


def test_pad_rows_to_roundtrip():
    """The padding half of the reference's ``assemble_global_batch``:
    short (or empty) local arrays gain zero rows, numpy or torch."""
    local = np.arange(12, dtype=np.float32).reshape(3, 4)
    (a, b) = distributed.pad_rows_to(
        (local, torch.from_numpy(local[:0].copy())), 4)
    np.testing.assert_array_equal(a[:3], local)
    assert a.shape == (4, 4) and not a[3].any()
    assert b.shape == (4, 4) and not b.any()
    (c,) = distributed.pad_rows_to((local,), None)
    assert c is local


WORKER = """
import os, sys, json
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from repic_tpu_torch.parallel import distributed
from repic_tpu_torch.runtime.cluster import resolve_identity
ok = distributed.initialize()
ident = distributed.runtime_identity()
t = torch.tensor([dist.get_rank() + 1.0])
dist.all_reduce(t)
shard = distributed.shard_for_process(list(range(10)))
print(json.dumps({{"ok": ok, "ident": ident, "sum": float(t[0]),
                   "shard": shard, "cluster": resolve_identity(),
                   "backend": dist.get_backend()}}))
assert distributed.shutdown() is True
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_group():
    """Two processes with torchrun's environment form one ``gloo``
    group: identity ``proc<rank>`` of 2 (the cluster runtime's default
    identity too), a working all-reduce, disjoint shards."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), CUDA_VISIBLE_DEVICES="")
        for var in ("REPIC_TPU_HOST_ID", "REPIC_TPU_HOST_RANK",
                    "REPIC_TPU_NUM_HOSTS"):
            env.pop(var, None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER.format(repo=REPO)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(__import__("json").loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, o in enumerate(outs):
        assert o["ok"] is True and o["backend"] == "gloo"
        assert o["ident"] == [f"proc{rank}", rank, 2]
        assert o["cluster"] == [f"proc{rank}", rank, 2]
        assert o["sum"] == 3.0
    assert outs[0]["shard"] + outs[1]["shard"] == list(range(10))
