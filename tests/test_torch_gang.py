"""The port's gang supervision (``repic_tpu_torch.parallel.gang``), its
global-batch layout and the gang path of ``run_consensus_dir``, held
to the JAX package.

26 of the 29 cases of ``tests/test_gang.py`` run twice from the same
process state (:mod:`torch_twin`): as written against ``repic_tpu``,
and against ``repic_tpu_torch`` with torchrun's launch variables where
the reference reads JAX's (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``)
and the directory runs on ``device="cpu"``; the reference's assertions
hold for both, and the directories the two leave -- file set and every
journal, clocks dropped -- are equal.  Three cases are not twins; each
has its counterpart here:

* ``test_runtime_identity_warns_on_private_module_drift`` reads
  ``jax._src``: the port's identity comes from torchrun's environment
  (:func:`test_runtime_identity_from_torchrun_env`);
* ``test_gang_chunk_entry_matches_unsharded`` runs the gang entry over
  a sharded mesh: here two hosts' local shards through
  ``gang_consensus_chunk`` plus the MAX exchange equal the unsharded
  batched program, bitwise
  (:func:`test_gang_chunk_two_host_shards_match_unsharded`);
* ``test_assemble_global_batch_pads_short_and_empty_shards`` builds a
  global ``jax.Array``: here its layout
  (:func:`test_assemble_global_batch_layout_pads_short_and_empty_shards`).

A cross-read case holds a coordination directory written by either
package's ``GangSupervisor`` readable by the other's.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from torch_twin import case_names, run_twins

NOT_TWINS = (
    "test_runtime_identity_warns_on_private_module_drift",
    "test_gang_chunk_entry_matches_unsharded",
    "test_assemble_global_batch_pads_short_and_empty_shards",
)

SUBS = (
    ("JAX_NUM_PROCESSES", "WORLD_SIZE"),
    ("JAX_PROCESS_ID", "RANK"),
    ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR"),
    ("str(plain), 180, use_mesh=False)",
     'str(plain), 180, use_mesh=False, device="cpu")'),
    ("180, gang=GangConfig()", '180, gang=GangConfig(), device="cpu"'),
    ("FIXTURE, str(out), 180,", 'FIXTURE, str(out), 180, device="cpu",'),
)

#: cases whose journals hold the chunk size of the gang's first chunk
#: in their ``gang_fault`` event: the reference sizes it over the 8
#: virtual CPU devices of the test session (a chunk of 8), the port
#: over its one device per process (a chunk of 3, the workload)
CHUNK_IN_FAULT = (
    "test_gang_stall_fault_reforms_and_completes",
    "test_gang_fault_budget_degrades_to_independent",
)
#: cases whose fault count depends on timing (a slow first chunk under
#: the case's 0.5 s deadline may add a fault and a re-formation; the
#: reference's assertions cover the invariants)
TIMED = ("test_gang_stall_fault_reforms_and_completes",)


def _drop_fault_chunk(view: dict) -> dict:
    return {
        "files": view["files"],
        "journals": {
            name: [{k: v for k, v in r.items()
                    if not (r.get("event") == "gang_fault"
                            and k == "chunk")}
                   for r in recs]
            for name, recs in view["journals"].items()
        },
    }


@pytest.mark.parametrize("name", case_names("test_gang.py",
                                            skip=NOT_TWINS))
def test_gang_case_matches_reference(name, tmp_path, capsys):
    views = run_twins("test_gang.py", name, tmp_path, SUBS, capsys,
                      compare=False)
    jax_v, port_v = views["jax"], views["port"]
    if name in CHUNK_IN_FAULT:
        jax_v, port_v = _drop_fault_chunk(jax_v), _drop_fault_chunk(port_v)
    if name in TIMED:
        # the fault-free prefix and the end state: one terminal record
        # per micrograph on both sides
        def terminal(view):
            return {n: sorted(
                (r["name"], r["status"]) for r in recs if "name" in r)
                for n, recs in view["journals"].items()}

        def files(view):  # one epoch record per re-formation
            return [f for f in view["files"]
                    if not f.startswith("out/_gang_epoch.")]

        assert files(port_v) == files(jax_v)
        assert terminal(port_v) == terminal(jax_v)
        return
    assert port_v == jax_v


def test_case_list_is_the_reference_file():
    names = [p.values[0] for p in case_names("test_gang.py")]
    assert len(names) == 29
    assert set(NOT_TWINS) <= set(names)


# -- the three counterparts ---------------------------------------------


def test_runtime_identity_from_torchrun_env(monkeypatch):
    """The port's counterpart of the reference's private-module drift
    case: without a group, identity is torchrun's ``RANK`` /
    ``WORLD_SIZE`` (a world of one is no identity), and a garbage value
    fails naming the variable."""
    from repic_tpu_torch.parallel import distributed

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.runtime_identity() is None
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    assert distributed.runtime_identity() == ("proc2", 2, 3)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.runtime_identity() is None
    monkeypatch.setenv("WORLD_SIZE", "three")
    with pytest.raises(ValueError, match="WORLD_SIZE='three'"):
        distributed.runtime_identity()


def test_gang_chunk_two_host_shards_match_unsharded():
    """Two hosts' local shards through ``gang_consensus_chunk``, each
    escalated from the MAX of both hosts' probes (what the all-reduce
    agrees), equal the unsharded batched program bitwise."""
    from repic_tpu_torch.parallel import distributed
    from repic_tpu_torch.pipeline.consensus import (
        _pack_box_outputs,
        _packed_probes,
        escalate_capacities,
        gang_consensus_chunk,
        make_batched_consensus,
    )

    rng = np.random.default_rng(0)
    m, k, n = 8, 3, 32
    xy = rng.uniform(50, 900, size=(m, k, n, 2)).astype(np.float32)
    conf = rng.uniform(0.05, 1.0, size=(m, k, n)).astype(np.float32)
    mask = np.ones((m, k, n), bool)
    # capacities that must escalate (d=2, cap=16), as a gang's first
    # chunk may
    d, cap, cell, pcap = 2, 16, 64, 16
    while True:
        shards, probes = [], []
        for rank in range(2):
            rows = distributed.shard_for_process(
                list(range(m)), process_id=rank, process_count=2)
            (sx, sc, sm), layout = distributed.assemble_global_batch(
                (xy[rows], conf[rows], mask[rows]), pad_rows_to=len(rows),
                process_id=rank, process_count=2)
            assert (layout.start, layout.stop) == (rows[0], rows[-1] + 1)
            res = gang_consensus_chunk(
                torch.from_numpy(sx), torch.from_numpy(sc),
                torch.from_numpy(sm), 180.0, max_neighbors=d,
                clique_capacity=cap, partial_capacity=pcap)
            shards.append(res)
            probes.append(_packed_probes(
                _pack_box_outputs(res).numpy()).max(axis=0))
        agreed = np.max(probes, axis=0)   # the MAX exchange
        d, cap, cell, pcap, retry = escalate_capacities(
            agreed, d, cap, cell, pcap, has_grid=False)
        if not retry:
            break
    assert d > 2 and cap > 16
    ref = make_batched_consensus(max_neighbors=d, clique_capacity=cap,
                                 partial_capacity=pcap)(
        torch.from_numpy(xy), torch.from_numpy(conf),
        torch.from_numpy(mask), 180.0)
    for field in ref._fields:
        got = torch.cat([getattr(s, field) for s in shards])
        assert torch.equal(got, getattr(ref, field)), field


def test_assemble_global_batch_layout_pads_short_and_empty_shards():
    """The layout half of the reference's global batch: short and
    empty local shards pad to the quota with zeros (all-masked rows),
    and the layout places each process's rows in the global batch."""
    from repic_tpu_torch.parallel import distributed

    quota = distributed.local_row_quota(0, 4)
    short = np.ones((quota - 2, 3), np.float32)
    empty = np.zeros((0, 3), np.float32)
    (g_short, g_empty), layout = distributed.assemble_global_batch(
        (short, empty), pad_rows_to=quota, process_id=2, process_count=3)
    assert g_short.shape == (quota, 3) and g_empty.shape == (quota, 3)
    np.testing.assert_array_equal(g_short[: quota - 2], short)
    assert not g_short[quota - 2:].any()
    assert not g_empty.any()
    assert layout == distributed.GlobalRows(rows=quota, world=3, rank=2)
    assert layout.global_rows == 3 * quota
    assert (layout.start, layout.stop) == (2 * quota, 3 * quota)
    # the same on tensors, and without a group the process is 0 of 1
    (t,), one = distributed.assemble_global_batch(
        (torch.ones(1, 2),), pad_rows_to=4)
    assert t.shape == (4, 2) and float(t[1:].abs().sum()) == 0.0
    assert (one.world, one.rank, one.global_rows) == (1, 0, 4)


# -- either package reads the other's coordination directory ------------


def _write_gang_dir(pkg: str, root: str) -> None:
    """A two-member gang of ``pkg`` in ``root`` with a stubbed group:
    h0 and h1 formed at epoch 1, h1's heartbeat aged out, h0 re-formed
    alone at epoch 2; journals with epoch-tagged records, a straggler's
    late write from epoch 1 among them."""
    base = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    gang = importlib.import_module(f"{base}.parallel.gang")
    cluster = importlib.import_module(f"{base}.runtime.cluster")
    journal_mod = importlib.import_module(f"{base}.runtime.journal")
    t = {"now": 1000.0}
    sups = {}
    for rank in (0, 1):
        cfg = gang.GangConfig(num_processes=2, process_id=rank,
                              host_timeout_s=1.0, reform_timeout_s=1.0)
        sup = gang.GangSupervisor(
            cfg, root, clock=lambda: t["now"],
            init_runtime=lambda *a: None, shutdown_runtime=lambda: True)
        sup.epoch, sup.mode = 1, "gang"
        ctx = cluster.ClusterContext(
            cluster.ClusterConfig(
                coordination_dir=root, host_id=f"h{rank}", rank=rank,
                num_hosts=2, heartbeat_interval_s=0.2, host_timeout_s=1.0),
            root, clock=lambda: t["now"])
        j = journal_mod.RunJournal.open(root, {"run": "gang"},
                                        host=ctx.host, cluster=True)
        ctx.beat()
        sup.bind(j, ctx)
        sups[rank] = (sup, j, ctx)
    s0, j0, c0 = sups[0]
    s1, j1, _c1 = sups[1]
    j0.record("m0", "ok", out="m0.box", gang_epoch=1, particles=3)
    j1.record("m1", "ok", out="m1.box", gang_epoch=1, particles=4)
    t["now"] += 5.0            # h1's heartbeat ages out
    c0.beat()
    s0.record_fault(gang.GangFault("x", kind="peer_dead", dead=("h1",)),
                    chunk=2, context="test")
    assert s0.reform(["m2", "m3"], chunk=2) == "gang"
    j0.record("m2", "ok", out="m2.box", gang_epoch=2, particles=5)
    t["now"] += 1.0
    # the straggler's late write of m2, from the dead epoch, loses
    j1.record("m2", "ok", out="m2.box", gang_epoch=1, particles=99)
    j0.record("m3", "ok", out="m3.box", gang_epoch=2, particles=6)
    j0.close()
    j1.close()


def _read_gang_dir(pkg: str, root: str) -> dict:
    base = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    gang = importlib.import_module(f"{base}.parallel.gang")
    journal_mod = importlib.import_module(f"{base}.runtime.journal")
    latest = gang.latest_epoch(root)
    records = {e: gang.read_epoch_record(root, e)
               for e in range(1, latest + 1)}
    for rec in records.values():
        rec.pop("ts", None)
    merged = {n: (e["status"], e.get("gang_epoch"), e.get("particles"),
                  e.get("host"))
              for n, e in journal_mod.merged_latest(root).items()}
    events = [(e["event"], e.get("gang_epoch"), e.get("host"))
              for e in journal_mod.read_all_journals(root)
              if str(e.get("event", "")).startswith("gang_")]
    return {"latest": latest, "records": records, "merged": merged,
            "events": sorted(events, key=repr)}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")],
                         ids=["jax_reads_port", "port_reads_jax"])
def test_gang_coordination_dir_reads_across_packages(tmp_path, writer,
                                                      reader):
    """Epoch records, member records and per-host journals with
    ``gang_epoch``, written by one package's supervisors, read the same
    through the other package's ``latest_epoch``, ``read_epoch_record``
    and merged fold as through the writer's own."""
    root = str(tmp_path / "coord")
    os.makedirs(root)
    _write_gang_dir(writer, root)
    got = _read_gang_dir(reader, root)
    assert got == _read_gang_dir(writer, root)
    assert got["latest"] == 2
    assert got["records"][2]["members"] == {"h0": 0}
    assert got["records"][2]["todo"] == ["m2", "m3"]
    assert got["merged"]["m2"] == ("ok", 2, 5, "h0")
    assert got["merged"]["m1"] == ("ok", 1, 4, "h1")
    with open(os.path.join(root, "_gang_member.h0.json")) as f:
        assert json.load(f)["epoch"] == 2


def test_reform_port_held_by_another_program_is_skipped(tmp_path):
    """A re-formation's leader publishes a port it can bind: while
    another program listens on ``reform_port_base + epoch``, the epoch
    record names the port 100 on, and the followers never wait on the
    other program's socket."""
    import socket

    from repic_tpu_torch.parallel.gang import GangConfig, GangSupervisor

    with socket.socket() as holder:
        holder.bind(("127.0.0.1", 0))
        holder.listen(1)
        held = holder.getsockname()[1]
        sup = GangSupervisor(GangConfig(reform_port_base=held - 2),
                             str(tmp_path))
        assert sup._reform_port(2) == held
        assert sup._free_reform_port(2) == held + 100
    assert sup._free_reform_port(2) == held
