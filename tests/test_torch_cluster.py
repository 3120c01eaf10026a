"""The port's cluster runtime (``repic_tpu_torch.runtime.cluster``) and
the cluster half of its run journal, held to the JAX package.

Every case of ``tests/test_cluster.py`` and ``test_runtime_journal.py``
runs twice from the same process state (:mod:`torch_twin`): once as
written against ``repic_tpu``, once against ``repic_tpu_torch`` (the
CLI case on ``--device cpu``); the reference's assertions hold for
both, and the two directories the case leaves -- file set and every
journal, clocks dropped -- are equal.  Two cases read a coordination
directory one package wrote with the other package's readers.
"""

import json
import os

import pytest

from torch_twin import case_names, run_twins

CLUSTER_SUBS = (('"--no_mesh",', '"--no_mesh", "--device", "cpu",'),)


@pytest.mark.parametrize("name", case_names("test_cluster.py"))
def test_cluster_case_matches_reference(name, tmp_path, capsys):
    run_twins("test_cluster.py", name, tmp_path, CLUSTER_SUBS, capsys)


@pytest.mark.parametrize("name", case_names("test_runtime_journal.py"))
def test_runtime_journal_case_matches_reference(name, tmp_path):
    run_twins("test_runtime_journal.py", name, tmp_path)


def _write_cluster_dir(pkg: str, root: str) -> None:
    """Two hosts of ``pkg`` in one coordination directory: hA live with
    a lease and a journal, hB silent (backdated) with a lease, one
    done micrograph and a fence by hA."""
    import importlib

    base = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    cluster = importlib.import_module(f"{base}.runtime.cluster")
    journal = importlib.import_module(f"{base}.runtime.journal")
    t = {"now": 1000.0}

    def ctx(host, rank):
        cfg = cluster.ClusterConfig(
            coordination_dir=root, host_id=host, rank=rank, num_hosts=2,
            heartbeat_interval_s=0.5, host_timeout_s=2.0,
        )
        return cluster.ClusterContext(cfg, root, clock=lambda: t["now"])

    b = ctx("hB", 1)
    b.beat()
    b.plan_shard(["m0", "m1", "m2", "m3"])
    jb = journal.RunJournal.open(root, {"cfg": 1}, host="hB", cluster=True)
    jb.record("m2", "ok", out="m2.box")
    jb.close()
    t["now"] += 1.0
    a = ctx("hA", 0)
    a.beat()
    a.plan_shard(["m0", "m1", "m2", "m3"])
    ja = journal.RunJournal.open(root, {"cfg": 1}, host="hA", cluster=True)
    ja.record("m0", "ok", out="m0.box")
    ja.record("m1", "quarantined", error={"type": "X"})
    t["now"] += 10.0
    a.beat()
    orphans = a.harvest_orphans(ja, ["m0", "m1", "m2", "m3"])
    assert orphans == ["m3"]
    ja.record("m3", "ok", out="m3.box", reassigned_from="hB")
    ja.close()


def _read_back(pkg: str, root: str) -> dict:
    """Liveness and the merged journal, read by ``pkg``'s readers."""
    import importlib

    base = "repic_tpu" if pkg == "jax" else "repic_tpu_torch"
    cluster = importlib.import_module(f"{base}.runtime.cluster")
    journal = importlib.import_module(f"{base}.runtime.journal")
    with open(cluster.heartbeat_path(root, "hA")) as f:
        now = json.load(f)["ts"]
    view = cluster.read_liveness(root, 2.0, now=now + 0.5)
    live = {h: (s.rung, s.rank, s.lease_names, s.lease_epoch, s.fenced,
                s.fenced_by, s.stopped) for h, s in view.items()}
    merged = {n: (e["status"], e.get("host"), e.get("reassigned_from"))
              for n, e in journal.merged_latest(root).items()}
    return {"liveness": live, "merged": merged}


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")],
                         ids=["jax_reads_port", "port_reads_jax"])
def test_coordination_dir_reads_across_packages(tmp_path, writer, reader):
    """A directory written by one package's hosts reads the same through
    the other package's ``read_liveness`` and ``merged_latest`` as
    through the writer's own: the files are one format."""
    root = str(tmp_path / "coord")
    os.makedirs(root)
    _write_cluster_dir(writer, root)
    got = _read_back(reader, root)
    assert got == _read_back(writer, root)
    assert got["liveness"]["hB"][0] == "fenced"
    assert got["liveness"]["hB"][5] == "hA"
    assert got["liveness"]["hA"][0] == "live"
    assert got["merged"]["m3"] == ("ok", "hA", "hB")
    assert got["merged"]["m2"] == ("ok", "hB", None)


@pytest.mark.parametrize("argv", [["--gang-min-world", "2"],
                                  ["--gang-no-degrade"],
                                  ["--heartbeat-interval", "1"]],
                         ids=["gang_min_world", "gang_no_degrade",
                              "heartbeat_alone"])
def test_consensus_flag_checks_equal_reference(argv):
    """A flag that needs ``--gang`` or ``--coordination-dir`` without it:
    the reference's message, before anything runs."""
    import argparse

    from repic_tpu.commands import consensus as jcmd
    from repic_tpu_torch.commands import consensus as tcmd

    msgs = []
    for mod in (jcmd, tcmd):
        p = argparse.ArgumentParser()
        mod.add_arguments(p)
        with pytest.raises(SystemExit) as e:
            mod.main(p.parse_args(["in", "out", "48", *argv]))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_gang_is_refused_naming_its_roadmap_item(tmp_path):
    """``--gang`` runs now (ROADMAP Queue 1 item 8b is ported); what it
    refuses are the reference's refusals -- ``--stripes`` among them,
    before anything runs -- and, with no card, the default device."""
    import argparse

    import torch

    from repic_tpu_torch.commands import consensus as tcmd

    p = argparse.ArgumentParser()
    tcmd.add_arguments(p)
    with pytest.raises(ValueError, match="gang mode composes with the "
                       "plain-BOX batched path only"):
        tcmd.main(p.parse_args([str(tmp_path / "in"), str(tmp_path / "o"),
                                "48", "--gang", "--stripes", "2"]))
    assert not (tmp_path / "o").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tcmd.main(p.parse_args([str(tmp_path / "in"),
                                    str(tmp_path / "o"), "48", "--gang"]))
