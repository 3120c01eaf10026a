"""The port's fault-tolerant directory runs against ``repic_tpu``'s.

The cases of ``tests/test_runtime_resilient.py``: each scenario runs
the same seeded directory under the same fault plan through both
packages (each with its own ``faults``) and compares the output
directories -- the file set, BOX and manifest bytes
(:func:`torch_runtime_common.assert_same_run`), the journal projected to
name, status, solver, particles, out and the error's type/kind/path
plus the ladder events, and ``stats["quarantined"]``,
``["resumed"]`` and ``["journal"]`` -- then checks the reference
test's own assertions on the port.  Also: the chunk engine's prefetch
(on and off give the same bytes and journal; an early ``close()``
joins the worker), the ``solver_diverge`` and ``megakernel_fallback``
demotions, and a bad BOX file in ``examples/10017``, which the port
used to die on with an empty output directory.
"""

import json
import os
import shutil
import threading

import pytest

from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.runtime import faults as tfaults
from repic_tpu_torch.runtime.journal import read_journal
from repic_tpu_torch.utils import box_io as tbox
from torch_port_common import corrupt_box, write_box_dir
from torch_runtime_common import (
    FAST_POLICY, assert_same_run, run_jax_dir, run_port_dir,
)

pytestmark = pytest.mark.faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "10017")
#: the JAX package's runtime digests on 10017 (the card's phase 9)
RUNTIME_DIGESTS = os.path.join(REPO, "tests", "golden",
                               "torch_port_runtime_digests.json")


def _both(tmp_path, tag, data, box=64, **kw):
    """One scenario through both packages; returns the two
    ``(out_dir, stats)`` pairs after asserting them equal."""
    p_out, j_out = str(tmp_path / f"{tag}_port"), str(tmp_path / f"{tag}_jax")
    p_stats, p_fired = run_port_dir(data, p_out, box, **kw)
    j_stats, j_fired = run_jax_dir(data, j_out, box, **kw)
    assert p_fired == j_fired, "the plan fired at other points"
    assert_same_run((p_out, p_stats), (j_out, j_stats))
    return (p_out, p_stats), (j_out, j_stats)


def _latest(out):
    return {e["name"]: e for e in read_journal(out) if "name" in e}


def _boxes(out):
    return {f: open(os.path.join(out, f)).read()
            for f in sorted(os.listdir(out)) if f.endswith(".box")}


def test_lenient_run_quarantines_and_resumes(tmp_path, monkeypatch):
    """One corrupt BOX file and one injected OOM: the run completes,
    quarantines the bad micrograph, and ``resume`` after the repair
    processes only that one."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    data = write_box_dir(tmp_path)
    corrupt_box(data, "mic2")
    (out, stats), (j_out, _) = _both(tmp_path, "a", data,
                                     plan=("oom:chunk:1",),
                                     policy=FAST_POLICY)
    assert sorted(stats["quarantined"]) == ["mic2"]
    info = stats["quarantined"]["mic2"]
    assert info["type"] == "BoxParseError" and "mic2.box" in info["message"]
    assert not os.path.exists(os.path.join(out, "mic2.box"))
    assert sorted(stats["particle_counts"]) == [
        f"mic{i}" for i in range(6) if i != 2]
    latest = _latest(out)
    assert latest["mic2"]["error"]["path"].endswith("picker0/mic2.box")
    assert any(e["status"] == "retried" for e in latest.values())
    assert stats["journal"]["quarantined"] == 1

    with open(os.path.join(data, "picker0", "mic2.box"), "wt") as f:
        f.write("100 100 64 64 0.9\n150 150 64 64 0.8\n")
    before = len(read_journal(out))
    p2, _ = run_port_dir(data, out, 64, resume=True, policy=FAST_POLICY)
    j2, _ = run_jax_dir(data, j_out, 64, resume=True, policy=FAST_POLICY)
    assert_same_run((out, p2), (j_out, j2))
    assert p2["resumed"] == 5 and p2["quarantined"] == {}
    assert sorted(p2["particle_counts"]) == ["mic2"]
    new = read_journal(out)[before:]
    assert [e["name"] for e in new if "name" in e] == ["mic2"]
    assert new[-1]["status"] == "ok"


def test_injected_corrupt_box_quarantines_then_resumes(tmp_path):
    data = write_box_dir(tmp_path, m=4)
    (out, stats), (j_out, _) = _both(tmp_path, "b", data,
                                     plan=("corrupt_box:mic3", "oom:chunk:1"),
                                     policy=FAST_POLICY)
    assert sorted(stats["quarantined"]) == ["mic3"]
    assert sorted(stats["particle_counts"]) == ["mic0", "mic1", "mic2"]
    p2, _ = run_port_dir(data, out, 64, resume=True)
    j2, _ = run_jax_dir(data, j_out, 64, resume=True)
    assert_same_run((out, p2), (j_out, j2))
    assert p2["resumed"] == 3 and sorted(p2["particle_counts"]) == ["mic3"]
    assert _latest(out)["mic3"]["status"] == "ok"


def test_strict_mode_fails_fast_on_corrupt_input(tmp_path):
    data = write_box_dir(tmp_path, m=3)
    corrupt_box(data, "mic1")
    with pytest.raises(tbox.BoxParseError, match="mic1.box"):
        run_port_dir(data, str(tmp_path / "out"), 64, strict=True)


def test_strict_mode_fails_fast_on_persistent_oom(tmp_path, monkeypatch):
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    data = write_box_dir(tmp_path, m=3)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        run_port_dir(data, str(tmp_path / "out"), 64,
                     plan=("oom:chunk:inf",), strict=True)


def test_per_micrograph_fallback_and_quarantine(tmp_path, monkeypatch):
    """The chunk's ladder spent: each micrograph alone; the one that
    still fails is quarantined, the rest complete degraded."""
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    data = write_box_dir(tmp_path, m=4)
    (out, stats), _ = _both(tmp_path, "c", data,
                            plan=("oom:chunk:inf", "oom:mic:mic1:inf"),
                            policy=FAST_POLICY)
    assert sorted(stats["quarantined"]) == ["mic1"]
    assert stats["quarantined"]["mic1"]["kind"] == "oom"
    assert sorted(stats["particle_counts"]) == ["mic0", "mic2", "mic3"]
    latest = _latest(out)
    assert latest["mic1"]["status"] == "quarantined"
    assert all(latest[n]["status"] == "degraded"
               for n in ("mic0", "mic2", "mic3"))
    events = [e["event"] for e in read_journal(out) if "event" in e]
    assert "per_micrograph_fallback" in events


def test_transient_error_retries_then_succeeds(tmp_path, monkeypatch):
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    data = write_box_dir(tmp_path, m=3)
    (out, stats), _ = _both(tmp_path, "d", data, plan=("io:chunk:1",),
                            policy=FAST_POLICY)
    assert stats["quarantined"] == {} and len(stats["particle_counts"]) == 3
    assert all(e["status"] == "retried" for e in _latest(out).values())


def test_crash_then_resume_matches_fresh_run(tmp_path, monkeypatch):
    """A strict run killed mid-directory, then resumed, writes the bytes
    of an uninterrupted run."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    data = write_box_dir(tmp_path, m=5)
    out, j_out = str(tmp_path / "out"), str(tmp_path / "jax")
    with pytest.raises(RuntimeError):
        run_port_dir(data, out, 64, plan=("oom:chunk:mic3:inf",),
                     strict=True)
    with pytest.raises(RuntimeError):
        run_jax_dir(data, j_out, 64, plan=("oom:chunk:mic3:inf",),
                    strict=True)
    done_before = set(_boxes(out))
    assert done_before and "mic3.box" not in done_before
    assert_same_run((out, None), (j_out, None))
    stats, _ = run_port_dir(data, out, 64, resume=True, strict=True)
    j_stats, _ = run_jax_dir(data, j_out, 64, resume=True, strict=True)
    assert_same_run((out, stats), (j_out, j_stats))
    assert stats["resumed"] == len(done_before)
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK")
    fresh = str(tmp_path / "fresh")
    run_port_dir(data, fresh, 64)
    assert _boxes(out) == _boxes(fresh)


@pytest.mark.parametrize("plan,budget,rung", [
    ((), None, "exact"),
    (("solver_budget:exact:inf",), None, "lp"),
    (("solver_budget:exact:inf", "solver_budget:lp:inf"), None, "greedy"),
    ((), -1.0, "lp"),
])
def test_solver_budget_degradation_is_journaled(tmp_path, plan, budget,
                                                rung):
    """exact -> lp -> greedy, the rung that ran journaled per
    micrograph."""
    data = write_box_dir(tmp_path, m=2)
    (out, stats), _ = _both(tmp_path, "e", data, plan=plan,
                            solver="exact", solver_budget_s=budget)
    latest = _latest(out)
    assert all(e["solver"] == rung for e in latest.values())
    status = "ok" if rung == "exact" else "degraded"
    assert all(e["status"] == status for e in latest.values())
    assert stats["solver_rungs"] == {n: rung for n in latest}


def test_exact_solver_plain_path_output_format(tmp_path):
    data = write_box_dir(tmp_path, m=2, n=20)
    (out, stats), _ = _both(tmp_path, "f", data, solver="exact")
    for name, count in stats["particle_counts"].items():
        bs = tbox.read_box(os.path.join(out, name + ".box"))
        assert bs.n == count > 0


def test_resume_config_mismatch_restarts_from_scratch(tmp_path):
    data = write_box_dir(tmp_path, m=2)
    outs = {}
    for run, name in ((run_port_dir, "port"), (run_jax_dir, "jax")):
        out = str(tmp_path / name)
        run(data, out, 64)
        with open(os.path.join(out, "stale_extra.box"), "wt") as f:
            f.write("999 999 64 64 1.0\n")
        outs[name] = (out, run(data, out, 128, resume=True)[0])
    assert_same_run(outs["port"], outs["jax"])
    out, stats = outs["port"]
    assert stats["resumed"] == 0 and len(stats["particle_counts"]) == 2
    assert not os.path.exists(os.path.join(out, "stale_extra.box"))


def test_solver_budget_requires_exact(tmp_path):
    data = write_box_dir(tmp_path, m=1)
    with pytest.raises(ValueError, match="solver='exact'"):
        run_port_dir(data, str(tmp_path / "o"), 64, solver="lp",
                     solver_budget_s=5.0)
    assert not os.path.exists(tmp_path / "o")


def test_outputs_are_atomic_no_temp_residue(tmp_path):
    data = write_box_dir(tmp_path, m=3)
    (out, _), _ = _both(tmp_path, "g", data)
    assert [f for f in os.listdir(out) if ".tmp" in f] == []


@pytest.mark.parametrize("solver,plan", [
    ("lp_device", ("solver_diverge:mic1:1",)),
    ("lp_device_fused", ("megakernel_fallback:mic2:1",
                         "solver_diverge:mic0:1")),
])
def test_fault_driven_demotions_match_reference(tmp_path, monkeypatch,
                                                solver, plan):
    """A named micrograph's device packing re-solved on the host ladder
    (``solver_degraded`` journaled, the micrograph degraded), over two
    chunks, the BOX bytes re-rendered from the new picks."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    data = write_box_dir(tmp_path, m=4)
    (out, stats), _ = _both(tmp_path, "h", data, plan=plan, solver=solver)
    events = [e for e in read_journal(out) if "event" in e]
    assert len(events) == len(plan)
    assert {e["event"] for e in events} == {"solver_degraded"}
    degraded = {e["micrograph"] for e in events}
    latest = _latest(out)
    assert {n for n, e in latest.items()
            if e["status"] == "degraded"} == degraded


def test_fault_driven_demotion_counts_the_fallback(tmp_path):
    from repic_tpu_torch.ops import megakernel

    data = write_box_dir(tmp_path, m=2)
    before = megakernel.FALLBACKS.get("fault", 0)
    run_port_dir(data, str(tmp_path / "o"), 64, solver="lp_device_fused",
                 plan=("megakernel_fallback:mic0:1",))
    assert megakernel.FALLBACKS["fault"] == before + 1


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetch_on_and_off_give_the_same_run(tmp_path, monkeypatch,
                                               prefetch):
    """The engine one chunk ahead in its worker thread or serial: the
    same bytes, journal and statistics as the reference, with a halved
    chunk, a retried one and a demotion on the way."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    if prefetch:
        monkeypatch.delenv("REPIC_TPU_NO_PREFETCH", raising=False)
    else:
        monkeypatch.setenv("REPIC_TPU_NO_PREFETCH", "1")
    data = write_box_dir(tmp_path, m=7)
    _both(tmp_path, "p", data, solver="lp_device_fused",
          plan=("oom:chunk:mic2:1", "io:chunk:mic4:1",
                "megakernel_fallback:mic5:1"),
          policy=FAST_POLICY)


def _loaded(data):
    pickers = tbox.discover_picker_dirs(data)
    names = tbox.micrograph_names(os.path.join(data, pickers[0]))
    return [(n, tbox.load_micrograph_set(data, pickers, n)) for n in names]


def test_prefetch_yields_the_serial_sequence(tmp_path, monkeypatch):
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    loaded = _loaded(write_box_dir(tmp_path, m=5))
    runs = []
    for prefetch in (True, False):
        tcons._LAST_GOOD_CONFIG.clear()
        tcons._RECENT_REQUIREMENTS.clear()
        runs.append([
            ([n for n, _ in part], batch.names, extras.tobytes())
            for part, batch, _res, extras, _s in tcons.iter_consensus_chunks(
                loaded, 64.0, device="cpu", prefetch=prefetch)
        ])
    assert runs[0] == runs[1] and len(runs[0]) == 3


def _prefetch_workers():
    return [t for t in threading.enumerate()
            if t.name == "repic-chunk-prefetch" and t.is_alive()]


def test_early_close_joins_the_worker(tmp_path, monkeypatch):
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    loaded = _loaded(write_box_dir(tmp_path, m=4))
    closed = []

    def engine(*a, **kw):
        try:
            yield from serial(*a, **kw)
        finally:
            closed.append(threading.current_thread().name)

    serial = tcons._iter_chunks_serial
    monkeypatch.setattr(tcons, "_iter_chunks_serial", engine)
    gen = tcons.iter_consensus_chunks(loaded, 64.0, device="cpu",
                                      prefetch=True)
    first = next(gen)
    assert [n for n, _ in first[0]] == ["mic0"]
    assert _prefetch_workers()
    gen.close()
    assert not _prefetch_workers()
    # the engine was closed in the worker's own thread
    assert closed == ["repic-chunk-prefetch"]


def test_engine_error_reaches_the_consumer(tmp_path, monkeypatch):
    """A strict failure inside the worker re-raises in the consumer at
    the chunk it belongs to, after the chunks before it."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    loaded = _loaded(write_box_dir(tmp_path, m=3))
    seen = []
    with tfaults.fault_plan("io:chunk:mic1:inf"):
        with pytest.raises(OSError, match="chunk:mic1"):
            for part, *_ in tcons.iter_consensus_chunks(
                    loaded, 64.0, device="cpu", prefetch=True, strict=True):
                seen.append(part[0][0])
    assert seen == ["mic0"] and not _prefetch_workers()


@pytest.mark.parametrize("prefetch", [False, True])
def test_cancel_stops_at_a_chunk_boundary(tmp_path, monkeypatch, prefetch):
    """Serial, the poll stops the loop before the next chunk; with the
    worker one chunk ahead, at most one chunk later."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    loaded = _loaded(write_box_dir(tmp_path, m=4))
    seen = []
    with pytest.raises(tcons.ConsensusCancelled, match="deadline"):
        for part, *_ in tcons.iter_consensus_chunks(
                loaded, 64.0, device="cpu", prefetch=prefetch,
                cancel=lambda: "deadline" if seen else None):
            seen.append(part[0][0])
    want = ["mic0"] if not prefetch else ["mic0", "mic1"][:len(seen)]
    assert seen == want and len(seen) >= 1 and not _prefetch_workers()


def _copy_examples(root):
    d = os.path.join(str(root), "in")
    shutil.copytree(EXAMPLES, d)
    return d


def test_bad_box_file_in_10017_is_quarantined(tmp_path):
    """Formerly the port died with a traceback and an empty OUT_DIR on
    this input; now the 11 other BOX files, a ``quarantined`` journal
    line and ``stats["quarantined"]`` naming the file, as the reference
    does -- here with ``chip_smoke.py`` phase 9's fault plan (a halved
    chunk, a demoted micrograph).  Resume after the repair writes the
    12th.  The port also meets the committed JAX digests of both runs,
    which the card is held to."""
    from repic_tpu_torch.utils.synthetic import journal_view, output_digests

    with open(RUNTIME_DIGESTS) as f:
        gold = json.load(f)
    data = _copy_examples(tmp_path)
    picker, name = gold["bad_box"][: -len(".box")].split("/")
    path = corrupt_box(data, name, picker, gold["bad_text"])
    (out, stats), (j_out, _) = _both(tmp_path, "q", data, box=180,
                                     solver=gold["solver"],
                                     plan=tuple(gold["plan"]))
    assert list(stats["quarantined"]) == [name]
    assert stats["quarantined"][name]["path"] == path
    assert len([f for f in os.listdir(out) if f.endswith(".box")]) == 11
    assert _latest(out)[name]["status"] == "quarantined"
    want = gold["lenient"]
    assert output_digests(out, (".box",)) == want["boxes"]
    assert journal_view(out, data) == want["journal"]
    assert stats["journal"] == want["summary"]
    events = [e["event"] for e in read_journal(out) if "event" in e]
    assert sorted(events) == ["chunk_halved", "solver_degraded"]
    shutil.copy(os.path.join(EXAMPLES, picker, name + ".box"), path)
    p2, _ = run_port_dir(data, out, 180, resume=True, solver=gold["solver"])
    j2, _ = run_jax_dir(data, j_out, 180, resume=True, solver=gold["solver"])
    assert_same_run((out, p2), (j_out, j2))
    assert p2["resumed"] == 11 and list(p2["particle_counts"]) == [name]
    assert output_digests(out, (".box",)) == gold["resumed"]["boxes"]
    assert journal_view(out, data) == gold["resumed"]["journal"]


def test_10017_out_dir_equals_reference(tmp_path):
    """A clean run of 10017 writes the reference's files (telemetry
    off): the BOX files, ``_journal.jsonl``, ``_manifest.json``,
    ``_trace.jsonl`` and ``consensus_runtime.tsv``."""
    (out, _), _ = _both(tmp_path, "x", EXAMPLES, box=180)
    assert sorted(f for f in os.listdir(out) if not f.endswith(".box")) == [
        "_journal.jsonl", "_manifest.json", "_trace.jsonl",
        "consensus_runtime.tsv"]
