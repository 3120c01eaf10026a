"""The chunk program's stage ranges, host-sync and ascent-step counts,
and the dispatch report that carries them (CPU, small ``lp_device``
batches).

* ``ascent_steps`` is the dual ascent's trip count, and ``host_syncs``
  every blocking read: the first-visit probe, each loop test of the
  ascent and of both greedy rounding solves (their rounds counted here
  by a plain row-by-row greedy), each compaction's boolean-mask
  selects and the packed fetch, over every attempt of the batch.
* With no profiler the ranges cost a flag check: no
  ``record_function`` is entered, no CUDA event built, no ``stage_ms``.
* Under a profiler the six stage ranges nest in ``consensus_dispatch``
  and the report carries their times.
* The journal's ``chunk_dispatches`` keeps the reference's four fields.
* The benchmark's nine readers return the reports' values.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repic_tpu_torch.ops import cliques
from repic_tpu_torch.parallel.batching import PaddedBatch
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.solver import dual
from repic_tpu_torch.telemetry import metrics
from repic_tpu_torch.utils import tracing
from repic_tpu_torch.utils.synthetic import synthesize

STAGES = ("consensus_neighbors", "consensus_join", "consensus_compact",
          "consensus_ascent", "consensus_rounding", "consensus_fetch")
# (pickers, particle spacing, jitter): crowded fields, so the ascent
# runs to its cap; K = 3 the full product, K = 5 the staged join with
# its compactions and escalations
FIELDS = {"k3": (3, 60.0, 40.0), "k5_staged": (5, 60.0, 40.0)}


def _batch(k, spacing=60.0, jitter=40.0, m=2, n=48, seed=0):
    xy, conf, mask = synthesize(m, k, n, seed=seed, spacing=spacing,
                                jitter=jitter)
    return PaddedBatch(xy=xy, conf=conf, mask=mask,
                       names=tuple(f"m{i}" for i in range(m)),
                       counts=np.full((m, k), n, np.int32))


@pytest.fixture
def fresh(monkeypatch):
    """A first visit of every shape (the probes run), telemetry on,
    and no report left over."""
    monkeypatch.setattr(tcons, "_LAST_GOOD_CONFIG", {})
    monkeypatch.setattr(tcons, "_RECENT_REQUIREMENTS", {})
    was = metrics.enabled()
    metrics.set_enabled(True)
    tcons.consume_dispatch_report()
    yield
    metrics.set_enabled(was)


def greedy_rounds(mv, w, valid) -> int:
    """Rounds of the parallel greedy, row by row in plain Python: a
    round picks every live clique that wins (weight desc, index asc)
    at each of its vertices, then drops every live clique that shares
    a vertex with a pick; the batch loops until its last row is done."""
    c, k = mv.shape[-2:]
    mv = mv.reshape(-1, c, k).numpy()
    w = w.reshape(-1, c).numpy()
    valid = valid.reshape(-1, c).numpy()
    most = 0
    for row in range(len(w)):
        alive = {i for i in range(c) if valid[row, i] and w[row, i] > 0}
        rounds = 0
        while alive:
            rounds += 1
            best = {}
            for i in alive:
                for v in mv[row, i]:
                    best[v] = max(best.get(v, (-np.inf, 0)),
                                  (w[row, i], -i))
            picks = {i for i in alive
                     if all(best[v] == (w[row, i], -i) for v in mv[row, i])}
            used = {v for i in picks for v in mv[row, i]}
            alive = {i for i in alive - picks
                     if not used.intersection(mv[row, i])}
        most = max(most, rounds)
    return most


class Recorder:
    """The solver inputs of every ascent and greedy solve, and the
    boolean-mask selects of every compaction, of the batches run while
    it is installed."""

    def __init__(self, monkeypatch):
        self.ascents, self.greedy, self.selects = [], [], 0
        self.on = True
        real_solve = dual.solve_dual_decomposition
        real_greedy = dual.solve_greedy
        real_compact = cliques._stream_compact

        def solve(*args, **kw):
            if self.on:
                self.ascents.append(args)
            return real_solve(*args, **kw)

        def greedy(mv, w, valid, v):
            if self.on:
                self.greedy.append((mv, w, valid))
            return real_greedy(mv, w, valid, v)

        def compact(block, keep):
            if self.on:
                self.selects += 2 * len(block)
            return real_compact(block, keep)

        self.real_solve = real_solve
        monkeypatch.setattr(dual, "solve_dual_decomposition", solve)
        monkeypatch.setattr(dual, "solve_greedy", greedy)
        monkeypatch.setattr(cliques, "_stream_compact", compact)

    def steps(self) -> list[int]:
        """The ascents' trips, solved again on their inputs."""
        self.on = False
        return [int(self.real_solve(*a).iterations.max())
                for a in self.ascents]

    def syncs(self, probes: int, fetches: int) -> int:
        """Each loop runs one test more than its trips."""
        return (probes + fetches + self.selects
                + sum(s + 1 for s in self.steps())
                + sum(greedy_rounds(*g) + 1 for g in self.greedy))


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_counts_equal_the_solves_and_reads(fresh, monkeypatch, field):
    k, spacing, jitter = FIELDS[field]
    rec = Recorder(monkeypatch)
    tcons.run_consensus_batch(_batch(k, spacing, jitter), 180.0,
                              device="cpu")
    report = tcons.consume_dispatch_report()
    assert len(rec.ascents) == report["attempts"]
    assert len(rec.greedy) == 2 * report["attempts"]
    assert report["ascent_steps"] == sum(rec.steps()) > 0
    assert report["host_syncs"] == rec.syncs(
        probes=1, fetches=report["attempts"])
    if field == "k5_staged":
        assert rec.selects > 0 and report["attempts"] > 1
    assert "stage_ms" not in report


def test_a_forced_escalation_counts_the_rejected_attempt(fresh, monkeypatch):
    rec = Recorder(monkeypatch)
    batch = _batch(3, 150.0, 10.0)
    tcons.run_consensus_batch(batch, 180.0, device="cpu", clique_capacity=8)
    report = tcons.consume_dispatch_report()
    assert report["attempts"] == 2
    assert report["dispatches"] == 1      # the accepted attempt's fetch
    assert report["ascent_steps"] == sum(rec.steps())
    assert report["host_syncs"] == rec.syncs(probes=1, fetches=2)
    # the memo now holds the escalated capacities: one attempt, no probe
    rec2 = Recorder(monkeypatch)
    tcons.run_consensus_batch(batch, 180.0, device="cpu", clique_capacity=8)
    again = tcons.consume_dispatch_report()
    assert again["attempts"] == 1
    assert again["host_syncs"] == rec2.syncs(probes=0, fetches=1)
    assert report["host_syncs"] > again["host_syncs"] + 1


def test_no_profiler_enters_no_range_and_builds_no_event(fresh,
                                                         monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not tracing.profiling()
    assert tracing.annotate("consensus_join", timed=True) is \
        tracing.annotate("x")
    tcons.run_consensus_batch(_batch(5), 180.0, device="cpu")
    report = tcons.consume_dispatch_report()
    assert report["host_syncs"] > 0
    assert "stage_ms" not in report
    assert "stage_ms" not in tcons.recent_dispatch_reports(1)[-1]


def _nested_in(trace_path, outer):
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("ph") == "X"]
    outers = [e for e in ranges if e["name"] == outer]
    found = set()
    for e in ranges:
        if any(o["tid"] == e["tid"] and o["ts"] <= e["ts"]
               and e["ts"] + e["dur"] <= o["ts"] + o["dur"]
               for o in outers):
            found.add(e["name"])
    return found


def test_profiler_trace_nests_the_six_ranges_in_dispatch(fresh, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tcons.run_consensus_batch(_batch(5), 180.0, device="cpu")
    report = tcons.consume_dispatch_report()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert set(STAGES) <= _nested_in(path, "consensus_dispatch")
    assert sorted(report["stage_ms"]) == sorted(STAGES)
    assert all(v >= 0.0 for v in report["stage_ms"].values())


def test_journaled_chunk_dispatches_keep_four_fields(tmp_path,
                                                      monkeypatch):
    """A profiled directory run (the chunks on the profiled thread)
    leaves reports with the stage split, and journals only the
    reference's fields."""
    from torch_port_common import write_box_dir
    from torch_runtime_common import run_port_dir

    from repic_tpu_torch.runtime.journal import read_journal

    monkeypatch.setenv(tcons.NO_PREFETCH_ENV, "1")
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    data = write_box_dir(tmp_path, m=3)
    out = str(tmp_path / "out")
    with profile(activities=[ProfilerActivity.CPU]):
        run_port_dir(data, out, 64, telemetry=True)
    assert "stage_ms" in tcons.recent_dispatch_reports(1)[-1]
    events = [e for e in read_journal(out)
              if e.get("event") == "chunk_dispatches"]
    assert len(events) == 2
    for e in events:
        fields = set(e) - {"event", "ts", "trace", "host"}
        assert fields == set(tcons.JOURNAL_DISPATCH_FIELDS)


def test_recent_reports_leave_the_slot_and_keep_64(fresh):
    for seed in range(3):
        tcons.run_consensus_batch(_batch(3, 150.0, 10.0, seed=seed),
                                  180.0, device="cpu")
    last = tcons.recent_dispatch_reports(2)
    assert len(last) == 2 and tcons.recent_dispatch_reports(0) == []
    assert tcons.consume_dispatch_report() is last[-1]
    assert len(tcons.recent_dispatch_reports(1000)) <= 64


READERS = {
    **{f"consensus.{s.split('_', 1)[1]}_ms_per_mic": s for s in STAGES},
    "consensus.host_syncs_per_chunk": "host_syncs",
    "consensus.ascent_steps_per_chunk": "ascent_steps",
    "consensus.attempts_per_chunk": "attempts",
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_benchmark_readers_return_the_reports(fresh, name, monkeypatch):
    from portbench import run

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(root)
    spec = run.resolve(run.load_manifest(root), "k5_mixed.consensus")
    assert name in {m["name"] for m in spec["per_layer"]}
    read = run.load_reader(name)
    with profile(activities=[ProfilerActivity.CPU]):
        for seed in range(3):
            tcons.run_consensus_batch(_batch(3, 150.0, 10.0, seed=seed),
                                      180.0, device="cpu")
    reports = tcons.recent_dispatch_reports(3)
    key = READERS[name]
    if key in STAGES:
        want = (sum(r["stage_ms"][key] for r in reports)
                / sum(r["micrographs"] for r in reports))
    else:
        want = sum(r[key] for r in reports) / 3
    trace = {"steps": 3, "units": 6, "busy_s": 0.0, "window_s": 0.0}
    assert read({"kind": "consensus", "trace": trace}) == \
        pytest.approx(want, rel=1e-12)
    assert read({"kind": "pick", "trace": trace}) is None
    assert read({"kind": "consensus", "trace": None}) is None
