"""The port's request trace, ``trace`` command and SLO tracker against
``repic_tpu``'s.

The cases of ``tests/test_trace.py`` (the serve daemon's aside): the
trace context and its ``_trace.jsonl``, the trace id on every span,
event, log and journal record while a context is active, the worker
thread's handoff, the torn artifact, per-host files; ``summarize``
(dict), ``critical_path`` and ``render_waterfall`` (text) given the
same records in both packages; the ``trace`` command's JSON and text
equal to the reference command's on the same directory; and the SLO
tracker's summaries.  Also: a prefetched multi-chunk run of the port
keeps the trace id on the worker's spans and journal records.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from repic_tpu.main import main as jcli
from repic_tpu.telemetry import server as jserver
from repic_tpu.telemetry import trace as jtrace
from repic_tpu_torch import telemetry as ttelemetry
from repic_tpu_torch.main import main as tcli
from repic_tpu_torch.runtime.journal import RunJournal, read_journal
from repic_tpu_torch.telemetry import events as tevents
from repic_tpu_torch.telemetry import server as tserver
from repic_tpu_torch.telemetry import trace as ttrace
from torch_port_common import write_box_dir
from torch_runtime_common import run_port_dir


def _records(seed=0, n_chunks=3):
    """A seeded trace artifact's records: a root and a CLI run's
    segments with cache counts, overlaps and gaps."""
    rng = np.random.default_rng(seed)
    t = 1000.0
    recs = [{"ev": "trace", "trace": "t1", "t": t, "kind": "cli",
             "run_id": "r"}]
    recs.append({"ev": "segment", "trace": "t1", "seg": "load", "t": t,
                 "dur_s": 0.25, "micrographs": 7})
    t += 0.25
    for c in range(n_chunks):
        comp = float(rng.uniform(0, 0.5)) if c == 0 else 0.0
        exe = float(rng.uniform(0.1, 2.0))
        emit = float(rng.uniform(0.01, 0.3))
        recs.append({"ev": "segment", "trace": "t1", "seg": "compile",
                     "t": round(t, 6), "dur_s": round(comp, 6),
                     "chunk": c, "cache_hits": int(c > 0),
                     "cache_misses": int(c == 0)})
        recs.append({"ev": "segment", "trace": "t1", "seg": "execute",
                     "t": round(t + comp, 6), "dur_s": round(exe, 6),
                     "chunk": c, "micrographs": 2, "capacity": 128})
        t += comp + exe
        # the emit overlaps the next chunk's execute a little
        recs.append({"ev": "segment", "trace": "t1", "seg": "emit",
                     "t": round(t - 0.01, 6), "dur_s": round(emit, 6),
                     "chunk": c, "micrographs": 2})
        t += emit + float(rng.uniform(0, 0.02))
    recs.append({"ev": "trace", "trace": "t2", "t": t, "kind": "serve",
                 "job": "j9"})
    recs.append({"ev": "segment", "trace": "t2", "seg": "queue_wait",
                 "t": t, "dur_s": 0.5})
    recs.append({"ev": "segment", "trace": "t2", "seg": "execute",
                 "t": t + 5.0, "dur_s": 1.0})
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_summarize_render_critical_path_equal_reference(seed):
    recs = _records(seed)
    events = [{"ev": "span", "name": "consensus_dispatch", "trace": "t1",
               "device_tail_s": 0.125, "host_s": 0.5},
              {"ev": "span", "name": "consensus_dispatch", "trace": "t1",
               "device_tail_s": 0.25, "host_s": 0.5},
              {"ev": "span", "name": "write", "trace": "t1"}]
    got, want = ttrace.summarize(recs), jtrace.summarize(recs)
    assert got == want
    for tid, tr in got.items():
        segs = tr["segments"]
        assert ttrace.critical_path(segs) == jtrace.critical_path(segs)
        assert ttrace.render_waterfall(tid, tr, events=events) == \
            jtrace.render_waterfall(tid, want[tid], events=events)
        assert ttrace.render_waterfall(tid, tr, width=12) == \
            jtrace.render_waterfall(tid, want[tid], width=12)
    assert got["t1"]["cache"] == {"hits": 2, "misses": 1}
    text = ttrace.render_waterfall("t1", got["t1"], events=events)
    assert "device tail (from 2 dispatch span(s)" in text
    assert ttrace.critical_path([]) == []
    assert ttrace.render_waterfall("x", {"segments": []}) == \
        jtrace.render_waterfall("x", {"segments": []})


def test_scope_writes_root_and_segments(tmp_path):
    out = str(tmp_path)
    with ttrace.scope(out, kind="cli", job="j1") as ctx:
        assert ttrace.current_trace_id() == ctx.trace_id
        ttrace.add_segment("plan", 1.0, 0.25, micrographs=3)
        with ttrace.segment("emit", chunk=0):
            time.sleep(0.01)
    assert ttrace.current_trace_id() is None
    records = ttrace.read_trace(out)
    assert records == jtrace.read_trace(out)
    assert [r["ev"] for r in records] == ["trace", "segment", "segment"]
    root, plan, emit = records
    assert root["kind"] == "cli" and root["job"] == "j1"
    assert {r["trace"] for r in records} == {ctx.trace_id}
    assert plan["seg"] == "plan" and plan["dur_s"] == 0.25
    assert emit["seg"] == "emit" and emit["dur_s"] >= 0.01


def test_add_segment_is_noop_without_active_context(tmp_path):
    ttrace.add_segment("execute", 0.0, 1.0)
    ctx = ttrace.start(None)
    token = ttrace.activate(ctx)
    try:
        ttrace.add_segment("execute", 0.0, 1.0)
    finally:
        ttrace.deactivate(token)
        ctx.close()
    assert not os.path.exists(ttrace.trace_path(str(tmp_path)))


def test_records_carry_the_trace_id_while_active(tmp_path):
    out = str(tmp_path)
    rt = ttelemetry.start_run(out, flush_interval_s=0)
    try:
        with ttrace.scope(out, kind="cli") as ctx:
            with tevents.span("traced_stage"):
                pass
            tevents.event("traced_event")
            tevents.get_logger("t").info("traced log")
            j = RunJournal(out)
            j.record("mic0", "ok")
            j.record_event("chunk_retry")
            j.close()
        with tevents.span("untraced_stage"):
            pass
        j = RunJournal(out)
        j.record("mic1", "ok")
        j.close()
    finally:
        ttelemetry.finish_run(rt)
    by_name = {r.get("name") or r.get("msg"): r
               for r in tevents.read_events(out)}
    for key in ("traced_stage", "traced_event", "traced log"):
        assert by_name[key]["trace"] == ctx.trace_id, key
    assert "trace" not in by_name["untraced_stage"]
    journal = read_journal(out)
    assert [e.get("trace") for e in journal] == [ctx.trace_id] * 2 + [None]


def test_thread_target_propagates_context(tmp_path):
    seen = {}

    def probe(key):
        seen[key] = ttrace.current_trace_id()

    with ttrace.scope(str(tmp_path)) as ctx:
        bare = threading.Thread(target=probe, args=("bare",))
        bound = threading.Thread(target=ttrace.thread_target(probe, "bound"))
        bare.start(), bound.start()
        bare.join(timeout=10), bound.join(timeout=10)
    assert not bare.is_alive() and not bound.is_alive()
    assert seen["bare"] is None
    assert seen["bound"] == ctx.trace_id


def test_prefetch_worker_keeps_the_trace(tmp_path, monkeypatch):
    """A run in chunks of one, the worker one chunk ahead: its spans
    nest in the right parents and every span, journal record and
    ladder event carries the run's trace id."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    monkeypatch.delenv("REPIC_TPU_NO_PREFETCH", raising=False)
    data = write_box_dir(tmp_path, m=4)
    out = str(tmp_path / "out")
    run_port_dir(data, out, 64, telemetry=True, plan=("oom:chunk:mic2:1",))
    (root,) = [r for r in ttrace.read_trace(out) if r["ev"] == "trace"]
    tid = root["trace"]
    spans = [r for r in tevents.read_events(out) if r.get("ev") == "span"]
    assert spans and all(r.get("trace") == tid for r in spans)
    names = {r["span"]: r["name"] for r in spans}
    parents = {r["name"]: names.get(r.get("parent")) for r in spans}
    assert parents["consensus_dispatch"] == "consensus_chunk"
    assert parents["consensus_chunk"] is None
    journal = read_journal(out)
    assert any("event" in e for e in journal)
    assert all(e.get("trace") == tid for e in journal)
    segs = [r["seg"] for r in ttrace.read_trace(out) if r["ev"] == "segment"]
    assert segs[0] == "load" and segs.count("emit") == 4


def test_torn_tail_artifact_still_renders(tmp_path, capsys):
    out = str(tmp_path)
    with ttrace.scope(out, kind="serve", job="j9") as ctx:
        ttrace.add_segment("queue_wait", 100.0, 0.5)
        ttrace.add_segment("execute", 100.5, 2.0, chunk=0)
    with open(ttrace.trace_path(out), "a") as f:
        f.write('{"ev": "segment", "trace": "' + ctx.trace_id)
    assert len(ttrace.read_trace(out)) == 3
    tcli(["trace", out])
    rendered = capsys.readouterr().out
    jcli(["trace", out])
    assert rendered == capsys.readouterr().out
    assert ctx.trace_id in rendered
    assert "queue_wait" in rendered and "execute[0]" in rendered
    assert "critical path" in rendered


def test_trace_cli_json_equals_reference(tmp_path, capsys):
    out = str(tmp_path)
    with ttrace.scope(out, kind="cli") as ctx:
        ttrace.add_segment("execute", 1.0, 1.0)
    tcli(["trace", out, "--json"])
    got = json.loads(capsys.readouterr().out)
    jcli(["trace", out, "--json"])
    assert got == json.loads(capsys.readouterr().out)
    assert got["traces"][ctx.trace_id]["segment_totals"] == {"execute": 1.0}
    with pytest.raises(SystemExit):
        tcli(["trace", str(tmp_path / "nowhere")])


def test_per_host_trace_files_merge(tmp_path):
    out = str(tmp_path)
    tids = {}
    for host in ("h1", "h2"):
        ctx = ttrace.start(out, host=host, kind="cli")
        token = ttrace.activate(ctx)
        try:
            ttrace.add_segment("execute", 1.0, 1.0)
        finally:
            ttrace.deactivate(token)
            ctx.close()
        tids[host] = ctx.trace_id
    assert not os.path.exists(ttrace.trace_path(out))
    for host in ("h1", "h2"):
        assert ttrace.trace_path(out, host=host) == \
            jtrace.trace_path(out, host=host)
        assert os.path.exists(ttrace.trace_path(out, host=host))
    summaries = ttrace.summarize(ttrace.read_trace(out))
    assert set(summaries) == set(tids.values())
    assert summaries == jtrace.summarize(jtrace.read_trace(out))


def test_trace_cli_lists_jobs_in_work_dir(tmp_path, capsys):
    jobs = tmp_path / "jobs"
    for jid in ("j1", "j2"):
        with ttrace.scope(str(jobs / jid), job=jid):
            ttrace.add_segment("execute", 1.0, 1.0)
    os.makedirs(jobs / "j3")
    tcli(["trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert "j1" in out and "j2" in out and "j3" not in out
    tcli(["trace", str(tmp_path), "j2"])
    assert "execute" in capsys.readouterr().out


# -- SLO tracking -----------------------------------------------------------


def test_parse_slo_targets():
    for specs in (None, ["job=60", "queue_wait=5@0.99"]):
        assert tserver.parse_slo_targets(specs) == \
            jserver.parse_slo_targets(specs)
    for bad in ("job", "job=0", "job=10@1.5", "=5", "job=x"):
        with pytest.raises(ValueError):
            tserver.parse_slo_targets([bad])


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_tracker_summary_equals_reference(seed):
    rng = np.random.default_rng(seed)
    obs = [(str(rng.choice(["job", "queue_wait", "tenant:a"])),
            float(rng.exponential(1.0)), bool(rng.random() > 0.1),
            None if rng.random() < 0.5 else int(rng.choice([256, 512])))
           for _ in range(60)]
    trackers = {}
    for name, mod in (("port", tserver), ("jax", jserver)):
        tr = mod.SLOTracker(objectives={"job": (1.0, 0.9)}, window=16)
        for ep, lat, ok, bucket in obs:
            tr.observe(ep, lat, ok=ok, bucket=bucket)
        trackers[name] = tr
    assert trackers["port"].summary() == trackers["jax"].summary()
    for ep in ("job", "tenant:a", "queue_wait", "none"):
        assert trackers["port"].budget_burn(ep) == \
            trackers["jax"].budget_burn(ep)


def test_slo_tracker_percentiles_and_burn():
    tracker = tserver.SLOTracker(objectives={"job": (1.0, 0.9)}, window=100)
    for _ in range(8):
        tracker.observe("job", 0.5)
    tracker.observe("job", 3.0)
    tracker.observe("job", 4.0, ok=False)
    ep = tracker.summary()["endpoints"]["job"]
    assert ep["count"] == 10 and ep["p50_s"] == pytest.approx(0.5)
    assert ep["p99_s"] == pytest.approx(4.0)
    assert ep["compliance"] == pytest.approx(0.8)
    assert ep["budget_burn"] == pytest.approx(2.0)
    tracker.observe("queue_wait", 0.1)
    qw = tracker.summary()["endpoints"]["queue_wait"]
    assert "budget_burn" not in qw and qw["p50_s"] > 0
    window = tserver.SLOTracker(window=4)
    for i in range(10):
        window.observe("job", float(i), bucket=256)
    assert window.summary()["endpoints"]["job"]["by_bucket"]["256"][
        "count"] == 4


def test_observe_slo_noop_without_tracker():
    assert tserver.get_slo_tracker() is None
    tserver.observe_slo("job", 1.0)


def test_route_labels_are_bounded():
    for path in ("/v1/jobs", "/v1/jobs/abc123", "/v1/jobs/abc/artifacts",
                 "/v1/jobs/a/artifacts/m1.box", "/healthz/ready",
                 "/metrics", "/status", "/favicon.ico"):
        assert tserver._route(path) == jserver._route(path)
    assert tserver._route("/v1/jobs/abc123") == "job"
