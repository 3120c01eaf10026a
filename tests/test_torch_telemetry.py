"""The port's metrics, events, probes, sinks and stage timer against
``repic_tpu``'s.

The cases of ``tests/test_telemetry.py`` and ``tests/test_tracing.py``:
each gives both packages the same operations and compares what they
produce -- registry snapshots, the JSON snapshot, the Prometheus text
(bytes), span/event/log records with clocks and ids dropped, the
runtime TSV (bytes) -- then checks the reference test's assertions on
the port.  Also the read half of the multi-host journal, the port's
probes on the CPU (nothing to measure: empty values) and its build
counters, and a real ``torch.profiler`` session.
"""

import json
import os
import time

import numpy as np
import pytest

from repic_tpu.runtime import journal as jjournal
from repic_tpu.telemetry import events as jevents
from repic_tpu.telemetry import metrics as jmetrics
from repic_tpu.telemetry import sinks as jsinks
from repic_tpu.utils import tracing as jtracing
from repic_tpu_torch import telemetry as ttelemetry
from repic_tpu_torch.runtime import journal as tjournal
from repic_tpu_torch.telemetry import devicetime as tdevicetime
from repic_tpu_torch.telemetry import events as tevents
from repic_tpu_torch.telemetry import metrics as tmetrics
from repic_tpu_torch.telemetry import probes as tprobes
from repic_tpu_torch.telemetry import sinks as tsinks
from repic_tpu_torch.utils import tracing as ttracing

PACKAGES = {
    "jax": (jmetrics, jevents, jsinks),
    "port": (tmetrics, tevents, tsinks),
}


def _both(fn):
    """``fn(metrics, events, sinks)`` for each package."""
    return {name: fn(*mods) for name, mods in PACKAGES.items()}


def _registry_ops(metrics, events, sinks):
    """The reference tests' registry operations; the snapshot."""
    reg = metrics.MetricsRegistry(enabled=True)
    c = reg.counter("c_total", "help text")
    c.inc()
    c.inc(2.5)
    c.inc(rung="exact")
    c.inc(3, rung="exact")
    g = reg.gauge("g", "a gauge")
    g.set(4.0, host="a")
    g.add(1.5, host="a")
    g.set(7.0, host="b")
    g.set(float("nan"), host="c")
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    h.observe(0.2, name="x")
    assert reg.counter("c_total") is c
    with pytest.raises(ValueError):
        reg.gauge("c_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    return reg


def test_registry_semantics_and_snapshot_equal_reference():
    got = _both(lambda m, e, s: _registry_ops(m, e, s).as_dict())
    assert got["port"] == got["jax"]
    reg = _registry_ops(tmetrics, tevents, tsinks)
    c = reg.counter("c_total")
    assert c.value() == 3.5 and c.value(rung="exact") == 4.0
    assert c.value(rung="lp") == 0.0
    assert reg.gauge("g").value(host="a") == 5.5
    snap = reg.histogram("h_seconds").snapshot()
    assert snap["counts"] == [1, 2, 1, 1] and snap["count"] == 5
    assert snap["sum"] == pytest.approx(56.05)
    assert reg.as_dict()["g"]["samples"][2]["value"] is None


def test_disabled_registry_is_noop_in_both():
    def run(metrics, events, sinks):
        reg = metrics.MetricsRegistry(enabled=False)
        c = reg.counter("c_total")
        h = reg.histogram("h_seconds")
        c.inc()
        h.observe(1.0)
        reg.gauge("g").set(5)
        assert c.value() == 0.0 and h.snapshot() is None
        return reg.as_dict()

    got = _both(run)
    assert got["port"] == got["jax"]
    assert all(not e["samples"] for e in got["port"].values())


def test_disabled_mode_overhead_smoke():
    reg = tmetrics.MetricsRegistry(enabled=False)
    c = reg.counter("c_total")
    t0 = time.perf_counter()
    for _ in range(20_000):
        c.inc()
    saved = tmetrics.REGISTRY._enabled
    tmetrics.REGISTRY._enabled = False
    try:
        for _ in range(20_000):
            with tevents.span("noop"):
                pass
    finally:
        tmetrics.REGISTRY._enabled = saved
    assert time.perf_counter() - t0 < 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentile_and_diff_snapshots_equal_reference(seed):
    rng = np.random.default_rng(seed)
    values = rng.exponential(1.0, size=int(rng.integers(1, 40))).tolist()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert tmetrics.percentile(values, q) == \
            jmetrics.percentile(values, q)
    assert tmetrics.percentile([], 0.5) == jmetrics.percentile([], 0.5)

    def run(metrics, events, sinks):
        reg = metrics.MetricsRegistry(enabled=True)
        c = reg.counter("c_total")
        h = reg.histogram("h_seconds", buckets=(0.5, 2.0))
        g = reg.gauge("g")
        c.inc(2, k="a")
        h.observe(float(values[0]))
        base = reg.as_dict()
        c.inc(3, k="a")
        c.inc(1, k="b")
        for v in values:
            h.observe(float(v))
        g.set(9.0)
        return metrics.diff_snapshots(reg.as_dict(), base)

    got = _both(run)
    assert got["port"] == got["jax"]


def _sample_registry(metrics):
    reg = metrics.MetricsRegistry(enabled=True)
    reg.counter("repic_c_total", "a counter").inc(3, kind="x")
    reg.counter("repic_c_total", "a counter").inc(1, kind='q"u\\o\nte')
    reg.gauge("repic_g", "a gauge").set(1.5)
    h = reg.histogram(
        "repic_h_seconds", "a histogram", buckets=(0.1, 1.0)
    )
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    return reg


def test_sinks_write_the_reference_bytes(tmp_path):
    """The JSON snapshot reads back the registry; the Prometheus
    textfile is the reference's byte for byte."""
    texts = {}
    for name, (metrics, _events, sinks) in PACKAGES.items():
        reg = _sample_registry(metrics)
        d = tmp_path / name
        d.mkdir()
        sinks.write_metrics_json(str(d / "_metrics.json"), reg)
        assert sinks.read_metrics_json(str(d)) == reg.as_dict()
        sinks.write_prometheus_textfile(str(d / "_metrics.prom"), reg)
        texts[name] = (d / "_metrics.prom").read_bytes()
        assert sinks.render_prometheus(reg.as_dict()).encode() == \
            texts[name]
    assert texts["port"] == texts["jax"]
    text = texts["port"].decode()
    assert 'repic_c_total{kind="x"} 3' in text
    assert "repic_g 1.5" in text
    assert 'repic_h_seconds_bucket{le="0.1"} 1' in text
    assert 'repic_h_seconds_bucket{le="1"} 2' in text
    assert 'repic_h_seconds_bucket{le="+Inf"} 3' in text
    assert "repic_h_seconds_count 3" in text
    assert tsinks.render_prometheus({}) == jsinks.render_prometheus({})


def test_runtime_tsv_bytes_equal_reference(tmp_path):
    stages = [("load", 0.5), ("load", 0.25), ("compute", 1.0 / 3)]
    a = tsinks.write_runtime_tsv(str(tmp_path / "p"), stages)
    b = jsinks.write_runtime_tsv(str(tmp_path / "j"), stages)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a).read().startswith("load\t0.500000\nload\t0.250000\n")


# -- events --------------------------------------------------------------


def _with_log(events, path, fn):
    log = events.EventLog(path)
    prev = events.set_current_log(log)
    try:
        fn()
    finally:
        events.set_current_log(prev)
        log.close()
    return events.read_events(path), log.run_id


def _shape(records):
    """Records without clocks and ids; span/parent ids renumbered in
    order of appearance."""
    ids: dict = {}
    out = []
    for r in records:
        r = {k: v for k, v in r.items() if k not in ("t", "dur_s", "run")}
        for key in ("span", "parent"):
            if key in r:
                r[key] = ids.setdefault(r[key], len(ids))
        out.append(r)
    return out


def test_span_event_log_records_equal_reference(tmp_path, capsys):
    def run(metrics, events, sinks):
        def work():
            with events.span("outer", micrographs=2):
                with events.span("inner"):
                    events.event("capacity_escalated", cap=2048)
                with events.span("inner"):
                    pass
            with pytest.raises(ValueError):
                with events.span("fails"):
                    raise ValueError("boom")
            events.get_logger("consensus").info("chunk retried",
                                                attempt=2)

        path = str(tmp_path / f"{metrics.__name__}.jsonl")
        records, run_id = _with_log(events, path, work)
        assert {r["run"] for r in records} == {run_id}
        return _shape(records)

    got = _both(run)
    assert got["port"] == got["jax"]
    spans = [r for r in got["port"] if r["ev"] == "span"]
    assert [s["name"] for s in spans] == ["inner", "inner", "outer",
                                          "fails"]
    assert spans[2]["micrographs"] == 2 and "parent" not in spans[2]
    assert all(s["parent"] == spans[2]["span"] for s in spans[:2])
    assert spans[3]["error"] == "ValueError"
    out = capsys.readouterr().out
    assert out.count("repic-tpu INFO [consensus] chunk retried attempt=2") \
        == 2


def test_logger_level_threshold(capsys, monkeypatch):
    monkeypatch.setenv("REPIC_TPU_LOG_LEVEL", "warning")
    log = tevents.get_logger("t")
    log.info("hidden")
    log.warning("shown")
    captured = capsys.readouterr()
    assert "hidden" not in captured.out + captured.err
    assert "shown" in captured.err


def test_spans_noop_without_run_log(tmp_path):
    with tevents.span("lonely"):
        pass
    assert tevents.read_events(str(tmp_path)) == []


def test_read_events_merges_hosts_and_tolerates_torn_lines(tmp_path):
    (tmp_path / "_events.h1.jsonl").write_text(
        json.dumps({"ev": "event", "name": "a", "t": 1.0}) + "\n"
        + json.dumps({"ev": "event", "name": "c", "t": 3.0}) + "\n"
    )
    (tmp_path / "_events.h2.jsonl").write_text(
        json.dumps({"ev": "event", "name": "b", "t": 2.0}) + "\n"
        + '{"ev": "eve'
    )
    torn = tmp_path / "one.jsonl"
    torn.write_text(json.dumps({"ev": "event", "name": "a"})
                    + "\n{\"ev\": \"spa")
    for events in (tevents, jevents):
        assert [r["name"] for r in events.read_events(str(tmp_path))] \
            == ["a", "b", "c"]
        assert [r["name"] for r in events.read_events(str(torn))] == ["a"]
        assert events.read_events("/nonexistent/evlog.jsonl") == []
        assert events.host_events_name("h/1") == "_events.h_1.jsonl"


# -- run lifecycle -------------------------------------------------------


def test_start_run_per_host_artifact_names(tmp_path):
    rt = ttelemetry.start_run(str(tmp_path), host="h1",
                              flush_interval_s=0)
    try:
        with tevents.span("stage_a"):
            pass
    finally:
        ttelemetry.finish_run(rt)
    assert (tmp_path / "_events.h1.jsonl").exists()
    assert (tmp_path / "_metrics.h1.json").exists()
    assert (tmp_path / "_metrics.h1.prom").exists()
    assert not (tmp_path / "_events.jsonl").exists()
    by_host = tsinks.read_all_metrics_json(str(tmp_path))
    assert list(by_host) == ["h1"]
    assert "repic_span_seconds" in by_host["h1"]
    assert jsinks.read_all_metrics_json(str(tmp_path)) == by_host


def test_flush_run_streams_sinks_mid_run(tmp_path):
    c = tmetrics.counter("repic_flush_test_total", "streaming flush test")
    rt = ttelemetry.start_run(str(tmp_path), flush_interval_s=0)
    try:
        c.inc(2)
        ttelemetry.flush_run(rt)
        mid = tsinks.read_metrics_json(str(tmp_path))
        assert mid["repic_flush_test_total"]["samples"][0]["value"] == 2
        c.inc(3)
        ttelemetry.flush_run(rt)
        mid = tsinks.read_metrics_json(str(tmp_path))
        assert mid["repic_flush_test_total"]["samples"][0]["value"] == 5
    finally:
        ttelemetry.finish_run(rt)
    c.inc(100)
    ttelemetry.flush_run(rt)
    final = tsinks.read_metrics_json(str(tmp_path))
    assert final["repic_flush_test_total"]["samples"][0]["value"] == 5


def test_periodic_flusher_writes_without_explicit_flush(tmp_path):
    rt = ttelemetry.start_run(str(tmp_path), flush_interval_s=0.05)
    try:
        deadline = time.time() + 10.0
        while not (tmp_path / "_metrics.json").exists():
            assert time.time() < deadline, "flusher never fired"
            time.sleep(0.02)
    finally:
        ttelemetry.finish_run(rt)
    assert rt._flusher is not None and not rt._flusher.is_alive()


def test_flush_disabled_telemetry_is_noop(tmp_path, monkeypatch):
    monkeypatch.setattr(tmetrics.REGISTRY, "_enabled", False)
    rt = ttelemetry.start_run(str(tmp_path))
    ttelemetry.flush_run(rt)
    ttelemetry.finish_run(rt)
    assert list(tmp_path.iterdir()) == []


def test_prom_snapshot_carries_span_histogram(tmp_path):
    rt = ttelemetry.start_run(str(tmp_path), flush_interval_s=0)
    try:
        with tevents.span("prom_hist_stage"):
            time.sleep(0.002)
    finally:
        ttelemetry.finish_run(rt)
    prom = (tmp_path / "_metrics.prom").read_text()
    assert ('repic_span_seconds_bucket{le="+Inf",name="prom_hist_stage"}'
            in prom)
    assert 'repic_span_seconds_count{name="prom_hist_stage"} 1' in prom


# -- probes --------------------------------------------------------------


def test_record_transfer_and_dispatch_accumulate():
    c0 = tprobes.counters()
    d0 = tprobes.snapshot(sample_memory=False)["device_dispatches"]
    tprobes.record_transfer(1024)
    tprobes.record_transfer(512, fetches=2)
    tprobes.note_dispatch()
    c1 = tprobes.counters()
    assert c1[1] - c0[1] == 1536 and c1[2] - c0[2] == 3
    assert tprobes.snapshot(sample_memory=False)["device_dispatches"] \
        - d0 == 1


def test_build_counters_count_builds_and_cached_loads():
    """A fresh build is a compile; a load of a built library is a
    compile that was a persistent-cache hit."""
    hits = tmetrics.counter("repic_persistent_cache_hits_total")
    c0, s0 = tprobes.counters()[0], tprobes.compile_seconds()
    v0 = hits.value()
    tprobes.note_build(1.5)
    tprobes.note_cached_load(0.25)
    assert tprobes.counters()[0] - c0 == 2
    assert tprobes.compile_seconds() - s0 == pytest.approx(1.75)
    assert hits.value() - v0 == (1 if tmetrics.enabled() else 0)


def test_probes_on_the_cpu_measure_nothing():
    """No CUDA run: no device to sync, no allocator statistics."""
    assert tprobes.sync_device() == 0.0
    assert tprobes.device_memory() == {}
    assert tprobes.live_buffers() == (0, 0)
    snap = tprobes.snapshot()
    assert "device_memory" not in snap
    assert snap["live_buffer_count"] == 0
    reg = tmetrics.MetricsRegistry(enabled=True)
    snap = tprobes.publish(reg)
    d = reg.as_dict()
    assert d["repic_recompiles_total"]["samples"][0]["value"] == \
        snap["recompiles"]
    assert d["repic_transfer_bytes_total"]["samples"][0]["value"] == \
        snap["transfer_bytes"]
    assert "repic_device_memory_bytes" not in d
    jreg = jmetrics.MetricsRegistry(enabled=True)
    from repic_tpu.telemetry import probes as jprobes

    jprobes.publish(jreg)
    # the same gauges, help strings included
    for name in d:
        assert d[name]["help"] == jreg.as_dict()[name]["help"], name


# -- the journal's read half ---------------------------------------------


def _write_journals(d):
    rows = {
        "_journal.jsonl": [
            {"name": "a", "status": "ok", "ts": 1.0},
            {"event": "chunk_retry", "ts": 1.5},
        ],
        "_journal.h1.jsonl": [
            {"name": "a", "status": "quarantined", "ts": 2.0,
             "gang_epoch": 2},
            {"name": "b", "status": "ok", "ts": 0.5, "gang_epoch": 1},
        ],
        "_journal.h2.jsonl": [
            {"name": "a", "status": "ok", "ts": 3.0, "gang_epoch": 1},
            {"name": "c", "status": "ok", "ts": 2.5},
        ],
    }
    for f, entries in rows.items():
        with open(os.path.join(d, f), "w") as fh:
            for e in entries:
                fh.write(json.dumps(e) + "\n")
    with open(os.path.join(d, "_journal.h2.jsonl"), "a") as fh:
        fh.write('{"name": "d", "sta')  # torn by a crash


def test_journal_read_half_equals_reference(tmp_path):
    _write_journals(str(tmp_path))
    d = str(tmp_path)
    for fn in ("journal_paths", "read_all_journals", "merged_latest"):
        assert getattr(tjournal, fn)(d) == getattr(jjournal, fn)(d), fn
    assert tjournal.host_artifact_paths(d, "_journal.jsonl") == \
        jjournal.host_artifact_paths(d, "_journal.jsonl")
    latest = tjournal.merged_latest(d)
    # the epoch-2 quarantine outranks the later epoch-1 straggler
    assert latest["a"]["status"] == "quarantined"
    reader = tjournal.MergedJournalReader(d)
    v = reader.version
    assert reader.latest() == latest and reader.version > v
    v = reader.version
    reader.entries()
    assert reader.version == v  # unchanged sizes: nothing re-parsed
    for host in ("h/1", "x y"):
        assert tjournal.host_journal_name(host) == \
            jjournal.host_journal_name(host)
    with pytest.raises(ValueError):
        tjournal.sanitize_host_id("")


# -- stage timer and profiler --------------------------------------------


def test_stage_timer_equals_reference(tmp_path, monkeypatch):
    timer = ttracing.StageTimer()
    with timer.stage("work"):
        time.sleep(0.005)
    (label, secs), = timer.stages
    assert label == "work" and 0.004 <= secs < 5.0
    stages = [("compute", 1.0), ("write", 0.5), ("compute", 2.0)]
    a, b = ttracing.StageTimer(list(stages)), jtracing.StageTimer(
        list(stages))
    assert a.as_dict() == b.as_dict() == {"compute": 3.0, "write": 0.5}
    pa, pb = a.write_tsv(str(tmp_path / "p")), b.write_tsv(str(tmp_path))
    assert open(pa, "rb").read() == open(pb, "rb").read()
    assert os.path.basename(pa) == "runtime.tsv"
    failed = ttracing.StageTimer()
    with pytest.raises(ValueError):
        with failed.stage("fails"):
            raise ValueError("boom")
    assert [lb for lb, _ in failed.stages] == ["fails"]
    # no wall clock while telemetry is off
    monkeypatch.setattr(tmetrics.REGISTRY, "_enabled", False)
    monkeypatch.setattr(time, "time", lambda: 1 / 0)
    with ttracing.StageTimer().stage("work"):
        pass


def test_stage_emits_telemetry_span(tmp_path):
    def run(metrics, events, sinks):
        tracing = ttracing if events is tevents else jtracing

        def work():
            with tracing.StageTimer().stage("load"):
                pass

        path = str(tmp_path / f"{metrics.__name__}.jsonl")
        return _shape(_with_log(events, path, work)[0])

    got = _both(run)
    assert got["port"] == got["jax"]
    assert got["port"][0]["name"] == "load"
    assert got["port"][0]["kind"] == "stage"


def test_trace_session_and_annotate(tmp_path):
    ran = []
    with ttracing.trace_session(None):
        ran.append(True)
    assert ran == [True] and ttracing.active_trace_dir() is None
    with ttracing.annotate("outer"):
        with ttracing.annotate("inner"):
            pass
    trace_dir = str(tmp_path / "prof")
    with ttracing.trace_session(trace_dir):
        assert ttracing.active_trace_dir() == os.path.abspath(trace_dir)
        with ttracing.annotate("step"):
            sum(range(1000))
    assert ttracing.active_trace_dir() is None
    out = tdevicetime.parse_trace_dir(trace_dir)
    assert out["files"] and out["files"][0].endswith(".pt.trace.json")
    # a CPU trace: host lanes only
    assert out["device_ops"] == 0 and out["device_busy_s"] == 0.0
    assert out["wall_s"] > 0
