"""The port's ``report`` against ``repic_tpu``'s, and the port's run
telemetry against the committed JAX digests.

The cases of ``tests/test_report.py``: ``build_report`` (the dict) and
``format_report`` / the ``report`` command (the text) of both packages
on the same run directories -- one the port wrote, one the JAX package
wrote, a telemetry-off run, per-host (cluster) artifacts and a serve
journal with SLO gauges -- then the reference test's assertions on the
port's run.  A default run of ``examples/10017`` on the CPU leaves the
reference's file set, and its projected counters, spans, trace segments
and journal trace ids equal ``tests/golden/torch_port_telemetry_digests
.json``; a run with telemetry on in both packages leaves the same files
and the same projection.
"""

import json
import os

import pytest

from repic_tpu.main import main as jcli
from repic_tpu.telemetry import report as jreport
from repic_tpu_torch.main import main as tcli
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.runtime.journal import read_journal
from repic_tpu_torch.telemetry import events as tevents
from repic_tpu_torch.telemetry import metrics as tmetrics
from repic_tpu_torch.telemetry import report as treport
from repic_tpu_torch.telemetry import sinks as tsinks
from repic_tpu_torch.utils.box_io import BoxParseError
from repic_tpu_torch.utils.synthetic import telemetry_view
from torch_port_common import SETTINGS, corrupt_box, write_box_dir
from torch_runtime_common import run_jax_dir, run_port_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "10017")
TELEMETRY_DIGESTS = os.path.join(REPO, "tests", "golden",
                                 "torch_port_telemetry_digests.json")


def _assert_same_report(run_dir):
    """Both packages' report of ``run_dir``: the dict and the text."""
    got, want = treport.build_report(run_dir), jreport.build_report(run_dir)
    assert got == want
    assert treport.format_report(got) == jreport.format_report(want)
    return got


@pytest.fixture(scope="module")
def journaled_runs(tmp_path_factory):
    """A lenient exact-solver run in chunks of 2 with one quarantined
    micrograph, telemetry on, through each package."""
    tmp = tmp_path_factory.mktemp("report")
    data = write_box_dir(tmp, m=6, n=70)
    corrupt_box(data, "mic2")
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPIC_CONSENSUS_CHUNK", "2")
        for name, run in (("port", run_port_dir), ("jax", run_jax_dir)):
            out = str(tmp / name)
            run(data, out, 64, telemetry=True, solver="exact")
            outs[name] = out
    return outs


def test_report_joins_all_artifacts(journaled_runs):
    out = journaled_runs["port"]
    for f in ("_events.jsonl", "_metrics.json", "_metrics.prom",
              "_trace.jsonl"):
        assert os.path.exists(os.path.join(out, f)), f
    report = _assert_same_report(out)
    by_status = report["micrographs"]["by_status"]
    assert by_status["quarantined"] == 1
    assert by_status.get("ok", 0) + by_status.get("degraded", 0) == 5
    assert report["micrographs"]["total"] == 6
    assert sum(report["solver_rungs"].values()) == 5
    assert set(report["solver_rungs"]) <= {"exact", "lp", "greedy"}
    assert report["ladder"]["chunk_halvings"] == 0
    chunk = report["stages"]["consensus_chunk"]
    assert chunk["count"] == 3
    assert 0 < chunk["p50_s"] <= chunk["p95_s"] <= chunk["max_s"]
    for stage in ("load", "write", "host_solve", "consensus_dispatch"):
        assert report["stages"][stage]["count"] >= 1, stage
    assert report["device"]["transfer_bytes"] > 0
    assert report["device"]["transfer_fetches"] >= 3
    assert set(report["runtime_tsv"]) >= {"load", "compute", "write"}
    assert report["schema_version"] == 3
    assert report["requests"]["count"] == 1
    text = treport.format_report(report)
    for needle in ("p50", "p95", "quarantined=1", "solver rungs:",
                   "recompiles=", "transfers=", "chunk_retries="):
        assert needle in text, needle


def test_report_of_the_jax_run_equals_reference(journaled_runs):
    _assert_same_report(journaled_runs["jax"])


def test_the_two_runs_report_the_same_outcomes(journaled_runs):
    p, j = (treport.build_report(journaled_runs[k]) for k in ("port", "jax"))
    for key in ("micrographs", "particles_total", "solver_rungs", "ladder"):
        assert p[key] == j[key], key
    assert {n: s["count"] for n, s in p["stages"].items()} == \
        {n: s["count"] for n, s in j["stages"].items()}


def test_report_cli_text_and_json_equal_reference(journaled_runs, capsys):
    out = journaled_runs["port"]
    tcli(["report", out])
    text = capsys.readouterr().out
    jcli(["report", out])
    assert text == capsys.readouterr().out
    assert "stage latencies" in text and "micrographs: 6" in text
    tcli(["report", out, "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["micrographs"]["by_status"]["quarantined"] == 1
    assert doc["stages"]["consensus_chunk"]["count"] == 3


def test_events_stream_has_run_id_and_chunk_spans(journaled_runs):
    records = tevents.read_events(journaled_runs["port"])
    assert len({r.get("run") for r in records}) == 1
    spans = [r for r in records if r.get("ev") == "span"]
    assert {"consensus_chunk", "load", "write"} <= {s["name"] for s in spans}
    chunk_spans = [s for s in spans if s["name"] == "consensus_chunk"]
    assert sorted(s["micrographs"] for s in chunk_spans) == [1, 2, 2]


def test_report_tolerates_torn_journal_line(journaled_runs, tmp_path):
    import shutil

    out = str(tmp_path / "copy")
    shutil.copytree(journaled_runs["port"], out)
    with open(os.path.join(out, "_journal.jsonl"), "at") as f:
        f.write('{"name": "mic9", "status": "o')
    assert _assert_same_report(out)["micrographs"]["total"] == 6


def test_report_degrades_without_telemetry(tmp_path):
    data = write_box_dir(tmp_path, m=3)
    out = str(tmp_path / "out")
    run_port_dir(data, out, 64)
    assert not os.path.exists(os.path.join(out, "_events.jsonl"))
    assert not os.path.exists(os.path.join(out, "_metrics.json"))
    report = _assert_same_report(out)
    assert report["micrographs"]["by_status"] == {"ok": 3}
    assert report["stages"] == {}
    assert "no event stream" in treport.format_report(report)
    with pytest.raises(FileNotFoundError):
        treport.build_report(str(tmp_path / "nope"))


def test_strict_raise_still_finishes_telemetry(tmp_path):
    data = write_box_dir(tmp_path, m=3)
    corrupt_box(data, "mic1")
    out = str(tmp_path / "out")
    with pytest.raises(BoxParseError):
        run_port_dir(data, out, 64, telemetry=True, strict=True)
    assert tevents.current_log() is None
    assert os.path.exists(os.path.join(out, "_metrics.json"))
    size_failed = os.path.getsize(os.path.join(out, "_events.jsonl"))
    run_port_dir(data, out + "2", 64, telemetry=True)
    assert os.path.getsize(os.path.join(out, "_events.jsonl")) == size_failed
    assert len({r["run"] for r in tevents.read_events(out + "2")}) == 1


def test_metrics_snapshot_is_per_run(tmp_path):
    data = write_box_dir(tmp_path, m=3)
    outs = [str(tmp_path / "r1"), str(tmp_path / "r2")]
    for out in outs:
        run_port_dir(data, out, 64, telemetry=True)
    for out in outs:
        m = tsinks.read_metrics_json(out)
        samples = m["repic_consensus_micrographs_total"]["samples"]
        assert sum(s["value"] for s in samples) == 3  # not 6


def _write_cluster_and_serve_dir(out):
    """Per-host journals, snapshots and event logs, gang events, and a
    serve journal with the SLO gauges."""
    rows = {
        "_journal.h1.jsonl": [
            {"name": "mic0", "status": "ok", "ts": 1.0, "host": "h1",
             "solver": "lp_device", "particles": 5, "wall_s": 0.5},
            {"event": "host_suspect", "suspect": "h2", "ts": 1.5},
            {"event": "gang_fault", "gang_epoch": 1, "kind": "stall",
             "ts": 1.6},
            {"event": "gang_reformed", "gang_epoch": 2, "world": 1,
             "ts": 1.7},
        ],
        "_journal.h2.jsonl": [
            {"name": "mic1", "status": "quarantined", "ts": 2.0,
             "host": "h2"},
            {"event": "work_reassigned", "names": ["mic1"], "ts": 2.5},
            {"name": "mic1", "status": "ok", "ts": 3.0, "host": "h1",
             "reassigned_from": "h2"},
        ],
        "_serve_journal.jsonl": [
            {"event": "server_started", "ts": 0.0,
             "slo_targets": {"job": [2.0, 0.9]}},
            {"job": "j1", "state": "queued", "ts": 1.0, "tenant": "a"},
            {"job": "j1", "state": "finished", "ts": 2.5},
            {"job": "j2", "state": "queued", "ts": 1.0},
            {"job": "j2", "state": "failed", "ts": 1.2},
        ],
        "_events.h1.jsonl": [
            {"ev": "span", "name": "consensus_chunk", "run": "r", "t": 1.0,
             "dur_s": 0.5, "host_s": 0.4, "device_tail_s": 0.1,
             "capacity": 64},
        ],
        "_events.h2.jsonl": [
            {"ev": "span", "name": "consensus_chunk", "run": "r", "t": 2.0,
             "dur_s": 0.7},
        ],
    }
    for f, entries in rows.items():
        with open(os.path.join(out, f), "w") as fh:
            for e in entries:
                fh.write(json.dumps(e) + "\n")
    reg = tmetrics.MetricsRegistry(enabled=True)
    reg.gauge("repic_transfer_bytes_total").set(1000)
    reg.gauge("repic_recompiles_total").set(2)
    reg.gauge("repic_slo_window_count").set(2, endpoint="job")
    reg.gauge("repic_slo_p95_seconds").set(1.5, endpoint="job")
    reg.gauge("repic_slo_budget_burn").set(5.0, endpoint="job")
    reg.gauge("repic_slo_compliance").set(0.5, endpoint="job")
    tsinks.write_metrics_json(
        os.path.join(out, tsinks.host_metrics_json_name("h1")), reg)
    reg2 = tmetrics.MetricsRegistry(enabled=True)
    reg2.gauge("repic_transfer_bytes_total").set(500)
    tsinks.write_metrics_json(
        os.path.join(out, tsinks.host_metrics_json_name("h2")), reg2)


def test_report_merges_hosts_gangs_and_serve_journals(tmp_path):
    _write_cluster_and_serve_dir(str(tmp_path))
    report = _assert_same_report(str(tmp_path))
    assert report["device"]["transfer_bytes"] == 1500
    assert report["stages"]["consensus_chunk"]["count"] == 2
    assert report["cluster"]["telemetry"]["h1"]["transfer_bytes"] == 1000
    assert report["gang"]["faults"] == 1 and report["gang"]["final_epoch"] == 2
    assert report["slo"]["endpoints"]["job"]["count"] == 2
    assert report["slo"]["window"]["job"]["budget_burn"] == 5.0


# -- the CPU run of 10017 against the JAX digests ----------------------


@pytest.mark.parametrize("setting", ["lp_device", "lp_device_pallas",
                                     "lp_device_fused"])
def test_10017_telemetry_equals_jax_digest(tmp_path, monkeypatch, setting):
    """A default run (telemetry on) leaves the reference's files, and
    its counters, spans, trace segments and journal trace ids are the
    JAX package's."""
    with open(TELEMETRY_DIGESTS) as f:
        want = json.load(f)[setting]
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    monkeypatch.setattr(tcons, "_PROGRAM_SIGNATURES", set())
    solver, pallas = SETTINGS[setting]
    out = str(tmp_path / "out")
    run_port_dir(EXAMPLES, out, 180, telemetry=True, solver=solver,
                 use_pallas=pallas)
    assert sorted(f for f in os.listdir(out) if not f.endswith(".box")) \
        == want["files"]
    got = telemetry_view(out)
    for key in ("metrics", "spans", "trace", "journal"):
        assert got[key] == want[key], key
    assert all(e.get("trace") for e in read_journal(out))


def test_telemetry_on_in_both_packages_same_files(tmp_path, monkeypatch):
    monkeypatch.delenv("REPIC_CONSENSUS_CHUNK", raising=False)
    data = write_box_dir(tmp_path, m=3)
    views, files = {}, {}
    for name, run in (("port", run_port_dir), ("jax", run_jax_dir)):
        out = str(tmp_path / name)
        if name == "port":
            tcons._PROGRAM_SIGNATURES.clear()
        else:
            from repic_tpu.pipeline import consensus as jcons

            jcons._PROGRAM_SIGNATURES.clear()
        run(data, out, 64, telemetry=True, solver="lp_device_fused")
        files[name] = sorted(os.listdir(out))
        views[name] = telemetry_view(out)
    assert files["port"] == files["jax"]
    assert {"_events.jsonl", "_metrics.json", "_metrics.prom",
            "_trace.jsonl"} <= set(files["port"])
    assert views["port"] == views["jax"]
