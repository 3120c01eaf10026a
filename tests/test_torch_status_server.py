"""The port's status server against ``repic_tpu``'s.

The cases of ``tests/test_status_server.py`` (the cluster liveness view
aside: the cluster layer is not ported): ``/healthz``, ``/metrics``
(the reference's exposition of the same registry, byte for byte, and
live), ``/status`` and 404, readiness, the inert surface without a
server, ``stop``, and scrapes while a real port run executes.  The
server binds port 0 on 127.0.0.1 and every request has a timeout of
a few seconds.
"""

import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from repic_tpu.telemetry import sinks as jsinks
from repic_tpu_torch.telemetry import server as tserver
from repic_tpu_torch.telemetry.metrics import MetricsRegistry
from torch_port_common import write_box_dir
from torch_runtime_common import run_port_dir

_PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$")


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.status, resp.headers, resp.read().decode()


@pytest.fixture
def server():
    reg = MetricsRegistry(enabled=True)
    reg.counter("repic_test_total", "test counter").inc(3, kind="a")
    reg.histogram("repic_test_seconds", "test histogram").observe(0.02)
    srv = tserver.StatusServer(port=0, registry=reg).start()
    try:
        yield srv
    finally:
        srv.stop()


def test_healthz_and_readiness(server):
    status, _, body = _get(server.port, "/healthz")
    assert (status, body) == (200, "ok\n")
    assert _get(server.port, "/healthz/live")[2] == "ok\n"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.port, "/healthz/ready")
    assert e.value.code == 503
    tserver.set_ready(True)
    assert tserver.is_ready()
    assert _get(server.port, "/healthz/ready")[2] == "ready\n"


def test_metrics_is_the_reference_exposition_and_live(server):
    status, headers, body = _get(server.port, "/metrics")
    assert status == 200
    assert headers["Content-Type"].startswith("text/plain")
    assert body == jsinks.render_prometheus(server.registry.as_dict())
    assert 'repic_test_total{kind="a"} 3' in body
    assert 'repic_test_seconds_bucket{le="+Inf"} 1' in body
    for line in body.splitlines():
        if line and not line.startswith("#"):
            assert _PROM_LINE.match(line), f"malformed line: {line!r}"
    server.registry.counter("repic_test_total", "").inc(2, kind="a")
    assert 'repic_test_total{kind="a"} 5' in _get(server.port, "/metrics")[2]


def test_status_document_and_404(server):
    tserver.set_status(run_id="abc123", micrographs_total=7,
                       cluster={"host": "h1"})
    status, headers, body = _get(server.port, "/status")
    assert status == 200 and headers["Content-Type"] == "application/json"
    doc = json.loads(body)
    assert doc["run_id"] == "abc123" and doc["micrographs_total"] == 7
    assert doc["cluster"] == {"host": "h1"}  # passes through as pushed
    assert doc["ts"] > 0
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server.port, "/nope")
    assert e.value.code == 404
    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/status",
                                 data=b"{}", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=5)
    assert e.value.code == 405


def test_status_endpoint_reports_slo_section():
    tracker = tserver.SLOTracker(objectives={"job": (60.0, 0.95)})
    tracker.observe("job", 1.5)
    prev = tserver.set_slo_tracker(tracker)
    srv = tserver.StatusServer(port=0).start()
    try:
        doc = json.loads(_get(srv.port, "/status")[2])
        assert doc["slo"]["objectives"]["job"]["target_s"] == 60.0
        assert doc["slo"]["endpoints"]["job"]["p95_s"] > 0
        doc = json.loads(_get(srv.port, "/status")[2])
        assert "http:status" in doc["slo"]["endpoints"]
    finally:
        srv.stop()
        tserver.set_slo_tracker(prev)


def test_set_status_is_noop_without_server():
    assert tserver.active_server() is None
    tserver.set_status(run_id="should-vanish")
    tserver.set_ready(True)
    assert tserver.get_status() == {} and not tserver.is_ready()


def test_stop_clears_status_and_unbinds():
    srv = tserver.StatusServer(port=0).start()
    port = srv.port
    tserver.set_status(run_id="x")
    srv.stop()
    assert tserver.active_server() is None
    assert tserver.get_status() == {}
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                               timeout=1)


def test_maybe_status_server(tmp_path):
    with tserver.maybe_status_server(None) as srv:
        assert srv is None and tserver.active_server() is None
    with tserver.maybe_status_server(0) as srv:
        with pytest.raises(SystemExit, match="cannot bind"):
            with tserver.maybe_status_server(srv.port):
                pass


def test_mid_run_scrape_and_readiness(tmp_path, monkeypatch):
    """Scrapes while a real port run executes (chunks of 1): /status
    carries the run's id and progress, readiness turns on after the
    first chunk and off at the end, /metrics has the run's counters."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    data = write_box_dir(tmp_path, m=4)
    with tserver.maybe_status_server(0) as srv:
        done = threading.Event()
        errors = []

        def _run():
            try:
                run_port_dir(data, str(tmp_path / "out"), 64,
                             telemetry=True)
            except Exception as e:  # pragma: no cover
                errors.append(e)
            finally:
                done.set()

        t = threading.Thread(target=_run)
        t.start()
        seen_total = None
        while not done.is_set():
            doc = json.loads(_get(srv.port, "/status")[2])
            if doc.get("micrographs_total"):
                seen_total = doc["micrographs_total"]
                break
            time.sleep(0.01)
        t.join(timeout=120)
        assert not t.is_alive() and not errors, errors
        doc = json.loads(_get(srv.port, "/status")[2])
        assert doc["micrographs_total"] == 4 and doc.get("run_id")
        assert doc["micrographs_done"] == 4 and doc["chunks_done"] == 4
        assert doc["phase"] == "finished"
        assert seen_total in (None, 4)
        assert not tserver.is_ready()
        body = _get(srv.port, "/metrics")[2]
        assert "repic_consensus_micrographs_total" in body


def test_resumed_run_status_counts_prior_work(tmp_path):
    data = write_box_dir(tmp_path, m=4)
    out = str(tmp_path / "out")
    run_port_dir(data, out, 64)
    os.remove(os.path.join(out, "mic3.box"))
    with tserver.maybe_status_server(0) as srv:
        run_port_dir(data, out, 64, resume=True)
        doc = json.loads(_get(srv.port, "/status")[2])
    assert doc["micrographs_total"] == 4
    assert doc["micrographs_done"] == 4, doc
