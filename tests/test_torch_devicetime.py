"""The port's device-time attribution against ``repic_tpu``'s.

The cases of ``tests/test_devicetime.py``: ``--device-time`` spans
carry ``host_s`` / ``device_tail_s``, ``span_device_time`` aggregates
them per stage and capacity (the same dict as the reference's on the
same records), ``parse_trace_dir`` reads the reference's Chrome-trace
fixture as the reference does, and ``report`` joins the
``trace_dir`` breadcrumb.  Also the Kineto rules: a
``torch.profiler`` trace labels its GPU lanes in ``process_labels``
(every lane's ``process_name`` is the program's), and the
``record_function`` ranges lie on the GPU lanes over the kernels they
enclose, so the port counts only kernel, copy and memset events there,
as the union of their intervals.
"""

import gzip
import json
import os

import pytest

from repic_tpu.telemetry import devicetime as jdevicetime
from repic_tpu.telemetry import report as jreport
from repic_tpu_torch.telemetry import devicetime as tdevicetime
from repic_tpu_torch.telemetry import events as tevents
from repic_tpu_torch.telemetry import probes as tprobes
from repic_tpu_torch.telemetry import report as treport
from torch_port_common import write_box_dir
from torch_runtime_common import run_port_dir


@pytest.fixture
def device_time_mode():
    tprobes.set_device_time(True)
    try:
        yield
    finally:
        tprobes.set_device_time(False)


def test_sync_device_on_the_cpu_waits_for_nothing():
    assert tprobes.sync_device() == 0.0
    with tprobes.device_time(True):
        assert tprobes.device_time_enabled()
    assert not tprobes.device_time_enabled()


def _one_span(tmp_path):
    log = tevents.EventLog(str(tmp_path / "_events.jsonl"))
    prev = tevents.set_current_log(log)
    try:
        with tevents.span("stage_a"):
            pass
    finally:
        tevents.set_current_log(prev)
        log.close()
    (rec,) = [r for r in tevents.read_events(str(tmp_path))
              if r.get("ev") == "span"]
    return rec


def test_spans_carry_device_fields_when_enabled(tmp_path,
                                                device_time_mode):
    rec = _one_span(tmp_path)
    assert "host_s" in rec and "device_tail_s" in rec
    assert rec["dur_s"] >= rec["host_s"]
    assert rec["device_tail_s"] == 0.0


def test_spans_omit_device_fields_when_disabled(tmp_path):
    rec = _one_span(tmp_path)
    assert "device_tail_s" not in rec and "host_s" not in rec


SPAN_RECORDS = [
    [
        {"ev": "span", "name": "consensus_chunk", "capacity": 128,
         "dur_s": 1.0, "host_s": 0.7, "device_tail_s": 0.3},
        {"ev": "span", "name": "consensus_chunk", "capacity": 128,
         "dur_s": 1.0, "host_s": 0.5, "device_tail_s": 0.5},
        {"ev": "span", "name": "consensus_chunk", "capacity": 256,
         "dur_s": 2.0, "host_s": 1.0, "device_tail_s": 1.0},
        {"ev": "span", "name": "write",
         "dur_s": 0.2, "host_s": 0.2, "device_tail_s": 0.0},
        {"ev": "event", "name": "not_a_span"},
        {"ev": "span", "name": "untimed_span", "dur_s": 0.1},
    ],
    [
        {"ev": "span", "name": "consensus_chunk", "capacity": 64,
         "dur_s": 10.0, "host_s": 10.0, "device_tail_s": 0.0},
        {"ev": "span", "name": "consensus_chunk", "capacity": 64,
         "dur_s": 7.0, "host_s": 1.0, "device_tail_s": 6.0},
    ],
    [
        {"ev": "span", "name": "consensus_chunk", "capacity": 128,
         "dur_s": 5.0, "host_s": 5.0, "device_tail_s": 0.0},
        {"ev": "span", "name": "consensus_dispatch", "capacity": 128,
         "dur_s": 4.5, "host_s": 0.5, "device_tail_s": 4.0},
    ],
    [{"ev": "span", "name": "x", "dur_s": 1.0}],
]


@pytest.mark.parametrize("case", range(len(SPAN_RECORDS)))
def test_span_device_time_equals_reference(case):
    records = SPAN_RECORDS[case]
    assert tdevicetime.span_device_time(records) == \
        jdevicetime.span_device_time(records)


def test_span_device_time_aggregates_and_prefers_dispatch_spans():
    out = tdevicetime.span_device_time(SPAN_RECORDS[0])
    chunk = out["stages"]["consensus_chunk"]
    assert chunk["count"] == 3
    assert chunk["host_s"] == pytest.approx(2.2)
    assert chunk["device_tail_s"] == pytest.approx(1.8)
    assert out["by_capacity"][128]["count"] == 2
    assert "untimed_span" not in out["stages"]
    assert out["dispatch_gap_s"] == pytest.approx(0.4)
    # the gap floors per span, not in aggregate
    assert tdevicetime.span_device_time(SPAN_RECORDS[1])[
        "dispatch_gap_s"] == pytest.approx(10.0)
    out = tdevicetime.span_device_time(SPAN_RECORDS[2])
    assert out["dispatch_gap_s"] == pytest.approx(0.0)
    assert out["by_capacity"][128]["device_tail_s"] == pytest.approx(4.0)
    assert tdevicetime.span_device_time(SPAN_RECORDS[3]) == {}


def _write_chrome_trace(trace_dir, gz=True):
    """The reference's fixture: a host lane, a device lane with two
    kernels (400 us busy) and a host lane whose name contains 'tpu'."""
    run_dir = os.path.join(trace_dir, "plugins", "profile", "r")
    os.makedirs(run_dir, exist_ok=True)
    trace = {"traceEvents": [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/host:CPU python"}},
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1000,
         "name": "dispatch"},
        {"ph": "X", "pid": 7, "tid": 1, "ts": 100, "dur": 300,
         "name": "fusion.1"},
        {"ph": "X", "pid": 7, "tid": 1, "ts": 500, "dur": 100,
         "name": "fusion.2"},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "python repic_tpu tpu_driver pool"}},
        {"ph": "X", "pid": 9, "tid": 1, "ts": 0, "dur": 900,
         "name": "callback"},
    ]}
    path = os.path.join(run_dir, "local.trace.json" + (".gz" if gz else ""))
    with (gzip.open if gz else open)(path, "wt") as f:
        json.dump(trace, f)
    return path


@pytest.mark.parametrize("gz", [True, False])
def test_parse_trace_dir_reads_the_reference_fixture(tmp_path, gz):
    _write_chrome_trace(str(tmp_path), gz=gz)
    out = tdevicetime.parse_trace_dir(str(tmp_path))
    assert out == jdevicetime.parse_trace_dir(str(tmp_path))
    assert out["device_ops"] == 2
    assert out["device_busy_s"] == pytest.approx(400e-6)
    assert out["wall_s"] == pytest.approx(1000e-6)
    assert out["dispatch_gap_s"] == pytest.approx(600e-6)


def test_parse_trace_dir_degrades_to_empty(tmp_path):
    assert tdevicetime.parse_trace_dir(str(tmp_path)) == {}
    bad = tmp_path / "plugins" / "profile" / "r"
    bad.mkdir(parents=True)
    (bad / "x.trace.json").write_text("{not json")
    assert tdevicetime.parse_trace_dir(str(tmp_path)) == {}


def test_kineto_annotations_do_not_count_twice(tmp_path):
    """A trace in Kineto's format (every lane's ``process_name`` the
    program's, a GPU lane's ``process_labels`` "GPU 0"): on GPU 0, a
    ``gpu_user_annotation`` over two kernels, a memcpy, and a kernel on
    a second stream overlapping the first; on the host, the
    annotation's CPU side and runtime calls.  Device busy is the union
    of the kernel/copy intervals."""
    trace = {"traceEvents": [
        {"ph": "M", "pid": 4242, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": 4242, "name": "process_labels",
         "args": {"labels": "CPU"}},
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": 0, "name": "process_labels",
         "args": {"labels": "GPU 0"}},
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": 1, "name": "process_labels",
         "args": {"labels": "GPU 1"}},
        {"ph": "X", "cat": "user_annotation", "pid": 4242, "tid": 1,
         "ts": 0.0, "dur": 1000.0, "name": "consensus_batch"},
        {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 1,
         "ts": 10.0, "dur": 5.0, "name": "cudaLaunchKernel"},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "ts": 100.0, "dur": 500.0, "name": "consensus_batch"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 100.0,
         "dur": 200.0, "name": "clique_count_kernel"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 350.0,
         "dur": 250.0, "name": "dual_solve_kernel"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 9, "ts": 250.0,
         "dur": 150.0, "name": "topk_neighbors_kernel"},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7, "ts": 700.0,
         "dur": 50.0, "name": "Memcpy DtoH (Device -> Pageable)"},
        {"ph": "s", "cat": "ac2g", "pid": 4242, "tid": 1, "ts": 10.0,
         "id": 1, "name": "ac2g"},
    ]}
    d = tmp_path / "prof"
    d.mkdir()
    with open(d / "host_4242.1700000000000.pt.trace.json", "w") as f:
        json.dump(trace, f)
    out = tdevicetime.parse_trace_dir(str(d))
    # kernels cover [100, 600) (the second stream inside it), the copy
    # [700, 750): 550 us; the annotation adds nothing
    assert out["device_busy_s"] == pytest.approx(550e-6)
    assert out["device_ops"] == 4
    assert out["wall_s"] == pytest.approx(1000e-6)
    assert out["dispatch_gap_s"] == pytest.approx(450e-6)
    assert out["host_busy_s"] == pytest.approx(1005e-6)
    assert out["files"] == ["host_4242.1700000000000.pt.trace.json"]
    # the reference's lane rule reads no device lane in this format
    assert jdevicetime.parse_trace_dir(str(d))["device_ops"] == 0


def _breadcrumb_dir(out, traces):
    out.mkdir()
    with open(out / "_events.jsonl", "wt") as f:
        for t, path in traces:
            f.write(json.dumps({"ev": "event", "name": "trace_dir",
                                "run": "r", "t": t,
                                "path": str(path)}) + "\n")
        f.write(json.dumps(
            {"ev": "span", "name": "consensus_chunk", "run": "r", "t": 2.5,
             "dur_s": 1.0, "host_s": 0.8, "device_tail_s": 0.2,
             "capacity": 64}) + "\n")
    with open(out / "_journal.jsonl", "wt") as f:
        f.write(json.dumps({"name": "mic0", "status": "ok",
                            "ts": 1.0}) + "\n")


def test_report_joins_the_latest_trace_dir_breadcrumb(tmp_path):
    stale, fresh = tmp_path / "t1", tmp_path / "t2"
    _write_chrome_trace(str(stale))
    run_dir = fresh / "plugins" / "profile" / "r2"
    run_dir.mkdir(parents=True)
    with open(run_dir / "x.trace.json", "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "M", "pid": 7, "name": "process_name",
             "args": {"name": "/device:TPU:0"}},
            {"ph": "X", "pid": 7, "tid": 1, "ts": 0, "dur": 100,
             "name": "fusion.only"},
        ]}, f)
    out = tmp_path / "run"
    _breadcrumb_dir(out, [(1.0, stale), (2.0, fresh)])
    got = treport.build_report(str(out))
    assert got == jreport.build_report(str(out))
    assert got["device_time"]["trace"]["device_ops"] == 1
    text = treport.format_report(got)
    assert text == jreport.format_report(got)
    assert "profiler trace: device_busy=" in text


def test_report_device_time_section_of_a_device_timed_run(
        tmp_path, device_time_mode):
    data = write_box_dir(tmp_path, m=3)
    out = str(tmp_path / "out")
    run_port_dir(data, out, 64, telemetry=True)
    report = treport.build_report(out)
    assert report == jreport.build_report(out)
    dt = report["device_time"]
    for stage in ("consensus_chunk", "consensus_dispatch", "load", "write"):
        assert dt["stages"][stage]["host_s"] >= 0, stage
    assert dt["stages"]["consensus_chunk"]["host_s"] > 0
    assert dt["by_capacity"] and "dispatch_gap_s" in dt
    text = treport.format_report(report)
    assert "device time (host vs device tail, s):" in text
    assert "dispatch gap (est):" in text


def test_report_omits_device_time_without_the_mode(tmp_path):
    data = write_box_dir(tmp_path, m=2)
    out = str(tmp_path / "out")
    run_port_dir(data, out, 64, telemetry=True)
    assert "device_time" not in treport.build_report(out)
