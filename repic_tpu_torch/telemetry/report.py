"""Run summary behind ``report RUN_DIR`` (the port's copy of
``repic_tpu_torch.telemetry.report``).

Joins what a directory consensus run leaves behind into one summary:

* ``_journal.jsonl`` -- per-micrograph outcomes, solver rungs, wall
  times, ladder events;
* ``_events.jsonl`` -- spans (per-stage latencies with build/transfer
  deltas, the ``--device-time`` split), events, log records;
* ``_metrics.json`` -- the registry snapshot with the probe totals;
* ``_trace.jsonl`` -- the request trace's segments;
* the profiler trace named by a ``trace_dir`` event (``--profile``).

Every section degrades on its own: a journal-only run (telemetry
disabled) still reports outcome tallies.  The dict and the text are
the reference's, field for field, so one dashboard reads either
package's runs.
"""

from __future__ import annotations

import json
import os

from repic_tpu_torch.telemetry import devicetime as _devicetime
from repic_tpu_torch.telemetry import events as _events
from repic_tpu_torch.telemetry import sinks as _sinks
from repic_tpu_torch.telemetry import trace as _trace
from repic_tpu_torch.telemetry.metrics import percentile as _percentile

#: version of the ``report --json`` field contract (the reference's:
#: v3 has the per-request ``requests`` section)
SCHEMA_VERSION = 3


def _stage_stats(durations: list[float]) -> dict:
    return {
        "count": len(durations),
        "total_s": round(sum(durations), 6),
        "mean_s": round(sum(durations) / len(durations), 6),
        "p50_s": round(_percentile(durations, 0.50), 6),
        "p95_s": round(_percentile(durations, 0.95), 6),
        "max_s": round(max(durations), 6),
    }


def _gauge_value(metrics: dict, name: str):
    entry = metrics.get(name)
    if not entry:
        return None
    for sample in entry.get("samples", []):
        if not sample.get("labels"):
            return sample.get("value")
    return None


def _gauge_total(metrics_by_host: dict, name: str):
    """Sum a gauge over every host's snapshot (cluster runs write one
    ``_metrics.<host>.json`` each; the probe gauges are per-run
    totals, so the cluster figure is their sum).  ``None`` when no
    snapshot carries the gauge — callers then fall back to span
    deltas."""
    values = [
        _gauge_value(m, name) for m in metrics_by_host.values()
    ]
    values = [v for v in values if v is not None]
    return sum(values) if values else None


def _read_runtime_tsv(run_dir: str) -> dict:
    """Legacy stage rows (summed per label), when present."""
    path = os.path.join(run_dir, "consensus_runtime.tsv")
    out: dict[str, float] = {}
    try:
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 2:
                    continue
                try:
                    out[parts[0]] = out.get(parts[0], 0.0) + float(
                        parts[1]
                    )
                except ValueError:
                    continue
    except OSError:
        return {}
    return out


# the serve journal's vocabulary (the reference's serve.jobs), kept
# here so the report needs no serving stack
_SERVE_JOURNAL_NAME = "_serve_journal.jsonl"
_SERVE_OK_STATE = "finished"
_SERVE_TERMINAL = frozenset(
    ("finished", "failed", "cancelled", "deadline_exceeded",
     "quarantined")
)


def _slo_window_gauges(metrics_by_host: dict) -> dict:
    """Per-endpoint rolling-window SLO numbers from the
    ``repic_slo_*`` gauges of any ``_metrics.json`` snapshot.  These
    are labeled gauges (one sample per endpoint), so the flat
    :func:`_gauge_value` cannot read them; with several snapshots
    (fleet replicas) the one that saw the most observations wins per
    endpoint."""
    best: dict[str, dict] = {}
    for m in metrics_by_host.values():
        if not isinstance(m, dict):
            continue

        def by_endpoint(gauge_name: str) -> dict:
            entry = m.get(gauge_name) or {}
            out = {}
            for sample in entry.get("samples", []):
                ep = (sample.get("labels") or {}).get("endpoint")
                if ep is not None:
                    out[ep] = sample.get("value")
            return out

        counts = by_endpoint("repic_slo_window_count")
        p95 = by_endpoint("repic_slo_p95_seconds")
        compliance = by_endpoint("repic_slo_compliance")
        burn = by_endpoint("repic_slo_budget_burn")
        for ep, count in counts.items():
            row: dict = {"count": int(count)}
            if ep in p95:
                row["p95_s"] = p95[ep]
            if ep in compliance:
                row["compliance"] = compliance[ep]
            if ep in burn:
                row["budget_burn"] = burn[ep]
            prev = best.get(ep)
            if prev is None or row["count"] >= prev["count"]:
                best[ep] = row
    return {ep: best[ep] for ep in sorted(best)}


def _slo_section(run_dir: str, metrics_by_host: dict):
    """Post-mortem SLO reconstruction: per-endpoint
    compliance and error-budget burn rebuilt from the serve request
    journal(s) — accept-to-terminal latency per job, judged against
    the objectives the daemon journaled at startup — plus the live
    tracker's last rolling-window gauges where a metrics snapshot
    carries them.  The journal view covers the WHOLE run (the /status
    window is bounded), and needs no live daemon: this is what an
    incident review reads after the fleet is gone.  ``None`` when the
    directory holds no serve artifacts at all."""
    from repic_tpu_torch.runtime.journal import MergedJournalReader

    entries = MergedJournalReader(
        run_dir, base_name=_SERVE_JOURNAL_NAME
    ).entries()
    objectives: dict = {}
    jobs: dict[str, dict] = {}
    for e in entries:
        if e.get("event") == "server_started":
            # last generation wins: judge against the objectives the
            # run actually served under at the end
            targets = e.get("slo_targets")
            if isinstance(targets, dict):
                try:
                    objectives = {
                        str(ep): (float(t), float(g))
                        for ep, (t, g) in targets.items()
                    }
                except (TypeError, ValueError):
                    pass
            continue
        jid = e.get("job")
        state = e.get("state")
        if jid is None or state is None:
            continue
        row = jobs.setdefault(jid, {})
        if state == "queued":
            if "accepted" not in row:
                row["accepted"] = e.get("ts")
                if e.get("tenant") is not None:
                    row["tenant"] = e["tenant"]
        elif state in _SERVE_TERMINAL and "done" not in row:
            row["done"] = e.get("ts")
            row["state"] = state
    rows: dict[str, list] = {}
    for row in jobs.values():
        accepted, done = row.get("accepted"), row.get("done")
        if accepted is None or done is None:
            continue
        lat = max(float(done) - float(accepted), 0.0)
        ok = row.get("state") == _SERVE_OK_STATE
        rows.setdefault("job", []).append((lat, ok))
        if row.get("tenant") is not None:
            rows.setdefault(
                f"tenant:{row['tenant']}", []
            ).append((lat, ok))
    endpoints: dict = {}
    for ep in sorted(rows):
        lats = [lat for lat, _ in rows[ep]]
        entry = {
            "count": len(lats),
            "p50_s": round(_percentile(lats, 0.50), 6),
            "p95_s": round(_percentile(lats, 0.95), 6),
        }
        objective = objectives.get(ep)
        if objective is None and ep.startswith("tenant:"):
            # the same inheritance the live tracker applies
            objective = objectives.get("job")
        if objective is not None:
            target, goal = objective
            bad = sum(
                1 for lat, ok in rows[ep] if not ok or lat > target
            )
            violating = bad / len(rows[ep])
            entry["target_s"] = target
            entry["goal"] = goal
            entry["compliance"] = round(1.0 - violating, 4)
            entry["budget_burn"] = round(
                violating / max(1.0 - goal, 1e-9), 3
            )
        endpoints[ep] = entry
    window = _slo_window_gauges(metrics_by_host)
    if not endpoints and not window:
        return None
    section: dict = {"endpoints": endpoints}
    if objectives:
        section["objectives"] = {
            ep: {"target_s": t, "goal": g}
            for ep, (t, g) in sorted(objectives.items())
        }
    if window:
        section["window"] = window
    return section


def build_report(run_dir: str) -> dict:
    """Join journal + events + metrics of ``run_dir`` into one dict.

    Cluster runs are merged on read: entries from every
    ``_journal.<host>.jsonl`` fold in timestamp order (last writer
    wins per micrograph), and the summary gains a ``cluster`` section
    with per-host outcome tallies plus suspicion/fence/reassignment
    counts — what a fleet operator needs after a host loss.
    """
    from repic_tpu_torch.runtime.journal import (
        fold_latest,
        read_all_journals,
    )

    if not os.path.isdir(run_dir):
        raise FileNotFoundError(f"run directory not found: {run_dir}")

    journal = read_all_journals(run_dir)
    records = _events.read_events(run_dir)
    # every metrics snapshot: the single-process _metrics.json plus
    # any per-host _metrics.<host>.json a cluster run left behind
    metrics_by_host = _sinks.read_all_metrics_json(run_dir)

    # -- journal: per-micrograph outcomes ----------------------------
    latest: dict[str, dict] = {}
    ladder = {
        "chunk_retries": 0,
        "chunk_halvings": 0,
        "per_micrograph_fallbacks": 0,
    }
    cluster = {
        "hosts": {},
        "suspects": 0,
        "fences": 0,
        "reassignments": {"events": 0, "micrographs": 0},
    }
    clustered = False
    # distinct hosts, not raw events: with several survivors (or
    # several generations) the same dead host may be suspected or
    # fenced more than once, and the operator wants a host count
    suspect_hosts: set = set()
    fenced_hosts: set = set()
    # gang transitions in journal order (the reference's
    # "Pod-scale gangs"): the formed -> fault -> reformed/degraded
    # sequence IS what the operator reads after a pod incident
    gang_events: list = []
    for entry in journal:
        if "name" in entry:
            if "host" in entry:
                clustered = True
        elif entry.get("event") == "chunk_retry":
            ladder["chunk_retries"] += 1
        elif entry.get("event") == "chunk_halved":
            ladder["chunk_halvings"] += 1
        elif entry.get("event") == "per_micrograph_fallback":
            ladder["per_micrograph_fallbacks"] += 1
        elif entry.get("event") == "host_suspect":
            clustered = True
            suspect_hosts.add(entry.get("suspect"))
        elif entry.get("event") == "host_fenced":
            clustered = True
            fenced_hosts.add(entry.get("suspect"))
        elif entry.get("event") == "work_reassigned":
            clustered = True
            cluster["reassignments"]["events"] += 1
            cluster["reassignments"]["micrographs"] += int(
                entry.get("count", len(entry.get("names", ())))
            )
        elif str(entry.get("event", "")).startswith("gang_"):
            ev = {
                "event": entry["event"],
                "gang_epoch": entry.get("gang_epoch"),
            }
            for f in ("kind", "world", "dead", "host", "reason",
                      "oom"):
                if entry.get(f) not in (None, [], False):
                    ev[f] = entry[f]
            gang_events.append(ev)

    # the epoch-fenced merged fold (a gang straggler's late records
    # lose) — the same view --resume trusts
    latest = fold_latest(journal)

    by_status: dict[str, int] = {}
    solver_rungs: dict[str, int] = {}
    wall, particles = [], 0
    for e in latest.values():
        s = e.get("status", "unknown")
        by_status[s] = by_status.get(s, 0) + 1
        if e.get("solver"):
            solver_rungs[e["solver"]] = (
                solver_rungs.get(e["solver"], 0) + 1
            )
        if isinstance(e.get("wall_s"), (int, float)):
            wall.append(float(e["wall_s"]))
        if isinstance(e.get("particles"), int):
            particles += e["particles"]
        if clustered:
            host = e.get("host", "(no host)")
            hstats = cluster["hosts"].setdefault(
                host, {"by_status": {}, "reassigned_in": 0}
            )
            hstats["by_status"][s] = hstats["by_status"].get(s, 0) + 1
            if e.get("reassigned_from") is not None:
                hstats["reassigned_in"] += 1

    # -- events: per-stage span latencies + probe deltas -------------
    stage_durs: dict[str, list[float]] = {}
    span_recompiles = 0
    span_transfer_bytes = 0
    span_transfer_fetches = 0
    run_id = None
    for rec in records:
        run_id = rec.get("run", run_id)
        if rec.get("ev") != "span":
            continue
        stage_durs.setdefault(rec.get("name", "?"), []).append(
            float(rec.get("dur_s", 0.0))
        )
        span_recompiles += int(rec.get("recompiles", 0))
        span_transfer_bytes += int(rec.get("transfer_bytes", 0))
        span_transfer_fetches += int(rec.get("transfer_fetches", 0))

    stages = {
        name: _stage_stats(durs)
        for name, durs in sorted(stage_durs.items())
    }

    # -- device probes: metrics snapshots (summed over hosts), span
    #    deltas as fallback ------------------------------------------
    recompiles = _gauge_total(metrics_by_host, "repic_recompiles_total")
    transfer_bytes = _gauge_total(
        metrics_by_host, "repic_transfer_bytes_total"
    )
    transfer_fetches = _gauge_total(
        metrics_by_host, "repic_transfer_fetches_total"
    )
    device = {
        "recompiles": int(
            recompiles if recompiles is not None else span_recompiles
        ),
        "transfer_bytes": int(
            transfer_bytes
            if transfer_bytes is not None
            else span_transfer_bytes
        ),
        "transfer_fetches": int(
            transfer_fetches
            if transfer_fetches is not None
            else span_transfer_fetches
        ),
    }
    compile_s = _gauge_total(
        metrics_by_host, "repic_compile_seconds_total"
    )
    if compile_s is not None:
        device["compile_seconds"] = round(float(compile_s), 3)

    # -- device-time attribution (--device-time / --trace-dir) -------
    device_time = _devicetime.span_device_time(records)
    trace_paths = [
        str(rec["path"])
        for rec in records
        if rec.get("ev") == "event"
        and rec.get("name") == "trace_dir"
        and rec.get("path")
    ]
    # LAST breadcrumb wins: the run log appends across re-runs /
    # resumes into the same directory, and the trace numbers must
    # describe the same execution the span stats do
    for path in reversed(trace_paths):
        if not os.path.isdir(path):
            continue
        trace = _devicetime.parse_trace_dir(path)
        if trace:
            device_time["trace"] = trace
            break

    report = {
        "schema_version": SCHEMA_VERSION,
        "run_dir": os.path.abspath(run_dir),
        "run_id": run_id,
        "micrographs": {
            "total": len(latest),
            "by_status": dict(sorted(by_status.items())),
        },
        "particles_total": particles,
        "solver_rungs": dict(sorted(solver_rungs.items())),
        "ladder": ladder,
        "stages": stages,
        "micrograph_wall_s": (
            {
                "count": len(wall),
                "p50_s": round(_percentile(wall, 0.50), 6),
                "p95_s": round(_percentile(wall, 0.95), 6),
            }
            if wall
            else {}
        ),
        "device": device,
        "runtime_tsv": _read_runtime_tsv(run_dir),
    }
    if device_time:
        report["device_time"] = device_time

    # -- per-request traces (_trace.jsonl, serve jobs + CLI runs) ----
    trace_records = _trace.read_trace(run_dir)
    if trace_records:
        traces = {}
        for tid, tr in _trace.summarize(trace_records).items():
            row = {
                "kind": tr.get("kind"),
                "job": tr.get("job"),
                "t0": tr.get("t0"),
                "span_s": tr.get("span_s"),
                "total_s": tr.get("total_s"),
                "segments": tr.get("segment_totals", {}),
            }
            if tr.get("cache"):
                row["cache"] = tr["cache"]
            traces[tid] = row
        report["requests"] = {
            "count": len(traces),
            "traces": traces,
        }
    # -- SLO post-mortem (serve journal + repic_slo_* gauges) --------
    slo = _slo_section(run_dir, metrics_by_host)
    if slo is not None:
        report["slo"] = slo
    if clustered:
        cluster["hosts"] = dict(sorted(cluster["hosts"].items()))
        cluster["suspects"] = len(suspect_hosts)
        cluster["fences"] = len(fenced_hosts)
        # per-host device totals from the per-host metric snapshots
        telemetry_by_host = {}
        for host, m in sorted(metrics_by_host.items()):
            if host is None:
                continue
            row = {}
            for field, gauge in (
                ("recompiles", "repic_recompiles_total"),
                ("transfer_bytes", "repic_transfer_bytes_total"),
                ("transfer_fetches", "repic_transfer_fetches_total"),
            ):
                v = _gauge_value(m, gauge)
                if v is not None:
                    row[field] = int(v)
            if row:
                telemetry_by_host[host] = row
        if telemetry_by_host:
            cluster["telemetry"] = telemetry_by_host
        report["cluster"] = cluster
    if gang_events:
        report["gang"] = {
            "events": gang_events,
            "faults": sum(
                1 for e in gang_events
                if e["event"] == "gang_fault"
            ),
            "reformations": sum(
                1 for e in gang_events
                if e["event"] == "gang_reformed"
            ),
            "degraded": any(
                e["event"] == "gang_degraded" for e in gang_events
            ),
            "final_epoch": max(
                (
                    int(e["gang_epoch"])
                    for e in gang_events
                    if e.get("gang_epoch") is not None
                ),
                default=None,
            ),
        }
    return report


def _fmt_bytes(n: int) -> str:
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if size < 1024 or unit == "TiB":
            return (
                f"{int(size)} {unit}"
                if unit == "B"
                else f"{size:.1f} {unit}"
            )
        size /= 1024
    return f"{n} B"


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`build_report` output."""
    lines = [f"run: {report['run_dir']}"]
    if report.get("run_id"):
        lines.append(f"run id: {report['run_id']}")

    mg = report["micrographs"]
    tallies = ", ".join(
        f"{k}={v}" for k, v in mg["by_status"].items()
    ) or "none"
    lines.append(f"micrographs: {mg['total']} ({tallies})")
    lines.append(f"particles: {report['particles_total']}")

    rungs = ", ".join(
        f"{k}={v}" for k, v in report["solver_rungs"].items()
    ) or "none recorded"
    lines.append(f"solver rungs: {rungs}")

    lad = report["ladder"]
    lines.append(
        "ladder: "
        f"chunk_retries={lad['chunk_retries']} "
        f"chunk_halvings={lad['chunk_halvings']} "
        f"per_micrograph_fallbacks="
        f"{lad['per_micrograph_fallbacks']} "
        f"quarantined={mg['by_status'].get('quarantined', 0)}"
    )

    cl = report.get("cluster")
    if cl:
        lines.append("cluster hosts:")
        for host, hs in cl["hosts"].items():
            tally = ", ".join(
                f"{k}={v}" for k, v in sorted(hs["by_status"].items())
            )
            extra = (
                f" (reassigned_in={hs['reassigned_in']})"
                if hs.get("reassigned_in")
                else ""
            )
            lines.append(f"  {host}: {tally}{extra}")
        re_ = cl["reassignments"]
        lines.append(
            "host ladder: "
            f"suspects={cl['suspects']} fences={cl['fences']} "
            f"reassigned={re_['micrographs']} "
            f"(in {re_['events']} event(s))"
        )

    gang = report.get("gang")
    if gang:
        lines.append(
            "gang: "
            f"faults={gang['faults']} "
            f"reformations={gang['reformations']} "
            f"final_epoch={gang['final_epoch']}"
            + (" DEGRADED" if gang["degraded"] else "")
        )
        for e in gang["events"]:
            detail = " ".join(
                f"{k}={e[k]}"
                for k in ("kind", "world", "dead", "reason", "oom")
                if k in e
            )
            lines.append(
                f"  epoch {e.get('gang_epoch')}: {e['event']}"
                + (f" ({detail})" if detail else "")
            )

    if report["stages"]:
        lines.append("stage latencies (s):")
        width = max(len(n) for n in report["stages"])
        lines.append(
            f"  {'stage'.ljust(width)}  count    p50      p95"
            "      mean     total"
        )
        for name, st in report["stages"].items():
            lines.append(
                f"  {name.ljust(width)}  "
                f"{st['count']:>5}  "
                f"{st['p50_s']:>7.3f}  {st['p95_s']:>7.3f}  "
                f"{st['mean_s']:>7.3f}  {st['total_s']:>8.3f}"
            )
    else:
        lines.append(
            "stage latencies: no event stream found "
            "(telemetry disabled for this run?)"
        )

    mw = report.get("micrograph_wall_s")
    if mw:
        lines.append(
            f"per-micrograph wall (journal): p50={mw['p50_s']:.3f}s "
            f"p95={mw['p95_s']:.3f}s over {mw['count']}"
        )

    dev = report["device"]
    dev_line = (
        f"device: recompiles={dev['recompiles']} "
        f"transfers={dev['transfer_fetches']} "
        f"({_fmt_bytes(dev['transfer_bytes'])})"
    )
    if "compile_seconds" in dev:
        dev_line += f" compile_time={dev['compile_seconds']:.1f}s"
    lines.append(dev_line)

    dt = report.get("device_time")
    if dt:
        lines.append("device time (host vs device tail, s):")
        for name, st in dt.get("stages", {}).items():
            lines.append(
                f"  {name}: host={st['host_s']:.3f} "
                f"device_tail={st['device_tail_s']:.3f} "
                f"(device_frac={st['device_frac']:.2f})"
            )
        for cap, st in dt.get("by_capacity", {}).items():
            lines.append(
                f"  capacity {cap}: host={st['host_s']:.3f} "
                f"device_tail={st['device_tail_s']:.3f} "
                f"over {st['count']} chunk(s)"
            )
        if "dispatch_gap_s" in dt:
            lines.append(
                f"  dispatch gap (est): {dt['dispatch_gap_s']:.3f}s"
            )
        tr = dt.get("trace")
        if tr:
            lines.append(
                f"  profiler trace: device_busy={tr['device_busy_s']:.3f}s"
                f" of {tr['wall_s']:.3f}s wall "
                f"({tr['device_ops']} device op(s), "
                f"gap={tr['dispatch_gap_s']:.3f}s)"
            )

    req = report.get("requests")
    if req:
        lines.append(f"requests (traces): {req['count']}")
        for tid, tr in sorted(req["traces"].items()):
            segs = " ".join(
                f"{k}={v:.3f}s"
                for k, v in sorted(tr["segments"].items())
            )
            cache = tr.get("cache")
            tail = (
                f" cache_hits={cache['hits']}"
                f" cache_misses={cache['misses']}"
                if cache
                else ""
            )
            job = f" job={tr['job']}" if tr.get("job") else ""
            lines.append(
                f"  {tid}{job} total={tr['total_s']:.3f}s "
                f"{segs}{tail}"
            )
        lines.append(
            "  (waterfall + critical path: repic-tpu trace <dir>)"
        )

    slo = report.get("slo")
    if slo:
        if slo.get("endpoints"):
            lines.append("slo (journal, accept -> terminal):")
            for ep, st in slo["endpoints"].items():
                base = (
                    f"  {ep}: n={st['count']} "
                    f"p50={st['p50_s']:.3f}s p95={st['p95_s']:.3f}s"
                )
                if "budget_burn" in st:
                    base += (
                        f" compliance={st['compliance']:.4f}"
                        f" burn={st['budget_burn']:.2f}"
                        f" (target {st['target_s']:g}s"
                        f"@{st['goal']:g})"
                    )
                lines.append(base)
        win = slo.get("window")
        if win:
            lines.append("slo (last rolling window, gauges):")
            for ep, st in win.items():
                base = f"  {ep}: n={st['count']}"
                if "p95_s" in st:
                    base += f" p95={st['p95_s']:.3f}s"
                if "budget_burn" in st:
                    base += (
                        f" compliance={st.get('compliance', 0):.4f}"
                        f" burn={st['budget_burn']:.2f}"
                    )
                lines.append(base)

    if report["runtime_tsv"]:
        stages = " ".join(
            f"{k}={v:.3f}s"
            for k, v in report["runtime_tsv"].items()
        )
        lines.append(f"runtime.tsv: {stages}")
    return "\n".join(lines)
