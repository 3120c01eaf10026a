"""Metric exporters: JSON snapshot, Prometheus textfile, runtime TSV
(the port's copy of ``repic_tpu.telemetry.sinks``).

* :func:`write_metrics_json` -- the machine-readable snapshot that
  ``report`` joins with the run journal and the event stream.
* :func:`write_prometheus_textfile` -- Prometheus exposition format
  for the node-exporter textfile collector.
* :func:`write_runtime_tsv` -- the reference's ``*_runtime.tsv``
  shape (one ``stage<TAB>seconds`` row per stage).

Every write is atomic (:mod:`repic_tpu_torch.runtime.atomic`): a sink
file is the previous complete snapshot or the new one, never torn.
"""

from __future__ import annotations

import json
import os
import time

from repic_tpu_torch.runtime.atomic import atomic_write
from repic_tpu_torch.telemetry import metrics as _metrics

METRICS_JSON_NAME = "_metrics.json"
METRICS_PROM_NAME = "_metrics.prom"


def host_metrics_json_name(host: str) -> str:
    """Per-host JSON snapshot name: the ``_journal.<host>.jsonl``
    scheme, so processes sharing a run directory never clobber each
    other's snapshot."""
    from repic_tpu_torch.runtime.journal import sanitize_host_id

    return f"_metrics.{sanitize_host_id(host)}.json"


def host_metrics_prom_name(host: str) -> str:
    from repic_tpu_torch.runtime.journal import sanitize_host_id

    return f"_metrics.{sanitize_host_id(host)}.prom"


def metrics_json_paths(out_dir: str) -> list[tuple[str | None, str]]:
    """``(host, path)`` for every metrics snapshot of a run — the
    single-process ``_metrics.json`` (host ``None``) plus any per-host
    ``_metrics.<host>.json``, hosts sorted."""
    from repic_tpu_torch.runtime.journal import host_artifact_paths

    return host_artifact_paths(out_dir, METRICS_JSON_NAME)


def read_all_metrics_json(out_dir: str) -> dict:
    """``{host_or_None: metrics-mapping}`` over every snapshot of a
    run directory.  Cluster runs produce one snapshot per host;
    ``report`` sums the per-host device totals and keeps the
    per-host breakdown in its cluster section."""
    return {
        host: read_metrics_json(path)
        for host, path in metrics_json_paths(out_dir)
    }


def write_metrics_json(path: str, registry=None, data=None) -> str:
    """Snapshot the registry as one JSON document; returns ``path``.

    ``data`` overrides the registry with a pre-computed
    ``as_dict``-shaped mapping (e.g. a per-run
    :func:`~repic_tpu_torch.telemetry.metrics.diff_snapshots` view).
    """
    if data is None:
        data = (registry or _metrics.get_registry()).as_dict()
    with atomic_write(path) as f:
        json.dump({"ts": time.time(), "metrics": data}, f, indent=2)
    return path


def read_metrics_json(path_or_dir: str) -> dict:
    """The ``metrics`` mapping of a snapshot, or {} when absent."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, METRICS_JSON_NAME)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data.get("metrics", {}) if isinstance(data, dict) else {}


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _escape(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value) -> str:
    if value is None:
        return "NaN"
    f = float(value)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(data: dict) -> str:
    """Prometheus exposition text for an ``as_dict``-shaped mapping.

    Histograms expand to ``_bucket{le=...}`` series with CUMULATIVE
    counts (the stored per-bucket counts are disjoint), plus ``_sum``
    and ``_count``; the terminal ``le="+Inf"`` bucket equals
    ``_count`` as the format requires.  Shared by the textfile sink
    and the live ``/metrics`` endpoint
    (:mod:`repic_tpu_torch.telemetry.server`).
    """
    lines: list[str] = []
    for name, entry in sorted(data.items()):
        lines.append(f"# HELP {name} {entry['help']}")
        lines.append(f"# TYPE {name} {entry['kind']}")
        if entry["kind"] == "histogram":
            edges = entry["bucket_edges"]
            for sample in entry["samples"]:
                labels = sample["labels"]
                cum = 0
                for edge, n in zip(edges, sample["buckets"]):
                    cum += n
                    le = dict(labels, le=_fmt(edge))
                    lines.append(
                        f"{name}_bucket{_prom_labels(le)} {cum}"
                    )
                le = dict(labels, le="+Inf")
                lines.append(
                    f"{name}_bucket{_prom_labels(le)} "
                    f"{sample['count']}"
                )
                lines.append(
                    f"{name}_sum{_prom_labels(labels)} "
                    f"{_fmt(sample['sum'])}"
                )
                lines.append(
                    f"{name}_count{_prom_labels(labels)} "
                    f"{sample['count']}"
                )
        else:
            for sample in entry["samples"]:
                lines.append(
                    f"{name}{_prom_labels(sample['labels'])} "
                    f"{_fmt(sample['value'])}"
                )
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus_textfile(path: str, registry=None,
                              data=None) -> str:
    """Write the registry as a Prometheus textfile
    (:func:`render_prometheus`); ``data`` overrides the registry as in
    :func:`write_metrics_json`.
    """
    if data is None:
        data = (registry or _metrics.get_registry()).as_dict()
    with atomic_write(path) as f:
        f.write(render_prometheus(data))
    return path


def write_runtime_tsv(
    out_dir: str, stages, name: str = "runtime.tsv"
) -> str:
    """Legacy ``stage<TAB>seconds`` rows (drop-in reference shape).

    ``stages`` is an iterable of ``(label, seconds)`` in run order;
    repeated labels stay as separate rows, exactly as the reference's
    appending writers produced them.
    """
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with atomic_write(path) as f:
        for label, secs in stages:
            f.write(f"{label}\t{secs:.6f}\n")
    return path
