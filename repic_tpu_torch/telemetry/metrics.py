"""Process-wide metrics registry: counters, gauges, histograms
(the port's copy of ``repic_tpu.telemetry.metrics``).

A registry of named instruments with label support, exported by
:mod:`repic_tpu_torch.telemetry.sinks` (JSON snapshot, Prometheus
textfile) and joined into run summaries by ``report``.  Metric names,
help strings, bucket edges and the snapshot layout are the
reference's, so a dashboard reads either package's files.

* **Near-zero overhead when disabled.**  Every instrument method
  starts with one attribute load and a branch;
  ``REPIC_TPU_TELEMETRY=0`` (or :func:`set_enabled`) turns the whole
  surface into no-ops.
* **Get-or-create instruments.**  Modules declare their instruments
  at import time; a repeated declaration returns the same handle, and
  a kind mismatch on an existing name raises.
* **Fixed-bucket histograms.**  Static bucket edges (the Prometheus
  model): one ``observe`` allocates nothing.

Instruments are thread-safe (one registry lock: the prefetch worker,
the loader pool and the status server all touch them).
"""

from __future__ import annotations

import math
import os
import threading

# Default histogram bucket edges (seconds) — span latencies from
# sub-ms host work to multi-minute compiles; +Inf is implicit.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (exact for the small sample counts a
    run or rolling window produces; no interpolation at N=1).  The one
    quantile definition that ``report`` and the SLO tracker share."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(int(math.ceil(q * len(ordered))) - 1, 0)
    return float(ordered[min(rank, len(ordered) - 1)])


def _env_enabled() -> bool:
    return os.environ.get("REPIC_TPU_TELEMETRY", "1").lower() not in (
        "0", "false", "off",
    )


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Instrument:
    """Shared name/help/labelset bookkeeping for all three kinds."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str,
                 help: str):
        self._registry = registry
        self.name = name
        self.help = help
        self._samples: dict[tuple, object] = {}

    def samples(self) -> dict[tuple, object]:
        with self._registry._lock:
            return dict(self._samples)

    def clear(self) -> None:
        with self._registry._lock:
            self._samples.clear()


class Counter(_Instrument):
    """Monotonically increasing value per labelset."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not self._registry._enabled:
            return
        if value < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc {value})"
            )
        key = _label_key(labels)
        with self._registry._lock:
            self._samples[key] = self._samples.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))


class Gauge(_Instrument):
    """Last-written value per labelset (set or add)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._registry._enabled:
            return
        with self._registry._lock:
            self._samples[_label_key(labels)] = float(value)

    def add(self, value: float, **labels) -> None:
        if not self._registry._enabled:
            return
        key = _label_key(labels)
        with self._registry._lock:
            self._samples[key] = self._samples.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._samples.get(_label_key(labels), 0.0))


class Histogram(_Instrument):
    """Fixed-bucket histogram: cumulative counts, sum, and count.

    Bucket edges are static (Prometheus ``le`` semantics: an
    observation lands in every bucket whose edge is >= value, with
    +Inf implicit), so ``observe`` allocates nothing on the hot path.
    """

    kind = "histogram"

    def __init__(self, registry, name, help,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: empty bucket list")

    def observe(self, value: float, **labels) -> None:
        if not self._registry._enabled:
            return
        key = _label_key(labels)
        with self._registry._lock:
            state = self._samples.get(key)
            if state is None:
                state = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
                self._samples[key] = state
            # linear scan: bucket lists are short and mostly hit the
            # low end (sub-second spans), so this beats bisect's call
            # overhead in practice
            i = 0
            for edge in self.buckets:
                if value <= edge:
                    break
                i += 1
            state["counts"][i] += 1
            state["sum"] += float(value)
            state["count"] += 1

    def samples(self) -> dict[tuple, object]:
        # deep-copy UNDER the lock: the per-labelset state dicts are
        # mutated in place by observe(), so the base class's shallow
        # copy could be read mid-update from another thread and yield
        # bucket counts disagreeing with count/sum
        with self._registry._lock:
            return {
                k: {
                    "counts": list(v["counts"]),
                    "sum": v["sum"],
                    "count": v["count"],
                }
                for k, v in self._samples.items()
            }

    def snapshot(self, **labels) -> dict | None:
        return self.samples().get(_label_key(labels))


class MetricsRegistry:
    """Named instruments with one shared enabled flag and lock."""

    def __init__(self, enabled: bool | None = None):
        self._lock = threading.Lock()
        self._instruments: dict[str, _Instrument] = {}
        self._enabled = _env_enabled() if enabled is None else enabled

    # -- enable/disable ----------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, flag: bool) -> None:
        self._enabled = bool(flag)

    # -- instrument declaration (get-or-create) ----------------------

    def _declare(self, cls, name, help, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if inst.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, requested {cls.kind}"
                    )
                return inst
            inst = cls(self, name, help, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets)

    # -- reads -------------------------------------------------------

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return list(self._instruments.values())

    def as_dict(self) -> dict:
        """JSON-safe snapshot of every instrument and labelset."""
        out = {}
        for inst in self.instruments():
            samples = []
            for key, val in sorted(inst.samples().items()):
                labels = {k: v for k, v in key}
                if inst.kind == "histogram":
                    samples.append(
                        {
                            "labels": labels,
                            "buckets": list(val["counts"]),
                            "sum": val["sum"],
                            "count": val["count"],
                        }
                    )
                else:
                    v = float(val)
                    if math.isnan(v) or math.isinf(v):
                        v = None
                    samples.append({"labels": labels, "value": v})
            entry = {
                "kind": inst.kind,
                "help": inst.help,
                "samples": samples,
            }
            if inst.kind == "histogram":
                entry["bucket_edges"] = list(inst.buckets)
            out[inst.name] = entry
        return out

    def reset(self) -> None:
        """Clear sample values (instrument handles stay valid — the
        instrumented modules hold references created at import)."""
        for inst in self.instruments():
            inst.clear()


# The process-wide default registry.  Instrumented modules use the
# module-level shorthands below so every metric lands here.
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY


def enabled() -> bool:
    return REGISTRY.enabled


def set_enabled(flag: bool) -> None:
    REGISTRY.set_enabled(flag)


def diff_snapshots(current: dict, baseline: dict) -> dict:
    """Per-run view of an :meth:`MetricsRegistry.as_dict` snapshot.

    Counters and histograms are ADDITIVE across runs in one process
    (module-scope instrument handles live for the process lifetime),
    so a run's own numbers are ``current - baseline``; gauges are
    point-in-time and pass through unchanged.  Zero-delta samples are
    dropped — they belong to some earlier run, not this one.
    """
    out = {}
    for name, entry in current.items():
        base = baseline.get(name)
        if entry["kind"] == "gauge" or base is None:
            out[name] = entry
            continue
        base_by_labels = {
            tuple(sorted(s["labels"].items())): s
            for s in base["samples"]
        }
        samples = []
        for s in entry["samples"]:
            b = base_by_labels.get(tuple(sorted(s["labels"].items())))
            if b is None:
                samples.append(s)
                continue
            if entry["kind"] == "histogram":
                count = s["count"] - b["count"]
                if count <= 0:
                    continue
                samples.append(
                    {
                        "labels": s["labels"],
                        "buckets": [
                            c - c0
                            for c, c0 in zip(
                                s["buckets"], b["buckets"]
                            )
                        ],
                        "sum": s["sum"] - b["sum"],
                        "count": count,
                    }
                )
            else:
                delta = (s["value"] or 0.0) - (b["value"] or 0.0)
                if delta == 0.0:
                    continue
                samples.append({"labels": s["labels"], "value": delta})
        pruned = dict(entry)
        pruned["samples"] = samples
        out[name] = pruned
    return out


def counter(name: str, help: str = "") -> Counter:
    return REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets)
