"""In-process status server: ``/metrics``, ``/status``, ``/healthz``
(the port's copy of ``repic_tpu_torch.telemetry.server``).

* ``/metrics`` -- Prometheus exposition of the live registry
  (:func:`repic_tpu_torch.telemetry.sinks.render_prometheus`).
* ``/status`` -- one JSON document: run id, chunk progress, ladder and
  quarantine tallies (pushed by the pipeline through
  :func:`set_status`), and the SLO tracker's rolling view.
* ``/healthz`` / ``/healthz/live`` -- liveness (200 ``ok`` while the
  server runs).
* ``/healthz/ready`` -- readiness: 200 only between ``set_ready(True)``
  and ``set_ready(False)``; the consensus pipeline turns it on after
  its first completed chunk and off when the run winds down.

Off by default; ``consensus --status-port`` turns it on (port 0 binds
an ephemeral port).  Binds 127.0.0.1 only.  Without a running server
the surface is inert: :func:`set_status` is one global load and a
branch, and nothing is bound or spawned.  Requests are served by a
stdlib ``ThreadingHTTPServer`` in a daemon thread.

The reference also recomputes cluster, fleet and gang liveness per
scrape from their coordination directories; those layers are not
ported, and a pushed section passes through as pushed.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque

from repic_tpu_torch.telemetry import metrics as _metrics

_ACTIVE: "StatusServer | None" = None
_STATUS: dict = {}
_STATUS_LOCK = threading.Lock()
_SLO: "SLOTracker | None" = None

_HTTP_SECONDS = _metrics.histogram(
    "repic_http_request_seconds",
    "status/serve endpoint latency (by route)",
)

#: hard cap on any request body this server will buffer (413 above)
MAX_REQUEST_BODY = 4 << 20

# The rolling tracker's per-endpoint view as registry gauges, so the
# end-of-run ``_metrics.json`` (and any /metrics scrape) carries
# compliance and burn for ``report``'s slo section.
_SLO_COMPLIANCE = _metrics.gauge(
    "repic_slo_compliance",
    "rolling SLO compliance fraction (by endpoint)",
)
_SLO_BURN = _metrics.gauge(
    "repic_slo_budget_burn",
    "rolling error-budget burn rate (by endpoint)",
)
_SLO_P95 = _metrics.gauge(
    "repic_slo_p95_seconds",
    "rolling p95 latency over the SLO window (by endpoint)",
)
_SLO_COUNT = _metrics.gauge(
    "repic_slo_window_count",
    "observations in the rolling SLO window (by endpoint)",
)


# -- SLO tracking ------------------------------------------------------


def parse_slo_targets(specs) -> dict:
    """``--slo-target`` parser: ``endpoint=seconds[@goal]`` specs.

    ``job=60`` means "jobs should finish within 60 s"; the goal (the
    fraction of requests that must meet the target, default 0.95)
    rides after ``@``: ``queue_wait=5@0.99``.  Returns
    ``{endpoint: (target_s, goal)}``; malformed specs raise
    ``ValueError`` with the offending text (mapped to a CLI error).
    """
    out: dict = {}
    for spec in specs or ():
        try:
            endpoint, rest = spec.split("=", 1)
            if "@" in rest:
                target_s, goal = rest.split("@", 1)
            else:
                target_s, goal = rest, "0.95"
            endpoint = endpoint.strip()
            target = float(target_s)
            goal_f = float(goal)
            if not endpoint or target <= 0 or not (0 < goal_f < 1):
                raise ValueError
        except ValueError:
            raise ValueError(
                f"bad --slo-target {spec!r} (want "
                "endpoint=seconds[@goal], e.g. job=60@0.95)"
            ) from None
        out[endpoint] = (target, goal_f)
    return out


class SLOTracker:
    """Rolling per-endpoint latency objectives + error-budget burn.

    Keeps the last ``window`` observations per (endpoint, bucket) in
    a deque — a ROLLING view, deliberately distinct from the
    registry's cumulative histograms (which a scraper rates over
    time): ``/status`` must answer "how are we doing right now"
    without a Prometheus deployment.  ``summary()`` computes
    p50/p95/p99 plus, for endpoints with a configured objective
    (:func:`parse_slo_targets`), the compliance fraction and the
    error-budget burn rate::

        burn = violating_fraction / (1 - goal)

    burn < 1 means the endpoint is within budget over the window;
    burn = 3 means the budget is being spent 3x too fast — the
    standard multi-window burn-rate alarm input.  Thread-safe; ``observe`` is a
    deque append under the lock, cheap enough for per-request use.
    """

    def __init__(self, objectives: dict | None = None,
                 window: int = 512):
        self.objectives = dict(objectives or {})
        self.window = int(window)
        self._lock = threading.Lock()
        self._samples: dict = {}

    def observe(self, endpoint: str, latency_s: float,
                ok: bool = True, bucket=None) -> None:
        key = (
            str(endpoint),
            None if bucket is None else str(bucket),
        )
        with self._lock:
            dq = self._samples.get(key)
            if dq is None:
                dq = self._samples[key] = deque(maxlen=self.window)
            dq.append((float(latency_s), bool(ok)))

    def _stats(self, rows: list, objective) -> dict:
        lats = [lat for lat, _ in rows]
        out = {
            "count": len(rows),
            "p50_s": round(_metrics.percentile(lats, 0.50), 6),
            "p95_s": round(_metrics.percentile(lats, 0.95), 6),
            "p99_s": round(_metrics.percentile(lats, 0.99), 6),
        }
        if objective is not None and rows:
            target, goal = objective
            bad = sum(
                1 for lat, ok in rows
                if not ok or lat > target
            )
            violating = bad / len(rows)
            out["target_s"] = target
            out["goal"] = goal
            out["compliance"] = round(1.0 - violating, 4)
            out["budget_burn"] = round(
                violating / max(1.0 - goal, 1e-9), 3
            )
        return out

    def summary(self) -> dict:
        """The ``/status`` SLO section: per-endpoint rolling stats
        (aggregated over capacity buckets) with a per-bucket
        breakdown where buckets were observed."""
        with self._lock:
            snap = {
                key: list(dq) for key, dq in self._samples.items()
            }
        by_endpoint: dict = {}
        for (endpoint, bucket), rows in snap.items():
            slot = by_endpoint.setdefault(
                endpoint, {"all": [], "buckets": {}}
            )
            slot["all"].extend(rows)
            if bucket is not None:
                slot["buckets"].setdefault(bucket, []).extend(rows)
        endpoints = {}
        for endpoint in sorted(by_endpoint):
            slot = by_endpoint[endpoint]
            objective = self.objectives.get(endpoint)
            if objective is None and endpoint.startswith("tenant:"):
                # per-tenant job buckets (serve tenancy) inherit the
                # `job` objective: one --slo-target job=... yields a
                # compliance/burn readout PER TENANT, so one
                # tenant's throttling is visibly not another's SLO
                objective = self.objectives.get("job")
            entry = self._stats(slot["all"], objective)
            if slot["buckets"]:
                entry["by_bucket"] = {
                    b: self._stats(rows, objective)
                    for b, rows in sorted(slot["buckets"].items())
                }
            endpoints[endpoint] = entry
        # mirror the rolling view onto the durable gauges: the
        # end-of-run _metrics.json (and any /metrics scrape) then
        # carries the same numbers /status shows live
        for endpoint, entry in endpoints.items():
            _SLO_P95.set(entry["p95_s"], endpoint=endpoint)
            _SLO_COUNT.set(entry["count"], endpoint=endpoint)
            if "budget_burn" in entry:
                _SLO_COMPLIANCE.set(
                    entry["compliance"], endpoint=endpoint
                )
                _SLO_BURN.set(
                    entry["budget_burn"], endpoint=endpoint
                )
        return {
            "window": self.window,
            "objectives": {
                ep: {"target_s": t, "goal": g}
                for ep, (t, g) in sorted(self.objectives.items())
            },
            "endpoints": endpoints,
        }

    def objective_for(self, endpoint: str):
        """The endpoint's objective, with ``tenant:*`` inheriting
        the ``job`` target (the same rule :meth:`summary` applies)."""
        objective = self.objectives.get(endpoint)
        if objective is None and endpoint.startswith("tenant:"):
            objective = self.objectives.get("job")
        return objective

    def budget_burn(self, endpoint: str) -> float | None:
        """The endpoint's current burn rate alone — the autoscaler's
        and the batcher's control signal, cheap enough to poll every
        scheduling pass (one pass over the rolling window, no
        percentile sorts).  ``None`` without an objective or before
        any observation."""
        objective = self.objective_for(endpoint)
        if objective is None:
            return None
        target, goal = objective
        with self._lock:
            rows = [
                row
                for (ep, _bucket), dq in self._samples.items()
                if ep == endpoint
                for row in dq
            ]
        if not rows:
            return None
        bad = sum(1 for lat, ok in rows if not ok or lat > target)
        return (bad / len(rows)) / max(1.0 - goal, 1e-9)


def set_slo_tracker(tracker: "SLOTracker | None") -> "SLOTracker | None":
    """Install the process-wide SLO tracker surfaced on ``/status``;
    returns the previous one.  ``None`` removes the section."""
    global _SLO
    prev = _SLO
    _SLO = tracker
    return prev


def get_slo_tracker() -> "SLOTracker | None":
    return _SLO


def observe_slo(endpoint: str, latency_s: float, ok: bool = True,
                bucket=None) -> None:
    """Record one observation on the active tracker (no-op without
    one — the same near-zero disabled-mode contract as set_status)."""
    if _SLO is not None:
        _SLO.observe(endpoint, latency_s, ok=ok, bucket=bucket)


def _route(path: str) -> str:
    """Coarse endpoint label for the HTTP latency surface (bounded
    cardinality: job ids must never become label values)."""
    if path.startswith("/v1/jobs"):
        parts = [p for p in path.split("/") if p][2:]
        if not parts:
            return "jobs"
        if len(parts) >= 2 and parts[1] == "artifacts":
            return "artifacts"
        return "job"
    if path.startswith("/healthz"):
        return "healthz"
    if path in ("/metrics", "/status"):
        return path[1:]
    return "other"


def set_status(**fields) -> None:
    """Merge fields into the ``/status`` document.

    Near-zero overhead when no server is running (one global load and
    a branch) — the pipeline calls this per chunk unconditionally.
    """
    if _ACTIVE is None:
        return
    with _STATUS_LOCK:
        _STATUS.update(fields)


def get_status() -> dict:
    with _STATUS_LOCK:
        return dict(_STATUS)


def set_ready(flag: bool) -> None:
    """Flip the active server's readiness probe (no-op when none).

    Same near-zero disabled-mode cost as :func:`set_status`."""
    if _ACTIVE is not None:
        _ACTIVE.ready = bool(flag)


def is_ready() -> bool:
    return _ACTIVE is not None and _ACTIVE.ready


def active_server() -> "StatusServer | None":
    return _ACTIVE


class StatusServer:
    """One HTTP endpoint in a daemon thread; start()/stop() or use as
    a context manager.  ``port=0`` binds an ephemeral port — read the
    bound port from ``self.port`` after :meth:`start`."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None):
        self.host = host
        self.requested_port = int(port)
        self.port: int | None = None
        self.registry = registry
        self.ready = False
        self._httpd = None
        self._thread: threading.Thread | None = None

    def handle_request(self, handler, method: str, path: str,
                       body: bytes) -> bool:
        """Subclass hook: serve one request, return True if handled.

        A serving daemon extends the endpoint surface (``/v1/jobs``
        ...) by overriding this; the plumbing (threading, dispatch,
        readiness, client-abort tolerance) stays here.  Use
        ``handler._send`` / ``handler.send_header`` for responses.
        """
        return False

    def start(self) -> "StatusServer":
        global _ACTIVE
        import http.server  # lazy: the module is inert unless served

        registry = self.registry or _metrics.get_registry()
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            # a client that connects and never completes a request
            # must not pin its handler thread forever
            timeout = 30.0

            def _dispatch(self, method: str):
                path = self.path.split("?", 1)[0]
                # per-endpoint latency: time the whole handling,
                # observe into the shared histogram + the SLO
                # tracker's rolling window (both label by the
                # bounded route, never by job id)
                t0 = time.perf_counter()
                self._last_code = 200
                try:
                    self._dispatch_inner(method, path)
                except BaseException:
                    # the client saw a dropped connection, not a
                    # response — the SLO must count it as a failure
                    self._last_code = 500
                    raise
                finally:
                    route = _route(path)
                    dur = time.perf_counter() - t0
                    _HTTP_SECONDS.observe(dur, route=route)
                    observe_slo(
                        "http:" + route, dur,
                        ok=self._last_code < 500,
                    )

            def _dispatch_inner(self, method: str, path: str):
                try:
                    length = int(
                        self.headers.get("Content-Length") or 0
                    )
                except ValueError:
                    self._send(
                        400, "text/plain; charset=utf-8",
                        "bad Content-Length\n",
                    )
                    return
                if not 0 <= length <= MAX_REQUEST_BODY:
                    # refuse to buffer an absurd body — a NEGATIVE
                    # length would make read(-1) buffer until the
                    # client closes, the exact abuse this cap stops;
                    # the serve layer re-checks its own tighter cap
                    self._send(
                        413, "text/plain; charset=utf-8",
                        "request body too large\n",
                    )
                    return
                body = self.rfile.read(length) if length else b""
                if server.handle_request(self, method, path, body):
                    return
                if method != "GET":
                    self._send(
                        405, "text/plain; charset=utf-8",
                        "method not allowed\n",
                    )
                elif path in ("/healthz", "/healthz/live"):
                    self._send(
                        200, "text/plain; charset=utf-8", "ok\n"
                    )
                elif path == "/healthz/ready":
                    if server.ready:
                        self._send(
                            200, "text/plain; charset=utf-8",
                            "ready\n",
                        )
                    else:
                        self._send(
                            503, "text/plain; charset=utf-8",
                            "unready (warming up or draining)\n",
                        )
                elif path == "/metrics":
                    from repic_tpu_torch.telemetry import sinks

                    self._send(
                        200,
                        "text/plain; version=0.0.4; charset=utf-8",
                        sinks.render_prometheus(registry.as_dict()),
                    )
                elif path == "/status":
                    self._send(
                        200,
                        "application/json",
                        json.dumps(
                            server.status_document(),
                            default=str,
                            sort_keys=True,
                        )
                        + "\n",
                    )
                else:
                    self._send(
                        404, "text/plain; charset=utf-8",
                        "not found (try /metrics, /status, /healthz)\n",
                    )

            def do_GET(self):  # noqa: N802 - http.server protocol
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802 - http.server protocol
                self._dispatch("POST")

            def do_DELETE(self):  # noqa: N802 - http.server protocol
                self._dispatch("DELETE")

            def _send(self, code: int, ctype: str, body: str,
                      headers: dict | None = None):
                self._last_code = code
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in (headers or {}).items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # no per-request stderr spam
                pass

        class _QuietServer(http.server.ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # slow/vanished clients (broken pipe, reset) are the
                # CLIENT's failure: drop the connection silently
                # instead of spraying a traceback per disconnect;
                # anything else keeps the stdlib diagnostics
                import sys

                exc = sys.exc_info()[1]
                if isinstance(
                    exc, (BrokenPipeError, ConnectionResetError,
                          TimeoutError)
                ):
                    return
                super().handle_error(request, client_address)

        self._httpd = _QuietServer(
            (self.host, self.requested_port), Handler
        )
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.25},
            daemon=True,
            name="repic-tpu-status",
        )
        self._thread.start()
        _ACTIVE = self
        return self

    def stop(self) -> None:
        global _ACTIVE
        self.ready = False
        if _ACTIVE is self:
            _ACTIVE = None
            with _STATUS_LOCK:
                _STATUS.clear()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def status_document(self) -> dict:
        """The ``/status`` JSON: the pushed fields, the time, and the
        SLO tracker's summary when one is installed."""
        doc = get_status()
        doc["ts"] = time.time()
        if _SLO is not None:
            doc["slo"] = _SLO.summary()
        return doc

    def __enter__(self) -> "StatusServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@contextlib.contextmanager
def maybe_status_server(port: int | None):
    """CLI helper: a running server when ``port`` is set, else a pure
    no-op (nothing bound, nothing spawned — zero overhead)."""
    if port is None:
        yield None
        return
    try:
        srv = StatusServer(port).start()
    except OSError as e:
        # fail fast and readable — before the run touches anything
        raise SystemExit(
            f"repic-tpu-torch: --status-port {port}: cannot bind ({e})"
        ) from e
    try:
        yield srv
    finally:
        srv.stop()
