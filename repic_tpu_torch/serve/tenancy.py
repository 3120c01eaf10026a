"""Per-tenant auth, rate limits and quotas for ``serve`` (the port's own
copy of ``repic_tpu.serve.tenancy``).

The pure policy half -- who a request belongs to and whether that
tenant may submit now -- host-only stdlib and free of serve imports,
so the queue layer (:mod:`repic_tpu_torch.serve.jobs`) imports it
without a cycle.  The enforcement points are admission under the
queue lock, the HTTP handler and the batcher's deal loop.

* **Identity** -- a JSON keyfile (``--tenants FILE``) maps API keys to
  tenant names; requests send ``Authorization: Bearer <key>``.  A
  missing or malformed header is a 401, an unknown key a 403.  A
  tenant named ``anonymous`` (and only that one) may declare no keys
  and then admits keyless requests under its limits.  Without a
  keyfile every request resolves to no tenant.
* **Rate** -- a token bucket per tenant (``rate`` jobs/s, ``burst``);
  an empty bucket is a 429 whose ``Retry-After`` is the exact refill
  time to the next token.
* **Quotas** -- caps on open jobs (``max_open_jobs``) and queued
  micrographs (``max_queued_micrographs``), checked at admission
  beside the global queue-full 429, priced in the same decayed
  per-micrograph service time, each with its own ``cause``.

The keyfile parser is untrusted input: a bad file is a ``ValueError``
at startup, never a crash.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from dataclasses import dataclass, field

from repic_tpu_torch import telemetry

TENANT_ANONYMOUS = "anonymous"

#: brownout priority classes, best-kept-first: under staged load
#: shedding (docs/serving.md "Autoscaling & brownout") ``low`` is
#: refused admission first, then ``normal``; ``high`` is never shed
#: at admission.  Tenants without a declared class — and requests
#: with no tenant at all — are ``normal``.
PRIORITIES = ("high", "normal", "low")
DEFAULT_PRIORITY = "normal"

#: tenant names become metric label values, SLO endpoint names, and
#: journal fields — one restricted alphabet, like journal host ids
_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

#: hard caps on the keyfile, mirroring the submission validator's
#: philosophy: anything past these is a config bug, not a workload
MAX_TENANTS = 256
MAX_KEYS_PER_TENANT = 16
MAX_KEY_LEN = 256
MAX_TENANTS_FILE_BYTES = 1 << 20

_ADMITTED = telemetry.counter(
    "repic_tenant_admitted_total",
    "serve submissions accepted, by tenant",
)
_REJECTED = telemetry.counter(
    "repic_tenant_rejected_total",
    "serve submissions refused at a tenant limit (by tenant, cause)",
)
_TENANT_JOBS = telemetry.counter(
    "repic_tenant_jobs_total",
    "serve jobs reaching a terminal state (by tenant, state)",
)
_AUTH_FAILURES = telemetry.counter(
    "repic_tenant_auth_failures_total",
    "requests refused at authentication (by http code)",
)
_OPEN_JOBS = telemetry.gauge(
    "repic_tenant_open_jobs",
    "queued + running serve jobs, by tenant",
)
_QUEUED_MICS = telemetry.gauge(
    "repic_tenant_queued_micrographs",
    "admission-time micrograph estimate queued, by tenant",
)


def note_admitted(tenant: str) -> None:
    _ADMITTED.inc(tenant=tenant)


def note_rejected(tenant: str, cause: str) -> None:
    _REJECTED.inc(tenant=tenant, cause=cause)


def note_job(tenant: str, state: str) -> None:
    _TENANT_JOBS.inc(tenant=tenant, state=state)


def note_auth_failure(code: int,
                      cause: str = "credentials") -> None:
    """``cause`` separates bad credentials (401/unknown key) from
    ownership denials (another tenant's job id) — an alert on
    credential problems must not fire on benign wrong-job 403s."""
    _AUTH_FAILURES.inc(code=str(code), cause=cause)


def set_tenant_gauges(tenant: str, open_jobs: int,
                      queued_micrographs: int) -> None:
    _OPEN_JOBS.set(open_jobs, tenant=tenant)
    _QUEUED_MICS.set(queued_micrographs, tenant=tenant)


class AuthError(Exception):
    """A request this daemon refuses to identify, mapped to HTTP.

    401 (no usable credential — the client should send one) vs 403
    (a credential that names nobody — re-sending it will not help);
    the split matters to retrying clients and to dashboards."""

    def __init__(self, http_status: int, reason: str):
        super().__init__(reason)
        self.http_status = int(http_status)
        self.reason = reason


@dataclass(frozen=True)
class TenantSpec:
    """One tenant's declared identity and limits.

    ``rate``/``burst`` bound submission frequency;
    ``max_open_jobs`` bounds concurrency (queued + running);
    ``max_queued_micrographs`` bounds how much WORK may sit queued
    (the unit the Retry-After estimate is priced in).  ``None``
    means unlimited — a tenant entry with only keys is pure
    identity/attribution."""

    name: str
    keys: tuple = ()
    rate: float | None = None          # jobs per second
    burst: int = 1                     # bucket capacity
    max_open_jobs: int | None = None
    max_queued_micrographs: int | None = None
    priority: str = DEFAULT_PRIORITY   # brownout shed class


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"tenants file: {msg}")


def _parse_spec(entry: object, index: int) -> TenantSpec:
    _require(
        isinstance(entry, dict),
        f"tenant #{index} must be an object, got "
        f"{type(entry).__name__}",
    )
    known = {
        "name", "keys", "rate", "burst", "max_open_jobs",
        "max_queued_micrographs", "priority",
    }
    unknown = sorted(str(k)[:80] for k in set(entry) - known)
    _require(
        not unknown,
        f"tenant #{index}: unknown field(s) {unknown}; "
        f"known: {sorted(known)}",
    )
    name = entry.get("name")
    _require(
        isinstance(name, str) and bool(_NAME_RE.match(name)),
        f"tenant #{index}: name must match "
        f"{_NAME_RE.pattern}, got {str(name)[:80]!r}",
    )
    keys = entry.get("keys", [])
    _require(
        isinstance(keys, list)
        and len(keys) <= MAX_KEYS_PER_TENANT
        and all(
            isinstance(k, str) and 0 < len(k) <= MAX_KEY_LEN
            and "\n" not in k and "\r" not in k
            for k in keys
        ),
        f"tenant {name!r}: keys must be a list of at most "
        f"{MAX_KEYS_PER_TENANT} non-empty single-line strings "
        f"of at most {MAX_KEY_LEN} chars",
    )
    if name == TENANT_ANONYMOUS:
        _require(
            not keys,
            f"the {TENANT_ANONYMOUS!r} tenant admits KEYLESS "
            "requests and must not declare keys",
        )
    else:
        _require(
            bool(keys),
            f"tenant {name!r} declares no keys (only the "
            f"{TENANT_ANONYMOUS!r} tenant may)",
        )
    rate = entry.get("rate")
    if rate is not None:
        _require(
            isinstance(rate, (int, float))
            and not isinstance(rate, bool)
            and math.isfinite(rate) and 0 < rate <= 1e6,
            f"tenant {name!r}: rate must be a positive finite "
            "number of jobs/second",
        )
        rate = float(rate)
    burst = entry.get("burst", 1)
    _require(
        isinstance(burst, int) and not isinstance(burst, bool)
        and 1 <= burst <= 10**6,
        f"tenant {name!r}: burst must be an int >= 1",
    )
    caps = {}
    for cap in ("max_open_jobs", "max_queued_micrographs"):
        v = entry.get(cap)
        if v is not None:
            _require(
                isinstance(v, int) and not isinstance(v, bool)
                and 1 <= v <= 10**9,
                f"tenant {name!r}: {cap} must be an int >= 1",
            )
        caps[cap] = v
    priority = entry.get("priority", DEFAULT_PRIORITY)
    _require(
        priority in PRIORITIES,
        f"tenant {name!r}: priority must be one of "
        f"{list(PRIORITIES)}, got {str(priority)[:80]!r}",
    )
    return TenantSpec(
        name=name,
        keys=tuple(keys),
        rate=rate,
        burst=burst,
        priority=priority,
        **caps,
    )


def parse_tenants(data: object) -> list[TenantSpec]:
    """Validate a decoded tenants document into specs.

    Document shape::

        {"tenants": [{"name": "teamA", "keys": ["sk-..."],
                      "rate": 2.0, "burst": 4,
                      "max_open_jobs": 4,
                      "max_queued_micrographs": 64}, ...]}

    Raises ``ValueError`` with an operator-readable message on ANY
    malformation — the fuzz suite holds this to "ValueError or a
    valid list, nothing else".
    """
    _require(
        isinstance(data, dict),
        f"document must be a JSON object, got "
        f"{type(data).__name__}",
    )
    unknown = sorted(str(k)[:80] for k in set(data) - {"tenants"})
    _require(not unknown, f"unknown top-level field(s) {unknown}")
    tenants = data.get("tenants")
    _require(
        isinstance(tenants, list) and tenants,
        "a non-empty 'tenants' list is required",
    )
    _require(
        len(tenants) <= MAX_TENANTS,
        f"more than {MAX_TENANTS} tenants",
    )
    specs = [_parse_spec(e, i) for i, e in enumerate(tenants)]
    names = [s.name for s in specs]
    _require(
        len(set(names)) == len(names),
        "duplicate tenant names",
    )
    all_keys: list[str] = []
    for s in specs:
        all_keys.extend(s.keys)
    _require(
        len(set(all_keys)) == len(all_keys),
        "the same key appears under two tenants",
    )
    return specs


def load_tenants(path: str) -> list[TenantSpec]:
    """Read + validate a tenants keyfile.  ``ValueError`` on any
    problem (unreadable file included — a daemon must fail loudly at
    startup, not silently serve unauthenticated)."""
    try:
        size = os.path.getsize(path)
        if size > MAX_TENANTS_FILE_BYTES:
            raise ValueError(
                f"tenants file {path!r} exceeds "
                f"{MAX_TENANTS_FILE_BYTES} bytes"
            )
        with open(path, encoding="utf-8") as f:
            raw = f.read()
    except OSError as e:
        raise ValueError(f"cannot read tenants file {path!r}: {e}")\
            from None
    try:
        data = json.loads(raw)
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(
            f"tenants file {path!r} is not valid JSON: {e}"
        ) from None
    return parse_tenants(data)


@dataclass
class _TokenBucket:
    """The standard refill-on-read token bucket (no timer thread).

    State is guarded by the registry lock; ``take`` either consumes
    one token or reports the exact seconds until one exists — the
    429's ``Retry-After`` is derived, not guessed."""

    rate: float
    burst: int
    tokens: float = field(default=0.0)
    #: None until the first take — a timestamp sentinel (0.0) would
    #: misbehave under injected clocks that legitimately start at 0
    last: float | None = field(default=None)

    def take(self, now: float) -> float:
        """0.0 on success (a token was consumed), else seconds until
        the next token refills."""
        if self.last is not None:
            self.tokens = min(
                float(self.burst),
                self.tokens + (now - self.last) * self.rate,
            )
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate


class TenantRegistry:
    """The resolved keyfile plus live per-tenant rate state.

    Constructed once at daemon start; ``resolve`` runs per request
    (dict lookups), ``check_admission`` runs under the queue lock
    (compare-and-bucket-take — no I/O, no blocking inside another
    component's critical section)."""

    def __init__(self, specs, *, clock=time.time):
        specs = list(specs)
        if not specs:
            raise ValueError("TenantRegistry needs >= 1 tenant")
        self._clock = clock
        self._lock = threading.Lock()
        self._specs = {s.name: s for s in specs}
        self._by_key = {
            k: s.name for s in specs for k in s.keys
        }
        self._buckets = {
            s.name: _TokenBucket(
                rate=s.rate, burst=s.burst,
                tokens=float(s.burst),  # full burst from the start
            )
            for s in specs
            if s.rate is not None
        }
        self._rejected: dict[tuple, int] = {}

    @classmethod
    def load(cls, path: str, *, clock=time.time) -> "TenantRegistry":
        return cls(load_tenants(path), clock=clock)

    def names(self) -> list[str]:
        return sorted(self._specs)

    def spec(self, name: str) -> TenantSpec | None:
        return self._specs.get(name)

    def priority(self, name: str | None) -> str:
        """The brownout class of ``name`` — ``normal`` for no tenant
        (tenancy off / pre-tenancy jobs) and for unknown names, so
        shedding composes with every identity configuration."""
        spec = self._specs.get(name) if name is not None else None
        return spec.priority if spec is not None \
            else DEFAULT_PRIORITY

    # -- identity -----------------------------------------------------

    def resolve(self, authorization: str | None) -> str:
        """Map an ``Authorization`` header to a tenant name.

        Raises :class:`AuthError` — 401 for a missing or malformed
        credential (the ``anonymous`` tenant, when declared, admits
        the missing case), 403 for a well-formed key that names
        nobody.  Total over arbitrary header bytes: the fuzz suite
        holds this to "AuthError or a tenant name"."""
        if authorization is None or not str(authorization).strip():
            if TENANT_ANONYMOUS in self._specs:
                return TENANT_ANONYMOUS
            raise AuthError(
                401, "missing Authorization: Bearer <key>"
            )
        parts = str(authorization).strip().split(None, 1)
        if len(parts) != 2 or parts[0].lower() != "bearer":
            raise AuthError(
                401,
                "malformed Authorization header "
                "(want: Bearer <key>)",
            )
        key = parts[1].strip()
        if not key or len(key) > MAX_KEY_LEN:
            raise AuthError(401, "malformed bearer key")
        name = self._by_key.get(key)
        if name is None:
            raise AuthError(403, "unknown API key")
        return name

    # -- admission ----------------------------------------------------

    def check_admission(
        self,
        tenant: str,
        *,
        micrographs: int,
        open_jobs: int,
        queued_micrographs: int,
        per_mic_s: float = 2.0,
    ) -> tuple[str, float] | None:
        """One tenant-limit decision: ``None`` admits (and consumes
        a rate token), else ``(cause, retry_after_s)`` for the 429.

        Called with the caller's queue lock held — the quota
        comparison and the token take must be atomic with the
        admission that follows, exactly like the global queue-full
        check.  Quota causes price the Retry-After as the time to
        drain the tenant's OWN backlog (decayed per-micrograph
        service time × their queued micrographs); the rate cause
        prices it as the exact bucket refill.
        """
        spec = self._specs.get(tenant)
        if spec is None:
            # an unknown name can only reach here through a caller
            # bug; refuse closed rather than admit unmetered
            return ("tenant_unknown", 30.0)
        if (
            spec.max_open_jobs is not None
            and open_jobs >= spec.max_open_jobs
        ):
            return self._reject(
                tenant,
                "tenant_open_jobs",
                max(queued_micrographs, 1) * per_mic_s,
            )
        if spec.max_queued_micrographs is not None:
            if max(micrographs, 1) > spec.max_queued_micrographs:
                # the job ALONE exceeds the quota: no amount of
                # queue drain ever admits it, so the refusal must
                # be the permanent kind (413), not a retryable 429
                # a well-behaved client would replay forever
                return self._reject(
                    tenant, "tenant_job_too_large", 0.0
                )
            if (
                queued_micrographs + max(micrographs, 1)
                > spec.max_queued_micrographs
            ):
                return self._reject(
                    tenant,
                    "tenant_micrographs",
                    max(queued_micrographs, 1) * per_mic_s,
                )
        if spec.rate is not None:
            with self._lock:
                wait = self._buckets[tenant].take(self._clock())
            if wait > 0.0:
                return self._reject(tenant, "tenant_rate", wait)
        return None

    def _reject(self, tenant: str, cause: str,
                retry_after_s: float) -> tuple[str, float]:
        with self._lock:
            key = (tenant, cause)
            self._rejected[key] = self._rejected.get(key, 0) + 1
        note_rejected(tenant, cause)
        return (cause, retry_after_s)

    # -- status -------------------------------------------------------

    def describe(self, name: str) -> dict:
        """The /status view of one tenant's configured limits and
        live rate state (never the keys)."""
        spec = self._specs[name]
        out: dict = {"priority": spec.priority}
        if spec.rate is not None:
            with self._lock:
                b = self._buckets[name]
                tokens = b.tokens
                if b.last is not None:
                    tokens = min(
                        float(b.burst),
                        b.tokens
                        + (self._clock() - b.last) * b.rate,
                    )
            out["rate"] = {
                "jobs_per_s": spec.rate,
                "burst": spec.burst,
                "tokens": round(tokens, 3),
            }
        if spec.max_open_jobs is not None:
            out["max_open_jobs"] = spec.max_open_jobs
        if spec.max_queued_micrographs is not None:
            out["max_queued_micrographs"] = (
                spec.max_queued_micrographs
            )
        with self._lock:
            rej = {
                cause: n
                for (t, cause), n in sorted(self._rejected.items())
                if t == name
            }
        if rej:
            out["rejected"] = rej
        return out
