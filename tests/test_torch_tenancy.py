"""The port's tenancy and submission validation against the JAX
package's, on the CPU: the cases of ``tests/test_tenancy.py`` and
``tests/test_serve_fuzz.py``.

Pure policy (the keyfile parser, token buckets under an injected
clock, quotas, breaker scoping, the tenant-fair deal, ``from_dict`` and
``validate_submission`` on the fuzz corpus) gives equal outputs, or
equal exception types and messages, on the same inputs; the HTTP cases
drive both daemons with the same keys and compare the status codes,
the bodies projected and the attributions.
"""

import http.client
import itertools
import json
import math
import random
import string
import time
from types import SimpleNamespace

import pytest

from repic_tpu_torch.utils.synthetic import job_view
from torch_serve_common import (
    FIXTURE,
    REPO,
    SUBMIT,
    both,
    mods,
    new_daemon,
    req,
    running,
    wait_terminal,
)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _registry(pkg, clk=None, **overrides):
    t = mods(pkg).tenancy
    specs = [
        t.TenantSpec(name="teamA", keys=("ka",), **overrides),
        t.TenantSpec(name="teamB", keys=("kb",)),
    ]
    return t.TenantRegistry(specs, clock=clk or time.time)


def _outcome(fn):
    """``("ok", value)`` or ``("raise", type name, message, http
    status or None, reason or None)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raise", type(e).__name__, str(e),
                getattr(e, "http_status", None), getattr(e, "reason",
                                                         None))


def _spec_view(s):
    return (s.name, tuple(s.keys), s.rate, s.burst, s.max_open_jobs,
            s.max_queued_micrographs, s.priority)


# -- keyfile parsing ---------------------------------------------------


def test_parse_tenants_valid_and_resolve():
    doc = {"tenants": [
        {"name": "teamA", "keys": ["sk-a-1", "sk-a-2"], "rate": 2.0,
         "burst": 4, "max_open_jobs": 3, "max_queued_micrographs": 64},
        {"name": "teamB", "keys": ["sk-b"]},
    ]}

    def run(pkg):
        t = mods(pkg).tenancy
        specs = t.parse_tenants(doc)
        reg = t.TenantRegistry(specs)
        return ([_spec_view(s) for s in specs], reg.names(),
                reg.resolve("Bearer sk-a-2"), reg.resolve("bearer sk-b"),
                reg.describe("teamA"))

    jax, port = both(run)
    assert port == jax
    assert port[1:4] == (["teamA", "teamB"], "teamA", "teamB")


def test_parse_tenants_rejects_malformations():
    bad = [
        [], {}, {"tenants": []}, {"tenants": [{}]}, {"tenants": "teamA"},
        {"tenants": [{"name": "a b", "keys": ["k"]}]},
        {"tenants": [{"name": "a", "keys": []}]},
        {"tenants": [{"name": "a", "keys": ["k"], "typo": 1}]},
        {"tenants": [{"name": "a", "keys": ["k"], "rate": 0}]},
        {"tenants": [{"name": "a", "keys": ["k"],
                      "rate": float("nan")}]},
        {"tenants": [{"name": "a", "keys": ["k"], "burst": 0}]},
        {"tenants": [{"name": "a", "keys": ["k"],
                      "max_open_jobs": True}]},
        {"tenants": [{"name": "a", "keys": ["k"]},
                     {"name": "a", "keys": ["k2"]}]},
        {"tenants": [{"name": "a", "keys": ["k"]},
                     {"name": "b", "keys": ["k"]}]},
        {"tenants": [{"name": "anonymous", "keys": ["k"]}]},
        {"tenants": [{"name": "a", "keys": ["k\nx"]}]},
        {"extra": 1, "tenants": [{"name": "a", "keys": ["k"]}]},
    ]

    def run(pkg):
        parse = mods(pkg).tenancy.parse_tenants
        return [_outcome(lambda d=d: parse(d)) for d in bad]

    jax, port = both(run)
    assert port == jax
    assert all(o[:2] == ("raise", "ValueError") for o in port)


def test_parse_tenants_priority_round_trip():
    doc = {"tenants": [
        {"name": "gold", "keys": ["kg"], "priority": "high"},
        {"name": "std", "keys": ["ks"]},
        {"name": "bulk", "keys": ["kb"], "priority": "low"},
    ]}

    def run(pkg):
        t = mods(pkg).tenancy
        specs = t.parse_tenants(doc)
        reg = t.TenantRegistry(specs)
        return ([s.priority for s in specs],
                [reg.priority(n) for n in ("gold", "std", "bulk",
                                           "unknown", None)],
                reg.describe("gold")["priority"])

    jax, port = both(run)
    assert port == jax == (["high", "normal", "low"],
                           ["high", "normal", "low", "normal", "normal"],
                           "high")


def test_parse_tenants_rejects_bad_priority():
    def run(pkg):
        parse = mods(pkg).tenancy.parse_tenants
        return [_outcome(lambda p=p: parse({"tenants": [
            {"name": "a", "keys": ["k"], "priority": p}]}))
            for p in ("critical", "", 3, None)]

    jax, port = both(run)
    assert port == jax
    assert all(o[:2] == ("raise", "ValueError") for o in port)


def test_load_tenants_unreadable_file_is_valueerror(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")

    def run(pkg):
        load = mods(pkg).tenancy.load_tenants
        return [_outcome(lambda: load(str(tmp_path / "nope.json")))[:2],
                _outcome(lambda: load(str(p)))[:2]]

    jax, port = both(run)
    assert port == jax == [("raise", "ValueError")] * 2


def test_anonymous_tenant_admits_keyless_requests():
    def run(pkg):
        t = mods(pkg).tenancy
        reg = t.TenantRegistry([
            t.TenantSpec(name="anonymous", max_open_jobs=1),
            t.TenantSpec(name="teamA", keys=("ka",)),
        ])
        out = [reg.resolve(None), reg.resolve(""),
               reg.resolve("Bearer ka")]
        out.append(_outcome(lambda: _registry(pkg).resolve(None)))
        return out

    jax, port = both(run)
    assert port == jax
    assert port[:3] == ["anonymous", "anonymous", "teamA"]
    assert port[3][3] == 401


def test_resolve_auth_error_codes():
    headers = ["Basic abc", "Bearer", "Bearer  ", "ka",
               "Bearer " + "x" * 500, "Bearer nope"]

    def run(pkg):
        reg = _registry(pkg)
        return [_outcome(lambda h=h: reg.resolve(h)) for h in headers]

    jax, port = both(run)
    assert port == jax
    assert [o[3] for o in port] == [401] * 5 + [403]


# -- rate limits and quotas --------------------------------------------


def test_token_bucket_refill_and_retry_after():
    def run(pkg):
        clk = Clock()
        reg = _registry(pkg, clk, rate=2.0, burst=2)

        def take(name="teamA"):
            return reg.check_admission(name, micrographs=1, open_jobs=0,
                                       queued_micrographs=0)

        out = [take(), take(), take()]
        clk.advance(0.25)
        out.append(take())
        clk.advance(0.5)
        out.append(take())
        out.append([take("teamB") for _ in range(10)])
        return out

    jax, port = both(run)
    assert port == jax
    assert port[:2] == [None, None]
    assert port[2][0] == "tenant_rate"
    assert port[2][1] == pytest.approx(0.5, abs=0.01)
    assert port[3][1] == pytest.approx(0.25, abs=0.01)
    assert port[4] is None and port[5] == [None] * 10


def test_quota_causes_and_retry_after_pricing():
    def run(pkg):
        reg = _registry(pkg, max_open_jobs=2, max_queued_micrographs=10)
        return [
            reg.check_admission("teamA", micrographs=3, open_jobs=1,
                                queued_micrographs=3),
            reg.check_admission("teamA", micrographs=1, open_jobs=2,
                                queued_micrographs=3, per_mic_s=2.0),
            reg.check_admission("teamA", micrographs=8, open_jobs=1,
                                queued_micrographs=3),
            reg.check_admission("teamA", micrographs=11, open_jobs=0,
                                queued_micrographs=0),
        ]

    jax, port = both(run)
    assert port == jax
    assert port[0] is None
    assert port[1] == ("tenant_open_jobs", pytest.approx(6.0))
    assert port[2][0] == "tenant_micrographs"
    assert port[3][0] == "tenant_job_too_large"


def test_oversize_job_is_a_permanent_413(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(10, jobs.ServeJournal(str(tmp_path / pkg)),
                          tenants=_registry(pkg, max_queued_micrographs=4))
        return (_outcome(lambda: q.submit({"r": 1}, tenant="teamA",
                                          micrographs=5))[3:],
                q.submit({"r": 2}, tenant="teamA", micrographs=4).state)

    jax, port = both(run)
    assert port == jax == ((413, "tenant_job_too_large"), "queued")


def test_queue_tenant_quota_429_in_admission_path(tmp_path):
    def run(pkg):
        m = mods(pkg)
        q = m.jobs.JobQueue(10, m.jobs.ServeJournal(str(tmp_path / pkg)),
                            tenants=_registry(pkg, max_open_jobs=1))
        q.submit({"r": 1}, tenant="teamA", micrographs=2)
        refused = _outcome(lambda: q.submit({"r": 2}, tenant="teamA"))
        b = q.submit({"r": 3}, tenant="teamB").tenant
        none = q.submit({"r": 4}).tenant
        accepts = sorted(
            str(e.get("tenant"))
            for e in m.journal._read_entries(q.journal.path)
            if e.get("state") == "queued")
        return refused[3:], b, none, accepts

    jax, port = both(run)
    assert port == jax
    assert port[0] == (429, "tenant_open_jobs")
    assert port[1:3] == ("teamB", None)
    assert port[3] == ["None", "teamA", "teamB"]


def test_queue_rate_limit_429(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        clk = Clock()
        q = jobs.JobQueue(10, jobs.ServeJournal(str(tmp_path / pkg)),
                          tenants=_registry(pkg, clk, rate=1.0, burst=1),
                          clock=clk)
        q.submit({"r": 1}, tenant="teamA")
        refused = _outcome(lambda: q.submit({"r": 2}, tenant="teamA"))
        clk.advance(1.1)
        return refused[3:], q.submit({"r": 3}, tenant="teamA").state

    jax, port = both(run)
    assert port == jax == ((429, "tenant_rate"), "queued")


def test_idempotency_keys_scoped_per_tenant(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(10, jobs.ServeJournal(str(tmp_path / pkg)),
                          tenants=_registry(pkg))
        a, da = q.submit_idempotent({"r": 1}, idempotency_key="k",
                                    tenant="teamA")
        b, db = q.submit_idempotent({"r": 2}, idempotency_key="k",
                                    tenant="teamB")
        again, d = q.submit_idempotent({"r": 3}, idempotency_key="k",
                                       tenant="teamA")
        return da, db, b.id != a.id, d, again.id == a.id

    jax, port = both(run)
    assert port == jax == (False, False, True, True, True)


def test_dedupe_bypasses_tenant_throttle(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(10, jobs.ServeJournal(str(tmp_path / pkg)),
                          tenants=_registry(pkg, max_open_jobs=1))
        job = q.submit({"r": 1}, idempotency_key="k", tenant="teamA")
        refused = _outcome(lambda: q.submit({"r": 2}, tenant="teamA"))
        again, deduped = q.submit_idempotent(
            {"r": 1}, idempotency_key="k", tenant="teamA")
        return refused[3], deduped, again.id == job.id

    jax, port = both(run)
    assert port == jax == (429, True, True)


# -- breaker scoping ---------------------------------------------------


def test_breaker_contains_single_tenant_failures():
    def run(pkg):
        jobs = mods(pkg).jobs
        t = Clock()
        b = jobs.CircuitBreaker(threshold=2, cooldown_s=10.0, clock=t)
        b.record_failure("teamA")
        b.record_failure("teamA")
        out = [_outcome(lambda: b.check_admission("teamA"))[3:],
               _outcome(lambda: b.check_admission("teamB")),
               _outcome(lambda: b.check_admission(None)), b.describe()]
        t.advance(10.1)
        b.check_admission("teamA")
        b.record_success("teamA")
        out += [_outcome(lambda: b.check_admission("teamA")),
                b.describe()]
        return out

    jax, port = both(run)
    assert port == jax
    assert port[0] == (503, "tenant_circuit_open")
    assert port[3]["state"] == "closed"
    assert port[3]["tenants"]["teamA"]["state"] == "open"
    assert "teamA" not in port[5].get("tenants", {})


def test_breaker_shared_trip_needs_two_tenants_at_threshold():
    def run(pkg):
        jobs = mods(pkg).jobs
        b = jobs.CircuitBreaker(threshold=2, cooldown_s=10.0,
                                clock=Clock())
        for _ in range(20):
            b.record_failure("teamA")
        b.record_failure("teamB")
        out = [_outcome(lambda: b.check_admission("teamC")),
               _outcome(lambda: b.check_admission(None))]
        b.record_failure("teamB")
        out.append(_outcome(lambda: b.check_admission("teamC"))[3:])
        return out

    jax, port = both(run)
    assert port == jax
    assert port[:2] == [("ok", None)] * 2
    assert port[2] == (503, "circuit_open")


def test_breaker_tenantless_failures_keep_legacy_behavior():
    def run(pkg):
        b = mods(pkg).jobs.CircuitBreaker(threshold=2, cooldown_s=10.0,
                                          clock=Clock())
        b.record_failure()
        b.record_failure()
        return _outcome(b.check_admission)[3:]

    jax, port = both(run)
    assert port == jax == (503, "circuit_open")


def test_batcher_deal_is_tenant_fair():
    def oj(tenant, pending):
        return SimpleNamespace(job=SimpleNamespace(tenant=tenant),
                               pending=list(range(pending)))

    def run(pkg):
        deal = mods(pkg).batcher.ContinuousBatcher._deal
        out = []
        for spec, target in (
            ((("A", 10), ("A", 10), ("A", 10), ("B", 10)), 8),
            (((None, 10), (None, 10)), 8),
            ((("A", 2), ("B", 10)), 8),
        ):
            order = [oj(t, n) for t, n in spec]
            alloc = deal(order, target)
            out.append([alloc[id(o)] for o in order])
        return out

    jax, port = both(run)
    assert port == jax
    assert port[0][3] == 4 and sum(port[0][:3]) == 4
    assert port[1] == [4, 4] and port[2] == [2, 6]


def test_queue_finish_counts_tenant_jobs(tmp_path):
    def run(pkg):
        m = mods(pkg)
        q = m.jobs.JobQueue(10, m.jobs.ServeJournal(str(tmp_path / pkg)),
                            tenants=_registry(pkg))
        before = m.tenancy._TENANT_JOBS.value(tenant="teamA",
                                              state="finished")
        job = q.submit({"r": 1}, tenant="teamA")
        q.next_job(0.01)
        q.mark_running(job)
        q.finish(job, m.jobs.JOB_FINISHED)
        return m.tenancy._TENANT_JOBS.value(
            tenant="teamA", state="finished") - before

    jax, port = both(run)
    assert port == jax == 1


# -- HTTP end to end ---------------------------------------------------


def test_http_auth_and_tenant_attribution(tmp_path):
    def run(pkg):
        m = mods(pkg)
        with running(pkg, str(tmp_path / pkg), queue_limit=16,
                     warmup=False, drain_grace_s=10.0,
                     tenants=_registry(pkg, max_open_jobs=2),
                     slo_targets={"job": (300.0, 0.95)}) as d:
            port = d.server.port
            out = {}
            code, headers, _ = req(port, "POST", "/v1/jobs", SUBMIT)
            out["anon"] = (code, headers.get("WWW-Authenticate"))
            out["wrong"] = req(port, "POST", "/v1/jobs", SUBMIT,
                               key="wrong")[0]
            out["open"] = (req(port, "GET", "/healthz/live")[0],
                           req(port, "GET", "/metrics")[0])
            code, _, body = req(port, "POST", "/v1/jobs", SUBMIT, key="ka")
            doc = json.loads(body)
            out["submit"] = (code, doc["tenant"])
            jid = doc["id"]
            out["done"] = job_view(wait_terminal(port, jid, key="ka"),
                                   REPO)
            out["isolation"] = (
                req(port, "GET", f"/v1/jobs/{jid}", key="kb")[0],
                req(port, "GET", f"/v1/jobs/{jid}/artifacts",
                    key="kb")[0],
                json.loads(req(port, "GET", "/v1/jobs", key="kb")[2]),
                [j["id"] == jid for j in json.loads(
                    req(port, "GET", "/v1/jobs", key="ka")[2])["jobs"]],
            )
            metrics = req(port, "GET", "/metrics")[2]
            out["metrics"] = (
                'repic_tenant_admitted_total{tenant="teamA"}' in metrics,
                "repic_tenant_jobs_total" in metrics)
            tenants = json.loads(req(port, "GET", "/status")[2])["tenants"]
            out["status"] = (sorted(tenants),
                             tenants["teamA"]["max_open_jobs"])
            accept = next(
                e for e in m.journal._read_entries(d.journal.path)
                if e.get("job") == jid and e.get("state") == "queued")
            out["accept_tenant"] = accept["tenant"]
            job_dir = d.job_dir(jid)
        roots = [e for e in m.journal._read_entries(
            job_dir + "/_trace.jsonl") if e.get("tenant") == "teamA"]
        out["trace_root"] = len(roots)
        return out

    jax, port = both(run)
    assert port == jax
    assert port["anon"] == (401, "Bearer") and port["wrong"] == 403
    assert port["open"] == (200, 200) and port["submit"] == (202, "teamA")
    assert port["done"]["state"] == "finished"
    assert port["isolation"] == (403, 403, {"jobs": []}, [True])
    assert port["metrics"] == (True, True)
    assert port["status"] == (["teamA", "teamB"], 2)
    assert port["accept_tenant"] == "teamA" and port["trace_root"] >= 1


def test_tenant_isolation_quota_429_vs_b_slo(tmp_path):
    def run(pkg):
        with running(pkg, str(tmp_path / pkg), queue_limit=16,
                     warmup=False, tenants=_registry(pkg, max_open_jobs=2),
                     slo_targets={"job": (300.0, 0.95)}) as d:
            port = d.server.port
            a = []
            for _ in range(6):
                code, headers, body = req(port, "POST", "/v1/jobs",
                                          SUBMIT, key="ka")
                a.append((code, json.loads(body).get("error"),
                          int(headers.get("Retry-After", 0)) >= 1))
            b_ids = []
            for _ in range(2):
                code, _, body = req(port, "POST", "/v1/jobs", SUBMIT,
                                    key="kb")
                b_ids.append((code, json.loads(body)["id"]))
            b_docs = [wait_terminal(port, i, key="kb")["state"]
                      for _, i in b_ids]
            a_ids = [j.id for j in d.queue.jobs() if j.tenant == "teamA"]
            for i in a_ids:
                wait_terminal(port, i, key="ka")
            ep = d.slo.summary()["endpoints"]["tenant:teamB"]
            rejected = json.loads(req(port, "GET", "/status")[2])[
                "tenants"]["teamA"].get("rejected", {})
            return (a, [c for c, _ in b_ids], b_docs,
                    (ep["count"], ep["compliance"], ep["budget_burn"]),
                    d.queue.breaker.describe()["state"], rejected)

    jax, port = both(run)
    # how many of A's six land before its first job finishes is timing
    assert [c for c, _, _ in port[0]].count(429) >= 2
    assert all(e.startswith("tenant_") and ra
               for c, e, ra in port[0] if c == 429)
    assert [c for c, _, _ in jax[0]].count(429) >= 2
    assert port[1:5] == jax[1:5]
    assert port[1] == [202, 202] and port[2] == ["finished"] * 2
    assert port[3] == (2, 1.0, 0.0) and port[4] == "closed"
    assert sum(port[5].values()) >= 2


def test_daemon_rejects_bad_tenants_file(tmp_path):
    bad = tmp_path / "tenants.json"
    bad.write_text('{"tenants": []}')

    def run(pkg):
        return _outcome(lambda: new_daemon(
            pkg, str(tmp_path / pkg), warmup=False, tenants=str(bad)))[:3]

    jax, port = both(run)
    assert port == jax
    assert port[:2] == ("raise", "ValueError")


# -- the submission boundary under fuzz (test_serve_fuzz.py) ----------

FIELDS = ("in_dir", "box_size", "options", "deadline_s", "bucket_hint",
          "idempotency_key", "typo_field", "__proto__")
OPTION_FIELDS = ("threshold", "max_neighbors", "num_particles",
                 "use_mesh", "spatial", "solver", "use_pallas", "strict",
                 "max_retries", "nope")


def _weird_values(rng):
    deep = x = []
    for _ in range(40):
        x.append([])
        x = x[0]
    return [
        None, True, False, 0, -1, 1, 2**63, -(2**63),
        0.0, -0.0, 1e308, -1e308, float("inf"), float("-inf"),
        float("nan"), 0.3, "", "x", "0.5", "greedy", "exact",
        "\x00", "‮", "a" * 10_000, [], [[]], deep, {}, {"": ""},
        {"a": {"b": {"c": 1}}}, [1, 2, 3], ["a"], [None],
        rng.random(), rng.randint(-(10**9), 10**9),
        "".join(rng.choice(string.printable) for _ in range(20)),
    ]


def _opts_view(o):
    return tuple(getattr(o, f) for f in OPTION_FIELDS[:-1])


def _validate(pkg, body: bytes):
    """``validate_submission``'s outcome: ValueError (-> 400) with its
    message, or the tuple with the options as values; anything else
    raises."""
    d = mods(pkg).daemon
    try:
        request, options, deadline_s, hint, key = d.validate_submission(
            body)
    except ValueError as e:
        return ("400", str(e))
    assert deadline_s is None or (isinstance(deadline_s, float)
                                  and math.isfinite(deadline_s)
                                  and deadline_s > 0)
    assert hint is None or (isinstance(hint, int) and hint >= 1)
    assert key is None or (isinstance(key, str) and key)
    return ("ok", json.dumps(request, sort_keys=True, default=str),
            repr(_opts_view(options)), deadline_s, hint, key)


def _from_dict(pkg, payload):
    cls = mods(pkg).engine.ConsensusOptions
    try:
        return ("ok", repr(_opts_view(cls.from_dict(payload))))
    except ValueError as e:
        return ("400", str(e))


def test_options_from_dict_never_crashes_on_weird_values():
    def run(pkg):
        values = _weird_values(random.Random(1234))
        return [_from_dict(pkg, {f: v}) for f in OPTION_FIELDS
                for v in values]

    jax, port = both(run)
    assert port == jax


def test_options_from_dict_rejects_wrong_types_explicitly():
    bad = [
        {"threshold": "0.5"}, {"threshold": [0.5]}, {"threshold": True},
        {"threshold": float("nan")}, {"threshold": float("inf")},
        {"threshold": 0.0}, {"threshold": 2.0}, {"max_neighbors": 0},
        {"max_neighbors": 1.5}, {"max_neighbors": False},
        {"max_neighbors": 10**9}, {"num_particles": -3},
        {"num_particles": "many"}, {"use_mesh": 1}, {"use_mesh": "yes"},
        {"strict": None}, {"spatial": "auto"}, {"solver": 5},
        {"solver": "exact"}, {"max_retries": -1}, {"max_retries": 3.5},
        {"unknown_knob": 1}, "not a dict", [("threshold", 0.5)],
    ]

    def run(pkg):
        return [_from_dict(pkg, p) for p in bad]

    jax, port = both(run)
    assert port == jax
    assert all(o[0] == "400" for o in port)


def test_options_from_dict_accepts_the_valid_envelope():
    payload = {"threshold": 0.3, "max_neighbors": 16,
               "num_particles": 100, "use_mesh": False, "spatial": None,
               "solver": "lp", "use_pallas": False, "strict": True,
               "max_retries": 2}
    jax, port = both(_from_dict, payload)
    assert port == jax and port[0] == "ok"


def test_validate_submission_malformed_bytes_yield_400():
    f = FIXTURE.encode()
    cases = [
        b"", b"not json", b"[]", b'"a string"', b"123", b"null", b"{",
        b'{"in_dir": }', b"\xff\xfe\x00garbage",
        '{"in_dir": "‮"}'.encode(),
        b'{"in_dir": "/tmp", "box_size": 180, "box_size": 190',
        json.dumps({"in_dir": FIXTURE}).encode(),
        json.dumps({"in_dir": FIXTURE, "box_size": 180,
                    "options": []}).encode(),
        json.dumps({"in_dir": FIXTURE, "box_size": 180,
                    "options": 0}).encode(),
        json.dumps({"in_dir": FIXTURE, "box_size": 180,
                    "options": False}).encode(),
        b'{"in_dir": "%s", "box_size": Infinity}' % f,
        b'{"in_dir": "%s", "box_size": NaN}' % f,
        b'{"in_dir": "%s", "box_size": 180, "deadline_s": Infinity}' % f,
    ]

    def run(pkg):
        return [_validate(pkg, body) for body in cases]

    jax, port = both(run)
    assert port == jax
    assert all(o[0] == "400" for o in port)


def test_validate_submission_oversized_fields_yield_400():
    huge = {"in_dir": FIXTURE, "box_size": 180}

    def run(pkg):
        limit = mods(pkg).daemon.MAX_BODY_BYTES
        bodies = [
            b"x" * (limit + 1),
            json.dumps(dict(huge, in_dir="/" + "a" * 5000)).encode(),
            json.dumps(dict(huge, box_size=[180] * 100)).encode(),
            json.dumps(dict(huge, idempotency_key="k" * 500)).encode(),
            json.dumps(dict(huge, idempotency_key="k" * 200)).encode(),
        ]
        return [_validate(pkg, b) for b in bodies]

    jax, port = both(run)
    assert port == jax
    assert [o[0] for o in port] == ["400"] * 4 + ["ok"]
    assert port[4][5] == "k" * 200


def test_validate_submission_generative_sweep():
    def run(pkg):
        rng = random.Random(20260803)
        values = _weird_values(rng)
        base = {"in_dir": FIXTURE, "box_size": 180}
        out = []
        for field, v in itertools.product(FIELDS, values):
            payload = dict(base)
            payload[field] = v
            out.append(_validate(
                pkg, json.dumps(payload, default=str).encode()))
        for field, v in itertools.product(OPTION_FIELDS, values):
            out.append(_validate(pkg, json.dumps(
                dict(base, options={field: v}), default=str).encode()))
        valid = json.dumps(dict(base, options={"use_mesh": False},
                                deadline_s=5)).encode()
        for _ in range(300):
            body = bytearray(valid)
            for _ in range(rng.randint(1, 4)):
                body[rng.randrange(len(body))] = rng.randrange(256)
            out.append(_validate(pkg, bytes(body)))
        for _ in range(200):
            n = rng.randint(0, 64)
            out.append(_validate(
                pkg, bytes(rng.randrange(256) for _ in range(n))))
        return out

    jax, port = both(run)
    assert port == jax
    assert {o[0] for o in port} == {"ok", "400"}


def test_tenants_file_parser_fuzz():
    fields = ("name", "keys", "rate", "burst", "max_open_jobs",
              "max_queued_micrographs", "nope")

    def run(pkg):
        t = mods(pkg).tenancy
        rng = random.Random(20260804)
        values = _weird_values(rng)
        base = {"name": "teamA", "keys": ["ka"]}

        def check(doc):
            try:
                specs = t.parse_tenants(doc)
            except ValueError as e:
                return ("400", str(e))
            return ("ok", [repr(_spec_view(s)) for s in specs])

        out = []
        for field, v in itertools.product(fields, values):
            entry = dict(base)
            entry[field] = v
            out.append(check({"tenants": [entry]}))
        for v in values:
            out.append(check(v))
            out.append(check({"tenants": v}))
        for _ in range(200):
            n = rng.randint(0, 4)
            out.append(check({"tenants": [
                {rng.choice(fields): rng.choice(values),
                 "name": rng.choice(["teamA", "teamA", "x y", "", 7]),
                 "keys": rng.choice([["k"], ["k", "k"], [], "k", [1]])}
                for _ in range(n)]}))
        return out

    jax, port = both(run)
    assert port == jax


def test_authorization_header_fuzz():
    def run(pkg):
        t = mods(pkg).tenancy
        reg = t.TenantRegistry([t.TenantSpec(name="teamA", keys=("ka",)),
                                t.TenantSpec(name="anonymous")])
        rng = random.Random(4321)
        headers = [
            None, "", " ", "Bearer", "Bearer ", "Bearer ka",
            "bearer ka", "BEARER ka", "Basic a2E=", "Bearer ka extra",
            "Bearer\tka", "Bearer \x00", "Bearer " + "k" * 10_000,
            "‮", "Bearer ‮", "ka", ": Bearer ka",
        ] + ["".join(rng.choice(string.printable)
                     for _ in range(rng.randint(0, 40)))
             for _ in range(300)]
        out = []
        for h in headers:
            try:
                out.append(("ok", reg.resolve(h)))
            except t.AuthError as e:
                out.append(("auth", e.http_status))
        return out

    jax, port = both(run)
    assert port == jax
    assert ("ok", "teamA") in port
    assert {o[1] for o in port if o[0] == "auth"} <= {401, 403}


def test_http_auth_fuzz_worker_survives(tmp_path):
    auths = (None, "", "Bearer", "Bearer nope", "Basic xx",
             "Bearer " + "k" * 5000, "Bearer \x7f\x01")

    def run(pkg):
        t = mods(pkg).tenancy
        with running(pkg, str(tmp_path / pkg), warmup=False, queue_limit=4,
                     tenants=t.TenantRegistry(
                         [t.TenantSpec(name="teamA", keys=("ka",))])) as d:
            port = d.server.port
            body = json.dumps(SUBMIT).encode()

            def post(auth):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                try:
                    conn.putrequest("POST", "/v1/jobs")
                    conn.putheader("Content-Length", str(len(body)))
                    if auth is not None:
                        conn.putheader("Authorization", auth)
                    conn.endheaders(body)
                    resp = conn.getresponse()
                    return resp.status, resp.read().decode()
                finally:
                    conn.close()

            codes = [post(a)[0] for a in auths]
            code, text = post("Bearer ka")
            doc = wait_terminal(port, json.loads(text)["id"], key="ka")
            return codes, code, job_view(doc, REPO)

    jax, port = both(run)
    assert port == jax
    assert all(c in (401, 403) for c in port[0])
    assert port[1] == 202 and port[2]["state"] == "finished"


def test_http_maps_validation_to_400_and_413(tmp_path):
    f = FIXTURE.encode()
    bad = [
        b"not json", b"[1, 2, 3]", json.dumps({"in_dir": FIXTURE}).encode(),
        json.dumps({"in_dir": FIXTURE, "box_size": 180,
                    "options": {"threshold": "NaN"}}).encode(),
        json.dumps({"in_dir": FIXTURE, "box_size": [180, -1]}).encode(),
        b'{"in_dir": "%s", "box_size": Infinity}' % f,
    ]

    def run(pkg):
        with running(pkg, str(tmp_path / pkg), warmup=False,
                     queue_limit=4) as d:
            port = d.server.port
            out = [req(port, "POST", "/v1/jobs", raw=b)[::2] for b in bad]
            try:
                out.append(req(port, "POST", "/v1/jobs",
                               raw=b"x" * (5 << 20))[0])
            except OSError:
                out.append(413)  # refused while the client still sent
            for bad_len in ("-1", "nope"):
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                try:
                    conn.putrequest("POST", "/v1/jobs")
                    conn.putheader("Content-Length", bad_len)
                    conn.endheaders()
                    out.append(conn.getresponse().status)
                finally:
                    conn.close()
            code, _, body = req(port, "POST", "/v1/jobs", SUBMIT)
            doc = wait_terminal(port, json.loads(body)["id"])
            out.append((code, job_view(doc, REPO)))
            return out

    jax, port = both(run)
    assert port == jax
    assert [c for c, _ in port[:6]] == [400] * 6
    assert port[6] == 413 and port[7] in (400, 413)
    assert port[9][0] == 202 and port[9][1]["state"] == "finished"
