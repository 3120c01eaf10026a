"""The port's serve daemon and job model against the JAX package's, on
the CPU: the in-process cases of ``tests/test_serve.py`` (the
subprocess and compaction cases are in ``test_torch_serve_recovery.py``).

Each case drives the same submissions through the JAX daemon
(``use_mesh: false``) and the port's (``device="cpu"``) and compares
the status codes, the JSON bodies and the request journal projected by
``repic_tpu_torch.utils.synthetic.job_view`` / ``serve_journal_view``
(ids and clocks removed), the artifact bytes, and the run journals
projected; the unit cases compare equal outcomes on the same calls.
Last, the port's daemon serves examples/10017 in phase 11a's three
settings and is held to ``tests/golden/torch_port_serve_digests.json``.
"""

import http.client
import json
import os
import threading
import urllib.error

import pytest

from repic_tpu_torch.utils.synthetic import job_view, serve_journal_view
from torch_serve_common import (
    FIXTURE,
    REPO,
    SUBMIT,
    both,
    counter,
    job_dir_view,
    mods,
    new_daemon,
    req,
    run_job,
    running,
    serve_10017,
    submit,
    wait_ready,
    wait_terminal,
)

SERVE_DIGESTS = os.path.join(REPO, "tests", "golden",
                             "torch_port_serve_digests.json")


def _admission(fn):
    """``("ok", value)`` or ``("refused", http status, reason)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        if hasattr(e, "http_status"):
            return ("refused", e.http_status, e.reason)
        return ("raise", type(e).__name__)


def _journal(wd):
    return serve_journal_view(wd, REPO)


# -- unit: journal, breaker, queue ------------------------------------


def test_serve_journal_recovery_and_torn_tail(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        j.record("j1", "queued", request={"a": 1})
        j.record("j2", "queued", request={"a": 2})
        j.record("j1", "running")
        j.record("j2", "running")
        j.record("j2", "finished")
        j.close()
        with open(j.path, "a") as f:
            f.write('{"job": "j3", "state": "que')  # crash mid-append
        return [(r.id, r.resumed, r.request, r.attempts)
                for r in jobs.ServeJournal(wd).recover()]

    jax, port = both(run)
    assert port == jax == [("j1", True, {"a": 1}, 1)]


def test_circuit_breaker_state_machine():
    def run(pkg):
        jobs = mods(pkg).jobs
        t = {"now": 0.0}
        b = jobs.CircuitBreaker(threshold=2, cooldown_s=10.0,
                                clock=lambda: t["now"])
        seen = [_admission(b.check_admission)]
        b.record_failure()
        seen.append(_admission(b.check_admission))
        b.record_failure()
        seen.append(_admission(b.check_admission))
        seen.append(b.describe())
        t["now"] += 10.1
        seen.append(_admission(b.check_admission))
        seen.append(b.state)
        b.record_failure()
        seen.append(_admission(b.check_admission))
        t["now"] += 10.1
        seen.append(_admission(b.check_admission))
        b.record_success()
        seen.append((b.state, _admission(b.check_admission)))
        return seen

    jax, port = both(run)
    assert port == jax
    assert port[2] == ("refused", 503, "circuit_open")
    assert port[5] == "half_open" and port[-1][0] == "closed"


def test_queue_admission_bounds_and_retry_after(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(2, jobs.ServeJournal(str(tmp_path / pkg)))
        q.submit({"r": 1})
        q.submit({"r": 2})
        try:
            q.submit({"r": 3})
        except jobs.AdmissionError as e:
            full = (e.http_status, e.reason, e.retry_after_s)
        q2 = jobs.JobQueue(2, jobs.ServeJournal(str(tmp_path / pkg / "d")))
        q2.begin_drain()
        return full, _admission(lambda: q2.submit({"r": 1}))

    jax, port = both(run)
    assert port == jax
    assert port[0][:2] == (429, "queue_full") and port[0][2] >= 1
    assert port[1] == ("refused", 503, "draining")


def test_queue_cancel_and_warm_affinity(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(10, jobs.ServeJournal(str(tmp_path / pkg)))
        a = q.submit({"r": 1}, bucket_hint=128)
        b = q.submit({"r": 2}, bucket_hint=256)
        c = q.submit({"r": 3}, bucket_hint=256)
        order = [q.next_job(0.01, last_bucket=256).request["r"],
                 q.next_job(0.01, last_bucket=256).request["r"]]
        d = q.submit({"r": 4}, bucket_hint=256)
        order.append(q.next_job(0.01, last_bucket=256).request["r"])
        return (order, q.cancel(d.id).state, q.next_job(0.01),
                [j.state for j in (a, b, c, d)])

    jax, port = both(run)
    assert port == jax
    assert port[0] == [2, 3, 1] and port[1] == "cancelled"


def test_cancel_of_popped_but_unmarked_job_is_cooperative(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(10, jobs.ServeJournal(str(tmp_path / pkg)))
        job = q.submit({"r": 1})
        popped = q.next_job(0.01)
        got = q.cancel(job.id)
        seen = [popped is job, got is job, job.cancel_requested,
                job.state]
        q.mark_running(job)
        return seen + [job.state, job.cancel_requested]

    jax, port = both(run)
    assert port == jax == [True, True, True, "queued", "running", True]


def test_running_cancel_survives_restart(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        q = jobs.JobQueue(4, j)
        job = q.submit({"r": 1})
        q.next_job(0.01)
        q.mark_running(job)
        flag = q.cancel(job.id).cancel_requested
        j.close()
        rec = jobs.ServeJournal(wd).recover()
        return (flag, [r.id == job.id for r in rec],
                [(r.resumed, r.cancel_requested) for r in rec],
                _journal(wd))

    jax, port = both(run)
    assert port == jax
    assert port[:3] == (True, [True], [(True, True)])


def test_concurrent_cancel_and_finish_never_resurrect(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        out = []
        for i in range(30):
            wd = str(tmp_path / f"{pkg}{i}")
            j = jobs.ServeJournal(wd)
            q = jobs.JobQueue(4, j)
            job = q.submit({"r": 1})
            q.next_job(0.01)
            q.mark_running(job)
            go = threading.Barrier(2)

            def do_cancel():
                go.wait(5)
                q.cancel(job.id)

            def do_finish():
                go.wait(5)
                q.finish(job, jobs.JOB_FINISHED)

            ts = [threading.Thread(target=do_cancel),
                  threading.Thread(target=do_finish)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(10)
            j.close()
            states = [e["state"] for e in _journal(wd) if "job" in e]
            out.append((states[-1], states.count("finished"),
                        states.count("cancelled"),
                        jobs.ServeJournal(wd).recover()))
        return set(map(repr, out))

    jax, port = both(run)
    assert port == jax == {repr(("finished", 1, 0, []))}


def test_terminal_jobs_evicted_beyond_cap(tmp_path, monkeypatch):
    def run(pkg):
        jobs = mods(pkg).jobs
        monkeypatch.setattr(jobs.JobQueue, "MAX_TERMINAL", 3)
        q = jobs.JobQueue(100, jobs.ServeJournal(str(tmp_path / pkg)))
        ids = []
        for i in range(5):
            job = q.submit({"r": i})
            ids.append(job.id)
            q.next_job(0.01)
            q.mark_running(job)
            q.finish(job, jobs.JOB_FINISHED)
        return [q.get(i) is not None for i in ids], len(q.jobs())

    jax, port = both(run)
    assert port == jax == ([False, False, True, True, True], 3)


@pytest.mark.faults
def test_request_storm_fault_forces_queue_full(tmp_path):
    def run(pkg):
        m = mods(pkg)
        q = m.jobs.JobQueue(100, m.jobs.ServeJournal(str(tmp_path / pkg)))
        with m.faults.fault_plan("request_storm::1"):
            first = _admission(lambda: q.submit({"r": 1}))
            second = q.submit({"r": 2}).state
        return first, second

    jax, port = both(run)
    assert port == jax == (("refused", 429, "queue_full"), "queued")


# -- the daemon over HTTP ---------------------------------------------


def test_submit_poll_artifacts_and_warm_second_job(tmp_path):
    def run(pkg):
        with running(pkg, str(tmp_path / pkg), queue_limit=4,
                     warmup=False, drain_grace_s=10.0) as d:
            port = d.server.port
            live = req(port, "GET", "/healthz/live")[0]
            code, _, doc = submit(port)
            first = wait_terminal(port, doc["id"])
            code_a, _, body = req(port, "GET",
                                  f"/v1/jobs/{doc['id']}/artifacts")
            names = json.loads(body)["artifacts"]
            texts = {n: req(port, "GET",
                            f"/v1/jobs/{doc['id']}/artifacts/{n}")[2]
                     for n in names}
            first_dir = d.job_dir(doc["id"])
            hits0 = counter(pkg, "repic_program_cache_hits_total")
            miss0 = counter(pkg, "repic_program_cache_misses_total")
            second = run_job(port)
            hits = counter(pkg, "repic_program_cache_hits_total") - hits0
            miss = counter(pkg, "repic_program_cache_misses_total") - miss0
            listed = json.loads(req(port, "GET", "/v1/jobs")[2])["jobs"]
        # after the drain: the worker has closed every job's sinks
        return {"codes": (live, code, code_a), "first": job_view(
            first, REPO), "second": job_view(second, REPO),
            "texts": texts, "dir": job_dir_view(first_dir), "hits": hits,
            "misses": miss, "listed": len(listed),
            "journal": _journal(d.work_dir)}

    jax, port = both(run)
    for key in jax:
        if key != "journal":
            assert port[key] == jax[key], key
    assert port["codes"] == (200, 202, 200)
    assert port["first"]["state"] == "finished"
    assert port["first"]["result"]["journal"] == {"ok": 3}
    assert sorted(port["texts"]) == ["mic_000.box", "mic_001.box",
                                     "mic_002.box"]
    assert port["texts"] == port["dir"]["boxes"]
    assert port["hits"] >= 1 and port["misses"] == 0
    assert port["listed"] == 2
    # the drain records follow: the whole journal but the close
    assert port["journal"] == jax["journal"]


def test_worker_survives_journal_failure(tmp_path, monkeypatch):
    def run(pkg):
        with running(pkg, str(tmp_path / pkg), queue_limit=4,
                     warmup=False) as d:
            orig = d.journal.record
            armed = {"on": True}

            def flaky(job_id, state, **fields):
                if state == "running" and armed["on"]:
                    armed["on"] = False
                    raise OSError("disk full")
                return orig(job_id, state, **fields)

            monkeypatch.setattr(d.journal, "record", flaky)
            port = d.server.port
            failed = run_job(port)
            ok = run_job(port)
            return (job_view(failed, REPO), failed["error"]["message"],
                    job_view(ok, REPO),
                    d.slo.summary()["endpoints"]["job"]["count"])

    jax, port = both(run)
    assert port == jax
    assert port[0]["state"] == "failed" and "disk full" in port[1]
    assert port[2]["state"] == "finished" and port[3] == 2


def test_submission_validation_maps_to_400(tmp_path):
    cases = [
        {"box_size": 180},
        {"in_dir": "/nonexistent", "box_size": 180},
        {"in_dir": FIXTURE, "box_size": -1},
        {"in_dir": FIXTURE, "box_size": 180, "typo": 1},
        {"in_dir": FIXTURE, "box_size": 180, "options": {"typo": 1}},
        {"in_dir": FIXTURE, "box_size": 180, "deadline_s": 0},
    ]

    def run(pkg):
        with running(pkg, str(tmp_path / pkg), warmup=False) as d:
            port = d.server.port
            out = [req(port, "POST", "/v1/jobs", body)[::2]
                   for body in cases]
            out.append(req(port, "GET", "/v1/jobs/job-nope")[::2])
            return out

    jax, port = both(run)
    assert port == jax
    assert [c for c, _ in port] == [400] * 6 + [404]


def test_readiness_follows_warmup_and_drain(tmp_path):
    def run(pkg):
        d = new_daemon(pkg, str(tmp_path / pkg), port=0,
                       warmup=True).start()
        try:
            port = d.server.port
            live = req(port, "GET", "/healthz/live")[0]
            wait_ready(port)
            d.begin_drain()
            ready = req(port, "GET", "/healthz/ready")[0]
            live2 = req(port, "GET", "/healthz/live")[0]
            code, headers, body = req(port, "POST", "/v1/jobs", SUBMIT)
        finally:
            d.finish_drain()
        with pytest.raises(urllib.error.URLError):
            req(port, "GET", "/healthz/live", timeout=2)
        return (live, ready, live2, code, json.loads(body),
                int(headers["Retry-After"]), _journal(d.work_dir))

    jax, port = both(run)
    assert port == jax
    assert port[:4] == (200, 503, 200, 503)
    assert port[4]["error"] == "draining" and port[5] >= 1


def test_deadline_expired_while_queued(tmp_path):
    def run(pkg):
        with running(pkg, str(tmp_path / pkg), warmup=False) as d:
            doc = run_job(d.server.port, dict(SUBMIT, deadline_s=1e-4))
            return job_view(doc, REPO), _journal(d.work_dir)

    jax, port = both(run)
    assert port == jax
    assert port[0]["state"] == "deadline_exceeded"
    assert "queued" in port[0]["reason"]


@pytest.mark.faults
@pytest.mark.parametrize("prefetch", ["on", "off"])
def test_deadline_fault_cancels_at_chunk_boundary(prefetch, tmp_path,
                                                  monkeypatch):
    """``deadline_exceeded`` fires at the chunk-boundary poll (in the
    port's prefetch worker, one chunk ahead, when the prefetch is on):
    the same job document, request journal and run journal, record by
    record, as the JAX run's, in chunks of one micrograph."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    if prefetch == "off":
        monkeypatch.setenv("REPIC_TPU_NO_PREFETCH", "1")

    def run(pkg):
        m = mods(pkg)
        with running(pkg, str(tmp_path / pkg), warmup=False,
                     scheduler="single") as d:
            with m.faults.fault_plan("deadline_exceeded::1"):
                doc = run_job(d.server.port)
        return (job_view(doc, REPO), _journal(d.work_dir),
                job_dir_view(d.job_dir(doc["id"])))

    jax, port = both(run)
    assert port == jax
    assert port[0]["state"] == "deadline_exceeded"
    states = [e["state"] for e in port[1] if "job" in e]
    assert states == ["queued", "running", "deadline_exceeded"]
    # the first boundary fired: nothing emitted, nothing journaled
    assert port[2]["boxes"] == {}
    assert port[2]["journal"] == {"records": {}, "events": [],
                                  "dispatches": []}


@pytest.mark.parametrize("prefetch", ["on", "off"])
def test_deadline_at_second_boundary_journals_like_jax(prefetch, tmp_path,
                                                       monkeypatch):
    """A deadline that expires at the second chunk boundary (polled by
    the prefetch worker when the prefetch is on): the first chunk's
    artifact and journal record, the job document and the request
    journal equal the JAX run's, record by record."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    if prefetch == "off":
        monkeypatch.setenv("REPIC_TPU_NO_PREFETCH", "1")

    def run(pkg):
        with running(pkg, str(tmp_path / pkg), warmup=False,
                     scheduler="single") as d:
            checks = d._cancel_check

            def expiring(job):
                polls = []
                check = checks(job)

                def poll():
                    polls.append(1)
                    if len(polls) == 2:
                        job.cancel_reason = "deadline exceeded (test)"
                    return job.cancel_reason or check()

                return poll

            monkeypatch.setattr(d, "_cancel_check", expiring)
            doc = run_job(d.server.port)
        return (job_view(doc, REPO), _journal(d.work_dir),
                job_dir_view(d.job_dir(doc["id"])))

    jax, port = both(run)
    assert port == jax
    assert port[0]["state"] == "deadline_exceeded"
    assert sorted(port[2]["boxes"]) == ["mic_000.box"]
    assert list(port[2]["journal"]["records"]) == ["mic_000"]


@pytest.mark.faults
def test_slow_client_hurts_only_itself(tmp_path):
    def run(pkg):
        m = mods(pkg)
        with running(pkg, str(tmp_path / pkg), warmup=False) as d:
            port = d.server.port
            doc = run_job(port)
            path = f"/v1/jobs/{doc['id']}/artifacts/mic_000.box"
            with m.faults.fault_plan("slow_client::1"):
                with pytest.raises((http.client.HTTPException,
                                    ConnectionError, OSError)):
                    req(port, "GET", path)
            code, _, content = req(port, "GET", path)
            return (code, content, req(port, "GET", "/healthz/live")[0],
                    json.loads(req(port, "GET",
                                   f"/v1/jobs/{doc['id']}")[2])["state"])

    jax, port = both(run)
    assert port == jax
    assert port[0] == 200 and port[1] and port[2:] == (200, "finished")


def test_queued_job_survives_restart_in_process(tmp_path):
    def run(pkg):
        wd = str(tmp_path / pkg)
        dead = new_daemon(pkg, wd, warmup=False)  # never started
        job = dead.queue.submit(dict(SUBMIT))
        dead.journal.close()
        with running(pkg, wd, warmup=False) as d2:
            doc = wait_terminal(d2.server.port, job.id)
        return (job_view(doc, REPO), job_dir_view(d2.job_dir(job.id)),
                _journal(wd))

    jax, port = both(run)
    assert port == jax
    assert port[0]["state"] == "finished"
    assert len(port[1]["boxes"]) == 3


@pytest.mark.faults
def test_breaker_opens_after_repeated_failures(tmp_path):
    bad_dir = tmp_path / "bad"
    bad_dir.mkdir()  # exists at validation, has no picker subdirs

    def run(pkg):
        with running(pkg, str(tmp_path / pkg), warmup=False,
                     breaker_threshold=3, breaker_cooldown_s=60.0,
                     queue_limit=10) as d:
            port = d.server.port
            bad = {"in_dir": str(bad_dir), "box_size": 180}
            ids = [submit(port, bad)[2]["id"] for _ in range(3)]
            docs = [job_view(wait_terminal(port, i), REPO) for i in ids]
            code, headers, body = req(port, "POST", "/v1/jobs", SUBMIT)
            return (docs, code, json.loads(body)["error"],
                    int(headers["Retry-After"]) >= 1,
                    d.queue.breaker.describe()["state"])

    jax, port = both(run)
    assert port == jax
    assert [d["state"] for d in port[0]] == ["failed"] * 3
    assert port[1:] == (503, "circuit_open", True, "open")


def test_recover_quarantines_job_over_retry_budget(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        j.record("poison", "queued", request=dict(SUBMIT),
                 trace="t-poison")
        for _ in range(3):
            j.record("poison", "running")
        j.close()
        with running(pkg, wd, warmup=False, reassign_budget=2) as d:
            port = d.server.port
            code, _, body = req(port, "GET", "/v1/jobs/poison")
            doc = json.loads(body)
            fresh_job = run_job(port)
            return (code, job_view(doc, REPO), job_view(fresh_job, REPO),
                    _journal(wd))

    jax, port = both(run)
    assert port == jax
    assert port[0] == 200 and port[1]["state"] == "quarantined"
    assert "retry budget" in port[1]["reason"]
    assert port[1]["attempts"] == 3
    assert port[2]["state"] == "finished"


def test_recover_requeues_job_within_budget(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        j.record("ok-job", "queued", request=dict(SUBMIT))
        j.record("ok-job", "running")
        j.close()
        with running(pkg, wd, warmup=False) as d:
            doc = wait_terminal(d.server.port, "ok-job")
        return job_view(doc, REPO), job_dir_view(d.job_dir("ok-job"))

    jax, port = both(run)
    assert port == jax
    assert port[0]["state"] == "finished" and port[0]["resumed"] is True


def test_statusserver_readiness_endpoints_standalone():
    def run(pkg):
        server = mods(pkg).server
        srv = server.StatusServer(port=0).start()
        try:
            port = srv.port
            out = [req(port, "GET", p)[0]
                   for p in ("/healthz", "/healthz/live", "/healthz/ready")]
            server.set_ready(True)
            out.append(req(port, "GET", "/healthz/ready")[0])
            server.set_ready(False)
            out.append(req(port, "GET", "/healthz/ready")[0])
            return out
        finally:
            srv.stop()

    jax, port = both(run)
    assert port == jax == [200, 200, 503, 200, 503]


# -- the 10017 golden (phase 11a on the CPU) --------------------------


def test_10017_jobs_equal_the_jax_serve_digests(tmp_path):
    """The port's daemon serves examples/10017 fused, with ``--pallas``
    and ``lp_device``: every artifact's sha256, the job documents, the
    run journals and the request journal equal the JAX daemon's
    (``tests/golden/torch_port_serve_digests.json``)."""
    from torch_serve_common import fresh

    with open(SERVE_DIGESTS) as f:
        want = json.load(f)
    fresh("port")
    got = serve_10017("port", str(tmp_path / "wd"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
    assert all(len(want[s]["artifacts"]) == 12
               for s in ("lp_device_fused", "lp_device_pallas",
                         "lp_device"))


def test_serve_request_never_touches_tensors_on_http_threads(tmp_path):
    """Device work happens on the worker thread only: the HTTP handler
    threads of a busy daemon run no chunk (the ``consensus_chunk``
    spans carry the worker's thread)."""
    consensus = mods("port").consensus
    seen = set()
    orig = consensus.run_consensus_batch

    def spy(*a, **kw):
        seen.add(threading.current_thread().name)
        return orig(*a, **kw)

    consensus.run_consensus_batch = spy
    try:
        with running("port", str(tmp_path / "wd"), warmup=False) as d:
            for _ in range(2):
                assert run_job(d.server.port)["state"] == "finished"
    finally:
        consensus.run_consensus_batch = orig
    assert seen and all(n.startswith("repic-") for n in seen), seen
    assert not any("Thread-" in n for n in seen), seen
