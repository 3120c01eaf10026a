"""The port's serve daemon across process death, against the JAX
package's, on the CPU: the crash-recovery, poison-job and journal
compaction cases of ``tests/test_serve.py``, the ``serve`` command as a
process (``python -m repic_tpu_torch serve WD --device cpu`` beside
``python -m repic_tpu.main serve WD``), and what the port adds: the
daemon's device and the fleet's refusal.

Compared across packages: exit codes, the job documents and the
request journal projected (``job_view`` / ``serve_journal_view``, ids
and clocks removed), and the artifacts' bytes.
"""

import http.client
import json
import os
import signal

import pytest

from repic_tpu_torch.utils.synthetic import job_view, serve_journal_view
from torch_serve_common import (
    REPO,
    SUBMIT,
    TERMINAL,
    artifact_digests,
    both,
    mods,
    new_daemon,
    req,
    run_job,
    running,
    spawn,
    stop,
    submit,
    wait_terminal,
)


def _journal(wd):
    return serve_journal_view(wd, REPO)


def _queued_before_running(entries):
    """The request journal with the first daemon's ``queued`` entries
    ahead of its other job entries, each kept in its order.  The worker
    writes job 1's ``running`` while the HTTP thread writes job 2's
    ``queued``, and either lands first, in either package."""
    end = next((i for i, e in enumerate(entries)
                if i and e.get("event") == "server_started"), len(entries))
    head = entries[1:end]
    return (entries[:1]
            + [e for e in head if e.get("state") == "queued"]
            + [e for e in head if e.get("state") != "queued"]
            + entries[end:])


def _submit_two(pkg, port, wd):
    """POST two ``SUBMIT`` jobs whose requests both reach the daemon
    before either answer is read: the worker's first chunk (about 0.1
    s on the CPU) then races only the daemon's own accept of the
    second request, never a client descheduled between two calls.
    Returns the two ids in the order the request journal queued them."""
    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=10)
             for _ in range(2)]
    try:
        for c in conns:
            c.request("POST", "/v1/jobs", json.dumps(SUBMIT).encode(),
                      {"Content-Type": "application/json"})
        answers = [(r.status, json.loads(r.read()))
                   for r in (c.getresponse() for c in conns)]
    finally:
        for c in conns:
            c.close()
    assert [code for code, _ in answers] == [202, 202], answers
    ids = {doc["id"] for _, doc in answers}
    queued = [e["job"] for e in mods(pkg).journal._read_entries(
        os.path.join(wd, "_serve_journal.jsonl"))
        if e.get("state") == "queued" and e["job"] in ids]
    assert sorted(queued) == sorted(ids), queued
    return queued


@pytest.mark.faults
def test_server_crash_recovers_all_accepted_jobs(tmp_path):
    """A crash at job 1's first chunk boundary (exit 24) loses no
    accepted job: the restarted daemon resumes job 1 past its
    completed micrograph and runs job 2 -- the same documents,
    artifacts and request journal as the JAX daemon's."""

    def run(pkg):
        wd = str(tmp_path / pkg)
        os.makedirs(wd)
        env = {"REPIC_CONSENSUS_CHUNK": "1",
               "REPIC_TPU_FAULTS": "server_crash:chunk:1"}
        proc, port = spawn(pkg, wd, env, ["--scheduler", "single"])
        try:
            j1, j2 = _submit_two(pkg, port, wd)
            rc = proc.wait(timeout=120)
        finally:
            stop(proc, signal.SIGKILL)
        proc2, port2 = spawn(pkg, wd, {"REPIC_CONSENSUS_CHUNK": "1"},
                             ["--scheduler", "single"])
        try:
            docs = [wait_terminal(port2, j, timeout=180) for j in (j1, j2)]
            arts = [artifact_digests(port2, j) for j in (j1, j2)]
        finally:
            rc2 = stop(proc2)
        return (rc, rc2, [job_view(d, REPO) for d in docs], arts,
                _queued_before_running(_journal(wd)))

    jax, port = both(run)
    assert port == jax
    rc, rc2, docs, arts, _ = port
    assert rc == mods("port").jobs.SERVE_CRASH_EXIT_CODE == 24
    assert rc2 == 0
    assert [d["state"] for d in docs] == ["finished", "finished"]
    assert docs[0]["resumed"] is True
    assert docs[0]["result"]["resumed_micrographs"] >= 1
    assert [len(a) for a in arts] == [3, 3]


@pytest.mark.faults
def test_poison_job_fault_exits_26_and_quarantines_on_restart(tmp_path):
    def run(pkg):
        wd = str(tmp_path / pkg)
        os.makedirs(wd)
        plan = {"REPIC_TPU_FAULTS": "poison_job:mini10017:inf"}
        args = ["--reassign-budget", "0"]
        proc, port = spawn(pkg, wd, plan, args)
        try:
            try:
                submit(port)
            except (http.client.HTTPException, OSError):
                pass  # the pill may kill the daemon mid-202
            rc = proc.wait(timeout=60)
        finally:
            stop(proc, signal.SIGKILL)
        queued = [e["job"] for e in mods(pkg).journal._read_entries(
            os.path.join(wd, "_serve_journal.jsonl"))
            if e.get("state") == "queued"]
        proc2, port2 = spawn(pkg, wd, plan, args)
        try:
            doc = wait_terminal(port2, queued[0])
            live = req(port2, "GET", "/healthz/live")[0]
            listed = req(port2, "GET", "/v1/jobs")[0]
        finally:
            rc2 = stop(proc2)
        return rc, rc2, job_view(doc, REPO), live, listed, _journal(wd)

    jax, port = both(run)
    assert port == jax
    assert port[0] == mods("port").jobs.POISON_CRASH_EXIT_CODE == 26
    assert port[2]["state"] == "quarantined" and port[2]["attempts"] == 1
    assert port[3:5] == (200, 200)


def test_journal_compaction_folds_old_terminal_jobs(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        for i in range(6):
            jid = f"t{i}"
            j.record(jid, "queued", request={"n": i},
                     idempotency_key=f"key-{i}", tenant="teamA")
            j.record(jid, "running")
            j.record(jid, "finished", particles=i)
        j.record("open-q", "queued", request={"n": "q"})
        j.record("open-r", "queued", request={"n": "r"})
        j.record("open-r", "running")
        j.record("open-r", "running", cancel_requested=True)
        j.record_event("warmup", programs_warmed=1)
        j.close()
        with open(j.path, "a") as f:
            f.write('{"job": "torn", "state": "que')
        stats = jobs.ServeJournal(wd).compact(max_terminal=2)
        rec = sorted((r.id, r.resumed, r.cancel_requested, r.request)
                     for r in jobs.ServeJournal(wd).recover())
        again = jobs.ServeJournal(wd).compact(max_terminal=2)
        return stats, _journal(wd), rec, again

    jax, port = both(run)
    assert port == jax
    stats, entries, rec, again = port
    assert stats["folded"] == 4 and again is None
    folded = [e for e in entries if e.get("folded") is True]
    assert len(folded) == 4
    assert all("request" not in e and e["tenant"] == "teamA"
               for e in folded)
    assert [r[0] for r in rec] == ["open-q", "open-r"]
    assert rec[1][1:3] == (True, True)


def test_compaction_runs_on_daemon_start(tmp_path, monkeypatch):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        for i in range(5):
            j.record(f"t{i}", "queued", request={"n": i})
            j.record(f"t{i}", "finished")
        j.close()
        monkeypatch.setattr(jobs.JobQueue, "MAX_TERMINAL", 2)
        with running(pkg, wd, warmup=False) as d:
            states = sorted((j.id, j.state) for j in d.queue.jobs())
        return states, _journal(wd)

    jax, port = both(run)
    assert port == jax
    states, entries = port
    assert len([e for e in entries if e.get("folded") is True]) == 3
    assert any(e.get("event") == "journal_compacted" for e in entries)
    assert all(s in TERMINAL for _, s in states)


def test_compaction_folds_peer_terminal_jobs_via_hint(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd, replica="a")
        for i in range(4):
            j.record(f"p{i}", "queued", request={"n": i},
                     idempotency_key=f"k{i}")
        j.record("open", "queued", request={"n": "o"})
        j.close()
        stats = jobs.ServeJournal(wd, replica="a").compact(
            max_terminal=1, terminal_ids={f"p{i}" for i in range(4)})
        entries = [
            {k: v for k, v in e.items() if k != "ts"}
            for e in mods(pkg).journal._read_entries(j.path)
        ]
        return stats, entries, os.path.basename(j.path)

    jax, port = both(run)
    assert port == jax
    assert port[0]["folded"] == 3
    assert port[2] == "_serve_journal.a.jsonl"


def test_rerun_records_do_not_bill_the_retry_budget(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        wd = str(tmp_path / pkg)
        j = jobs.ServeJournal(wd)
        j.record("jx", "queued", request={})
        j.record("jx", "running")
        for _ in range(3):
            j.record("jx", "running", rerun=True)
        j.close()
        (job,) = jobs.ServeJournal(wd).recover()
        q = jobs.JobQueue(4, jobs.ServeJournal(os.path.join(wd, "q")))
        job2 = q.submit({"r": 1})
        q.next_job(0.01)
        q.mark_running(job2)
        q.mark_running(job2)
        runs = [bool(e.get("rerun")) for e in _journal(os.path.join(wd, "q"))
                if e.get("state") == "running"]
        return job.attempts, runs

    jax, port = both(run)
    assert port == jax == (1, [False, True])


def test_sigterm_drain_of_the_serve_process(tmp_path):
    """``serve`` as a process: a job, then SIGTERM -- readiness red,
    exit 0, the journal ends in ``drain_begin``/``drain_complete``, as
    the JAX daemon's does."""

    def run(pkg):
        wd = str(tmp_path / pkg)
        os.makedirs(wd)
        proc, port = spawn(pkg, wd)
        try:
            doc = run_job(port)
        finally:
            rc = stop(proc)
        return rc, job_view(doc, REPO), _journal(wd)

    jax, port = both(run)
    assert port == jax
    assert port[0] == 0 and port[1]["state"] == "finished"
    assert [e.get("event") for e in port[2][-2:]] == [
        "drain_begin", "drain_complete"]


def test_serve_help_lists_the_reference_flags_and_device():
    from repic_tpu_torch import main as port_main

    parser = port_main.build_parser()
    sub = parser._subparsers._group_actions[0].choices["serve"]
    flags = {s for a in sub._actions for s in a.option_strings}
    for flag in ("--port", "--queue-limit", "--default-deadline",
                 "--drain-grace", "--breaker-threshold",
                 "--breaker-cooldown", "--no-warmup", "--scheduler",
                 "--max-open", "--compile-cache", "--warmup-bucket",
                 "--tenants", "--reassign-budget", "--slo-target",
                 "--device"):
        assert flag in flags, flag
    for flag in ("--fleet-dir", "--replica-id", "--heartbeat-interval",
                 "--replica-timeout"):
        assert flag not in flags, flag
    args = parser.parse_args(["serve", "wd"])
    assert args.device == "cuda"


def test_fleet_dir_is_refused_not_run_single(tmp_path):
    with pytest.raises(ValueError, match="fleet mode is not ported"):
        new_daemon("port", str(tmp_path / "wd"),
                   fleet_dir=str(tmp_path / "fleet"))


def test_cuda_daemon_without_a_card_raises_before_binding(tmp_path):
    """The daemon's device defaults to ``cuda``: where there is no card
    it raises at construction -- no port bound, no ``_serve.json``."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present (tests/test_torch_cuda.py "
                    "holds the card case)")
    wd = str(tmp_path / "wd")
    with pytest.raises(RuntimeError, match="CUDA"):
        mods("port").daemon.ConsensusDaemon(wd, port=0)
    assert not os.path.exists(os.path.join(wd, "_serve.json"))


def test_serve_process_without_a_card_exits_nonzero(tmp_path):
    """``serve WD`` (default ``--device cuda``) with no card: a
    readable error and a non-zero exit, never a CPU daemon."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    wd = str(tmp_path / "wd")
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "serve", wd,
         "--port", "0"],
        capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
    )
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not os.path.exists(os.path.join(wd, "_serve.json"))


def test_request_options_keep_the_reference_keys():
    """The device belongs to the daemon, not to a request: a request
    naming one is a 400 in both packages."""
    from dataclasses import fields

    from repic_tpu.pipeline.engine import ConsensusOptions as JaxOptions
    from repic_tpu_torch.pipeline.engine import ConsensusOptions

    assert [f.name for f in fields(ConsensusOptions)] == [
        f.name for f in fields(JaxOptions)]
    for cls in (ConsensusOptions, JaxOptions):
        with pytest.raises(ValueError, match="unknown option"):
            cls.from_dict({"device": "cpu"})
