"""The port's continuous batcher and compile-cache sidecar against the
JAX package's, on the CPU: the cases of ``tests/test_batcher.py``.

The scheduling units (``_select``, the streak bound, the shape ladder)
run both packages' ``ContinuousBatcher`` on the same hand-made open
jobs and compare the deal; the queue units compare equal outcomes; the
daemon cases drive the same bursts through both daemons and compare
the job documents, the artifacts, the per-job traces and journals
projected, and the program-cache hit and miss counts; the restart case
compares the ``programs.json`` sidecars byte for byte.
"""

import json
import os

import pytest

from repic_tpu_torch.utils.synthetic import job_view, trace_view
from torch_serve_common import (
    FIXTURE,
    both,
    counter,
    fresh,
    job_dir_view,
    make_picker_dir,
    mods,
    new_daemon,
    run_job,
    running,
    spawn,
    stop,
    wait_ready,
    wait_terminal,
)


def _bare_batcher(pkg):
    cls = mods(pkg).batcher.ContinuousBatcher
    b = cls.__new__(cls)
    b.MIN_CHUNK_PAD = cls.MIN_CHUNK_PAD
    b._open = []
    b._last_key = None
    b._last_capacity = None
    b._streak = 0
    b._rr = -1
    return b


def _key(pkg, cap=64):
    return mods(pkg).batcher.CoalesceKey(
        bucket_key=(3, cap, 0.3, "greedy"), box_sizes=(180.0,),
        max_neighbors=16, use_mesh=False, spatial=None,
        use_pallas=False, n_dev=1,
    )


class FakeJob:
    def __init__(self, ts, tenant=None, deadline_ts=None):
        self.accepted_ts = ts
        self.tenant = tenant
        self.deadline_ts = deadline_ts


class FakeOpen:
    num_pickers = 3

    def __init__(self, name, pending, key, ts, **job):
        self.name = name
        self.job = FakeJob(ts, **job)
        self.key = key
        self.pending = [(f"{name}{i:04d}", None) for i in range(pending)]


def _deal_view(parts):
    return [(oj.name, [n for n, _ in items]) for oj, items in parts]


def test_select_deals_round_robin_and_contiguous():
    def run(pkg):
        b = _bare_batcher(pkg)
        key = _key(pkg)
        b._open = [FakeOpen("big", 40, key, 1.0),
                   FakeOpen("s1", 2, key, 2.0),
                   FakeOpen("s2", 2, key, 3.0)]
        return [_deal_view(b._select()) for _ in range(3)]

    jax, port = both(run)
    assert port == jax
    first = dict(port[0])
    assert set(first) == {"big", "s1", "s2"}
    assert len(first["s1"]) == len(first["s2"]) == 2
    for _, names in port[0]:
        assert names == sorted(names)


def test_bucket_streak_bounds_warm_affinity():
    def run(pkg):
        b = _bare_batcher(pkg)
        b._open = [FakeOpen("w", 100000, _key(pkg, 64), 1.0),
                   FakeOpen("c", 100000, _key(pkg, 128), 1.0)]
        return [b._select()[0][0].key.capacity for _ in range(12)]

    jax, port = both(run)
    assert port == jax
    first_cold = port.index(128)
    assert first_cold <= (
        mods("port").batcher.ContinuousBatcher.MAX_BUCKET_STREAK + 1)
    assert 64 in port[first_cold:]


def test_chunk_shape_ladder_is_sparse():
    def run(pkg):
        b = _bare_batcher(pkg)
        key = _key(pkg)
        return ({m: b._padded_micrographs(m, key) for m in range(1, 65)},
                [b._ladder_around(m) for m in (1, 3, 4, 15, 16, 65, 300)])

    jax, port = both(run)
    assert port == jax
    assert set(port[0].values()) == {4, 16, 64}
    assert port[1][5] == (64, 256)


def test_retry_after_is_per_micrograph(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(2, jobs.ServeJournal(str(tmp_path / pkg)))
        q._avg_mic_s = 3.0
        q.submit({"r": 1}, micrographs=5)
        q.submit({"r": 2}, micrographs=2)
        try:
            q.submit({"r": 3})
        except jobs.AdmissionError as e:
            return e.http_status, e.reason, e.retry_after_s

    jax, port = both(run)
    assert port == jax == (429, "queue_full", 21)


def test_next_job_does_not_sleep_with_pending_work(tmp_path):
    import time

    def run(pkg):
        jobs = mods(pkg).jobs
        q = jobs.JobQueue(8, jobs.ServeJournal(str(tmp_path / pkg)))
        a = q.submit({"r": 1})
        b = q.submit({"r": 2})
        t0 = time.perf_counter()
        order = [q.next_job(5.0) is a, q.next_job(5.0) is b]
        return order, time.perf_counter() - t0 < 1.0

    jax, port = both(run)
    assert port == jax == ([True, True], True)


def test_compilecache_sidecar_roundtrip(tmp_path, monkeypatch):
    def run(pkg):
        cc = mods(pkg).compilecache
        d = str(tmp_path / pkg)
        os.makedirs(d)
        monkeypatch.setattr(cc, "_enabled_dir", None)
        monkeypatch.setattr(cc, "_seen", set())
        empty = cc.load_programs(d)
        cc.record_program({"a": 1})  # disabled: no-op
        monkeypatch.setattr(cc, "_enabled_dir", d)
        e1 = {"threshold": 0.3, "shape": [4, 3, 64, 2]}
        cc.record_program(e1)
        cc.record_program(e1)  # deduped
        cc.record_program({"threshold": 0.5, "shape": [16, 3, 64, 2]})
        with open(os.path.join(d, cc.PROGRAMS_NAME), "rb") as f:
            raw = f.read()
        got = cc.load_programs(d)
        with open(os.path.join(d, cc.PROGRAMS_NAME), "w") as f:
            f.write("{torn")
        return empty, raw, got, cc.load_programs(d)

    jax, port = both(run)
    assert port == jax
    assert port[0] == [] and port[3] == [] and len(port[2]) == 2


def test_compilecache_resolve_dir(monkeypatch):
    def run(pkg):
        cc = mods(pkg).compilecache
        monkeypatch.delenv(cc.ENV_DIR, raising=False)
        out = [cc.resolve_dir(None, "/d"), cc.resolve_dir("/x", "/d"),
               cc.resolve_dir("off", "/d")]
        monkeypatch.setenv(cc.ENV_DIR, "/env")
        out.append(cc.resolve_dir(None, "/d"))
        monkeypatch.setenv(cc.ENV_DIR, "off")
        out.append(cc.resolve_dir(None, "/d"))
        return out

    jax, port = both(run)
    assert port == jax == ["/d", "/x", None, "/env", None]


def test_parse_warmup_buckets():
    def run(pkg):
        parse = mods(pkg).engine.parse_warmup_buckets
        out = [parse(None), parse(["3:256", "2:64", "3:256"])]
        for bad in ("3", "1:64", "3:0", "a:b"):
            try:
                parse([bad])
            except ValueError as e:
                out.append(str(e))
        return out

    jax, port = both(run)
    assert port == jax
    assert port[:2] == [[], [(3, 256), (2, 64)]] and len(port) == 6


def test_bucket_key_ignores_micrograph_count_and_names(tmp_path):
    a = make_picker_dir(tmp_path / "a", 2, seed=1)
    b = make_picker_dir(tmp_path / "b", 3, seed=2, prefix="other")

    def run(pkg):
        m = mods(pkg)
        keys = []
        for d in (a, b):
            pickers = m.box_io.discover_picker_dirs(d)
            names = m.box_io.micrograph_names(os.path.join(d, pickers[0]))
            loaded = [(nm, m.box_io.load_micrograph_set(d, pickers, nm))
                      for nm in names]
            keys.append(m.engine.plan_request(loaded, 180).bucket_key)
        return keys

    jax, port = both(run)
    assert port == jax
    assert port[0] == port[1]


def test_different_job_sizes_share_one_compiled_program(tmp_path):
    """A 2-micrograph and a 3-micrograph job land on one padded chunk
    shape: the second is a program-cache hit, not a miss -- the same
    counts as the JAX daemon's."""
    a = make_picker_dir(tmp_path / "a", 2, seed=1)
    b = make_picker_dir(tmp_path / "b", 3, seed=2, prefix="other")

    def run(pkg):
        with running(pkg, str(tmp_path / pkg), warmup=False) as d:
            port = d.server.port
            body = {"box_size": 180, "options": {"use_mesh": False}}
            h0 = counter(pkg, "repic_program_cache_hits_total")
            m0 = counter(pkg, "repic_program_cache_misses_total")
            first = run_job(port, dict(body, in_dir=a))
            h1 = counter(pkg, "repic_program_cache_hits_total")
            m1 = counter(pkg, "repic_program_cache_misses_total")
            second = run_job(port, dict(body, in_dir=b))
            h2 = counter(pkg, "repic_program_cache_hits_total")
            m2 = counter(pkg, "repic_program_cache_misses_total")
        return (job_view(first), job_view(second),
                (h1 - h0, m1 - m0), (h2 - h1, m2 - m1))

    jax, port = both(run)
    assert port == jax
    assert port[1]["state"] == "finished"
    assert port[3][1] == 0 and port[3][0] >= 1


def test_burst_coalesces_across_requests(tmp_path):
    """A burst of queued jobs runs as coalesced chunks: every job
    finishes with its own artifacts, and the traces' execute segments
    carry the coalesced share -- as in the JAX daemon."""
    dirs = [make_picker_dir(tmp_path / f"j{i}", 2, seed=i)
            for i in range(4)]

    def run(pkg):
        wd = str(tmp_path / pkg)
        # journal the burst before the worker exists: every job is
        # pending when the batcher starts
        dead = new_daemon(pkg, wd, warmup=False)
        jobs = [dead.queue.submit({"in_dir": d, "box_size": 180,
                                   "options": {"use_mesh": False}})
                for d in dirs]
        dead.journal.close()
        b0 = counter(pkg, "repic_serve_batches_total")
        with running(pkg, wd, warmup=False) as d2:
            docs = [job_view(wait_terminal(d2.server.port, j.id))
                    for j in jobs]
        batches = counter(pkg, "repic_serve_batches_total") - b0
        dirs_ = [job_dir_view(d2.job_dir(j.id)) for j in jobs]
        execs = [[r for r in _trace(d2.job_dir(j.id))
                  if r.get("seg") == "execute"] for j in jobs]
        shares = [[(r.get("coalesced_jobs"), r.get("share"),
                    r.get("micrographs")) for r in e] for e in execs]
        return docs, dirs_, batches, shares

    jax, port = both(run)
    assert port == jax
    docs, dirs_, batches, shares = port
    assert all(d["state"] == "finished" for d in docs)
    assert all(len(d["boxes"]) == 2 for d in dirs_)
    assert batches >= 1
    assert any(c > 1 for s in shares for c, _, _ in s)


def _trace(job_dir):
    with open(os.path.join(job_dir, "_trace.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_coalesced_multi_tenant_chunk_solves_on_device(tmp_path):
    """A coalesced chunk's packings solve inside the device program
    (the ``lp_device`` rung): the in-program solve counter moves by
    the real micrograph count, no trace has a host solve, and every
    job's journal records ``lp_device`` per micrograph."""
    dirs = [make_picker_dir(tmp_path / f"t{i}", 2, seed=10 + i)
            for i in range(3)]

    def run(pkg):
        wd = str(tmp_path / pkg)
        dead = new_daemon(pkg, wd, warmup=False)
        jobs = [dead.queue.submit({"in_dir": d, "box_size": 180,
                                   "options": {"use_mesh": False}})
                for d in dirs]
        dead.journal.close()
        s0 = counter(pkg, "repic_solver_device_solves_total")
        with running(pkg, wd, warmup=False) as d2:
            docs = [job_view(wait_terminal(d2.server.port, j.id))
                    for j in jobs]
        solves = counter(pkg, "repic_solver_device_solves_total") - s0
        views = [job_dir_view(d2.job_dir(j.id)) for j in jobs]
        return docs, solves, views

    jax, port = both(run)
    assert port == jax
    docs, solves, views = port
    assert solves >= 6
    for v in views:
        assert "host_solve" not in v["trace"]
        recs = v["journal"]["records"]
        assert len(recs) == 2
        assert all(r[-1]["solver"] == "lp_device"
                   and r[-1]["status"] == "ok" for r in recs.values())


def test_restart_with_persisted_compile_cache_serves_warm(tmp_path):
    """Generation 1 records its program signatures in the sidecar
    (byte for byte the JAX daemon's ``programs.json``); generation 2's
    warmup replays them, so its first request is a program-cache hit
    with no miss and a compile segment near 0."""
    sub = {"in_dir": FIXTURE, "box_size": 180,
           "options": {"use_mesh": False}}

    def run(pkg):
        wd = str(tmp_path / pkg)
        os.makedirs(wd)
        proc, port = spawn(pkg, wd, warmup=True)
        try:
            wait_ready(port)
            first = run_job(port, sub)
        finally:
            rc = stop(proc)
        with open(os.path.join(wd, "_compile_cache",
                               "programs.json"), "rb") as f:
            sidecar = f.read()
        proc2, port2 = spawn(pkg, wd, warmup=True)
        try:
            wait_ready(port2)
            doc = run_job(port2, sub)
        finally:
            rc2 = stop(proc2)
        with open(os.path.join(wd, "_serve_journal.jsonl")) as f:
            warmups = [json.loads(line) for line in f
                       if '"warmup"' in line]
        comp = [r for r in _trace(os.path.join(wd, "jobs", doc["id"]))
                if r.get("seg") == "compile"]
        return {
            "rc": (rc, rc2), "sidecar": sidecar,
            "first": job_view(first), "second": job_view(doc),
            "warmed": [(w.get("programs_warmed"),
                        w.get("programs_failed")) for w in warmups],
            "compile": [(c.get("cache_hits"), c.get("cache_misses"))
                        for c in comp],
            "compile_s": sum(c["dur_s"] for c in comp),
            "trace": trace_view(os.path.join(wd, "jobs", doc["id"])),
        }

    jax, port = both(run)
    for key in ("rc", "sidecar", "first", "second", "warmed", "compile",
                "trace"):
        assert port[key] == jax[key], key
    assert port["rc"] == (0, 0)
    assert port["warmed"][-1][0] >= 1
    assert sum(h for h, _ in port["compile"]) >= 1
    assert sum(m for _, m in port["compile"]) == 0
    assert port["compile_s"] < 0.3


def test_cancel_at_coalesced_boundary_spares_survivors(tmp_path,
                                                       monkeypatch):
    """Cancel at a coalesced chunk boundary: the cancelled request
    stops between chunks, the survivor in the same chunks completes,
    and the SLO plane records one violation -- in both daemons.  The
    cancel is requested when job A's first chunk is done, from the
    scheduler's own boundary poll, so both daemons cancel at the same
    boundary."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "2")
    a = make_picker_dir(tmp_path / "a", 12, seed=1)
    b = make_picker_dir(tmp_path / "b", 12, seed=2, prefix="other")

    def run(pkg):
        wd = str(tmp_path / pkg)
        dead = new_daemon(pkg, wd, warmup=False)
        ids = [dead.queue.submit({"in_dir": d, "box_size": 180,
                                  "options": {"use_mesh": False}}).id
               for d in (a, b)]
        dead.journal.close()
        d = new_daemon(pkg, wd, port=0, warmup=False,
                       slo_targets={"job": (300.0, 0.95)})
        checks = d._cancel_check

        def cancel_after_first_chunk(job):
            check = checks(job)

            def poll():
                if job.id == ids[0] and job.progress.get(
                        "chunks_done", 0) >= 1:
                    job.cancel_requested = True
                return check()

            return poll

        monkeypatch.setattr(d, "_cancel_check", cancel_after_first_chunk)
        d.start()
        try:
            docs = [job_view(wait_terminal(d.server.port, i))
                    for i in ids]
            slo = d.slo.summary()["endpoints"]["job"]
        finally:
            d.drain()
        views = [job_dir_view(d.job_dir(i)) for i in ids]
        return docs, views, (slo["count"], slo["compliance"])

    jax, port = both(run)
    assert port == jax
    docs, views, slo = port
    assert docs[0]["state"] == "cancelled"
    assert docs[1]["state"] == "finished"
    assert docs[1]["result"]["particles"] > 0
    assert len(views[1]["boxes"]) == 12 and len(views[0]["boxes"]) < 12
    assert slo == (2, pytest.approx(0.5))


def test_batch_and_single_write_the_same_bytes(tmp_path):
    """Coalescing changes no output byte: the port's daemon writes the
    same BOX files under ``batch`` and ``single``, and the same as the
    JAX daemon under ``batch``."""
    dirs = [make_picker_dir(tmp_path / f"j{i}", 1 + i, seed=20 + i)
            for i in range(3)]

    def burst(pkg, scheduler):
        wd = str(tmp_path / f"{pkg}_{scheduler}")
        dead = new_daemon(pkg, wd, warmup=False)
        ids = [dead.queue.submit({"in_dir": d, "box_size": 180,
                                  "options": {"use_mesh": False}}).id
               for d in dirs]
        dead.journal.close()
        with running(pkg, wd, warmup=False, scheduler=scheduler) as dm:
            for i in ids:
                assert wait_terminal(dm.server.port, i)["state"] == (
                    "finished")
        return [job_dir_view(dm.job_dir(i))["boxes"] for i in ids]

    jax, port = both(burst, "batch")
    assert port == jax
    fresh("port")
    assert burst("port", "single") == port
    assert [len(b) for b in port] == [1, 2, 3]


def test_burst_of_split_jobs_writes_the_directory_runs_bytes(tmp_path):
    """Phase 11b at a small size: a synthetic set at 10017's density
    cut into jobs (``split_into_jobs``: small ones and a large one
    mid-burst) and served as one burst writes, micrograph for
    micrograph, the bytes of the port's directory run -- and the JAX
    daemon's served bytes."""
    from repic_tpu_torch.utils.synthetic import (
        split_into_jobs,
        write_synthetic_dir,
    )

    synth = str(tmp_path / "synth")
    write_synthetic_dir(synth, n_micrographs=9, seed=0)
    job_dirs = split_into_jobs(synth, str(tmp_path / "jobs"),
                               sizes=(1, 2, 3))
    assert [os.path.basename(j) for j in job_dirs] == [
        "small00", "large", "small01", "small02"]
    ref = str(tmp_path / "ref")
    fresh("port")
    mods("port").consensus.run_consensus_dir(synth, ref, 180, device="cpu")

    def run(pkg):
        wd = str(tmp_path / pkg)
        dead = new_daemon(pkg, wd, warmup=False)
        ids = [dead.queue.submit({
            "in_dir": d, "box_size": 180,
            "options": {"use_mesh": False},
        }).id for d in job_dirs]
        dead.journal.close()
        with running(pkg, wd, warmup=False) as d:
            for i in ids:
                assert wait_terminal(d.server.port, i)["state"] == (
                    "finished")
        out = {}
        for i in ids:
            out.update(job_dir_view(d.job_dir(i))["boxes"])
        return out

    jax, port = both(run)
    assert port == jax
    assert len(port) == 9
    for name, text in port.items():
        with open(os.path.join(ref, name)) as f:
            assert f.read() == text, name
