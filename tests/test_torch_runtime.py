"""The port's runtime modules against ``repic_tpu``'s, on the CPU.

The cases of ``tests/test_runtime_faults.py``,
``tests/test_runtime_journal.py`` and ``tests/test_runtime_ladder.py``
(its fault, backoff, ``_auto_chunk`` and ladder cases), each run
through both packages with the same inputs:

* ``runtime/faults.py``: spec parsing, count-based firing, the
  exceptions ``inject`` raises, plan scoping, ``REPIC_TPU_FAULTS``, and
  the two ``read_box`` sites (``io`` stays an ``OSError``,
  ``corrupt_box`` surfaces as ``BoxParseError``);
* ``runtime/journal.py`` and ``runtime/atomic.py``: records, resume,
  a mismatched manifest, the torn last line, the manifest's bytes;
* ``runtime/ladder.py``: the OOM classifier (``torch.cuda.
  OutOfMemoryError`` by its type), the backoff, ``_auto_chunk`` under
  ``REPIC_CONSENSUS_CHUNK`` / ``REPIC_CONSENSUS_CHUNK_BYTES``, and the
  solver ladder under the ``solver_budget`` / ``solver_diverge`` sites;
* ``utils/tracing.py``: ``consensus_runtime.tsv``'s rows.
"""

import json
import os

import numpy as np
import pytest
import torch

from repic_tpu.pipeline import consensus as jcons
from repic_tpu.runtime import atomic as jatomic
from repic_tpu.runtime import faults as jfaults
from repic_tpu.runtime import journal as jjournal
from repic_tpu.runtime import ladder as jladder
from repic_tpu.telemetry.sinks import write_runtime_tsv as jwrite_tsv
from repic_tpu.utils import box_io as jbox
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.runtime import atomic as tatomic
from repic_tpu_torch.runtime import faults as tfaults
from repic_tpu_torch.runtime import journal as tjournal
from repic_tpu_torch.runtime import ladder as tladder
from repic_tpu_torch.utils import box_io as tbox
from repic_tpu_torch.telemetry.sinks import write_runtime_tsv
from repic_tpu_torch.utils.tracing import StageTimer

PACKAGES = {
    "port": (tfaults, tjournal, tladder, tatomic, tbox),
    "jax": (jfaults, jjournal, jladder, jatomic, jbox),
}


# -- faults -------------------------------------------------------------


def test_known_sites_are_the_reference_sites():
    assert tfaults.KNOWN_SITES == jfaults.KNOWN_SITES


@pytest.mark.parametrize("spec", [
    "oom", "io:mic_002", "io:mic_002:3", "oom::inf", "oom:mic:a:2",
    "io:*", "megakernel_fallback:Falcon_2012_06_12-14_33_35_0:1",
    "solver_budget:exact:*",
])
def test_parse_spec_matches_reference(spec):
    got, want = tfaults.parse_spec(spec), jfaults.parse_spec(spec)
    assert (got.site, got.key, got.times) == (want.site, want.key,
                                              want.times)


@pytest.mark.parametrize("faults", [tfaults, jfaults])
def test_parse_spec_rejects_an_empty_site(faults):
    with pytest.raises(ValueError):
        faults.parse_spec(":key")


def _firing_sequence(faults):
    with faults.fault_plan("oom:chunk:2", "io::1"):
        fired = [faults.check(site, key) for site, key in (
            ("oom", "chunk:a"), ("oom", "other"), ("io", "x"),
            ("oom", "chunk:b"), ("io", "y"), ("oom", "chunk:c"))]
        log = faults.fired_log()
    return fired, log, faults.check("oom", "chunk:z"), faults.active()


def test_count_based_firing_matches_reference():
    got = _firing_sequence(tfaults)
    assert got == _firing_sequence(jfaults)
    fired, log, after, active = got
    assert fired == [True, False, True, True, False, False]
    assert log == (("oom", "chunk:a"), ("io", "x"), ("oom", "chunk:b"))
    assert after is False and active is False


@pytest.mark.parametrize("site,exc", [
    ("oom", RuntimeError), ("io", OSError), ("corrupt_box", ValueError),
    ("solver_budget", RuntimeError),
])
def test_inject_raises_the_reference_exception(site, exc):
    caught = []
    for faults in (tfaults, jfaults):
        with faults.fault_plan(site):
            with pytest.raises(exc) as ei:
                faults.inject(site, "site:key")
            faults.inject(site, "site:key")  # single-shot
        caught.append((type(ei.value), str(ei.value)))
    assert caught[0] == caught[1]


def test_injected_oom_is_classed_oom():
    with tfaults.fault_plan("oom"):
        with pytest.raises(RuntimeError) as ei:
            tfaults.inject("oom", "chunk:x")
    assert tladder.is_oom_error(ei.value)
    assert tladder.classify_error(ei.value) == "oom"
    assert jladder.classify_error(ei.value) == "oom"


@pytest.mark.parametrize("faults", [tfaults, jfaults])
def test_nested_plans_restore(faults):
    with faults.fault_plan("oom::inf"):
        assert faults.check("oom", "x")
        with faults.fault_plan("io"):
            assert not faults.check("oom", "x")
            assert faults.check("io", "y")
        assert faults.check("oom", "x")


def test_install_from_env_matches_reference():
    env = {"REPIC_TPU_FAULTS": "corrupt_box:mic_002, oom::1"}
    try:
        got = [(f.site, f.key, f.times)
               for f in tfaults.install_from_env(env)]
        want = [(f.site, f.key, f.times)
                for f in jfaults.install_from_env(env)]
        assert got == want == [("corrupt_box", "mic_002", 1),
                               ("oom", None, 1)]
        assert tfaults.install_from_env({}) == []
    finally:
        tfaults.clear()
        jfaults.clear()


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_read_box_corrupt_injection_is_boxparseerror(tmp_path, pkg):
    faults, _, _, _, box_io = PACKAGES[pkg]
    p = tmp_path / "mic_002.box"
    p.write_text("10 20 64 64 0.5\n")
    with faults.fault_plan("corrupt_box:mic_002"):
        with pytest.raises(box_io.BoxParseError) as ei:
            box_io.read_box(str(p))
        assert ei.value.path == str(p)
        bs = box_io.read_box(str(p))  # single-shot
        np.testing.assert_allclose(bs.xy, [[10, 20]])
    assert str(ei.value) == (
        f"failed to read BOX file {p}: ValueError: injected corrupt BOX "
        f"content at {p}")


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_read_box_io_injection_stays_oserror(tmp_path, pkg):
    faults, _, ladder, _, box_io = PACKAGES[pkg]
    p = tmp_path / "mic_007.box"
    p.write_text("10 20 64 64 0.5\n")
    with faults.fault_plan("io:mic_007"):
        with pytest.raises(OSError, match="injected I/O") as ei:
            box_io.read_box(str(p))
        assert not isinstance(ei.value, box_io.BoxParseError)
        assert ladder.classify_error(ei.value) == "io"
        assert box_io.read_box(str(p)).n == 1


# -- journal + atomic writes ---------------------------------------------

CFG = {"in_dir": "/data", "box_size": 64, "names": ["a", "b", "c"]}


def _projected(entries):
    return [{k: v for k, v in e.items() if k != "ts"} for e in entries]


def _record_run(journal, out):
    with journal.RunJournal.open(out, CFG) as j:
        j.record("a", "ok", wall_s=0.1, solver="greedy")
        j.record("b", "quarantined", error={"type": "ValueError"})
        j.record("b", "ok")
        j.record_event("chunk_halved", chunk=4)
        state = (j.done_names(), j.quarantined(), j.summary(),
                 j.events()[0]["event"])
    return state, _projected(journal.read_journal(out))


def test_record_latest_and_summary_match_reference(tmp_path):
    got = _record_run(tjournal, str(tmp_path / "port"))
    assert got == _record_run(jjournal, str(tmp_path / "jax"))
    (done, quarantined, summary, event), entries = got
    assert done == {"a", "b"} and quarantined == {} and event == "chunk_halved"
    assert summary == {"ok": 2}
    assert [e.get("name", e.get("event")) for e in entries] == [
        "a", "b", "b", "chunk_halved"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_resume_same_config_loads_entries(tmp_path, pkg):
    journal = PACKAGES[pkg][1]
    out = str(tmp_path / "run")
    with journal.RunJournal.open(out, CFG) as j:
        j.record("a", "ok", out="a.box")
        j.record("b", "quarantined",
                 error=journal.error_info(ValueError("x")))
    with journal.RunJournal.open(out, CFG, resume=True) as j2:
        assert j2.resumed
        assert j2.done_names() == {"a"}
        assert set(j2.quarantined()) == {"b"}
        j2.record("b", "ok", out="b.box")
        assert j2.done_names() == {"a", "b"}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_resume_config_mismatch_discards_journal(tmp_path, pkg):
    journal = PACKAGES[pkg][1]
    out = str(tmp_path / "run")
    with journal.RunJournal.open(out, CFG) as j:
        j.record("a", "ok")
    with journal.RunJournal.open(out, dict(CFG, box_size=128),
                                 resume=True) as j2:
        assert not j2.resumed and j2.latest() == {}
    assert journal.read_journal(out) == []
    with journal.RunJournal.open(out, CFG, resume=False) as j3:
        assert not j3.resumed and j3.latest() == {}


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_torn_trailing_line_is_tolerated(tmp_path, pkg):
    journal = PACKAGES[pkg][1]
    out = str(tmp_path / "run")
    with journal.RunJournal.open(out, CFG) as j:
        j.record("a", "ok")
        path = j.path
    with open(path, "at") as f:
        f.write('{"name": "b", "status": "o')  # a crash mid-write
    with journal.RunJournal.open(out, CFG, resume=True) as j2:
        assert j2.done_names() == {"a"}
    assert [e["name"] for e in journal.read_journal(out)] == ["a"]


def test_manifest_bytes_match_reference(tmp_path):
    """The manifest pins the JSON round trip of the configuration (a
    tuple and a list are the same run) in the reference's bytes, its
    ``created`` clock aside."""
    manifests = []
    for journal, name in ((tjournal, "port"), (jjournal, "jax")):
        out = str(tmp_path / name)
        with journal.RunJournal.open(out, {"names": ("a", "b"), "x": 1.5}):
            pass
        with journal.RunJournal.open(out, {"names": ["a", "b"], "x": 1.5},
                                     resume=True) as j:
            assert j.resumed
        with open(os.path.join(out, "_manifest.json")) as f:
            data = json.load(f)
        assert data["config"] == {"names": ["a", "b"], "x": 1.5}
        data["created"] = 0
        manifests.append(json.dumps(data, indent=2))
    assert manifests[0] == manifests[1]
    assert tjournal.DONE_STATUSES == jjournal.DONE_STATUSES


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_atomic_write_publishes_complete_file(tmp_path, pkg):
    atomic = PACKAGES[pkg][3]
    p = tmp_path / "x.txt"
    with atomic.atomic_write(str(p)) as f:
        f.write("hello")
        assert not p.exists()
    assert p.read_text() == "hello"
    assert list(tmp_path.iterdir()) == [p]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_atomic_write_failure_keeps_previous_content(tmp_path, pkg):
    atomic = PACKAGES[pkg][3]
    p = tmp_path / "x.txt"
    p.write_text("ORIGINAL")
    with pytest.raises(RuntimeError):
        with atomic.atomic_write(str(p)) as f:
            f.write("partial garbage")
            raise RuntimeError("crash mid-write")
    assert p.read_text() == "ORIGINAL"
    assert list(tmp_path.iterdir()) == [p]
    with pytest.raises(ValueError):
        with atomic.atomic_write(str(tmp_path / "y"), mode="at"):
            pass


def test_box_io_writes_through_the_runtime_atomic_write():
    assert tbox.atomic_write is tatomic.atomic_write


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_claims_are_create_once(tmp_path, pkg):
    atomic = PACKAGES[pkg][3]
    p = str(tmp_path / "token")
    assert atomic.try_claim(p, "a") and not atomic.try_claim(p, "b")
    q = str(tmp_path / "commit")
    assert atomic.commit_once(q, "first")
    assert not atomic.commit_once(q, "second")
    assert open(q).read() == "first"
    assert sorted(os.listdir(tmp_path)) == ["commit", "token"]


# -- the ladder ------------------------------------------------------------


@pytest.mark.parametrize("err,kind", [
    (RuntimeError("RESOURCE_EXHAUSTED: oom"), "oom"),
    (RuntimeError("Out of memory while trying"), "oom"),
    (RuntimeError("shape mismatch"), "error"),
    (OSError("disk gone"), "io"),
    (ValueError("bad row"), "error"),
])
def test_classify_error_matches_reference(err, kind):
    assert tladder.classify_error(err) == jladder.classify_error(err) == kind


def test_cuda_out_of_memory_is_classed_oom_by_type():
    """A ``torch.cuda.OutOfMemoryError`` is an OOM whatever its text."""
    e = torch.cuda.OutOfMemoryError("allocator gave up")
    assert tladder.is_oom_error(e) and tladder.classify_error(e) == "oom"


@pytest.mark.parametrize("attempt", [1, 2, 3, 4, 100])
def test_backoff_matches_reference(attempt):
    kw = dict(max_retries=5, backoff_base_s=0.1, backoff_cap_s=0.5)
    got = tladder.RetryPolicy(**kw).backoff(attempt)
    assert got == jladder.RetryPolicy(**kw).backoff(attempt)
    assert got == min(0.5, 0.1 * 2 ** (attempt - 1))
    assert tladder.DEFAULT_POLICY == tladder.RetryPolicy(max_retries=2)


@pytest.mark.parametrize("ladder", [tladder, jladder])
def test_negative_retries_rejected(ladder):
    with pytest.raises(ValueError, match="max_retries"):
        ladder.RetryPolicy(max_retries=-1)


def test_outcomes_keep_degraded_over_retried():
    out = tladder.ChunkOutcomes()
    out.mark(["a", "b"], "retried")
    out.mark(["b"], "degraded")
    out.mark(["b"], "retried")
    assert out.status == {"a": "retried", "b": "degraded"}
    assert out.quarantined == {} and out.solver == {}


@pytest.mark.parametrize("env", [
    {}, {"REPIC_CONSENSUS_CHUNK": "3"}, {"REPIC_CONSENSUS_CHUNK": "64"},
    {"REPIC_CONSENSUS_CHUNK": "0"},
    {"REPIC_CONSENSUS_CHUNK_BYTES": "1e8"},
    {"REPIC_CONSENSUS_CHUNK_BYTES": "1"},
])
def test_auto_chunk_matches_reference(monkeypatch, env):
    for var in ("REPIC_CONSENSUS_CHUNK", "REPIC_CONSENSUS_CHUNK_BYTES"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    for n_loaded, k, nb in ((100, 3, 1024), (10, 3, 1024), (1024, 5, 4096),
                            (12, 3, 1024), (1024, 5, 1024), (1, 2, 64),
                            (1024, 5, 65536)):
        got = tcons._auto_chunk(n_loaded, k, nb)
        assert got == jcons._auto_chunk(n_loaded, k, nb, 1)
        assert 1 <= got <= n_loaded


def _chain():
    """4 cliques on a shared-vertex chain; the optimum picks 0 and 2."""
    mv = np.array([[0, 1], [1, 2], [2, 3], [3, 4]], np.int64)
    w = np.array([2.0, 1.5, 1.0, 0.4])
    return mv, w, 5


@pytest.mark.parametrize("plan,solver,budget", [
    ((), "exact", None),
    (("solver_budget:exact:inf",), "exact", None),
    (("solver_budget:exact:inf", "solver_budget:lp:inf"), "exact", None),
    ((), "exact", -1.0),
    (("solver_diverge:lp_device:1",), "lp_device", None),
    (("solver_diverge:lp_device:1", "solver_budget:lp:1"), "lp_device",
     None),
    (("solver_budget:lp_device:1",), "lp_device_fused", None),
])
def test_solver_ladder_under_faults_matches_reference(plan, solver, budget):
    mv, w, nv = _chain()
    with tfaults.fault_plan(*plan):
        got, used = tladder.solve_host_ladder(mv, w, nv, solver=solver,
                                              budget_s=budget)
        got_log = tfaults.fired_log()
    with jfaults.fault_plan(*plan):
        want, used_want = jladder.solve_host_ladder(mv, w, nv, solver=solver,
                                                    budget_s=budget)
        want_log = jfaults.fired_log()
    assert used == used_want and got_log == want_log
    np.testing.assert_array_equal(got, want)
    assert list(np.where(got)[0]) == [0, 2]


def test_solver_ladder_empty_problem():
    picked, used = tladder.solve_host_ladder(np.zeros((0, 2), np.int64),
                                             np.zeros(0), 4, solver="exact")
    assert picked.shape == (0,) and used == "exact"


# -- consensus_runtime.tsv ------------------------------------------------


def test_runtime_tsv_rows_match_reference(tmp_path):
    stages = [("load", 0.0123456789), ("compute", 2.5), ("write", 1e-7),
              ("compute", 0.25)]
    got = write_runtime_tsv(str(tmp_path / "p"), stages, name="r.tsv")
    want = jwrite_tsv(str(tmp_path / "j"), stages, name="r.tsv")
    assert open(got).read() == open(want).read()
    timer = StageTimer()
    timer.stages += [("load", 0.5), ("load", 0.25)]
    path = timer.write_tsv(str(tmp_path / "t"))
    assert open(path).read() == "load\t0.500000\nload\t0.250000\n"
