"""The port's consensus engine (``repic_tpu_torch.pipeline.engine``)
against the JAX package's, on the CPU: the cases of
``tests/test_engine.py`` (not the contract registry, which is not
ported), each run through both engines on the same inputs, plus the
compile-cache sidecar's replay.

Tolerance: option validation gives equal values or equal exception
types and messages; plans are equal field by field; emitted BOX
contents are equal byte for byte.
"""

import json
import os

import pytest

from torch_serve_common import FIXTURE, both, fresh, mods

BOX = 180


def _loaded(pkg):
    box_io = mods(pkg).box_io
    pickers = box_io.discover_picker_dirs(FIXTURE)
    names = box_io.micrograph_names(os.path.join(FIXTURE, pickers[0]))
    return [(n, box_io.load_micrograph_set(FIXTURE, pickers, n))
            for n in names]


def _outcome(fn):
    """``("ok", value)`` or ``("raise", type name, message)``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raise", type(e).__name__, str(e))


def _opts_view(o):
    return {f: getattr(o, f) for f in (
        "threshold", "max_neighbors", "num_particles", "use_mesh",
        "spatial", "solver", "use_pallas", "strict", "max_retries")}


def _plan_view(plan):
    return {
        "num_pickers": plan.num_pickers, "capacity": plan.capacity,
        "chunk": plan.chunk, "n_dev": plan.n_dev,
        "bucket_key": plan.bucket_key,
        "chunks": [(c.index, c.names, c.capacity, c.micrographs)
                   for c in plan.chunks],
    }


def test_options_validation_equals_jax():
    cases = [
        lambda e: e.ConsensusOptions(solver="exact"),
        lambda e: e.ConsensusOptions.from_dict({"typo": 1}),
        lambda e: e.ConsensusOptions.from_dict([1]),
        lambda e: e.ConsensusOptions.from_dict(
            {"solver": "lp", "num_particles": 5, "use_mesh": False}),
        lambda e: e.ConsensusOptions.from_dict({"threshold": True}),
        lambda e: e.ConsensusOptions.from_dict({"max_neighbors": 0}),
        lambda e: e.ConsensusOptions.from_dict({"spatial": None,
                                                "max_retries": 3}),
    ]

    def run(pkg):
        eng = mods(pkg).engine
        out = []
        for case in cases:
            got = _outcome(lambda: case(eng))
            if got[0] == "ok":
                got = ("ok", _opts_view(got[1]),
                       got[1].policy().max_retries)
            out.append(got)
        return out

    jax, port = both(run)
    assert port == jax
    assert port[1][0] == "raise" and "unknown option" in port[1][2]
    assert port[3][1]["solver"] == "lp"


def test_plan_request_equals_jax():
    def run(pkg):
        eng = mods(pkg).engine
        loaded = _loaded(pkg)
        opts = eng.ConsensusOptions(use_mesh=False)
        plan = eng.plan_request(loaded, BOX, opts)
        again = eng.plan_request(loaded, BOX, opts)
        empty = _outcome(lambda: eng.plan_request([], BOX, opts))
        return _plan_view(plan), again.bucket_key, empty

    jax, port = both(run)
    assert port == jax
    plan = port[0]
    assert [n for c in plan["chunks"] for n in c[1]] == [
        n for n, _ in _loaded("port")]
    assert port[2][0] == "raise"


def test_plan_request_forced_chunk_equals_jax(monkeypatch):
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")

    def run(pkg):
        eng = mods(pkg).engine
        return _plan_view(eng.plan_request(
            _loaded(pkg), BOX, eng.ConsensusOptions(use_mesh=False)))

    jax, port = both(run)
    assert port == jax
    assert len(port["chunks"]) == 3
    assert all(c[3] == 1 for c in port["chunks"])


@pytest.mark.parametrize("solver", ["lp_device", "greedy"])
def test_execute_emit_equals_jax_and_directory_writer(solver, tmp_path):
    """Engine emission equals the JAX engine's, and the port's
    directory writer's, byte for byte."""

    def run(pkg):
        eng = mods(pkg).engine
        emitted = {}
        for _part, batch, _res, packed, _s in eng.execute_request(
            _loaded(pkg), BOX,
            eng.ConsensusOptions(use_mesh=False, solver=solver),
            **({"device": "cpu"} if pkg == "port" else {}),
        ):
            eng.emit_box_chunk(batch, packed, BOX,
                               sink=emitted.__setitem__)
        return emitted

    jax, port = both(run)
    assert port == jax
    out_dir = str(tmp_path / "dir")
    fresh("port")
    mods("port").consensus.run_consensus_dir(
        FIXTURE, out_dir, BOX, solver=solver, device="cpu")
    assert sorted(port) == sorted(
        f for f in os.listdir(out_dir) if f.endswith(".box"))
    for fname, content in port.items():
        with open(os.path.join(out_dir, fname)) as f:
            assert f.read() == content, fname


@pytest.mark.parametrize("prefetch", ["on", "off"])
def test_cancel_only_at_chunk_boundaries_equals_jax(prefetch,
                                                    monkeypatch):
    """A cancel firing mid-run stops between chunks, with the same
    completed chunks in both engines (the port's poll runs in the
    prefetch worker, one chunk ahead, when the prefetch is on)."""
    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "1")
    if prefetch == "off":
        monkeypatch.setenv("REPIC_TPU_NO_PREFETCH", "1")

    def run(pkg):
        eng = mods(pkg).engine
        polls = []

        def cancel():
            polls.append(1)
            return "deadline exceeded (test)" if len(polls) > 1 else False

        done = []
        try:
            for part, batch, _res, packed, _s in eng.execute_request(
                _loaded(pkg), BOX,
                eng.ConsensusOptions(use_mesh=False), cancel=cancel,
                **({"device": "cpu"} if pkg == "port" else {}),
            ):
                counts = eng.emit_box_chunk(batch, packed, BOX,
                                            sink=lambda f, c: None)
                done.append((part[0][0], counts))
        except eng.ConsensusCancelled as e:
            return done, str(e)
        return done, None

    jax, port = both(run)
    assert port == jax
    assert len(port[0]) == 1 and "deadline" in port[1]
    assert port[0][0][1][port[0][0][0]] > 0


def test_warmup_summary_equals_jax():
    def run(pkg):
        eng = mods(pkg).engine
        kw = {"device": "cpu"} if pkg == "port" else {}
        info = eng.warmup(**kw)
        buckets = eng.warmup_buckets([(3, 64)], **kw)
        assert info["compile_s"] >= 0
        return ({k: v for k, v in info.items() if k != "compile_s"},
                [sorted(b) for b in buckets])

    jax, port = both(run)
    assert port == jax
    assert port[0] == {"num_pickers": 2, "capacity": 64}


def test_warmup_from_cache_replays_recorded_signatures(tmp_path):
    """A run with the sidecar on records its signatures; a fresh
    process state replays them and the next run of the same input is
    a program-cache hit -- the same entries and counts as the JAX
    package's."""

    def run(pkg):
        m = mods(pkg)
        cache = str(tmp_path / pkg)
        m.compilecache.enable(cache)
        eng = m.engine
        kw = {"device": "cpu"} if pkg == "port" else {}
        for item in eng.execute_request(
                _loaded(pkg), BOX, eng.ConsensusOptions(use_mesh=False),
                **kw):
            pass
        with open(os.path.join(cache, "programs.json")) as f:
            sidecar = json.load(f)
        fresh(pkg)
        m.compilecache.enable(cache)
        summary = eng.warmup_from_cache(**kw)
        hits = m.telemetry.counter("repic_program_cache_hits_total")
        misses = m.telemetry.counter("repic_program_cache_misses_total")
        h0, m0 = hits.value(), misses.value()
        for item in eng.execute_request(
                _loaded(pkg), BOX, eng.ConsensusOptions(use_mesh=False),
                **kw):
            pass
        fresh(pkg)
        return (sidecar,
                {k: summary[k] for k in ("programs_warmed",
                                         "programs_failed",
                                         "programs_skipped")},
                hits.value() - h0, misses.value() - m0)

    # the JAX package's ``enable`` points jax's persistent compilation
    # cache at the directory for the whole process: put it back, so
    # later tests in this process compile as they would alone
    import jax as jax_mod

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax_mod.config, n) for n in names}
    try:
        jax, port = both(run)
    finally:
        for n, v in saved.items():
            jax_mod.config.update(n, v)
    assert port == jax
    assert port[1]["programs_warmed"] == len(port[0]) >= 1
    assert port[2] >= 1 and port[3] == 0
