"""The port's brownout policy (``repic_tpu_torch.serve.autoscale``, the
policy half of the reference module) and the batcher's EDF dealing
against the JAX package's, on the CPU: the brownout and EDF cases of
``tests/test_autoscale.py``.  Each case runs both packages on the same
inputs (the same published posture file, the same hand-made open jobs)
and compares the outputs, or the refusals' status, reason and
``Retry-After``.  The supervisor's cases wait for the fleet.
"""

import json
import os

import pytest

from torch_serve_common import both, mods


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _publish_state(root, **fields):
    doc = {"level": 0, "interval_s": 2.0, "cooldown_remaining_s": 0.0,
           **fields}
    with open(os.path.join(root, "_autoscale_state.json"), "w") as f:
        json.dump(doc, f)
    return doc


def _refusal(fn):
    try:
        return ("ok", fn().state)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("refused", e.http_status, e.reason, e.retry_after_s)


def _registry(pkg):
    t = mods(pkg).tenancy
    return t.TenantRegistry([
        t.TenantSpec(name="gold", keys=("kg",), priority="high"),
        t.TenantSpec(name="std", keys=("ks",)),
        t.TenantSpec(name="batch", keys=("kb",), priority="low"),
    ])


def _queue(pkg, root, limit=8, **kw):
    jobs = mods(pkg).jobs
    os.makedirs(root, exist_ok=True)
    return jobs.JobQueue(limit, jobs.ServeJournal(root),
                         tenants=_registry(pkg), **kw)


# -- brownout policy ---------------------------------------------------


@pytest.mark.parametrize("burn", [0.0, 1.9, 2.0, 5.9, 6.0, 13.9, 14.0,
                                  1e9])
def test_brownout_levels_are_staged(burn):
    jax, port = both(lambda pkg: mods(pkg).autoscale.brownout_level(burn))
    assert port == jax
    assert port == sum(burn >= t for t in (2.0, 6.0, 14.0))


def test_brownout_exit_hysteresis():
    cases = [(1.5, 1), (0.9, 1), (4.0, 2), (2.5, 2), (0.5, 2), (20.0, 1),
             (5.0, 3), (7.0, 3), (2.9, 3)]

    def run(pkg):
        level = mods(pkg).autoscale.brownout_level
        return [level(b, prev=p) for b, p in cases]

    jax, port = both(run)
    assert port == jax
    assert port[:6] == [1, 0, 2, 1, 0, 3]


def test_shed_priorities_ordering():
    jax, port = both(lambda pkg: [
        mods(pkg).autoscale.shed_priorities(lv) for lv in range(5)])
    assert port == jax
    assert port[:4] == [(), ("low",), ("low", "normal"), ("low", "normal")]


def test_effective_queue_limit_halves_at_level3():
    cases = [(8, 0), (8, 2), (8, 3), (1, 3), (9, 4)]
    jax, port = both(lambda pkg: [
        mods(pkg).autoscale.effective_queue_limit(n, lv)
        for n, lv in cases])
    assert port == jax == [8, 8, 4, 1, 4]


def test_shed_horizon_prices_class_not_global():
    state = {"interval_s": 2.0, "cooldown_remaining_s": 6.0}
    cases = [((state, 10, 3.0), {"live": 2}), (({}, 0, 3.0), {}),
             ((None, 0, 0.0), {}), (({"interval_s": 0.1}, 4, 1.0), {})]
    jax, port = both(lambda pkg: [
        mods(pkg).autoscale.shed_horizon_s(*a, **kw) for a, kw in cases])
    assert port == jax
    assert port[:3] == [23.0, 2.0, 2.0]


# -- posture file / BrownoutReader ------------------------------------


def test_brownout_reader_absent_file_is_level0(tmp_path):
    def run(pkg):
        r = mods(pkg).autoscale.BrownoutReader(str(tmp_path / pkg))
        return r.state(), r.level()

    jax, port = both(run)
    assert port == jax == (None, 0)


def test_brownout_reader_tracks_rewrites(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        r = mods(pkg).autoscale.BrownoutReader(root)
        _publish_state(root, level=2)
        out = [r.level()]
        _publish_state(root, level=0, note="recovered")
        out += [r.level(), r.state()]
        os.unlink(os.path.join(root, "_autoscale_state.json"))
        return out + [r.level()]

    jax, port = both(run)
    assert port == jax
    assert [port[0], port[1], port[3]] == [2, 0, 0]


def test_brownout_reader_tolerates_garbage(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        with open(os.path.join(root, "_autoscale_state.json"), "w") as f:
            f.write("{not json")
        r = mods(pkg).autoscale.BrownoutReader(root)
        return r.level(), mods(pkg).autoscale.read_state(root)

    jax, port = both(run)
    assert port == jax == (0, None)


def test_read_state_and_decisions(tmp_path):
    """The posture and the torn-tail-tolerant decision journal read
    the same files the same way."""

    def run(pkg):
        a = mods(pkg).autoscale
        root = str(tmp_path / pkg)
        os.makedirs(root)
        _publish_state(root, level=1, target=3)
        with open(a.journal_path(root), "w") as f:
            f.write(json.dumps({"action": "scale_up", "ts": 1.0}) + "\n")
            f.write('{"action": "sca')
        return (a.read_state(root), a.read_decisions(root),
                os.path.basename(a.state_path(root)),
                os.path.basename(a.journal_path(root)))

    jax, port = both(run)
    assert port == jax
    assert port[1] == [{"action": "scale_up", "ts": 1.0}]


# -- admission shedding -----------------------------------------------


def test_brownout_sheds_by_priority_class(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        q = _queue(pkg, root)
        _publish_state(root, level=1)
        out = [_refusal(lambda t=t, i=i: q.submit({"r": i}, tenant=t))
               for i, t in enumerate(("batch", "std", "gold"))]
        _publish_state(root, level=2)
        out += [_refusal(lambda t=t, i=i: q.submit({"r": i}, tenant=t))
                for i, t in enumerate(("std", None, "gold"))]
        return out

    jax, port = both(run)
    assert port == jax
    assert port[0][1:3] == (429, "brownout")
    assert port[1] == port[2] == ("ok", "queued")
    assert [o[0] for o in port[3:]] == ["refused", "refused", "ok"]


def test_brownout_recovery_readmits(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        q = _queue(pkg, root)
        _publish_state(root, level=1)
        shed = _refusal(lambda: q.submit({"r": 1}, tenant="batch"))
        _publish_state(root, level=0)
        return shed[:3], _refusal(lambda: q.submit({"r": 2},
                                                   tenant="batch"))

    jax, port = both(run)
    assert port == jax == (("refused", 429, "brownout"), ("ok", "queued"))


def test_level3_tightens_queue_limit(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        q = _queue(pkg, root, limit=4)
        _publish_state(root, level=3)
        return [_refusal(lambda i=i: q.submit({"r": i}, tenant="gold"))[:3]
                for i in range(3)]

    jax, port = both(run)
    assert port == jax
    assert port[2] == ("refused", 429, "queue_full")


def test_brownout_retry_after_uses_class_horizon(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        q = _queue(pkg, root, limit=32)
        q._avg_mic_s = 3.0
        q.submit({"r": 1}, micrographs=6, tenant="std")
        _publish_state(root, level=1, interval_s=2.0,
                       cooldown_remaining_s=4.0)
        return _refusal(lambda: q.submit({"r": 2}, micrographs=100,
                                         tenant="batch"))

    jax, port = both(run)
    assert port == jax == ("refused", 429, "brownout", 24)


def test_brownout_retry_after_excludes_shed_backlog(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg)
        q = _queue(pkg, root, limit=32, clock=Clock())
        q._avg_mic_s = 3.0
        q.submit({"r": 1}, micrographs=50, tenant="batch")
        q.submit({"r": 2}, micrographs=2, tenant="std")
        _publish_state(root, level=1, interval_s=2.0,
                       cooldown_remaining_s=0.0)
        return _refusal(lambda: q.submit({"r": 3}, tenant="batch"))

    jax, port = both(run)
    assert port == jax == ("refused", 429, "brownout", 8)


# -- EDF dealing in the batcher ---------------------------------------


def _edf_batcher(pkg, burn):
    cls = mods(pkg).batcher.ContinuousBatcher

    class FakeSLO:
        def budget_burn(self, endpoint):
            return burn

    class FakeDaemon:
        slo = FakeSLO()

    b = cls.__new__(cls)
    b.daemon = FakeDaemon()
    b._open = []
    b._last_key = None
    b._last_capacity = None
    b._streak = 0
    b._rr = -1
    b._dealing = "round_robin"
    return b


class FakeJob:
    def __init__(self, ts, deadline, tenant=None):
        self.accepted_ts = ts
        self.deadline_ts = deadline
        self.tenant = tenant


def _open(pkg):
    key = mods(pkg).batcher.CoalesceKey(
        bucket_key=(3, 64, 0.3, "greedy"), box_sizes=(180.0,),
        max_neighbors=16, use_mesh=False, spatial=None,
        use_pallas=False, n_dev=1,
    )

    class FakeOpen:
        num_pickers = 3

        def __init__(self, name, deadline, ts, pending=6, tenant=None):
            self.name = name
            self.job = FakeJob(ts, deadline, tenant)
            self.key = key
            self.pending = [(f"{name}-{i:03d}", None)
                            for i in range(pending)]

    return FakeOpen


def _deal(b):
    parts = b._select()
    return b._dealing, [(oj.name, len(items)) for oj, items in parts]


def test_edf_orders_by_deadline_under_burn():
    def run(pkg):
        FakeOpen = _open(pkg)
        b = _edf_batcher(pkg, burn=5.0)
        b._open = [FakeOpen("relaxed", 900.0, 1.0),
                   FakeOpen("urgent", 10.0, 3.0),
                   FakeOpen("open", None, 2.0)]
        return _deal(b)

    jax, port = both(run)
    assert port == jax
    mode, parts = port
    assert mode == "edf"
    assert parts[0][0] == "urgent" and parts[-1][0] == "open"
    dealt = dict(parts)
    assert dealt["urgent"] >= max(dealt["relaxed"], dealt["open"])


def test_round_robin_restored_when_calm():
    def run(pkg):
        FakeOpen = _open(pkg)
        b = _edf_batcher(pkg, burn=0.0)
        b._open = [FakeOpen("a", 10.0, 1.0), FakeOpen("b", 900.0, 2.0)]
        return _deal(b), b._rr

    jax, port = both(run)
    assert port == jax
    assert port[0][0] == "round_robin" and port[1] == 0


def test_edf_respects_tenant_fairness():
    def run(pkg):
        FakeOpen = _open(pkg)
        b = _edf_batcher(pkg, burn=5.0)
        b._open = [FakeOpen(f"noisy{i}", float(i + 1), float(i),
                            pending=20, tenant="noisy") for i in range(3)]
        b._open.append(FakeOpen("quiet", None, 9.0, pending=2,
                                tenant="quiet"))
        return _deal(b)

    jax, port = both(run)
    assert port == jax
    assert dict(port[1]).get("quiet", 0) >= 1


def test_edf_triggers_on_brownout_without_burn(tmp_path):
    def run(pkg):
        jobs = mods(pkg).jobs
        root = str(tmp_path / pkg)
        b = _edf_batcher(pkg, burn=None)
        before = b._edf_active()
        b.queue = jobs.JobQueue(8, jobs.ServeJournal(root))
        os.makedirs(root, exist_ok=True)
        _publish_state(root, level=1)
        return before, b._edf_active()

    jax, port = both(run)
    assert port == jax == (False, True)
