"""The port's LOCKCHECK (``repic_tpu_torch.analysis.lockcheck``), held
to the JAX package's.

The 16 cases of ``tests/test_lockcheck.py`` run twice (:mod:`torch_twin`):
as written against ``repic_tpu.analysis.lockcheck``, and against the
port's.  Each side's module carries a name its own sanitizer scopes to
-- the reference wraps locks allocated by ``repic_tpu*`` and ``test*``
frames, the port those of ``repic_tpu_torch`` and its tests -- so each
case's "a lock allocated HERE is checked" holds for both.  Beyond the
twins: the two sanitizers armed in one process each wrap only their
own frames (never ``torch``'s), and the port's ``scoped()`` puts
``threading.Lock`` / ``RLock`` back exactly as it found them.
"""

import threading

import pytest

from torch_twin import case_names, load_twin, run_case

#: module names each package's sanitizer scopes to
NAMES = {"jax": "test_lockcheck_jax_twin", "port": None}


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("name", case_names("test_lockcheck.py"))
def test_lockcheck_case_matches_reference(name, pkg, tmp_path):
    mod = load_twin("test_lockcheck.py", pkg, name=NAMES[pkg])
    before = (threading.Lock, threading.RLock)
    run_case(mod, name, str(tmp_path))
    assert (threading.Lock, threading.RLock) == before


def test_case_count():
    assert len(case_names("test_lockcheck.py")) == 16


def test_both_sanitizers_wrap_only_their_own_frames():
    import torch  # noqa: F401 - a torch frame allocates below

    from repic_tpu.analysis import lockcheck as ref
    from repic_tpu_torch.analysis import lockcheck as port

    found = (threading.Lock, threading.RLock)
    with ref.scoped(), port.scoped():
        ref_was = ref.installed()
        ref.install()
        port.install()
        try:
            made = {}
            for mod in ("repic_tpu.serve.daemon", "repic_tpu_torch.serve.daemon",
                        "torch.utils.data", "test_torch_lockcheck",
                        "threading"):
                ns = {"__name__": mod, "threading": threading}
                exec("lock = threading.Lock()", ns)
                made[mod] = ns["lock"]
            assert isinstance(made["repic_tpu_torch.serve.daemon"],
                              port.CheckedLock)
            assert isinstance(made["test_torch_lockcheck"],
                              port.CheckedLock)
            for mod in ("repic_tpu.serve.daemon", "torch.utils.data",
                        "threading"):
                assert not isinstance(made[mod], port.CheckedLock), mod
        finally:
            port.uninstall()
            # the port's uninstall restores the reference's factories
            assert threading.Lock is ref._lock_factory
            if not ref_was:
                ref.uninstall()
    assert (threading.Lock, threading.RLock) == found


def test_scoped_restores_the_factories_it_found():
    from repic_tpu_torch.analysis import lockcheck as port

    found = (threading.Lock, threading.RLock)
    with port.scoped():
        port.install()
        assert threading.Lock is port._lock_factory
    assert (threading.Lock, threading.RLock) == found
    assert not port.installed() or found[0] is port._lock_factory


def test_sites_lists_every_checked_lock():
    from repic_tpu_torch.analysis import lockcheck as port

    with port.scoped():
        port.reset()
        a = port.checked_lock("test_torch_lockcheck:1")
        port.checked_lock("test_torch_lockcheck:2", kind="rlock")
        with a:
            pass
        assert port.sites() == {"test_torch_lockcheck:1",
                                "test_torch_lockcheck:2"}
        assert port.report_text().splitlines() == [
            "LOCKCHECK: no violations",
            "LOCKCHECK checked lock sites (2): test_torch_lockcheck:1, "
            "test_torch_lockcheck:2",
        ]
    assert "test_torch_lockcheck:1" not in port.sites()
