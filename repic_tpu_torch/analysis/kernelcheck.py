"""KERNELCHECK: the kernel differential sanitizer (the port of
``repic_tpu.analysis.kernelcheck``).

Opt in with ``REPIC_TPU_KERNELCHECK=1`` (or :func:`install` and
:func:`run_registered` in a program) and every ``@checked`` entry
whose :class:`~repic_tpu_torch.analysis.contracts.Contract` declares a
``kernel=`` :class:`~repic_tpu_torch.analysis.kernels.KernelContract`
runs once against its unfused path, on the contract's own probe
inputs, across its whole shape ladder, on the device the caller names.
On the card that holds the CUDA kernels themselves against the unfused
path; on the CPU the wrappers run their plain versions, so it holds
two independent torch implementations against each other.  Divergence
beyond the contract's tolerance is a violation, and so is a probe that
raises (a kernel that does not build or launch): a probe error is
never a pass.

Recording never raises into the instrumented path: violations
accumulate in a module-level list and the caller's gate -- a test, or
``chip_smoke.py`` -- decides.  Under pytest the JAX package's
``tests/conftest.py`` arms the reference's sanitizer from the
environment variable; the port's tests arm this one through
:func:`scoped`.

Usage::

    from repic_tpu_torch.analysis import kernelcheck
    kernelcheck.install()
    kernelcheck.run_registered(device="cuda")
    assert not kernelcheck.violations(), kernelcheck.report_text()
"""

from __future__ import annotations

import contextlib
import importlib
import os

#: opt-in switch, mirroring REPIC_TPU_LOCKCHECK (the reference's name)
ENV_VAR = "REPIC_TPU_KERNELCHECK"

#: modules imported at install time so their ``@checked`` kernel
#: entries self-register before the registry sweep
DEFAULT_MODULES = (
    "repic_tpu_torch.ops.iou_pallas",
    "repic_tpu_torch.ops.megakernel",
)

_installed = False
_violations: list[dict] = []
#: ``(kernels probed, device)`` of the last :func:`run_registered`
_last_run = None


def enabled() -> bool:
    return os.environ.get(ENV_VAR, "") == "1"


def install() -> bool:
    """Arm the sanitizer.  Idempotent; returns True when active.

    Installation only flips the flag — probing happens in
    :func:`run_registered` so tests can arm without paying the probe
    twice (``maybe_install_from_env`` does both)."""
    global _installed
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    _installed = False


def installed() -> bool:
    return _installed


def maybe_install_from_env(device="cpu") -> bool:
    """Install + probe on ``device`` iff ``REPIC_TPU_KERNELCHECK=1``."""
    if enabled():
        install()
        run_registered(device=device)
        return True
    return False


def _record(kind: str, entry: str, detail: str) -> None:
    _violations.append(
        {"kind": kind, "entry": entry, "detail": detail}
    )


def run_registered(modules=DEFAULT_MODULES, *, device="cpu") -> int:
    """Probe every registered kernel entry on ``device``; returns the
    number of entries probed.

    Never raises: import failures and probe errors become violations
    (a sanitizer that crashes the session it guards is worse than the
    bug it hunts).  A card asked for where there is none is a
    violation: the kernels were not checked."""
    global _last_run
    import torch

    from repic_tpu_torch.analysis import contracts
    from repic_tpu_torch.analysis.kernels import differential_probe

    if torch.device(device).type == "cuda" and \
            not torch.cuda.is_available():
        _record("kernel-no-device", str(device),
                "no CUDA card: the kernels were not checked (pass "
                "device='cpu' to hold their plain versions instead)")
        _last_run = (0, str(device))
        return 0

    for m in modules:
        try:
            importlib.import_module(m)
        except Exception as e:
            _record(
                "kernel-import-error", m,
                f"{type(e).__name__}: {e}",
            )
    probed = 0
    for canonical, entry in sorted(contracts.registry().items()):
        kc = getattr(entry.contract, "kernel", None)
        if kc is None:
            continue
        probed += 1
        for dims in kc.ladder:
            try:
                msgs = differential_probe(entry, kc, dims=dims,
                                          device=device)
            except Exception as e:
                _record(
                    "kernel-probe-error", canonical,
                    f"dims {dims}: {type(e).__name__}: {e}",
                )
                continue
            for msg in msgs:
                _record(
                    "kernel-divergence", canonical,
                    f"dims {dims}: {msg}",
                )
    _last_run = (probed, str(device))
    return probed


def violations() -> list[dict]:
    return list(_violations)


def reset() -> None:
    """Clear recorded violations (test isolation)."""
    _violations.clear()


@contextlib.contextmanager
def scoped():
    """Isolate violations + installed flag (tests, and a program's
    own planted divergences).  Snapshots on entry, restores on
    exit."""
    global _installed, _last_run
    snap = list(_violations)
    was, last = _installed, _last_run
    try:
        yield
    finally:
        _violations[:] = snap
        _installed, _last_run = was, last


def report_text() -> str:
    """Human-readable violation report, naming the device of the last
    probe."""
    out = [f"KERNELCHECK {v['kind']} [{v['entry']}]: {v['detail']}"
           for v in violations()]
    if not out:
        out.append("KERNELCHECK: no violations")
    if _last_run is not None:
        out[-1] += f" ({_last_run[0]} kernel(s) probed on {_last_run[1]})"
    return "\n".join(out)
