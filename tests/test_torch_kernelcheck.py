"""The port's KERNELCHECK (``repic_tpu_torch.analysis.kernelcheck``) and
its ``@checked`` registry, held to the JAX package's.

The three KERNELCHECK cases of ``tests/test_analysis_spmd.py`` (that
file's other cases are the static layer, ROADMAP Queue 1 item 9b) as
they read against the port: the real registry probes clean, a broken
kernel is caught, the environment variable gates the armed probe.  On
the CPU each kernel wrapper runs its plain version, so the probe holds
two independent torch implementations against each other (the card
run holds the CUDA kernels: ``tests/test_torch_cuda.py``).  A probe
that raises is recorded as a violation, never a pass.

The registry twin: the port's ``registry()`` has the reference's 12
canonical names (modulo the package) with equal ``dims``,
``dispatch_budget`` and kernel ladders, and equal ``static`` but for
the Pallas knobs (``interpret``, ``tile_m``, ``tile_n``, ``tile_a``:
TPU tile sizes and the interpret switch, which a CUDA kernel has no
counterpart for).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

ENTRY_MODULES = ("ops.iou", "ops.solver", "ops.megakernel",
                 "ops.iou_pallas", "pipeline.consensus", "pipeline.engine",
                 "solver.dual", "models.infer", "models.train")
PALLAS_ONLY = {"interpret", "tile_m", "tile_n", "tile_a"}
KERNEL_ENTRIES = (
    "ops.iou_pallas.pallas_topk_neighbors",
    "ops.megakernel.fused_clique_candidates",
    "ops.megakernel.fused_dual_solve",
)


def test_kernelcheck_clean_on_the_real_registry():
    from repic_tpu_torch.analysis import kernelcheck

    with kernelcheck.scoped():
        kernelcheck.reset()
        probed = kernelcheck.run_registered(device="cpu")
        assert probed == 3
        assert kernelcheck.violations() == []
        assert "no violations" in kernelcheck.report_text()


def test_kernelcheck_catches_a_broken_kernel():
    import repic_tpu_torch.ops.iou_pallas  # noqa: F401 - registers
    from repic_tpu_torch.analysis import contracts, kernelcheck
    from repic_tpu_torch.analysis.kernels import differential_probe

    entry = contracts.registry()[
        "repic_tpu_torch.ops.iou_pallas.pallas_topk_neighbors"
    ]
    kc = entry.contract.kernel

    def bad_run(*args, **kw):
        v, i, c = kc.reference(*args, **kw)
        return v + 0.25, i, c + 1

    broken = dataclasses.replace(kc, run=bad_run)
    msgs = differential_probe(entry, broken)
    assert msgs, "a diverging kernel must produce messages"
    with kernelcheck.scoped():
        kernelcheck.reset()
        kernelcheck._record(
            "kernel-divergence", entry.canonical, msgs[0]
        )
        assert kernelcheck.violations()
        assert "kernel-divergence" in kernelcheck.report_text()


def test_kernelcheck_env_var_gates_install(monkeypatch):
    from repic_tpu_torch.analysis import kernelcheck

    with kernelcheck.scoped():
        kernelcheck.uninstall()
        monkeypatch.setenv(kernelcheck.ENV_VAR, "")
        assert kernelcheck.maybe_install_from_env() is False
        assert not kernelcheck.installed()
        monkeypatch.setenv(kernelcheck.ENV_VAR, "1")
        assert kernelcheck.maybe_install_from_env() is True
        assert kernelcheck.installed()
        assert kernelcheck.violations() == [], (
            "the env-armed probe must pass clean on the real tree"
        )


def test_kernelcheck_records_a_probe_error_and_a_planted_divergence():
    """A kernel that raises (fails to build or launch) is a violation,
    not a pass; so is one valid slot perturbed in a kernel's output."""
    from repic_tpu_torch.analysis import contracts, kernelcheck
    from repic_tpu_torch.ops import megakernel

    entry = contracts.registry()[
        "repic_tpu_torch.ops.megakernel.fused_dual_solve"]
    kc = entry.contract.kernel

    def perturbed(*args):
        picked = kc.run(*args).clone()
        picked[0] = ~picked[0]
        return picked

    def failing(*args):
        raise RuntimeError("kernel library failed to load")

    assert megakernel.fused_dual_solve is entry.fn
    with kernelcheck.scoped():
        kernelcheck.reset()
        for run in (perturbed, failing):
            contract = entry.contract
            entry.contract = dataclasses.replace(
                contract, kernel=dataclasses.replace(kc, run=run))
            try:
                kernelcheck.run_registered(
                    ("repic_tpu_torch.ops.megakernel",), device="cpu")
            finally:
                entry.contract = contract
        kinds = {v["kind"] for v in kernelcheck.violations()
                 if v["entry"] == entry.canonical}
        assert kinds == {"kernel-divergence", "kernel-probe-error"}
    assert kernelcheck.violations() == []


@pytest.mark.parametrize("canonical", KERNEL_ENTRIES)
def test_kernel_probe_inputs_equal_the_reference(canonical):
    """Each ladder rung's probe inputs are the reference's values."""
    ref, port = _registries()
    jk, tk = ref[canonical].contract.kernel, port[canonical].contract.kernel
    for rung in jk.ladder:
        (ja, jkw), (ta, tkw) = jk.make_inputs(rung), tk.make_inputs(rung)
        assert jkw == tkw == {}
        assert len(ja) == len(ta)
        for a, b in zip(ja, ta):
            b = b.numpy() if isinstance(b, torch.Tensor) else b
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _registries():
    for m in ENTRY_MODULES:
        importlib.import_module(f"repic_tpu.{m}")
        importlib.import_module(f"repic_tpu_torch.{m}")
    from repic_tpu.analysis.contracts import registry as jax_registry
    from repic_tpu_torch.analysis.contracts import registry

    # the package's own entries: the JAX package's analysis tests
    # register scratch modules' entries in the same process
    ref = {k[len("repic_tpu."):]: v for k, v in jax_registry().items()
           if k.startswith("repic_tpu.")}
    port = {k[len("repic_tpu_torch."):]: v for k, v in registry().items()
            if k.startswith("repic_tpu_torch.")}
    return ref, port


def test_registry_matches_the_reference():
    ref, port = _registries()
    assert len(ref) == 12
    assert sorted(port) == sorted(ref)
    for name in ref:
        j, t = ref[name].contract, port[name].contract
        assert t.dims == j.dims, name
        assert t.static == {k: v for k, v in j.static.items()
                            if k not in PALLAS_ONLY}, name
        assert t.dispatch_budget == j.dispatch_budget, name
        assert (j.kernel is None) == (t.kernel is None), name
        if j.kernel is not None:
            assert t.kernel.ladder == j.kernel.ladder, name
            assert t.kernel.tol == j.kernel.tol, name
    assert {n for n in ref if ref[n].contract.kernel} == set(KERNEL_ENTRIES)


def test_kernelcheck_without_a_card_is_a_violation(monkeypatch):
    """Asked for the card where there is none, KERNELCHECK records a
    violation naming the device: the plain versions are never held
    against each other in the kernels' place."""
    from repic_tpu_torch.analysis import kernelcheck

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with kernelcheck.scoped():
        kernelcheck.reset()
        assert kernelcheck.run_registered(device="cuda") == 0
        (v,) = kernelcheck.violations()
        assert v["kind"] == "kernel-no-device" and v["entry"] == "cuda"
        assert "0 kernel(s) probed on cuda" in kernelcheck.report_text()
        kernelcheck.reset()
        assert kernelcheck.run_registered(device="cpu") == 3
        assert kernelcheck.report_text() == (
            "KERNELCHECK: no violations (3 kernel(s) probed on cpu)")


def test_cli_kernelcheck_defaults_to_the_card(monkeypatch):
    """A command without ``--device`` probes the card, so a machine
    without one reports a violation and the run exits 1."""
    import argparse

    from repic_tpu_torch import main
    from repic_tpu_torch.analysis import kernelcheck

    monkeypatch.setenv(kernelcheck.ENV_VAR, "1")
    monkeypatch.delenv("REPIC_TPU_LOCKCHECK", raising=False)
    monkeypatch.delenv("REPIC_TPU_DISPATCHCHECK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with kernelcheck.scoped():
        kernelcheck.reset()
        armed = main._arm_sanitizers(argparse.Namespace())
        assert armed == [kernelcheck]
        assert [v["kind"] for v in kernelcheck.violations()] == [
            "kernel-no-device"]
        kernelcheck.reset()
        main._arm_sanitizers(argparse.Namespace(device="cpu"))
        assert kernelcheck.violations() == []
