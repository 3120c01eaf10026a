"""The port's fleet autoscale supervisor
(``repic_tpu_torch.serve.autoscale.Supervisor``) and its fault sites,
held to the JAX package.

The ``test_supervisor_*`` and fault cases of ``tests/test_autoscale.py``
run twice from the same process state (:mod:`torch_twin`): as written
against ``repic_tpu`` and against ``repic_tpu_torch``.  Both meet the
reference's assertions, and the fleet directories they leave -- file
set and the decision journal ``_autoscale.jsonl``, clocks dropped --
are equal.  The supervisor's default ``spawn`` command is checked
separately: ``python -m repic_tpu_torch serve --fleet-dir``.
"""

import pytest

from torch_twin import case_names, run_twins

FAULT_CASES = ("test_scale_stall_fault_wedges_one_tick",
               "test_storm_fault_substitutes_saturated_signals",
               "test_fault_site_coverage_gate")
CASES = [p for p in case_names("test_autoscale.py")
         if p.values[0].startswith("test_supervisor_")
         or p.values[0] in FAULT_CASES]


@pytest.mark.parametrize("name", CASES)
def test_supervisor_case_matches_reference(name, tmp_path, capsys):
    run_twins("test_autoscale.py", name, tmp_path, (), capsys)


def test_default_spawn_starts_a_port_replica(tmp_path, monkeypatch):
    """The default ``spawn`` runs this package's ``serve`` as a fleet
    replica with the supervisor's timeout and ``serve_args``, in the
    replica's own work directory."""
    import subprocess

    from repic_tpu_torch.serve import autoscale

    seen = {}

    class Proc:
        def poll(self):
            return None

    def popen(cmd, env=None):
        seen["cmd"] = cmd
        return Proc()

    monkeypatch.setattr(subprocess, "Popen", popen)
    sup = autoscale.Supervisor(str(tmp_path / "fleet"),
                               replica_timeout_s=3.0,
                               serve_args=("--device", "cpu"), env={})
    try:
        sup._spawn_proc("auto0", str(tmp_path / "wd"))
    finally:
        sup.shutdown()
    cmd = seen["cmd"]
    assert cmd[1:4] == ["-m", "repic_tpu_torch", "serve"]
    assert cmd[4] == str(tmp_path / "wd")
    i = cmd.index("--fleet-dir")
    assert cmd[i + 1] == str(tmp_path / "fleet")
    assert cmd[cmd.index("--replica-id") + 1] == "auto0"
    assert cmd[cmd.index("--replica-timeout") + 1] == "3.0"
    assert cmd[-2:] == ["--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["--brownout-burn", "2,x"],
    ["--brownout-burn", "6,2,14"],
    ["--min-replicas", "0"],
    ["--min-replicas", "3", "--max-replicas", "2"],
], ids=["burn_not_numbers", "burn_decreasing", "min_zero", "max_below_min"])
def test_fleet_supervise_checks_equal_reference(tmp_path, argv):
    """``fleet supervise`` refuses what the reference refuses, with its
    message, before spawning anything."""
    import argparse

    from repic_tpu.commands import fleet as jfleet
    from repic_tpu_torch.commands import fleet as tfleet

    msgs = []
    for pkg, mod in (("jax", jfleet), ("port", tfleet)):
        p = argparse.ArgumentParser()
        mod.add_arguments(p)
        args = p.parse_args(["supervise", str(tmp_path / pkg), *argv])
        with pytest.raises(SystemExit) as e:
            mod.main(args)
        msgs.append(str(e.value).replace(str(tmp_path / pkg), "<dir>"))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith("repic-tpu fleet: ")
