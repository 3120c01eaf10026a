"""The port's DISPATCHCHECK (``repic_tpu_torch.analysis.dispatchcheck``)
and its wiring into the chunk path, held to the JAX package's.

The 13 cases of ``tests/test_dispatchcheck.py`` run twice
(:mod:`torch_twin`): as written, and against ``repic_tpu_torch`` with
the batch on ``device="cpu"`` (the port's ``run_consensus_batch``
always fetches the packed outputs, so the reference's
``packed_probe=True`` is its only mode).  The budgets come from the
port's ``@checked`` registry (staged ``consensus_one`` 5, fused
``fused_clique_candidates`` 3); a chunk's window on the CPU is its one
fetch (the wrappers launch nothing there).
"""

import pytest

from torch_twin import case_names, run_twins

SUBS = (
    ("180.0, use_mesh=False", '180.0, device="cpu"'),
    (" packed_probe=True,", ""),
    ("str(out), 64, use_mesh=False,", 'str(out), 64, use_mesh=False, device="cpu",'),
)


@pytest.mark.parametrize("name", case_names("test_dispatchcheck.py"))
def test_dispatchcheck_case_matches_reference(name, tmp_path):
    run_twins("test_dispatchcheck.py", name, tmp_path, SUBS)


def test_case_count():
    assert len(case_names("test_dispatchcheck.py")) == 13


def test_env_vars_arm_the_port_sanitizers_in_a_cli_run(tmp_path):
    """In a CLI run the three variables arm the port's sanitizers: the
    reports on stderr, a clean run exits 0."""
    import os
    import subprocess
    import sys

    from torch_twin import REPO

    env = dict(os.environ, REPIC_TPU_KERNELCHECK="1",
               REPIC_TPU_DISPATCHCHECK="1", REPIC_TPU_LOCKCHECK="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "consensus",
         os.path.join(REPO, "tests", "fixtures", "mini10017"),
         str(tmp_path / "out"), "180", "--device", "cpu",
         "--solver", "lp_device_fused"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "KERNELCHECK: no violations" in proc.stderr
    assert "DISPATCHCHECK: no violations (1 chunk window(s)" in proc.stderr
    assert "LOCKCHECK: no violations" in proc.stderr
    # armed before the package's imports: its module-level locks too
    (line,) = [ln for ln in proc.stderr.splitlines()
               if ln.startswith("LOCKCHECK checked lock sites")]
    for mod, name in (("telemetry.server", "_STATUS_LOCK"),
                      ("runtime.faults", "_LOCK"), ("_build", "_LOCK")):
        path = os.path.join(REPO, "repic_tpu_torch",
                            *mod.split(".")) + ".py"
        with open(path) as f:
            (lineno,) = [i for i, ln in enumerate(f, 1)
                         if ln.startswith(f"{name} = threading.Lock()")]
        assert f"repic_tpu_torch.{mod}:{lineno}" in line, (mod, line)
