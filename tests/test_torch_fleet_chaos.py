"""The port's serving fleet over real processes: SIGKILL a replica
mid-job, crash one by fault, quarantine a poison job, drain the fleet.

The four cases of ``tests/test_fleet_chaos.py`` run against
``repic_tpu_torch`` (:mod:`torch_twin`): the replicas are
``python -m repic_tpu_torch.main serve --fleet-dir ... --device cpu``
processes.  The warm-restart case checks the shared compile cache's
path where the reference counts persistent XLA cache hits (the port's
count is of kernel libraries, none on the CPU).  The reference's
assertions are end states -- the job's id,
state and single terminal record, one completion token, the journaled
reassignment and fence, exit codes, zero orphaned leases, bytes equal
to a control run -- with a deadline on every wait.  Beyond them, every
finished job on ``examples/10017`` must hold the JAX package's BOX
files of that input (``tests/golden/torch_port_10017/lp_device``).
"""

import glob
import os

import pytest

from torch_twin import REPO, case_names, load_twin, run_case

SUBS = (
    ('"--port", "0",', '"--port", "0", "--device", "cpu",'),
    # the port's persistent hits count kernel-library loads from disk,
    # and a CPU replica loads none; the warm start it asserts is the
    # replay of the dead replica's programs from the shared fleet
    # cache, which programs_warmed >= 1 (kept) shows with this path
    ('assert warmups[-1]["persistent_cache_hits"] >= 1, (',
     'assert warmups[-1]["compile_cache"] == os.path.join('
     'fleet, "_compile_cache"), ('),
)
GOLDEN = os.path.join(REPO, "tests", "golden", "torch_port_10017",
                      "lp_device")


@pytest.mark.parametrize("name", case_names("test_fleet_chaos.py"))
def test_fleet_chaos_case_matches_reference(name, tmp_path):
    mod = load_twin("test_fleet_chaos.py", "port", SUBS)
    run_case(mod, name, str(tmp_path))
    golden = sorted(os.listdir(GOLDEN))
    compared = 0
    for job_dir in glob.glob(str(tmp_path / "fleet" / "jobs" / "*")):
        boxes = sorted(f for f in os.listdir(job_dir) if f.endswith(".box"))
        if boxes != golden:
            continue  # another input (the mini fixture, the poison dir)
        for f in boxes:
            with open(os.path.join(GOLDEN, f), "rb") as a, \
                    open(os.path.join(job_dir, f), "rb") as b:
                assert a.read() == b.read(), (job_dir, f)
        compared += 1
    if name == "test_sigkill_mid_job_finishes_on_survivor_identically":
        assert compared >= 2  # the failed-over job and its control
