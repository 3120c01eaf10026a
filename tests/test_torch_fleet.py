"""The port's serving fleet (``repic_tpu_torch.serve.fleet`` and the
fleet half of its daemon), held to the JAX package.

Every case of ``tests/test_fleet.py`` runs twice from the same process
state (:mod:`torch_twin`): as written against ``repic_tpu``, and
against ``repic_tpu_torch`` with its daemons on ``device="cpu"``.  The
reference's assertions hold for both; the fleet directories the two
runs leave -- file set, request and run journals, job ids in order of
appearance, clocks dropped -- are equal, except for the two cases
whose replicas run HTTP threads (which replica answers, and when,
follows the threads' timing; their assertions are end states).
"""

import pytest

from torch_twin import case_names, run_twins

SUBS = (("warmup=False,", 'warmup=False, device="cpu",'),)
#: cases whose directories depend on thread timing
THREADED = ("test_fleet_daemon_end_to_end",
            "test_fleet_two_daemons_share_one_queue",
            "test_concurrent_same_key_submits_yield_one_job")


@pytest.mark.parametrize("name", case_names("test_fleet.py"))
def test_fleet_case_matches_reference(name, tmp_path, capsys):
    run_twins("test_fleet.py", name, tmp_path, SUBS, capsys,
              compare=name not in THREADED)
