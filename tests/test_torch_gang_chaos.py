"""The port's gang over real processes: a peer killed mid-collective.

The case of ``tests/test_gang_chaos.py`` runs against
``repic_tpu_torch`` (:mod:`torch_twin`): three
``tests/torch_gang_worker.py`` processes form a gloo group on the CPU
from torchrun's variables and run one gang-scheduled directory run;
the victim dies through ``gang_peer_crash`` (exit 27) as its second
chunk's collective starts; the survivors classify the fault, fence the
victim, re-form a two-host gang and finish.  The reference skips its
own run here for want of a multi-process JAX backend; gloo needs none.
The uninterrupted control run stays the JAX package's single-host run,
so every BOX file is held, byte for byte, to JAX's, with zero lost and
zero duplicated micrographs.  The assertions are end states, not
timings or the number of re-formations.
"""

import pytest

from torch_twin import case_names, load_twin, run_case

pytestmark = pytest.mark.faults

SUBS = (
    ('"gang_worker.py"', '"torch_gang_worker.py"'),
    ('JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",',
     'MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),'),
    ("JAX_NUM_PROCESSES=str(WORLD)", "WORLD_SIZE=str(WORLD)"),
    ("JAX_PROCESS_ID=str(rank)", "RANK=str(rank)"),
    # the control run stays the JAX package's
    ('"import sys; from repic_tpu_torch.pipeline.consensus import "',
     '"import sys; from repic_tpu.pipeline.consensus import "'),
)


@pytest.mark.parametrize("name", case_names("test_gang_chaos.py"))
def test_gang_chaos_case_ends_in_jax_single_host_bytes(name, tmp_path):
    mod = load_twin("test_gang_chaos.py", "port", SUBS)
    run_case(mod, name, str(tmp_path))
