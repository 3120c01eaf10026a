"""The port's cluster mode over real processes, held to the JAX
package.

The two cases of ``tests/test_cluster_multihost.py`` run against
``repic_tpu_torch`` (:mod:`torch_twin`; the hosts are
``tests/torch_cluster_worker.py`` processes on the CPU): three hosts
with one crash and a resume generation, and two hosts with an in-run
takeover.  Beyond the reference's assertions (nothing lost, nothing
quarantined, provenance, fences, the report's cluster section, the
per-host telemetry), every BOX file the cluster wrote must equal, byte
for byte, the JAX package's single-host run of the same input.
"""

import glob
import os

import pytest

from torch_runtime_common import run_jax_dir
from torch_twin import case_names, load_twin, run_case

pytestmark = pytest.mark.faults

SUBS = (('os.path.join(REPO, "tests", "cluster_worker.py")',
         'os.path.join(REPO, "tests", "torch_cluster_worker.py")'),)


@pytest.mark.parametrize("name", case_names("test_cluster_multihost.py"))
def test_multihost_case_ends_in_jax_single_host_bytes(name, tmp_path):
    mod = load_twin("test_cluster_multihost.py", "port", SUBS)
    run_case(mod, name, str(tmp_path))
    out, in_dir = tmp_path / "out", tmp_path / "in"
    ref = str(tmp_path / "jax_single")
    run_jax_dir(str(in_dir), ref, mod.BOX)
    boxes = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ref, "*.box")))
    assert boxes and boxes == sorted(
        os.path.basename(p) for p in glob.glob(str(out / "*.box")))
    for f in boxes:
        with open(os.path.join(ref, f), "rb") as a, \
                open(str(out / f), "rb") as b:
            assert a.read() == b.read(), f
