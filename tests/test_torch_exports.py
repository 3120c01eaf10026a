"""The port's subpackages export the reference's names, and its
journal carries the reference's ``chunk_dispatches`` events.

Each subpackage's ``__all__`` equals the JAX package's, in order, and
every name resolves.  The reference's two JAX-only entry points have
thin equivalents here (there is no deliberate gap left:
:data:`GAPS` is empty and this test reads it): ``make_batched_consensus``
binds a static configuration to ``consensus_over_mesh`` (nothing is
compiled), and ``solve_lp_device_host`` solves host arrays as a batch
of one -- both held to the reference below.  ``runtime`` imports only
the stdlib, as the reference's does.
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("runtime", "solver", "parallel", "ops", "pipeline", "models")
#: reference names the port leaves out on purpose, with the reason
GAPS: dict = {}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_equals_reference(sub):
    ref = importlib.import_module(f"repic_tpu.{sub}")
    port = importlib.import_module(f"repic_tpu_torch.{sub}")
    want = [n for n in ref.__all__ if n not in GAPS]
    assert list(port.__all__) == want
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_runtime_imports_only_the_stdlib():
    code = ("import sys\nimport repic_tpu_torch.runtime as r\n"
            "assert r.ClusterConfig and r.ClusterContext\n"
            "bad = [m for m in ('torch', 'numpy') if m in sys.modules]\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_solve_lp_device_host_equals_reference():
    from repic_tpu.solver import solve_lp_device_host as jsolve
    from repic_tpu_torch.solver import solve_lp_device_host

    rng = np.random.default_rng(3)
    for c, k, v in ((40, 3, 30), (120, 4, 60), (7, 2, 9)):
        mv = rng.integers(0, v, size=(c, k)).astype(np.int32)
        w = rng.uniform(0.1, 1.0, size=c).astype(np.float32)
        got = solve_lp_device_host(mv, w, v, device="cpu")
        want = jsolve(mv, w, v)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_make_batched_consensus_equals_reference():
    """The port's ``make_batched_consensus`` and the reference's jitted
    program give the same cliques and picks on one batch."""
    import jax.numpy as jnp

    from repic_tpu.pipeline import make_batched_consensus as jmake
    from repic_tpu_torch.pipeline import make_batched_consensus

    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 1500, size=(2, 3, 48, 2)).astype(np.float32)
    conf = rng.uniform(0.1, 1, size=(2, 3, 48)).astype(np.float32)
    mask = np.ones((2, 3, 48), bool)
    mask[1, :, 40:] = False
    kw = dict(max_neighbors=8, clique_capacity=1024, solver="greedy")
    got = make_batched_consensus(**kw)(
        torch.from_numpy(xy), torch.from_numpy(conf),
        torch.from_numpy(mask), 180.0)
    want = jmake(**kw)(jnp.asarray(xy), jnp.asarray(conf),
                       jnp.asarray(mask), 180.0)
    for f in ("picked", "valid", "member_idx", "num_cliques"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))


def test_chunk_dispatches_journaled_like_reference(tmp_path, monkeypatch):
    """Every accepted chunk journals ``chunk_dispatches`` (``entry``,
    ``dispatches``, ``micrographs``, ``solver``), in the reference's
    order and fields (``utils/synthetic.py: dispatch_view``), on 10017
    in chunks of 5, fused and staged.  The count is the port's own:
    kernel launches plus fetches -- on the CPU no launch, so one packed
    fetch per accepted chunk."""
    from torch_runtime_common import run_jax_dir, run_port_dir

    from repic_tpu_torch.runtime.journal import read_journal
    from repic_tpu_torch.utils.synthetic import journal_view

    monkeypatch.setenv("REPIC_CONSENSUS_CHUNK", "5")
    examples = os.path.join(REPO, "examples", "10017")
    for solver in ("lp_device_fused", "lp_device"):
        p_out, j_out = str(tmp_path / f"p_{solver}"), str(
            tmp_path / f"j_{solver}")
        run_port_dir(examples, p_out, 180, solver=solver)
        run_jax_dir(examples, j_out, 180, solver=solver)
        got = journal_view(p_out)["dispatches"]
        assert got == journal_view(j_out)["dispatches"]
        assert [d["micrographs"] for d in got] == [5, 5, 2]
        events = [e for e in read_journal(p_out)
                  if e.get("event") == "chunk_dispatches"]
        assert [e["dispatches"] for e in events] == [1, 1, 1]
        assert {e["entry"] for e in events} == {
            "repic_tpu_torch.ops.megakernel.fused_clique_candidates"
            if solver == "lp_device_fused"
            else "repic_tpu_torch.pipeline.consensus.consensus_one"}
