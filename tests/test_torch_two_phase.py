"""The port's two-phase CLI (``get_cliques`` + ``run_ilp``) against the
JAX package's.

* ``get_cliques`` (plain, ``--multi_out``, ``--get_cc``) on a
  two-micrograph subset of ``examples/10017`` and on
  ``tests/fixtures/mini10017``: every pickle equal in content to the
  JAX package's (arrays exact, coordinate lists equal, constraint
  matrices equal as COO triples), and the runtime table's component
  columns equal.
* ``run_ilp`` with each backend on either package's pickles: BOX and
  TSV files byte-identical to the JAX ``run_ilp``'s.
* On 10017, the port's CPU run of both phases meets the committed JAX
  digests that ``chip_smoke.py`` holds the card to.
* ``consensus --multi_out/--get_cc`` equal to the port's own
  ``get_cliques`` + ``run_ilp`` for the same flags, under ``greedy``
  and ``lp`` (as ``tests/test_fused_flags.py`` holds the JAX package).
"""

import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from repic_tpu_torch.commands import get_cliques as tgc
from repic_tpu_torch.commands import run_ilp as tilp
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.utils.synthetic import output_digests, pickle_sha256
from tests.golden.make_torch_port_golden import (
    FLAGS_DIGESTS,
    run_jax_get_cliques,
    run_jax_ilp,
)
from tests.test_torch_tables import (
    BOX,
    EXAMPLES,
    MINI,
    assert_same_outputs,
    clear_memo,
    stage_subset,
)

GC_FLAGS = {"plain": (False, False), "multi_out": (True, False),
            "get_cc": (False, True)}
BACKENDS = ("exact", "greedy", "lp")


def port_get_cliques(in_dir, out, multi_out, get_cc):
    clear_memo()
    tgc.main(SimpleNamespace(in_dir=in_dir, out_dir=out, box_size=BOX,
                             multi_out=multi_out, get_cc=get_cc,
                             max_neighbors=16, no_mesh=True, device="cpu"))


def port_run_ilp(in_dir, backend):
    tilp.main(SimpleNamespace(in_dir=in_dir, box_size=BOX,
                              num_particles=None, backend=backend,
                              device="cpu"))


@pytest.fixture(scope="module")
def phase1(tmp_path_factory):
    """Both packages' get_cliques output per (dataset, flags)."""
    root = tmp_path_factory.mktemp("two_phase")
    data = {"sub2": stage_subset(root / "sub2"), "mini10017": MINI}
    out = {}
    for dname, in_dir in data.items():
        for flags, (mo, cc) in GC_FLAGS.items():
            j = str(root / f"jax_{dname}_{flags}")
            run_jax_get_cliques(in_dir, j, BOX, multi_out=mo, get_cc=cc)
            p = str(root / f"port_{dname}_{flags}")
            port_get_cliques(in_dir, p, mo, cc)
            out[dname, flags] = (j, p)
    return out


def _files(d, suffix):
    return sorted(f for f in os.listdir(d) if f.endswith(suffix))


@pytest.mark.parametrize("flags", list(GC_FLAGS))
@pytest.mark.parametrize("data", ["sub2", "mini10017"])
def test_get_cliques_pickles_match_jax(phase1, data, flags):
    j, p = phase1[data, flags]
    pickles = _files(j, ".pickle")
    assert len(pickles) >= 8 and _files(p, ".pickle") == pickles
    for f in pickles:
        assert pickle_sha256(os.path.join(p, f)) == \
            pickle_sha256(os.path.join(j, f)), f
    tsvs = _files(j, "_runtime.tsv")
    assert _files(p, "_runtime.tsv") == tsvs
    for f in tsvs:
        with open(os.path.join(j, f)) as a, open(os.path.join(p, f)) as b:
            assert a.read().split("\t")[1:3] == b.read().split("\t")[1:3]


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("flags", list(GC_FLAGS))
def test_run_ilp_matches_jax(phase1, tmp_path, flags, backend, source):
    """Either package's pickles, solved by each package's run_ilp."""
    j, p = phase1["sub2", flags]
    src = p if source == "port" else j
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(src, want)
    shutil.copytree(src, got)
    run_jax_ilp(want, BOX, backend)
    port_run_ilp(got, backend)
    assert_same_outputs(got, want)
    with open(os.path.join(got, _files(got, "_runtime.tsv")[0])) as f:
        assert len(f.read().splitlines()) == 2   # phase 1 + phase 2


@pytest.mark.parametrize("multi_out,get_cc,solver", [
    (True, False, "greedy"), (False, True, "greedy"), (True, True, "greedy"),
    (True, False, "lp"), (False, True, "lp"), (True, True, "lp"),
])
def test_consensus_flags_equal_two_phase(tmp_path, multi_out, get_cc,
                                         solver):
    in_dir = stage_subset(tmp_path / "in")
    two = str(tmp_path / "two")
    port_get_cliques(in_dir, two, multi_out, get_cc)
    port_run_ilp(two, solver)
    clear_memo()
    one = str(tmp_path / "one")
    tcons.run_consensus_dir(in_dir, one, BOX, multi_out=multi_out,
                            get_cc=get_cc, solver=solver, device="cpu")
    ext = ".tsv" if multi_out else ".box"
    # consensus_runtime.tsv is the run's stage table, not an output
    names = [f for f in _files(one, ext) if f != "consensus_runtime.tsv"]
    assert len(names) == 2
    for f in names:
        with open(os.path.join(one, f)) as a, open(os.path.join(two, f)) as b:
            assert a.read() == b.read(), f


def test_run_ilp_feasibility_check(phase1, tmp_path, monkeypatch):
    """A packing that puts a particle in two cliques is refused."""
    j, _ = phase1["sub2", "plain"]
    d = str(tmp_path / "p")
    shutil.copytree(j, d)
    monkeypatch.setattr(tilp, "_solve", lambda a_mat, w, backend, device:
                        np.ones(a_mat.shape[1], bool))
    with pytest.raises(AssertionError, match="multiple cliques"):
        port_run_ilp(d, "exact")


@pytest.mark.parametrize("flags", list(GC_FLAGS))
def test_port_meets_committed_digests(tmp_path, flags):
    with open(FLAGS_DIGESTS) as f:
        want = json.load(f)["two_phase"][flags]
    out = str(tmp_path / "p")
    port_get_cliques(EXAMPLES, out, *GC_FLAGS[flags])
    assert output_digests(out, (".pickle", "_runtime.tsv")) == \
        want["get_cliques"]
    for backend in BACKENDS:
        port_run_ilp(out, backend)
        assert output_digests(out) == want[backend], backend


def _cli(*args):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", *args],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=300,
    )


def test_cli_defaults_to_cuda(phase1, tmp_path):
    """get_cliques and the device backends of run_ilp run on cuda by
    default and fail where there is none; the exact backend is host
    C++ and needs no card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    proc = _cli("get_cliques", MINI, str(tmp_path / "g"), str(BOX))
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    j, _ = phase1["sub2", "plain"]
    d = str(tmp_path / "p")
    shutil.copytree(j, d)
    proc = _cli("run_ilp", d, str(BOX), "--backend", "greedy")
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    proc = _cli("run_ilp", d, str(BOX))
    assert proc.returncode == 0, proc.stderr
    assert len(_files(d, ".box")) == 2
