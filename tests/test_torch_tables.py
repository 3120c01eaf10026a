"""The port's ``--multi_out`` / ``--get_cc`` tables and its exact and lp
rungs against the JAX package, end to end.

* ``run_consensus_dir`` with ``multi_out``, ``get_cc`` or both, under
  ``greedy``, ``lp`` and ``lp_device``, on a two-micrograph subset of
  ``examples/10017`` and on ``tests/fixtures/mini10017``: every TSV and
  BOX file byte-identical to the JAX package's.
* ``--solver exact`` (also under an exhausted budget, which degrades
  every micrograph to lp) and ``--solver lp`` on 10017: BOX files
  byte-identical.
* The executed-reference goldens of ``tests/test_multiout_golden.py``
  (``ref_multiout_10017_2mics.json``, ``ref_getcc_10017_2mics.json``)
  on the port's ``get_cliques``.
* A micrograph with no edge under ``--get_cc``, and the flag checks.
* The port's CPU run meets the committed JAX digests that
  ``chip_smoke.py`` holds the card to
  (``tests/golden/torch_port_flags_digests.json``).
"""

import json
import os
import pickle
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

import tests.test_multiout_golden as tmg
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.utils.synthetic import output_digests
from tests.golden.make_torch_port_golden import (
    FLAGS_DIGESTS,
    TABLE_FLAGS,
    run_jax_flags,
)
from torch_port_common import SETTINGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "10017")
MINI = os.path.join(REPO, "tests", "fixtures", "mini10017")
NAMES = tmg.NAMES
BOX = 180
FLAGS = {"multi_out": (True, False), "get_cc": (False, True),
         "both": (True, True)}
SOLVERS = ("greedy", "lp", "lp_device")


def stage_subset(dest, names=NAMES, src=EXAMPLES):
    """Copy ``names`` of every picker of ``src`` into ``dest``."""
    for p in sorted(os.listdir(src)):
        if not os.path.isdir(os.path.join(src, p)):
            continue
        os.makedirs(os.path.join(dest, p))
        for nm in names:
            shutil.copy(os.path.join(src, p, nm + ".box"),
                        os.path.join(dest, p))
    return str(dest)


def clear_memo():
    tcons._LAST_GOOD_CONFIG.clear()
    tcons._RECENT_REQUIREMENTS.clear()


def outputs(d):
    """The BOX and TSV outputs of ``d`` (not the runtime tables)."""
    return sorted(f for f in os.listdir(d)
                  if f.endswith((".box", ".tsv"))
                  and not f.endswith("runtime.tsv"))


def assert_same_outputs(got_dir, want_dir):
    want = outputs(want_dir)
    assert want and outputs(got_dir) == want
    for f in want:
        with open(os.path.join(got_dir, f), "rb") as a, \
                open(os.path.join(want_dir, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tables_in")
    return {"sub2": stage_subset(root / "sub2"), "mini10017": MINI}


@pytest.fixture(scope="module")
def jax_tables(datasets, tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_tables")
    out = {}
    for data, in_dir in datasets.items():
        for solver in SOLVERS:
            for flags, (mo, cc) in FLAGS.items():
                d = str(root / f"{data}_{solver}_{flags}")
                run_jax_flags(in_dir, d, BOX, solver=solver,
                              multi_out=mo, get_cc=cc)
                out[data, solver, flags] = d
    return out


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("data", ["sub2", "mini10017"])
def test_tables_match_jax(datasets, jax_tables, tmp_path, data, solver,
                          flags):
    mo, cc = FLAGS[flags]
    clear_memo()
    stats = tcons.run_consensus_dir(
        datasets[data], str(tmp_path), BOX, solver=solver,
        multi_out=mo, get_cc=cc, device="cpu",
    )
    assert stats["num_cliques"] > 0
    if cc:
        assert all(r >= 2 for r in stats["cc_rounds"])
    assert_same_outputs(str(tmp_path), jax_tables[data, solver, flags])


@pytest.mark.parametrize("solver,budget", [("exact", None), ("exact", -1.0),
                                           ("lp", None)])
def test_exact_and_lp_boxes_match_jax(tmp_path, solver, budget):
    kw = {} if budget is None else {"solver_budget_s": budget}
    want = str(tmp_path / "jax")
    run_jax_flags(EXAMPLES, want, BOX, solver=solver, **kw)
    clear_memo()
    got = str(tmp_path / "port")
    stats = tcons.run_consensus_dir(EXAMPLES, got, BOX, solver=solver,
                                    device="cpu", **kw)
    assert_same_outputs(got, want)
    if solver == "exact":
        rung = "exact" if budget is None else "lp"
        assert stats["solver_rungs"] == dict.fromkeys(
            stats["particle_counts"], rung)


@pytest.fixture(scope="module")
def port_get_cliques(tmp_path_factory):
    """The port's get_cliques pickles on the subset, per flag set."""
    from repic_tpu_torch.commands import get_cliques

    root = tmp_path_factory.mktemp("gc")
    in_dir = stage_subset(root / "in")
    outs = {}
    for flags, (mo, cc) in {"multi_out": (True, False),
                            "plain": (False, False),
                            "get_cc": (False, True)}.items():
        clear_memo()
        out = str(root / flags)
        get_cliques.main(SimpleNamespace(
            in_dir=in_dir, out_dir=out, box_size=BOX, multi_out=mo,
            get_cc=cc, max_neighbors=16, no_mesh=True, device="cpu"))
        outs[flags] = out
    return outs


def _load(out, name, label):
    with open(os.path.join(out, f"{name}_{label}.pickle"), "rb") as f:
        return pickle.load(f)


def test_multi_out_meets_executed_reference(port_get_cliques):
    """The label-agnostic assertions of tests/test_multiout_golden.py
    on the port's --multi_out pickles."""
    out = port_get_cliques["multi_out"]
    ours = {nm: (_load(out, nm, "consensus_coords"),
                 np.asarray(_load(out, nm, "weight_vector")),
                 _load(out, nm, "constraint_matrix")) for nm in NAMES}
    tmg.test_multi_out_matches_reference_label_agnostic(ours)
    tmg.test_our_multiout_labels_are_truthful(ours)


def test_cc_stats_meet_executed_reference(port_get_cliques):
    """Largest component and component count as the executed
    reference printed them (columns 2 and 3 of the runtime table)."""
    want = {NAMES[0]: (16, 563), NAMES[1]: (12, 525)}
    for name, (largest, num) in want.items():
        with open(os.path.join(port_get_cliques["plain"],
                               name + "_runtime.tsv")) as f:
            line = f.read().split()
        assert (int(float(line[1])), int(float(line[2]))) == (largest, num)


def test_get_cc_meets_executed_reference(port_get_cliques):
    """--get_cc representative coordinates and weight sum against
    ref_getcc_10017_2mics.json."""
    import json

    with open(os.path.join(REPO, "tests", "golden",
                           "ref_getcc_10017_2mics.json")) as f:
        golden = json.load(f)
    out = port_get_cliques["get_cc"]
    for name, gd in golden.items():
        coords = _load(out, name, "consensus_coords")
        w = np.asarray(_load(out, name, "weight_vector"))
        assert len(coords) == gd["n"], name
        mine = sorted([round(float(c[0]), 3), round(float(c[1]), 3)]
                      for c in coords)
        assert mine == gd["rep_xy"], name
        np.testing.assert_allclose(float(np.sum(w)), gd["w_sum"], atol=2e-3)


def _write_box_dir(root, picker, name, rows):
    d = root / picker
    d.mkdir(parents=True, exist_ok=True)
    with open(d / (name + ".box"), "wt") as f:
        for x, y, s, c in rows:
            f.write(f"{x}\t{y}\t{s}\t{s}\t{c}\n")


@pytest.mark.parametrize("multi_out", [False, True])
def test_get_cc_on_a_graph_without_edges(tmp_path, multi_out):
    src = tmp_path / "in"
    _write_box_dir(src, "a", "m0", [(10, 10, 180, 0.9)])
    _write_box_dir(src, "b", "m0", [(5000, 5000, 180, 0.8)])
    out = str(tmp_path / "out")
    stats = tcons.run_consensus_dir(str(src), out, BOX, multi_out=multi_out,
                                    get_cc=True, device="cpu")
    assert stats["particle_counts"] == {"m0": 0}
    if multi_out:
        with open(os.path.join(out, "m0.tsv")) as f:
            assert f.read() == "a\tb\n"
    else:
        assert os.path.getsize(os.path.join(out, "m0.box")) == 0


def test_solver_budget_needs_exact(tmp_path):
    out = tmp_path / "o"
    out.mkdir()
    (out / "keep").write_text("x")
    with pytest.raises(ValueError, match="solver_budget_s"):
        tcons.run_consensus_dir(MINI, str(out), BOX, solver="lp",
                                solver_budget_s=1.0, device="cpu")
    # checked before the output directory is deleted
    assert (out / "keep").exists()


with open(FLAGS_DIGESTS) as _f:
    COMMITTED = json.load(_f)


@pytest.mark.parametrize("key", sorted(COMMITTED["tables"])
                         + sorted(COMMITTED["solvers"]))
def test_port_meets_committed_digests(tmp_path, key):
    if "/" in key:
        setting, flags = key.split("/")
        solver, pallas = SETTINGS[setting]
        mo, cc = TABLE_FLAGS[flags]
        want = COMMITTED["tables"][key]
    else:
        solver, pallas, mo, cc = key, False, False, False
        want = COMMITTED["solvers"][key]
    clear_memo()
    tcons.run_consensus_dir(EXAMPLES, str(tmp_path), BOX, solver=solver,
                            use_pallas=pallas, multi_out=mo, get_cc=cc,
                            device="cpu")
    assert len(want) == 12
    assert output_digests(str(tmp_path)) == want
