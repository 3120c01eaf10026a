#!/usr/bin/env python3
"""Regenerate the BOX goldens that the PyTorch port is held to.

Runs the JAX package's directory consensus on the CPU over
``examples/10017`` (box 180) once per solver setting and copies the
BOX files to ``tests/golden/torch_port_10017/<setting>/``:

* ``lp_device``        — the default staged program;
* ``lp_device_pallas`` — the same with the Pallas neighbour search;
* ``lp_device_fused``  — the megakernel rung, forced into interpret
  mode (``REPIC_TPU_MEGAKERNEL_FORCE=1``);
* ``greedy``           — the parallel greedy solver.

It also writes digest goldens for the two dense configurations,
``tests/golden/torch_port_digests.json``: per micrograph the BOX
file's sha256, its row count and the clique count, for ``lp_device``
and ``greedy``, over BOX trees that ``repic_tpu_torch.utils.synthetic``
writes from seed 0 (their digest is recorded too):

* ``stress_50k`` — 2 micrographs of the 50,000-particle, 4-picker
  field (the spatial path, anchor-chunked assembly);
* ``k5_mixed``   — 32 micrographs of the 5-picker mixed-size ensemble
  (the staged join).  The Pallas neighbour search runs in interpret
  mode here, too slowly for a golden of its own, so the script asserts
  on its first micrographs that ``lp_device --pallas`` writes the
  ``lp_device`` bytes; the card holds ``--pallas`` and
  ``lp_device_fused`` to the ``lp_device`` digests.

And it writes ``tests/golden/torch_port_flags_digests.json``: the
sha256 and row count of every output file (pickles by content,
:func:`repic_tpu_torch.utils.synthetic.pickle_sha256`) of

* ``tables`` — ``consensus --multi_out``, ``--get_cc`` and both on
  10017 under ``lp_device``, ``lp_device --pallas`` and
  ``lp_device_fused`` (megakernel in interpret mode);
* ``solvers`` — ``consensus --solver exact`` and ``--solver lp`` on
  10017;
* ``two_phase`` — ``get_cliques`` (plain, ``--multi_out``,
  ``--get_cc``) on 10017, then ``run_ilp`` with each backend
  (``exact``, ``greedy``, ``lp``);
* ``stripes`` — ``consensus --stripes 4`` on the two ``stress_50k``
  golden micrographs under ``lp_device`` (the striped path solves
  greedy) and ``lp``.

Every JAX run is ``use_mesh=False`` with the config cache off, so the
capacities come from that run alone.  The card machine has no JAX, so
``chip_smoke.py`` compares the port's output with these files;
``tests/test_torch_consensus.py`` holds the BOX goldens equal to a
live JAX run and ``tests/test_torch_staged.py`` the port's CPU run to
the digests.  Run from the repository root:

    JAX_PLATFORMS=cpu python tests/golden/make_torch_port_golden.py

And it writes ``tests/golden/torch_port_runtime_digests.json``, the
fault-tolerant runtime on 10017 (BOX sha256 and rows, and the journal
projected by :func:`repic_tpu_torch.utils.synthetic.journal_view`):

* ``lenient`` -- ``lp_device_fused`` (megakernel in interpret mode)
  with ``topaz/Falcon_2012_06_12-15_33_42_0.box`` unreadable and the
  fault plan :data:`LENIENT_PLAN`: 11 BOX files, the micrograph
  quarantined, one halved chunk, one demotion;
* ``resumed`` -- the file repaired, ``resume=True``: all 12;
* ``sidecar`` -- two runs in chunks of :data:`SIDECAR_CHUNK`, each as a
  new process (the in-process memo dropped) over one capacity-config
  sidecar: both runs' digests and the sidecar's entries.

And it writes ``tests/golden/torch_port_telemetry_digests.json``: the
telemetry of a default run (telemetry on) of 10017 under each setting
of :data:`TELEMETRY_SETTINGS`, projected by
:func:`repic_tpu_torch.utils.synthetic.telemetry_view` -- the counters
and probe gauges that count logical events (chunks, micrographs,
escalations, halvings, dispatches, fetches, program-cache hits and
misses, solver and ladder counters), each histogram's count, the span
names with their counts and parents, the trace segments in order, and
which journal records carry a ``trace`` id -- plus the run's file
names.  Clocks, ids, device memory and the build counters (a
process's history: the port counts its ``nvcc``/``g++`` builds where
the reference counts XLA compiles) are left out, and so is the
prefetched-chunk count (it follows the worker's timing).  Each run
starts from an empty program-signature set and escalation memo, as a
new process does.

And it writes ``tests/golden/torch_port_serve_digests.json``: the JAX
package's serve daemon on the CPU (warmup on, warmup bucket 3:1024)
serving examples/10017 once per setting of
``torch_serve_common.SERVE_SETTINGS`` (fused, ``--pallas``,
``lp_device``), one job after another -- per job the sha256 of every
artifact fetched over HTTP, the job document projected by
:func:`repic_tpu_torch.utils.synthetic.job_view` and the run journal by
:func:`~repic_tpu_torch.utils.synthetic.journal_view`, and the request
journal by :func:`~repic_tpu_torch.utils.synthetic.serve_journal_view`.

And it writes the CNN picker's goldens (``--only picker``) under
``tests/golden/torch_port_picker/``:

* ``deep.ckpt`` -- ``PickerCNN().init(PRNGKey(0))`` (the deep
  architecture) written by ``repic_tpu.models.checkpoint.save_checkpoint``
  with particle size 180;
* ``maps.npz`` -- for each seed of :data:`PICKER_SEEDS`, the JAX score
  maps of ``utils/synthetic.py: synthetic_micrograph(seed)`` (4096 x
  4096), preprocessed as ``pick_micrograph`` does, in ``patch`` and
  ``fcn`` mode (float32);
* ``picks_patch/`` and ``picks_fcn/`` -- the BOX files the JAX ``pick``
  command writes for those micrographs.

And the host utilities' digests (``--only utilities``),
``tests/golden/torch_port_utilities_digests.json``: the sha256 of every
file the JAX ``convert`` command writes from each picker directory of
examples/10017 -- BOX to STAR, TSV and BOX, then each of those STAR and
TSV outputs to STAR, TSV and BOX (box size 180) -- and the split
membership of ``build_subsets`` on ``utils/synthetic.py:
write_subsets_fixture`` (with and without ``--ignore_test``).

And the training goldens (``--only training``) under
``tests/golden/torch_port_training/``, on ``tests/test_train.py``'s
fixture (seed 7: three 800 x 800 training micrographs and one for
validation, particle size 120):

* ``step.npz`` -- one update of ``repic_tpu.models.train.
  _make_update_step`` (SGD, momentum 0.9, the staircase decay) from
  ``PickerCNN().init(PRNGKey(0))`` on the first :data:`STEP_BATCH`
  training patches under ``PRNGKey(STEP_KEY)``: the parameters before
  (``params/...``) and after (``updated/...``), the momentum
  (``trace/...``), the batch, labels, dropout mask, loss and logits,
  and optax's learning rates at the counts ``lr_counts`` for each
  ``lr_decay_steps``;
* ``fit.ckpt`` -- ``repic_tpu.models.train.fit`` (batch 16, 6 epochs,
  seed 1234, JAX's own init) on the fixture, saved as the JAX ``fit``
  command saves it;
* ``picks/`` -- the BOX file the JAX ``pick`` command writes with
  ``fit.ckpt`` for the held-out micrograph (``make_micrograph`` of
  seed :data:`HELD_OUT_SEED`).

``--only flags`` / ``--only runtime`` / ``--only telemetry`` /
``--only serve`` / ``--only picker`` / ``--only utilities`` /
``--only training`` rewrite only that file (or directory).
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)
)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_port_common import GOLDEN_DIR, SETTINGS  # noqa: E402

EXAMPLES = os.path.join(REPO, "examples", "10017")
BOX_SIZE = 180
DIGESTS = os.path.join(REPO, "tests", "golden", "torch_port_digests.json")
#: cell -> micrographs in its digest golden
DIGEST_MICROGRAPHS = {"stress_50k": 2, "k5_mixed": 32}
DIGEST_SETTINGS = ("lp_device", "greedy")
#: k5_mixed micrographs on which --pallas is checked in interpret mode
PALLAS_CHECK = 2
FLAGS_DIGESTS = os.path.join(REPO, "tests", "golden",
                             "torch_port_flags_digests.json")
#: 10017 table runs: flags -> (multi_out, get_cc)
TABLE_FLAGS = {"multi_out": (True, False), "get_cc": (False, True),
               "multi_out_get_cc": (True, True)}
#: solver settings of the table runs (names of ``SETTINGS``)
TABLE_SETTINGS = ("lp_device", "lp_device_pallas", "lp_device_fused")
SOLVER_SETTINGS = ("exact", "lp")
#: get_cliques flags -> (multi_out, get_cc); then each run_ilp backend
TWO_PHASE = {"plain": (False, False), "multi_out": (True, False),
             "get_cc": (False, True)}
BACKENDS = ("exact", "greedy", "lp")
STRIPES = 4
STRIPED_SOLVERS = ("lp_device", "lp")
RUNTIME_DIGESTS = os.path.join(REPO, "tests", "golden",
                               "torch_port_runtime_digests.json")
#: the 10017 lenient run: the unreadable file and its content
BAD_BOX = ("topaz", "Falcon_2012_06_12-15_33_42_0")
BAD_TEXT = "x y\n1 2 3 4 abc\nfoo bar\n"
LENIENT_SOLVER = "lp_device_fused"
LENIENT_PLAN = ("oom:chunk:1",
                "megakernel_fallback:Falcon_2012_06_12-14_33_35_0:1")
#: micrographs per chunk of the sidecar runs
SIDECAR_CHUNK = 4
TELEMETRY_DIGESTS = os.path.join(REPO, "tests", "golden",
                                 "torch_port_telemetry_digests.json")
#: settings (names of ``SETTINGS``) of the telemetry digests
SERVE_DIGESTS = os.path.join(REPO, "tests", "golden",
                             "torch_port_serve_digests.json")
SERVE_SETTINGS_ORDER = ("lp_device_fused", "lp_device_pallas", "lp_device")
TELEMETRY_SETTINGS = ("lp_device", "lp_device_pallas", "lp_device_fused")
PICKER_DIR = os.path.join(REPO, "tests", "golden", "torch_port_picker")
#: seeds of the picker's 4096 x 4096 synthetic micrographs
PICKER_SEEDS = (0, 1)
PICKER_PARTICLE = 180
PICKER_MODES = ("patch", "fcn")
UTILITIES_DIGESTS = os.path.join(REPO, "tests", "golden",
                                 "torch_port_utilities_digests.json")
#: convert chains: (input format, output format); star/tsv inputs are
#: the BOX -> star/tsv outputs
TRAINING_DIR = os.path.join(REPO, "tests", "golden", "torch_port_training")
#: patches in the golden train step, and its dropout key
STEP_BATCH = 16
STEP_KEY = 5
#: decay steps of the golden learning rates; each at counts 0, ds - 1,
#: ds and 10 ds
LR_DECAY_STEPS = (1, 8, 24, 184)
#: seed of the held-out micrograph the golden fit picks
HELD_OUT_SEED = 99
CONVERT_CHAINS = tuple(
    [("box", o) for o in ("star", "tsv", "box")]
    + [(i, o) for i in ("star", "tsv") for o in ("star", "tsv", "box")])


def run_jax(setting: str, out_dir: str, in_dir: str = EXAMPLES,
            box_size: int = BOX_SIZE) -> None:
    """The JAX package's BOX output for one setting into ``out_dir``."""
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu.pipeline.consensus import run_consensus_dir

    solver, pallas = SETTINGS[setting]
    force = "REPIC_TPU_MEGAKERNEL_FORCE"
    old = os.environ.get(force)
    if solver == "lp_device_fused":
        os.environ[force] = "1"
    try:
        run_consensus_dir(
            in_dir, out_dir, box_size,
            use_mesh=False, solver=solver, use_pallas=pallas,
        )
    finally:
        if old is None:
            os.environ.pop(force, None)
        else:
            os.environ[force] = old


def run_jax_flags(in_dir: str, out_dir: str, box_size, *,
                  solver: str = "lp_device", use_pallas: bool = False,
                  **kw) -> dict:
    """The JAX package's ``run_consensus_dir`` with any of its flags
    (``multi_out``, ``get_cc``, ``stripes``, ``solver_budget_s``): no
    mesh, no config cache, the in-memory memo cleared, the megakernel
    forced for ``lp_device_fused``."""
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu.pipeline import consensus as jcons

    jcons._LAST_GOOD_CONFIG.clear()
    jcons._RECENT_REQUIREMENTS.clear()
    force = "REPIC_TPU_MEGAKERNEL_FORCE"
    old = os.environ.get(force)
    if solver == "lp_device_fused":
        os.environ[force] = "1"
    try:
        return jcons.run_consensus_dir(
            in_dir, out_dir, box_size, use_mesh=False, solver=solver,
            use_pallas=use_pallas, **kw)
    finally:
        if old is None:
            os.environ.pop(force, None)
        else:
            os.environ[force] = old


def run_jax_get_cliques(in_dir: str, out_dir: str, box_size: int, *,
                        multi_out: bool, get_cc: bool) -> None:
    """The JAX package's ``get_cliques`` (no mesh, memo cleared)."""
    from types import SimpleNamespace

    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu.commands import get_cliques
    from repic_tpu.pipeline import consensus as jcons

    jcons._LAST_GOOD_CONFIG.clear()
    jcons._RECENT_REQUIREMENTS.clear()
    get_cliques.main(SimpleNamespace(
        in_dir=in_dir, out_dir=out_dir, box_size=box_size,
        multi_out=multi_out, get_cc=get_cc, max_neighbors=16,
        no_mesh=True))


def run_jax_ilp(in_dir: str, box_size: int, backend: str) -> None:
    """The JAX package's ``run_ilp`` over ``in_dir``'s pickles."""
    from types import SimpleNamespace

    from repic_tpu.commands import run_ilp

    run_ilp.main(SimpleNamespace(in_dir=in_dir, box_size=box_size,
                                 num_particles=None, backend=backend))


def make_flag_digests(tmp: str) -> dict:
    """The JAX outputs that ``chip_smoke.py`` phase 8 holds the card to."""
    from repic_tpu_torch.utils.synthetic import (
        output_digests,
        tree_sha256,
        write_cell_dir,
    )

    golden = {"tables": {}, "solvers": {}, "two_phase": {}, "stripes": {}}
    for setting in TABLE_SETTINGS:
        solver, pallas = SETTINGS[setting]
        for flags, (mo, cc) in TABLE_FLAGS.items():
            out = os.path.join(tmp, f"t_{setting}_{flags}")
            run_jax_flags(EXAMPLES, out, BOX_SIZE, solver=solver,
                          use_pallas=pallas, multi_out=mo, get_cc=cc)
            golden["tables"][f"{setting}/{flags}"] = output_digests(out)
            print("tables", setting, flags)
    for solver in SOLVER_SETTINGS:
        out = os.path.join(tmp, f"s_{solver}")
        run_jax_flags(EXAMPLES, out, BOX_SIZE, solver=solver)
        golden["solvers"][solver] = output_digests(out)
        print("solver", solver)
    for flags, (mo, cc) in TWO_PHASE.items():
        out = os.path.join(tmp, f"p_{flags}")
        run_jax_get_cliques(EXAMPLES, out, BOX_SIZE, multi_out=mo,
                            get_cc=cc)
        entry = {"get_cliques": output_digests(
            out, (".pickle", "_runtime.tsv"))}
        for backend in BACKENDS:
            run_jax_ilp(out, BOX_SIZE, backend)
            entry[backend] = output_digests(out)
        golden["two_phase"][flags] = entry
        print("two-phase", flags)
    in_dir = os.path.join(tmp, "stress_in")
    m = DIGEST_MICROGRAPHS["stress_50k"]
    box = write_cell_dir("stress_50k", in_dir, m)
    golden["stripes"] = {"cell": "stress_50k", "micrographs": m,
                         "input_sha256": tree_sha256(in_dir),
                         "stripes": STRIPES, "settings": {}}
    for solver in STRIPED_SOLVERS:
        out = os.path.join(tmp, f"g_{solver}")
        st = run_jax_flags(in_dir, out, box, solver=solver, stripes=STRIPES)
        assert st["stripes"] == STRIPES
        golden["stripes"]["settings"][solver] = output_digests(out)
        print("stripes", solver, st["num_cliques"], "cliques")
    return golden


def make_runtime_digests(tmp: str) -> dict:
    """The JAX outputs that ``chip_smoke.py`` phase 9 holds the card to."""
    from repic_tpu.pipeline import consensus as jcons
    from repic_tpu.runtime import faults as jfaults
    from repic_tpu_torch.utils.synthetic import journal_view, output_digests

    in_dir = os.path.join(tmp, "rt_in")
    shutil.copytree(EXAMPLES, in_dir)
    bad = os.path.join(in_dir, BAD_BOX[0], BAD_BOX[1] + ".box")
    with open(bad, "w") as f:
        f.write(BAD_TEXT)
    out = os.path.join(tmp, "rt_out")
    golden = {"plan": list(LENIENT_PLAN), "solver": LENIENT_SOLVER,
              "bad_box": "/".join(BAD_BOX) + ".box", "bad_text": BAD_TEXT}
    for run, resume in (("lenient", False), ("resumed", True)):
        if resume:
            shutil.copy(os.path.join(EXAMPLES, BAD_BOX[0],
                                     BAD_BOX[1] + ".box"), bad)
        plan = () if resume else LENIENT_PLAN
        with jfaults.fault_plan(*plan):
            st = run_jax_flags(in_dir, out, BOX_SIZE, solver=LENIENT_SOLVER,
                               resume=resume)
        golden[run] = {
            "boxes": output_digests(out, (".box",)),
            "journal": journal_view(out, in_dir),
            "quarantined": sorted(st["quarantined"]),
            "resumed": st["resumed"],
            "summary": st["journal"],
        }
        print(run, st["journal"])
    # the sidecar: each run as a new process would start
    home = os.path.join(tmp, "home")
    saved = {k: os.environ.get(k) for k in
             ("HOME", "REPIC_TPU_NO_CONFIG_CACHE", "REPIC_CONSENSUS_CHUNK")}
    os.environ.update(HOME=home, REPIC_CONSENSUS_CHUNK=str(SIDECAR_CHUNK))
    os.environ.pop("REPIC_TPU_NO_CONFIG_CACHE", None)
    golden["sidecar"] = {"chunk": SIDECAR_CHUNK}
    try:
        for run in ("first", "second"):
            jcons._LAST_GOOD_CONFIG.clear()
            jcons._RECENT_REQUIREMENTS.clear()
            jcons._LAST_PERSISTED.clear()
            jcons._CONFIG_CACHE_LOADED = False
            out = os.path.join(tmp, "sc_" + run)
            jcons.run_consensus_dir(EXAMPLES, out, BOX_SIZE, use_mesh=False)
            golden["sidecar"][run] = output_digests(out, (".box",))
        with open(os.path.join(home, ".cache", "repic_tpu",
                               "capacity_configs.json")) as f:
            golden["sidecar"]["entries"] = json.load(f)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return golden


def make_telemetry_digests(tmp: str) -> dict:
    """The JAX telemetry that the port's CPU run and ``chip_smoke.py``
    phase 10 are held to."""
    from repic_tpu.pipeline import consensus as jcons
    from repic_tpu.telemetry import metrics
    from repic_tpu_torch.utils.synthetic import telemetry_view

    was = metrics.enabled()
    metrics.set_enabled(True)
    golden = {}
    try:
        for setting in TELEMETRY_SETTINGS:
            solver, pallas = SETTINGS[setting]
            jcons._PROGRAM_SIGNATURES.clear()
            out = os.path.join(tmp, "tlm_" + setting)
            run_jax_flags(EXAMPLES, out, BOX_SIZE, solver=solver,
                          use_pallas=pallas)
            view = telemetry_view(out)
            view["files"] = sorted(f for f in os.listdir(out)
                                   if not f.endswith(".box"))
            golden[setting] = view
            print("telemetry", setting, view["trace"])
    finally:
        metrics.set_enabled(was)
    return golden


def make_serve_digests(tmp: str) -> dict:
    """The JAX daemon's 10017 jobs that the port's CPU daemon and
    ``chip_smoke.py`` phase 11a are held to."""
    from torch_serve_common import FORCE_ENV, fresh, serve_10017

    fresh("jax")
    os.environ[FORCE_ENV] = "1"
    try:
        golden = serve_10017("jax", os.path.join(tmp, "serve"))
    finally:
        os.environ.pop(FORCE_ENV, None)
    for setting in SERVE_SETTINGS_ORDER:
        print("serve", setting, len(golden[setting]["artifacts"]),
              "artifacts")
    return golden


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1, sort_keys=True)
        f.write("\n")


def run_jax_dir(in_dir: str, out_dir: str, box_size, solver: str,
                use_pallas: bool = False) -> dict:
    """The JAX package's ``run_consensus_dir`` (no mesh, no config
    cache); returns its clique count per micrograph."""
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu.pipeline import consensus as jcons

    jcons._LAST_GOOD_CONFIG.clear()
    jcons._RECENT_REQUIREMENTS.clear()
    cliques = {}
    write = jcons.write_consensus_boxes

    def recording(batch, res, *args, **kw):
        out = write(batch, res, *args, **kw)
        if kw.get("with_num_cliques"):
            cliques.update((name, int(c)) for name, c in
                           zip(batch.names, out[1]) if name)
        return out

    jcons.write_consensus_boxes = recording
    try:
        jcons.run_consensus_dir(in_dir, out_dir, box_size, use_mesh=False,
                                solver=solver, use_pallas=use_pallas)
    finally:
        jcons.write_consensus_boxes = write
    return cliques


def box_digests(out_dir: str, cliques: dict) -> dict:
    """Per micrograph: BOX sha256, row count and clique count."""
    from repic_tpu_torch.utils.synthetic import file_sha256

    out = {}
    for name in sorted(cliques):
        path = os.path.join(out_dir, name + ".box")
        with open(path) as f:
            rows = sum(1 for _ in f)
        out[name] = {"sha256": file_sha256(path), "rows": rows,
                     "num_cliques": cliques[name]}
    return out


def make_digests(tmp: str) -> dict:
    from repic_tpu_torch.utils.synthetic import tree_sha256, write_cell_dir

    golden = {}
    for cell, m in DIGEST_MICROGRAPHS.items():
        in_dir = os.path.join(tmp, cell)
        box = write_cell_dir(cell, in_dir, m)
        entry = {"micrographs": m, "seed": 0,
                 "input_sha256": tree_sha256(in_dir), "settings": {}}
        for setting in DIGEST_SETTINGS:
            out = os.path.join(tmp, f"{cell}_{setting}")
            cliques = run_jax_dir(in_dir, out, box, setting)
            entry["settings"][setting] = box_digests(out, cliques)
            print(cell, setting, sum(cliques.values()), "cliques")
        golden[cell] = entry
    # --pallas in interpret mode on the first k5_mixed micrographs
    in_dir = os.path.join(tmp, "k5_pallas")
    box = write_cell_dir("k5_mixed", in_dir, PALLAS_CHECK)
    got = {}
    for pallas in (False, True):
        out = os.path.join(tmp, f"k5_pallas_{pallas}")
        got[pallas] = box_digests(
            out, run_jax_dir(in_dir, out, box, "lp_device", pallas))
    if got[True] != got[False]:
        raise AssertionError("JAX --pallas differs from lp_device on k5")
    golden["k5_mixed"]["pallas_checked"] = sorted(got[True])
    return golden


def make_picker_goldens(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repic_tpu.main import main as jax_cli
    from repic_tpu.models import infer
    from repic_tpu.models import preprocess as pp
    from repic_tpu.models.checkpoint import save_checkpoint
    from repic_tpu.models.cnn import PickerCNN, fc_params_as_conv
    from repic_tpu_torch.utils import mrc
    from repic_tpu_torch.utils.synthetic import synthetic_micrograph

    shutil.rmtree(PICKER_DIR, ignore_errors=True)
    os.makedirs(PICKER_DIR)
    params = PickerCNN().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))["params"]
    ckpt = os.path.join(PICKER_DIR, "deep.ckpt")
    save_checkpoint(ckpt, params, {"particle_size": PICKER_PARTICLE,
                                   "patch_norm": "reference",
                                   "arch": "deep"})
    mrc_dir = os.path.join(tmp, "mrc")
    os.makedirs(mrc_dir)
    maps = {}
    patch = PICKER_PARTICLE // pp.BIN_SIZE
    for seed in PICKER_SEEDS:
        raw, _ = synthetic_micrograph(seed)
        mrc.write_mrc(os.path.join(mrc_dir, f"mic_{seed}.mrc"), raw)
        img = pp.preprocess_micrograph(jnp.asarray(raw))
        maps[f"mic_{seed}_patch"] = np.asarray(
            infer.score_micrograph_patches(params, img, patch_size=patch))
        maps[f"mic_{seed}_fcn"] = np.asarray(infer.score_micrograph_fcn(
            fc_params_as_conv(params), img, patch_size=patch))
        print("picker maps", seed, flush=True)
    np.savez_compressed(os.path.join(PICKER_DIR, "maps.npz"), **maps)
    for mode in PICKER_MODES:
        out = os.path.join(tmp, f"picks_{mode}")
        jax_cli(["pick", ckpt, mrc_dir, out, "--mode", mode])
        dest = os.path.join(PICKER_DIR, f"picks_{mode}")
        os.makedirs(dest)
        for f in sorted(os.listdir(out)):
            if f.endswith(".box"):
                shutil.copy(os.path.join(out, f), dest)


def write_training_fixture(root: str) -> dict:
    """``tests/test_train.py``'s fixture: ``{split: (mrc_dir,
    box_dir)}``."""
    import numpy as np
    from test_train import make_micrograph, write_pair

    rng = np.random.default_rng(7)
    dirs = {}
    for split, n in (("train", 3), ("val", 1)):
        mrc_dir = os.path.join(root, f"{split}_mrc")
        box_dir = os.path.join(root, f"{split}_box")
        os.makedirs(mrc_dir)
        os.makedirs(box_dir)
        for i in range(n):
            img, centers = make_micrograph(rng)
            write_pair((mrc_dir, box_dir), f"{split}{i}", img, centers)
        dirs[split] = (mrc_dir, box_dir)
    return dirs


def lr_counts(decay_steps: int) -> list:
    return [0, decay_steps - 1, decay_steps, 10 * decay_steps]


def make_training_goldens(tmp: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from repic_tpu.main import main as jax_cli
    from repic_tpu.models import data as jdata
    from repic_tpu.models.checkpoint import save_checkpoint
    from repic_tpu.models.cnn import PickerCNN
    from repic_tpu.models.train import TrainConfig, _make_update_step, fit
    from repic_tpu_torch.utils import mrc
    from test_train import PARTICLE, make_micrograph
    from torch_port_common import flat_tree
    from torch_train_common import jax_dropout_mask

    shutil.rmtree(TRAINING_DIR, ignore_errors=True)
    os.makedirs(TRAINING_DIR)
    dirs = write_training_fixture(tmp)
    train = jdata.load_dataset(*dirs["train"], PARTICLE)
    val = jdata.load_dataset(*dirs["val"], PARTICLE)

    model = PickerCNN()
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 64, 64, 1)))["params"]
    batch = jnp.asarray(train[0][:STEP_BATCH])
    labels = jnp.asarray(train[1][:STEP_BATCH])
    key = jax.random.PRNGKey(STEP_KEY)
    mask = jax_dropout_mask(model, params, batch, key)
    schedule = optax.exponential_decay(0.01, 8, 0.95, staircase=True)
    tx = optax.sgd(schedule, momentum=0.9)
    updated, opt_state, loss, logits = _make_update_step(model, tx)(
        params, tx.init(params), batch, labels, key)
    lrs = {}
    for ds in LR_DECAY_STEPS:
        sched = optax.exponential_decay(0.01, ds, 0.95, staircase=True)
        lrs[f"lr/{ds}"] = np.array(
            [np.asarray(sched(c)) for c in lr_counts(ds)], np.float32)
    np.savez_compressed(
        os.path.join(TRAINING_DIR, "step.npz"),
        batch=np.asarray(batch), labels=np.asarray(labels), mask=mask,
        loss=np.asarray(loss), logits=np.asarray(logits),
        lr=np.asarray(schedule(0)),
        **flat_tree(params, "params/"), **flat_tree(updated, "updated/"),
        **flat_tree(opt_state[0].trace, "trace/"), **lrs,
    )

    result = fit(*train, *val, TrainConfig(batch_size=16, max_epochs=6,
                                           verbose=False))
    ckpt = os.path.join(TRAINING_DIR, "fit.ckpt")
    save_checkpoint(ckpt, result.params, {
        "particle_size": PARTICLE, "patch_norm": "reference",
        "arch": "deep", "best_val_error": result.best_val_error,
        "epochs": result.epochs_run, "seed": 1234,
    })
    mrc_dir = os.path.join(tmp, "held_out")
    os.makedirs(mrc_dir)
    img, _ = make_micrograph(np.random.default_rng(HELD_OUT_SEED))
    mrc.write_mrc(os.path.join(mrc_dir, "held_out.mrc"), img)
    out = os.path.join(tmp, "picks")
    jax_cli(["pick", ckpt, mrc_dir, out])
    os.makedirs(os.path.join(TRAINING_DIR, "picks"))
    shutil.copy(os.path.join(out, "held_out.box"),
                os.path.join(TRAINING_DIR, "picks"))
    print("training goldens: best val error", result.best_val_error,
          flush=True)


def make_utilities_digests(tmp: str) -> dict:
    from repic_tpu.main import main as jax_cli
    from repic_tpu_torch.utils.synthetic import (
        output_digests,
        subsets_membership,
        write_subsets_fixture,
    )

    convert = {}
    for picker in sorted(os.listdir(EXAMPLES)):
        for in_fmt, out_fmt in CONVERT_CHAINS:
            src = (os.path.join(EXAMPLES, picker) if in_fmt == "box" else
                   os.path.join(tmp, picker, f"box_{in_fmt}"))
            files = sorted(os.path.join(src, f) for f in os.listdir(src)
                           if f.endswith("." + in_fmt))
            out = os.path.join(tmp, picker, f"{in_fmt}_{out_fmt}")
            jax_cli(["convert", *files, out, "-f", in_fmt, "-t", out_fmt,
                     "-b", str(BOX_SIZE), "--quiet"])
            convert[f"{picker}/{in_fmt}_{out_fmt}"] = output_digests(
                out, ("." + out_fmt,))
    subsets = {}
    for label, flags in (("default", []), ("ignore_test", ["--ignore_test"])):
        root = os.path.join(tmp, "subsets_" + label)
        defocus, box_dir, mrc_dir = write_subsets_fixture(root)
        out = os.path.join(root, "out")
        jax_cli(["build_subsets", defocus, box_dir, mrc_dir, out, *flags])
        subsets[label] = subsets_membership(out)
    return {"convert": convert, "build_subsets": subsets}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only",
                    choices=["flags", "runtime", "telemetry", "serve",
                             "picker", "utilities", "training"])
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    if args.only in (None, "utilities"):
        with tempfile.TemporaryDirectory() as tmp:
            write_json(UTILITIES_DIGESTS, make_utilities_digests(tmp))
    if args.only in (None, "training"):
        with tempfile.TemporaryDirectory() as tmp:
            make_training_goldens(tmp)
    if args.only in (None, "picker"):
        with tempfile.TemporaryDirectory() as tmp:
            make_picker_goldens(tmp)
    if args.only in (None, "serve"):
        with tempfile.TemporaryDirectory() as tmp:
            write_json(SERVE_DIGESTS, make_serve_digests(tmp))
    if args.only in (None, "telemetry"):
        with tempfile.TemporaryDirectory() as tmp:
            write_json(TELEMETRY_DIGESTS, make_telemetry_digests(tmp))
    if args.only in (None, "runtime"):
        with tempfile.TemporaryDirectory() as tmp:
            write_json(RUNTIME_DIGESTS, make_runtime_digests(tmp))
    if args.only in (None, "flags"):
        with tempfile.TemporaryDirectory() as tmp:
            write_json(FLAGS_DIGESTS, make_flag_digests(tmp))
    if args.only is not None:
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        write_json(DIGESTS, make_digests(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        for setting in SETTINGS:
            out = os.path.join(tmp, setting)
            run_jax(setting, out)
            dest = os.path.join(GOLDEN_DIR, setting)
            shutil.rmtree(dest, ignore_errors=True)
            os.makedirs(dest)
            for f in sorted(os.listdir(out)):
                if f.endswith(".box"):
                    shutil.copy(os.path.join(out, f), dest)
            print(setting, len(os.listdir(dest)), "files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
