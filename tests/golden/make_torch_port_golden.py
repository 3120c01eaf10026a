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

``--only flags`` / ``--only runtime`` / ``--only telemetry`` /
``--only serve`` rewrite only that file.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only",
                    choices=["flags", "runtime", "telemetry", "serve"])
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
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
