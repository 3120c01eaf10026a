"""The port's directory consensus against the JAX package's, end to end.

* BOX bytes: ``repic_tpu_torch``'s ``run_consensus_dir`` on the CPU
  writes the same files, byte for byte, as ``repic_tpu``'s
  ``run_consensus_dir(use_mesh=False)`` on ``examples/10017`` and on
  ``tests/fixtures/mini10017``, for ``lp_device``, ``lp_device`` with
  the fused neighbour search, ``lp_device_fused`` and ``greedy``.
* The committed goldens (``tests/golden/torch_port_10017``, which
  ``chip_smoke.py`` holds the card's output to) equal a live JAX run.
* Importing the port pulls in neither ``jax`` nor any ``repic_tpu``
  module (nor ``flax``, ``pandas`` or ``msgpack``); no file of the
  port, ``chip_smoke.py`` or the card-only tests imports them.
* The CLI runs on ``cuda`` by default and fails where there is none.
* Every test that needs the card carries the ``cuda`` marker and
  takes the fixture that skips it here.
"""

import ast
import filecmp
import glob
import json
import os
import subprocess
import sys

import pytest
import torch

from repic_tpu_torch.pipeline import consensus as tcons
from tests.golden.make_torch_port_golden import run_jax
from torch_port_common import GOLDEN_DIR, SETTINGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = {
    "10017": os.path.join(REPO, "examples", "10017"),
    "mini10017": os.path.join(REPO, "tests", "fixtures", "mini10017"),
}
BOX = 180


def _boxes(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".box"))


def _assert_same_boxes(got_dir, want_dir):
    want = _boxes(want_dir)
    assert want and _boxes(got_dir) == want
    diff = [f for f in want if not filecmp.cmp(
        os.path.join(got_dir, f), os.path.join(want_dir, f), shallow=False)]
    assert not diff, f"BOX files differ: {diff}"


@pytest.fixture(scope="module")
def jax_outputs(tmp_path_factory):
    """The JAX package's BOX output per (dataset, setting), run once."""
    root = tmp_path_factory.mktemp("jax_consensus")
    out = {}
    for data, in_dir in DATASETS.items():
        for setting in SETTINGS:
            d = str(root / f"{data}_{setting}")
            run_jax(setting, d, in_dir=in_dir, box_size=BOX)
            out[data, setting] = d
    return out


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("data", list(DATASETS))
def test_box_bytes_match_jax(jax_outputs, tmp_path, data, setting):
    solver, pallas = SETTINGS[setting]
    stats = tcons.run_consensus_dir(
        DATASETS[data], str(tmp_path), BOX,
        solver=solver, use_pallas=pallas, device="cpu",
    )
    assert stats["device"] == "cpu" and stats["num_cliques"] > 0
    _assert_same_boxes(str(tmp_path), jax_outputs[data, setting])


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_committed_goldens_match_live_jax(jax_outputs, setting):
    _assert_same_boxes(os.path.join(GOLDEN_DIR, setting),
                       jax_outputs["10017", setting])


def test_missing_micrograph_gets_empty_box(tmp_path):
    """A micrograph absent from one picker gets an empty BOX file."""
    src = DATASETS["mini10017"]
    in_dir = tmp_path / "in"
    for picker in sorted(os.listdir(src)):
        os.makedirs(in_dir / picker)
        for f in _boxes(os.path.join(src, picker)):
            with open(os.path.join(src, picker, f)) as fh:
                (in_dir / picker / f).write_text(fh.read())
    pickers = sorted(os.listdir(in_dir))
    first, last = pickers[0], pickers[-1]
    dropped = _boxes(in_dir / last)[0]
    os.remove(in_dir / last / dropped)
    out = tmp_path / "out"
    stats = tcons.run_consensus_dir(str(in_dir), str(out), BOX,
                                    device="cpu")
    assert stats["skipped"] == [dropped[: -len(".box")]]
    assert (out / dropped).read_text() == ""
    assert len(_boxes(out)) == len(_boxes(os.path.join(src, first)))


def test_import_pulls_in_no_jax():
    # only what the port's own imports add counts: the interpreter's
    # site hooks run before it
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import repic_tpu_torch\n"
        "for m in pkgutil.walk_packages(repic_tpu_torch.__path__,"
        " 'repic_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "assert {'repic_tpu_torch.pipeline.consensus',"
        " 'repic_tpu_torch.ops.spatial',"
        " 'repic_tpu_torch.utils.synthetic',"
        " 'repic_tpu_torch.pipeline.giant',"
        " 'repic_tpu_torch.ops.components',"
        " 'repic_tpu_torch.runtime.ladder',"
        " 'repic_tpu_torch.native',"
        " 'repic_tpu_torch.commands.get_cliques',"
        " 'repic_tpu_torch.commands.run_ilp',"
        " 'repic_tpu_torch.telemetry',"
        " 'repic_tpu_torch.telemetry.metrics',"
        " 'repic_tpu_torch.telemetry.events',"
        " 'repic_tpu_torch.telemetry.probes',"
        " 'repic_tpu_torch.telemetry.sinks',"
        " 'repic_tpu_torch.telemetry.trace',"
        " 'repic_tpu_torch.telemetry.devicetime',"
        " 'repic_tpu_torch.telemetry.report',"
        " 'repic_tpu_torch.telemetry.server',"
        " 'repic_tpu_torch.commands._observability',"
        " 'repic_tpu_torch.commands.report',"
        " 'repic_tpu_torch.commands.trace',"
        " 'repic_tpu_torch.runtime.compilecache',"
        " 'repic_tpu_torch.pipeline.engine',"
        " 'repic_tpu_torch.serve',"
        " 'repic_tpu_torch.serve.tenancy',"
        " 'repic_tpu_torch.serve.autoscale',"
        " 'repic_tpu_torch.serve.jobs',"
        " 'repic_tpu_torch.serve.batcher',"
        " 'repic_tpu_torch.serve.daemon',"
        " 'repic_tpu_torch.commands.serve',"
        " 'repic_tpu_torch.utils.mrc',"
        " 'repic_tpu_torch.models',"
        " 'repic_tpu_torch.models.cnn',"
        " 'repic_tpu_torch.models.checkpoint',"
        " 'repic_tpu_torch.models.preprocess',"
        " 'repic_tpu_torch.models.infer',"
        " 'repic_tpu_torch.ops.nms',"
        " 'repic_tpu_torch.commands.pick',"
        " 'repic_tpu_torch.utils.table',"
        " 'repic_tpu_torch.utils.coords',"
        " 'repic_tpu_torch.utils.matching',"
        " 'repic_tpu_torch.utils.scoring',"
        " 'repic_tpu_torch.utils.subsets',"
        " 'repic_tpu_torch.commands.get_examples',"
        " 'repic_tpu_torch.models.data',"
        " 'repic_tpu_torch.models.train',"
        " 'repic_tpu_torch.commands.fit',"
        " 'repic_tpu_torch.pipeline.pickers',"
        " 'repic_tpu_torch.pipeline.iterative',"
        " 'repic_tpu_torch.commands.iter_config',"
        " 'repic_tpu_torch.commands.iter_pick',"
        " 'repic_tpu_torch.parallel.gang',"
        " 'repic_tpu_torch.analysis',"
        " 'repic_tpu_torch.analysis.contracts',"
        " 'repic_tpu_torch.analysis.kernels',"
        " 'repic_tpu_torch.analysis.kernelcheck',"
        " 'repic_tpu_torch.analysis.dispatchcheck',"
        " 'repic_tpu_torch.analysis.lockcheck',"
        " 'repic_tpu_torch.analysis.engine',"
        " 'repic_tpu_torch.analysis.rules',"
        " 'repic_tpu_torch.analysis.concurrency',"
        " 'repic_tpu_torch.analysis.spmd',"
        " 'repic_tpu_torch.analysis.cost',"
        " 'repic_tpu_torch.analysis.semantic',"
        " 'repic_tpu_torch.analysis.sarif',"
        " 'repic_tpu_torch.analysis.cli',"
        " 'repic_tpu_torch.analysis.check_cli'} <= new\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repic_tpu', 'flax', 'optax', 'pandas',"
        " 'msgpack'))\n"
        "print(len(bad), bad[:5])\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # built libraries land under build/, never inside the package
    built = [f for f in glob.glob(os.path.join(REPO, "repic_tpu_torch", "**",
                                               "*"), recursive=True)
             if f.endswith((".so", ".o", ".tmp"))]
    assert not built, built


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


#: what no file of the port (nor chip_smoke.py) may import: JAX, the JAX
#: package, and the libraries the card machine does not have
FORBIDDEN = ("jax", "jaxlib", "repic_tpu", "flax", "optax", "pandas",
             "msgpack")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(REPO, "repic_tpu_torch", "**", "*.py"),
                      recursive=True)
    # the modules of the lp/exact rungs, the tables, the striped path,
    # the two-phase commands, the native cores and the telemetry layer
    # are among them, and so are the engine and the serve stack
    for mod in ("ops/solver.py", "ops/components.py", "runtime/ladder.py",
                "pipeline/giant.py", "native/__init__.py",
                "commands/get_cliques.py", "commands/run_ilp.py",
                "telemetry/__init__.py", "telemetry/metrics.py",
                "telemetry/events.py", "telemetry/probes.py",
                "telemetry/sinks.py", "telemetry/trace.py",
                "telemetry/devicetime.py", "telemetry/report.py",
                "telemetry/server.py", "commands/_observability.py",
                "commands/report.py", "commands/trace.py",
                "runtime/compilecache.py", "pipeline/engine.py",
                "serve/__init__.py", "serve/tenancy.py",
                "serve/autoscale.py", "serve/jobs.py", "serve/batcher.py",
                "serve/daemon.py", "commands/serve.py",
                # the CNN picker's inference path and the host utilities
                "utils/mrc.py", "models/__init__.py", "models/cnn.py",
                "models/checkpoint.py", "models/preprocess.py",
                "models/infer.py", "ops/nms.py", "commands/pick.py",
                "utils/table.py", "utils/coords.py", "utils/matching.py",
                "utils/scoring.py", "utils/subsets.py",
                "commands/get_examples.py",
                # the training half and the iterative loop
                "models/data.py", "models/train.py", "commands/fit.py",
                "pipeline/pickers.py", "pipeline/iterative.py",
                "commands/iter_config.py", "commands/iter_pick.py",
                # the cluster runtime, the mesh and process group, the
                # serving fleet and its supervisor
                "runtime/__init__.py", "runtime/cluster.py",
                "runtime/journal.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/distributed.py",
                "pipeline/__init__.py", "solver/__init__.py",
                "ops/__init__.py", "serve/fleet.py", "commands/fleet.py",
                "commands/consensus.py",
                # the gang and the runtime sanitizers
                "parallel/gang.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/contracts.py",
                "analysis/kernels.py", "analysis/kernelcheck.py",
                "analysis/dispatchcheck.py", "analysis/lockcheck.py",
                # the static analysis layer
                "analysis/engine.py", "analysis/rules.py",
                "analysis/concurrency.py", "analysis/spmd.py",
                "analysis/cost.py", "analysis/semantic.py",
                "analysis/sarif.py", "analysis/cli.py",
                "analysis/check_cli.py"):
        assert os.path.join(REPO, "repic_tpu_torch", mod) in files, mod
    # chip_smoke.py and the card-only tests run where there is no JAX
    files += [os.path.join(REPO, f) for f in (
        "chip_smoke.py", "tests/test_torch_cuda.py",
        "tests/torch_port_common.py", "tests/torch_serve_common.py",
        "tests/torch_cluster_worker.py", "tests/torch_gang_worker.py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (
                f"{os.path.relpath(path, REPO)} imports {mod}"
            )


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", *args], cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )


def test_cli_defaults_to_cuda_and_fails_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    proc = _cli("consensus", DATASETS["mini10017"], str(tmp_path / "o"),
                str(BOX))
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    with pytest.raises(RuntimeError, match="CUDA"):
        tcons.run_consensus_dir(DATASETS["mini10017"], str(tmp_path / "p"),
                                BOX)


def test_cli_on_cpu_matches_jax(jax_outputs, tmp_path):
    out = tmp_path / "o"
    proc = _cli("consensus", DATASETS["mini10017"], str(out), str(BOX),
                "--solver", "lp_device_fused", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    # on the CPU every wrapper runs its plain version: no launches
    assert stats["launches"] == {"topk_neighbors": 0,
                                 "fused_clique_candidates": 0,
                                 "fused_dual_solve": 0,
                                 "dual_ascent": 0}
    assert stats["demotions"] == 0
    _assert_same_boxes(str(out), jax_outputs["mini10017", "lp_device_fused"])


def test_unported_solver_raises(tmp_path):
    """Every solver of the reference is ported; a name that is none of
    them raises before anything is deleted."""
    assert tcons.SOLVERS == ("greedy", "lp", "lp_device",
                             "lp_device_fused", "exact")
    out = tmp_path / "o"
    out.mkdir()
    with pytest.raises(ValueError, match="unknown solver 'gurobi'"):
        tcons.run_consensus_dir(DATASETS["mini10017"], str(out), BOX,
                                solver="gurobi", device="cpu")
    assert out.exists()


def test_cuda_tests_are_marked():
    """A test that takes the ``cuda_device`` fixture carries the
    ``cuda`` marker, and the other way round."""
    seen = 0
    for path in glob.glob(os.path.join(REPO, "tests", "test_torch_*.py")):
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for fn in tree.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name.startswith("test_")):
                continue
            marked = any(
                ast.unparse(d) == "pytest.mark.cuda"
                for d in fn.decorator_list
            )
            takes = "cuda_device" in [a.arg for a in fn.args.args]
            assert marked == takes, f"{path}::{fn.name}"
            seen += marked
    assert seen >= 4
