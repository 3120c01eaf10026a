"""No module that a run loads is JAX's or the JAX package's, compared by
whole top-level name; the references import nothing of the program."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PB = os.path.join(ROOT, "portbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repic_tpu"}


def _sources():
    for d, _, files in os.walk(PB):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        bad = set(_imported(path)) & (FORBIDDEN | {"bench", "chip_smoke"})
        assert not bad, (path, bad)


def test_whole_top_level_names():
    from portbench import run

    assert run.forbidden_modules(
        ["repic_tpu_torch", "repic_tpu_torch.ops", "jaxtyping"]) == []
    assert run.forbidden_modules(
        ["repic_tpu_torch", "repic_tpu.ops.iou", "jax.numpy"]) == [
            "jax", "repic_tpu"]


def test_a_run_loads_no_forbidden_module():
    """Every module of the benchmark and what its drivers import from
    the program, loaded in one fresh process."""
    code = r"""
from portbench import run
import portbench.kinds.consensus, portbench.kinds.pick
import portbench.reference.consensus, portbench.reference.picker
import portbench.compare, portbench.trace, portbench.work
import portbench.readings
man = run.load_manifest()
for m in man["end_to_end"] + man["per_layer"]:
    run.load_reader(m["name"])
import repic_tpu_torch.pipeline.consensus, repic_tpu_torch.models.infer
import repic_tpu_torch.parallel.batching
bad = run.forbidden_modules()
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_references_import_nothing_of_the_program():
    code = ("import sys\n"
            "import portbench.reference.consensus\n"
            "import portbench.reference.picker\n"
            "import portbench.compare, portbench.synth, portbench.work\n"
            "bad = [m for m in sys.modules\n"
            "       if m.split('.')[0] in ('repic_tpu_torch', 'repic_tpu',\n"
            "                              'jax', 'flax')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
