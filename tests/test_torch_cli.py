"""The port's ``consensus`` command with the runtime's flags.

* ``consensus_runtime.tsv`` (``tests/test_cli.py::
  test_fused_consensus_writes_runtime_tsv``): ``load``, ``compute`` and
  ``write`` rows, on the batched and the striped path.
* ``--no_mesh`` runs (a no-op on one card) and writes the bytes of the
  run without it.
* ``REPIC_TPU_FAULTS``, ``--retries``, ``--resume`` through the CLI give
  the reference's files; ``--strict`` exits non-zero and names the bad
  file.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from repic_tpu_torch import main as cli
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.runtime import faults as tfaults
from repic_tpu_torch.telemetry import metrics as tmetrics
from torch_port_common import corrupt_box, write_box_dir
from torch_runtime_common import assert_same_run, run_jax_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "tests", "fixtures", "mini10017")


def _cli(capsys, *argv, telemetry=False):
    """``python -m repic_tpu_torch consensus ...`` on the CPU, in this
    process, the memo cleared as a new process has it, telemetry off
    (as :func:`run_jax_dir` runs the reference) unless asked; the
    stats."""
    tcons._LAST_GOOD_CONFIG.clear()
    tcons._RECENT_REQUIREMENTS.clear()
    was = tmetrics.enabled()
    tmetrics.set_enabled(telemetry)
    try:
        assert cli.main(["consensus", *map(str, argv), "--device", "cpu"]) == 0
    finally:
        tmetrics.set_enabled(was)
        tfaults.clear()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _stages(out):
    with open(os.path.join(out, "consensus_runtime.tsv")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert all(float(s) >= 0 for _, s in rows)
    return [label for label, _ in rows]


@pytest.mark.parametrize("extra", [[], ["--solver", "lp_device_fused"],
                                   ["--stripes", "2"]])
def test_consensus_writes_runtime_tsv(tmp_path, capsys, extra):
    data = write_box_dir(tmp_path, m=2)
    out = tmp_path / "out"
    _cli(capsys, data, out, 64, "--no_mesh", *extra)
    assert _stages(str(out)) == ["load", "compute", "write"]


def _boxes(out):
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out)) if f.endswith(".box")}


def test_no_mesh_writes_the_same_bytes(tmp_path, capsys):
    """Formerly refused with an argparse error (exit 2)."""
    a = _cli(capsys, MINI, tmp_path / "a", 180)
    b = _cli(capsys, MINI, tmp_path / "b", 180, "--no_mesh")
    assert _boxes(tmp_path / "a") == _boxes(tmp_path / "b")
    assert a["particle_counts"] == b["particle_counts"]


def test_faults_env_retries_and_resume_match_reference(tmp_path, capsys,
                                                       monkeypatch):
    """A plan from ``REPIC_TPU_FAULTS`` with ``--retries 0``: the
    transient chunk failure falls straight to the per-micrograph rung;
    a corrupt file is quarantined; ``--resume`` after the repair
    processes it alone.  Each step's files equal the reference's."""
    data = write_box_dir(tmp_path, m=4)
    bad = corrupt_box(data, "mic1", "picker2")
    out, j_out = tmp_path / "out", str(tmp_path / "jax")
    monkeypatch.setenv("REPIC_TPU_FAULTS", "io:chunk:1")
    stats = _cli(capsys, data, out, 64, "--retries", "0")
    j_stats, _ = run_jax_dir(data, j_out, 64, plan=("io:chunk:1",),
                             policy={"max_retries": 0})
    assert_same_run((str(out), stats), (j_out, j_stats))
    assert list(stats["quarantined"]) == ["mic1"]
    assert stats["journal"] == {"quarantined": 1, "degraded": 3}
    monkeypatch.delenv("REPIC_TPU_FAULTS")
    shutil.copy(os.path.join(data, "picker0", "mic1.box"), bad)
    stats = _cli(capsys, data, out, 64, "--resume")
    j_stats, _ = run_jax_dir(data, j_out, 64, resume=True)
    assert_same_run((str(out), stats), (j_out, j_stats))
    assert stats["resumed"] == 3 and list(stats["particle_counts"]) == ["mic1"]


def test_strict_exits_nonzero_naming_the_file(tmp_path):
    data = write_box_dir(tmp_path, m=2)
    bad = corrupt_box(data, "mic0", "picker1")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "consensus", data,
         str(tmp_path / "out"), "64", "--strict", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "BoxParseError" in proc.stderr and bad in proc.stderr
    # lenient, the same input completes
    proc = subprocess.run(
        [sys.executable, "-m", "repic_tpu_torch", "consensus", data,
         str(tmp_path / "out2"), "64", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["quarantined"]["mic0"]["path"] == bad
    assert len(stats["particle_counts"]) == 1
