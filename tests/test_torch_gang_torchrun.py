"""The gang as its users launch it: ``torchrun`` over three processes.

``python -m torch.distributed.run --nproc-per-node 3 -m repic_tpu_torch
consensus IN OUT 180 --gang --device cpu`` forms one gloo gang on the
CPU.  The agent of that launch hosts its own store at ``MASTER_PORT``,
so the gang's first epoch joins that store instead of hosting one
there.  Every BOX file must equal, byte for byte, the JAX package's
single-host run of the same directory, and each process must journal
its own share of the micrographs, once, at the launch's epoch.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import pytest

from torch_runtime_common import run_jax_dir
from torch_twin import REPO

pytestmark = pytest.mark.faults

WORLD = 3
IN_DIR = os.path.join(REPO, "examples", "10017")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_torchrun_gang_equals_jax_single_host(tmp_path):
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO, REPIC_TPU_NO_CONFIG_CACHE="1",
               # two chunks per process: the collectives run twice
               REPIC_CONSENSUS_CHUNK="6")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc-per-node", str(WORLD), "--master-addr", "127.0.0.1",
         "--master-port", str(_free_port()),
         # each rank's result line to a file of its own
         "--log-dir", str(tmp_path / "logs"), "--redirects", "1",
         "-m", "repic_tpu_torch", "consensus", IN_DIR, str(out), "180",
         "--gang", "--device", "cpu", "--gang-reform-timeout", "30"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = []
    for path in glob.glob(str(tmp_path / "logs" / "**" / "stdout.log"),
                          recursive=True):
        with open(path) as f:
            stats += [json.loads(line) for line in f
                      if line.startswith("{")]
    assert sorted(s["gang"]["rank"] for s in stats) == list(range(WORLD))
    for s in stats:
        assert s["gang"]["world"] == WORLD and s["gang"]["mode"] == "gang"
        assert s["gang"]["faults"] == 0 and s["gang"]["epoch"] == 1
    # each micrograph journaled once, by one process, at epoch 1
    seen = []
    for path in glob.glob(str(out / "_journal.*.jsonl")):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("status") == "ok":
                    assert rec["gang_epoch"] == 1
                    seen.append(rec["name"])
    ref = str(tmp_path / "jax_single")
    run_jax_dir(IN_DIR, ref, 180)
    boxes = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(ref, "*.box")))
    assert sorted(seen) == sorted(b[:-len(".box")] for b in boxes)
    assert boxes == sorted(os.path.basename(p)
                           for p in glob.glob(str(out / "*.box")))
    for f in boxes:
        with open(os.path.join(ref, f), "rb") as a, \
                open(str(out / f), "rb") as b:
            assert a.read() == b.read(), f
