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

The card machine has no JAX, so ``chip_smoke.py`` compares the port's
output with these files; ``tests/test_torch_consensus.py`` holds them
equal to a live JAX run.  Run from the repository root:

    JAX_PLATFORMS=cpu python tests/golden/make_torch_port_golden.py
"""

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


def main() -> int:
    sys.path.insert(0, REPO)
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
