"""Time the port's directory runs in one checkout on the card, for an
A/B of two commits on the same machine.

    python3 scripts/torch_ab_dir_runs.py TREE [RUNS]

``TREE`` is a checkout of the repository (the parent commit unpacked
with ``git archive`` under ``build/``, say).  The script builds that
tree's kernels, writes ``synthetic_256`` once (shared by every tree, as
``chip_smoke.py --passes`` does), runs ``lp_device_fused`` over it
``RUNS`` times (default 17: one cold run, then warm ones), and prints
one JSON line: each run's wall, ``load_s``, ``compute_s`` and
``write_s``, and the warm runs' medians.  Run the trees in turns on one
machine (parent, new, new, parent, ...): the host's speed differs
between machines and over time.  Imports nothing of JAX.
"""

import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 17
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    sys.path.insert(0, tree)
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    from repic_tpu_torch import _build
    from repic_tpu_torch.pipeline import consensus
    from repic_tpu_torch.utils.synthetic import write_synthetic_dir

    if not consensus.__file__.startswith(tree):
        raise AssertionError(f"imported {consensus.__file__}, not {tree}")
    t0 = time.time()
    _build.build_all()
    build_s = time.time() - t0
    synth = os.path.join(cs.AB_INPUTS, "synthetic_in")
    if not os.path.exists(synth + ".done"):
        write_synthetic_dir(synth, n_micrographs=cs.N_SYNTH, seed=0)
        open(synth + ".done", "w").close()
    out = os.path.join(cs.AB_INPUTS, "out")
    keys = ("wall_s", "load_s", "compute_s", "write_s")
    timed = []
    cs.clear_memo()
    for _ in range(runs):
        st, wall, _ = cs.run_dir(synth, out, cs.BOX,
                                 solver="lp_device_fused")
        timed.append({"wall_s": wall, **{k: st[k] for k in keys[1:]}})
    warm = timed[1:]
    print(json.dumps({
        "tree": tree, "card": cs.smi(), "build_s": build_s,
        "cold": timed[0], "warm": warm,
        "median": {k: statistics.median(r[k] for r in warm) for k in keys},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
