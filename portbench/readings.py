"""The readings that the limits of ``correct`` are set from.

    python3 -m portbench.readings --workload <cell> --seeds 1,2,3 \\
        [--control]

For each seed, in one process: the cell's set-up, one more pass over
its inputs through the timed path, then the numbers the run
compares (the program against the reference) and, with ``--control``,
the control's numbers (the reference in bfloat16 put in the program's
place, or the program's own bfloat16 path where it has one).  One JSON
line per seed.  Runs on the card at the cell's own size; it is not part
of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    os.environ["REPIC_TPU_NO_CONFIG_CACHE"] = "1"
    from portbench import run

    spec = run.resolve(run.load_manifest(), args.workload)
    kind = run.kind_module(spec["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = kind.Cell(spec["config"], spec["traffic"], seed, "cuda")
        cell.setup()
        for _ in range(len(getattr(cell, "chunks", None) or cell.images)):
            cell.step()
        cell.release()
        line = {"workload": args.workload, "seed": seed,
                "program": cell.numbers()}
        if args.control:
            line["control"] = cell.control_numbers()
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
    return 0


if __name__ == "__main__":
    sys.exit(main())
