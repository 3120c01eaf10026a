"""One process of the port's gang chaos test
(``tests/test_torch_gang_chaos.py``), as ``tests/gang_worker.py`` is
for the JAX package: ``run_consensus_dir`` on the CPU in gang mode.

Launched N times with torchrun's environment (``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``) plus the cluster identity
(``REPIC_TPU_HOST_ID`` / ``REPIC_TPU_HOST_RANK`` /
``REPIC_TPU_NUM_HOSTS``).  All processes run ONE gang-scheduled
directory run over the same input and output directories; the
victim's environment plants ``gang_peer_crash``, so it dies through
``os._exit(GANG_CRASH_EXIT_CODE)`` right as a chunk's collective
starts.  Survivors classify the gang fault, re-form a smaller gang,
resume from the merged journals and exit 0 with every output on disk.
Imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import sys


def main():
    p = argparse.ArgumentParser()
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("box_size", type=int)
    p.add_argument("--heartbeat-interval", type=float, default=0.2)
    p.add_argument("--host-timeout", type=float, default=2.0)
    # a floor above the reference worker's 1 s: under a loaded test
    # session a healthy chunk must not read as a stall (a dead peer is
    # found by its heartbeat, 2 s, whatever the floor)
    p.add_argument("--watchdog-floor", type=float, default=5.0)
    p.add_argument("--first-deadline", type=float, default=120.0)
    p.add_argument("--reform-timeout", type=float, default=60.0)
    p.add_argument("--device", default="cpu")
    args = p.parse_args()
    os.environ.setdefault("REPIC_TPU_NO_CONFIG_CACHE", "1")
    # small chunks: the crash happens with real work remaining, so
    # re-formation has something to resume
    os.environ.setdefault("REPIC_CONSENSUS_CHUNK", "3")

    from repic_tpu_torch.runtime import faults

    faults.install_from_env()

    from repic_tpu_torch.parallel.gang import GangConfig
    from repic_tpu_torch.pipeline.consensus import run_consensus_dir
    from repic_tpu_torch.runtime.cluster import ClusterConfig

    cluster = ClusterConfig(
        coordination_dir=args.out_dir,
        heartbeat_interval_s=args.heartbeat_interval,
        host_timeout_s=args.host_timeout,
    )
    gang = GangConfig(
        watchdog_factor=3.0,
        watchdog_floor_s=args.watchdog_floor,
        first_deadline_s=args.first_deadline,
        max_extensions=2,   # the default; the reference's worker has 1
        reform_timeout_s=args.reform_timeout,
        host_timeout_s=args.host_timeout,
    )
    stats = run_consensus_dir(
        args.in_dir,
        args.out_dir,
        args.box_size,
        cluster=cluster,
        gang=gang,
        device=args.device,
    )
    host = stats["cluster"]["host"]
    with open(os.path.join(args.out_dir, f"stats.{host}.json"), "w") as f:
        json.dump(stats, f, default=str)
    print(json.dumps({"journal": stats["journal"], "gang": stats["gang"]},
                     default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
