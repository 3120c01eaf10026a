"""One host of the port's simulated multi-host cluster tests
(``tests/test_torch_cluster_multihost.py``): ``run_consensus_dir`` on
the CPU in cluster mode, as ``tests/cluster_worker.py`` is for the JAX
package.  All workers share the input and output directories; identity
and fault plans come from the environment (``REPIC_TPU_HOST_ID`` /
``_HOST_RANK`` / ``_NUM_HOSTS``, ``REPIC_TPU_FAULTS``).  ``--barrier
FILE`` holds the start until FILE exists, after writing
``<FILE>.ready.<rank>``, so that import times do not decide who leases
what.  Imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import sys
import time


def main():
    p = argparse.ArgumentParser()
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("box_size", type=int)
    p.add_argument("--heartbeat-interval", type=float, default=0.2)
    p.add_argument("--host-timeout", type=float, default=1.5)
    p.add_argument("--takeover-wait", type=float, default=None)
    p.add_argument("--barrier", default=None)
    args = p.parse_args()
    # one micrograph per chunk: fine-grained crash points and records
    os.environ.setdefault("REPIC_CONSENSUS_CHUNK", "1")

    from repic_tpu_torch.pipeline.consensus import run_consensus_dir
    from repic_tpu_torch.runtime import faults
    from repic_tpu_torch.runtime.cluster import ClusterConfig

    faults.install_from_env()
    rank = int(os.environ.get("REPIC_TPU_HOST_RANK", "0"))
    if args.barrier:
        with open(f"{args.barrier}.ready.{rank}", "w") as f:
            f.write(str(os.getpid()))
        deadline = time.time() + 120.0
        while not os.path.exists(args.barrier):
            if time.time() > deadline:
                print("barrier timeout", file=sys.stderr)
                return 2
            time.sleep(0.02)
    cfg = ClusterConfig(
        coordination_dir=args.out_dir,
        heartbeat_interval_s=args.heartbeat_interval,
        host_timeout_s=args.host_timeout,
        takeover_wait_s=args.takeover_wait,
    )
    stats = run_consensus_dir(args.in_dir, args.out_dir, args.box_size,
                              device="cpu", use_mesh=False, cluster=cfg)
    host = stats["cluster"]["host"]
    with open(os.path.join(args.out_dir, f"stats.{host}.json"), "w") as f:
        json.dump(stats, f, default=str)
    print(json.dumps(stats["journal"], default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
