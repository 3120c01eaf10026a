"""The fault-tolerant consensus runtime (the port of
``repic_tpu.runtime``):

* :mod:`~repic_tpu_torch.runtime.journal` -- the JSONL run journal and
  manifest behind ``--resume`` (per-host journals merged on read in
  cluster mode);
* :mod:`~repic_tpu_torch.runtime.ladder` -- the retry and degradation
  ladders and the host liveness rung;
* :mod:`~repic_tpu_torch.runtime.cluster` -- heartbeats, leases,
  fences and the reassignment of a lost host's work;
* :mod:`~repic_tpu_torch.runtime.faults` -- deterministic fault
  injection (``REPIC_TPU_FAULTS``);
* :mod:`~repic_tpu_torch.runtime.atomic` -- crash-safe writes, file
  locks and create-once claims.

Importing this package imports only the stdlib (torch and numpy load
inside the functions that use them), so host-only commands start
without torch.
"""

from repic_tpu_torch.runtime.atomic import atomic_write, file_lock
from repic_tpu_torch.runtime.cluster import ClusterConfig, ClusterContext
from repic_tpu_torch.runtime.journal import (
    RunJournal,
    error_info,
    merged_latest,
    read_all_journals,
    read_journal,
)
from repic_tpu_torch.runtime.ladder import (
    DEFAULT_POLICY,
    ChunkOutcomes,
    RetryPolicy,
    classify_error,
    host_rung,
    is_oom_error,
    solve_host_ladder,
)

__all__ = [
    "atomic_write",
    "file_lock",
    "ClusterConfig",
    "ClusterContext",
    "RunJournal",
    "error_info",
    "merged_latest",
    "read_all_journals",
    "read_journal",
    "DEFAULT_POLICY",
    "ChunkOutcomes",
    "RetryPolicy",
    "classify_error",
    "host_rung",
    "is_oom_error",
    "solve_host_ladder",
]
