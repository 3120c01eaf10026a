"""Consensus as a service (the port of ``repic_tpu.serve``).

A long-lived daemon in front of the consensus engine
(:mod:`repic_tpu_torch.pipeline.engine`): admission control with 429 +
``Retry-After``, per-request deadlines, request isolation, a circuit
breaker, graceful drain, a crash-safe request journal, the continuous
batcher, tenancy and the brownout policy.  ``python -m repic_tpu_torch
serve WORK_DIR`` starts it (:mod:`repic_tpu_torch.commands.serve`);
``--fleet-dir`` makes it one replica of a fleet over a shared durable
queue (:mod:`repic_tpu_torch.serve.fleet`), whose size the autoscale
supervisor steers (:mod:`repic_tpu_torch.serve.autoscale`,
``fleet supervise``).
"""

from repic_tpu_torch.serve.jobs import (  # noqa: F401
    AdmissionError,
    CircuitBreaker,
    Job,
    JobQueue,
    ServeJournal,
)
