"""The port's analysis layer (the port of ``repic_tpu.analysis``),
re-derived for torch and CUDA.

The static layer imports no torch:

* :mod:`~repic_tpu_torch.analysis.rules` -- the per-file lint: RT004
  (host syncs on launch outputs or CUDA tensors in a hot loop) and the
  RT201-RT204 project contracts, over
  :mod:`~repic_tpu_torch.analysis.engine` (``# repic: noqa[RTxxx]``
  suppression, byte for byte the reference's);
* :mod:`~repic_tpu_torch.analysis.concurrency` -- RT301-RT305, the
  whole-program lock discipline of the port's threads;
* :mod:`~repic_tpu_torch.analysis.spmd` -- RT401/RT402/RT404 over the
  gang's ``torch.distributed`` collectives;
* :mod:`~repic_tpu_torch.analysis.cost` -- RT502/RT512 over the
  kernels' launch sites;
* :mod:`~repic_tpu_torch.analysis.sarif` -- SARIF 2.1.0 output.

``check`` (:mod:`~repic_tpu_torch.analysis.semantic`) imports torch and
the target modules: RT101/RT102 hold each ``@checked`` entry
(:mod:`~repic_tpu_torch.analysis.contracts`) to its contract, and
RT423/RT425 (:mod:`~repic_tpu_torch.analysis.kernels`) hold each
hand-written kernel to its reference, on the card unless the caller
asks for the CPU.

The runtime sanitizers ride the same registry:

* :mod:`~repic_tpu_torch.analysis.kernelcheck` -- KERNELCHECK: every
  registered kernel against its unfused path on a named device;
* :mod:`~repic_tpu_torch.analysis.dispatchcheck` -- DISPATCHCHECK:
  each accepted chunk's launches and fetches against its entry's
  budget;
* :mod:`~repic_tpu_torch.analysis.lockcheck` -- LOCKCHECK: witnessed
  lock-order cycles and unguarded writes in the port's threads.

Each arms from its environment variable (``REPIC_TPU_KERNELCHECK``,
``REPIC_TPU_DISPATCHCHECK``, ``REPIC_TPU_LOCKCHECK``) through
``maybe_install_from_env``, or programmatically.

Entry points: ``python -m repic_tpu_torch lint``, ``python -m
repic_tpu_torch check`` and ``python -m repic_tpu_torch.analysis``
(lint).  Programmatic use::

    from repic_tpu_torch.analysis import run_paths, run_concurrency
    findings = run_paths(["repic_tpu_torch"])
    findings += run_concurrency(["repic_tpu_torch"])  # still no torch

    from repic_tpu_torch.analysis.semantic import run_check
    report = run_check(["repic_tpu_torch"], device="cpu")  # imports torch
"""

from repic_tpu_torch.analysis import (
    dispatchcheck,
    kernelcheck,
    lockcheck,
)
from repic_tpu_torch.analysis.concurrency import run_concurrency
from repic_tpu_torch.analysis.contracts import (
    ArraySpec,
    CheckedEntry,
    Contract,
    checked,
    registry,
    spec,
)
from repic_tpu_torch.analysis.engine import (
    Finding,
    analyze_source,
    format_report,
    iter_python_files,
    run_paths,
)
from repic_tpu_torch.analysis.kernels import (
    KernelContract,
    differential_probe,
)
from repic_tpu_torch.analysis.rules import ALL_RULES, RULES_BY_ID

__all__ = [
    "ALL_RULES",
    "RULES_BY_ID",
    "ArraySpec",
    "CheckedEntry",
    "Contract",
    "Finding",
    "KernelContract",
    "analyze_source",
    "checked",
    "differential_probe",
    "dispatchcheck",
    "format_report",
    "iter_python_files",
    "kernelcheck",
    "lockcheck",
    "registry",
    "run_concurrency",
    "run_paths",
    "spec",
]
