"""Runtime sanitizers and the entry-point contract registry (the
dynamic half of ``repic_tpu.analysis``).

* :mod:`~repic_tpu_torch.analysis.contracts` -- ``@checked`` entry
  points with their :class:`Contract` (shapes, static knobs, dispatch
  budget, kernel contract), registered at import, free at call time.
* :mod:`~repic_tpu_torch.analysis.kernelcheck` -- KERNELCHECK: every
  registered kernel against its unfused path on a named device
  (:mod:`~repic_tpu_torch.analysis.kernels`).
* :mod:`~repic_tpu_torch.analysis.dispatchcheck` -- DISPATCHCHECK:
  each accepted chunk's launches and fetches against its entry's
  budget.
* :mod:`~repic_tpu_torch.analysis.lockcheck` -- LOCKCHECK: witnessed
  lock-order cycles and unguarded writes in the port's threads.

Each arms from its environment variable (``REPIC_TPU_KERNELCHECK``,
``REPIC_TPU_DISPATCHCHECK``, ``REPIC_TPU_LOCKCHECK``) through
``maybe_install_from_env``, or programmatically.  The reference's
static layer -- the AST lint rule packs and the trace-time ``check``
-- is ROADMAP Queue 1 item 9b and is not here.
"""

from repic_tpu_torch.analysis import (
    dispatchcheck,
    kernelcheck,
    lockcheck,
)
from repic_tpu_torch.analysis.contracts import (
    ArraySpec,
    CheckedEntry,
    Contract,
    checked,
    registry,
    spec,
)
from repic_tpu_torch.analysis.kernels import (
    KernelContract,
    differential_probe,
)

__all__ = [
    "ArraySpec",
    "CheckedEntry",
    "Contract",
    "KernelContract",
    "checked",
    "differential_probe",
    "dispatchcheck",
    "kernelcheck",
    "lockcheck",
    "registry",
    "spec",
]
