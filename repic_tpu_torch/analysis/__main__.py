"""``python -m repic_tpu_torch.analysis``: the reference's ``lint`` and
``check`` entry point, which the port does not have yet."""

import sys

sys.exit(
    "python -m repic_tpu_torch.analysis: the static analysis layer "
    "(`lint` and `check`: the AST rule packs and the trace-time "
    "contract checks) is not ported; it is ROADMAP Queue 1 item 9b.  "
    "The runtime sanitizers are: arm them with REPIC_TPU_KERNELCHECK=1,"
    " REPIC_TPU_DISPATCHCHECK=1 or REPIC_TPU_LOCKCHECK=1, or through "
    "repic_tpu_torch.analysis.{kernelcheck,dispatchcheck,lockcheck}"
)
