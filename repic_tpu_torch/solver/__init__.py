"""On-device packing solvers, the ``lp_device`` rung (the port of
``repic_tpu.solver``; the algorithm is in
:mod:`repic_tpu_torch.solver.dual`)."""

from repic_tpu_torch.solver.dual import (
    DEFAULT_NUM_ITERS,
    DEFAULT_TOL,
    DualSolveStats,
    note_program_solves,
    record_device_solve,
    solve_dual_decomposition,
    solve_lp_device,
    solve_lp_device_host,
)

__all__ = [
    "DEFAULT_NUM_ITERS",
    "DEFAULT_TOL",
    "DualSolveStats",
    "note_program_solves",
    "record_device_solve",
    "solve_dual_decomposition",
    "solve_lp_device",
    "solve_lp_device_host",
]
