"""The consensus operators (the port of ``repic_tpu.ops``)."""

from repic_tpu_torch.ops.cliques import CliqueSet, enumerate_cliques
from repic_tpu_torch.ops.iou import pair_iou, pairwise_iou_matrix
from repic_tpu_torch.ops.solver import solve_exact, solve_exact_py, solve_greedy

__all__ = [
    "pair_iou",
    "pairwise_iou_matrix",
    "enumerate_cliques",
    "CliqueSet",
    "solve_greedy",
    "solve_exact",
    "solve_exact_py",
]
