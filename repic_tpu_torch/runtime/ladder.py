"""The host solver ladder and the host liveness rung.

:func:`solve_host_ladder` solves one packing on the requested rung
and degrades when a rung cannot deliver: ``exact`` under a budget
that runs out, or ``lp_device`` whose dual ascent does not converge,
fall through to LP rounding and then greedy, which always ends.  It
returns the rung that produced the packing, so a run records where
each micrograph was solved.  The lp, lp_device and greedy rungs run
on ``device``; exact is host C++ (or, under a budget, the
interruptible Python search).

:func:`host_rung` classifies a host from its heartbeat age, for the
cluster runs that are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

HOST_LIVE = "live"
HOST_STOPPED = "stopped"      # clean shutdown recorded; no timeout wait
HOST_SUSPECT = "suspect"      # heartbeat older than the timeout
HOST_FENCED = "fenced"        # lease fenced by a survivor


def host_rung(
    age_s: float | None,
    timeout_s: float,
    *,
    stopped: bool = False,
    fenced: bool = False,
) -> str:
    """Classify one host: fenced > stopped > suspect > live.  No
    heartbeat at all (``age_s`` None) reads as suspect."""
    if fenced:
        return HOST_FENCED
    if stopped:
        return HOST_STOPPED
    if age_s is None or age_s > timeout_s:
        return HOST_SUSPECT
    return HOST_LIVE


#: degradation order per requested solver; every ladder ends on greedy
SOLVER_LADDER = {
    "exact": ("exact", "lp", "greedy"),
    "lp_device_fused": ("lp_device", "lp", "greedy"),
    "lp_device": ("lp_device", "lp", "greedy"),
    "lp": ("lp", "greedy"),
    "greedy": ("greedy",),
}


def solve_host_ladder(
    member_vertex,
    w,
    num_vertices: int,
    *,
    solver: str = "exact",
    budget_s: float | None = None,
    node_limit: int = 2_000_000,
    device="cpu",
):
    """Solve one packing, degrading down :data:`SOLVER_LADDER`.

    Args:
        member_vertex: ``(C, K)`` int vertex ids (valid cliques only).
        w: ``(C,)`` weights.
        num_vertices: vertex-space size.
        budget_s: wall-clock budget of the exact rung (None: none);
            the node limit applies either way.

    Returns:
        ``(picked, used)``: the ``(C,)`` bool picks and the rung that
        produced them.  An unbudgeted exact solve in which a component
        hit the node limit (greedy inside that component) reports as
        ``exact_fallback``.
    """
    from repic_tpu_torch.ops.solver import (
        SolverBudgetExceeded,
        solve_exact,
        solve_greedy,
        solve_lp_rounding,
    )
    from repic_tpu_torch.solver.dual import solve_dual_decomposition

    member_vertex = np.asarray(member_vertex)
    w = np.asarray(w)
    rungs = SOLVER_LADDER[solver]
    if len(w) == 0:
        return np.zeros(0, bool), rungs[0]
    for rung in rungs[:-1]:
        try:
            if rung == "lp_device":
                st = _solve_device(solve_dual_decomposition, member_vertex,
                                   w, num_vertices, device)
                if not bool(st.converged[0]):
                    continue
                picked = st.picked[0].cpu().numpy()
            elif rung == "exact":
                fallback_log: list = []
                picked = solve_exact(
                    member_vertex,
                    w.astype(np.float64),
                    node_limit=node_limit,
                    budget_s=budget_s,
                    fallback_log=fallback_log,
                )
                if fallback_log:
                    return picked, "exact_fallback"
            else:
                picked = _solve_device(solve_lp_rounding, member_vertex, w,
                                       num_vertices, device)[0]
                picked = picked.cpu().numpy()
        except SolverBudgetExceeded:
            continue
        return picked, rung
    picked = _solve_device(solve_greedy, member_vertex, w, num_vertices,
                           device)[0]
    return picked.cpu().numpy(), rungs[-1]


def _solve_device(fn, member_vertex, w, num_vertices, device):
    """One packing as a batch of one on ``device``."""
    dev = torch.device(device)
    return fn(
        torch.as_tensor(member_vertex, dtype=torch.int32, device=dev)[None],
        torch.as_tensor(np.asarray(w, np.float32), device=dev)[None],
        torch.ones((1, len(w)), dtype=torch.bool, device=dev),
        int(num_vertices),
    )
