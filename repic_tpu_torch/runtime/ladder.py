"""The runtime's retry and degradation ladders.

* **compute ladder** (driven by the chunk loop,
  ``pipeline/consensus.py: _iter_chunks_serial``): a chunk that runs
  out of device memory is halved; in lenient mode other failures get
  bounded-backoff retries (:class:`RetryPolicy`), then each micrograph
  runs alone, and one that still fails is quarantined.
  :func:`classify_error` picks the rung; :class:`ChunkOutcomes` keeps
  each micrograph's outcome for the journal.
* **solver ladder** (:func:`solve_host_ladder`): solves one packing on
  the requested rung and degrades when a rung cannot deliver --
  ``exact`` under a budget that runs out, or ``lp_device`` whose dual
  ascent does not converge, fall through to LP rounding and then
  greedy, which always ends.  It returns the rung that produced the
  packing.  The lp, lp_device and greedy rungs run on ``device``;
  exact is host C++ (or, under a budget, the interruptible Python
  search).  The ``solver_budget`` and ``solver_diverge`` fault sites
  (:mod:`~repic_tpu_torch.runtime.faults`) fire here.
* **host rung** (:func:`host_rung`): a host classified from its
  heartbeat age, the liveness ladder of the cluster runs
  (:mod:`~repic_tpu_torch.runtime.cluster`).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from repic_tpu_torch.runtime import faults


def is_oom_error(e: BaseException) -> bool:
    """Device or host allocator exhaustion: a
    ``torch.cuda.OutOfMemoryError`` by its type, anything else by its
    message (an injected ``oom`` says ``RESOURCE_EXHAUSTED``)."""
    # no torch in the process means no torch error (this package's
    # runtime layer imports only the stdlib)
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    s = str(e).lower()
    return "out of memory" in s or "resource_exhausted" in s


def classify_error(e: BaseException) -> str:
    """``oom`` | ``io`` | ``error``: the compute ladder's entry rung."""
    if is_oom_error(e):
        return "oom"
    if isinstance(e, OSError):
        return "io"
    return "error"


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded-backoff retry budget for transient failures."""

    max_retries: int = 2          # same-configuration re-attempts
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0

    def __post_init__(self):
        # a negative budget would run no attempt at all and drop
        # micrographs without a record
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}"
            )

    def backoff(self, attempt: int) -> float:
        """Exponential backoff for the 1-based ``attempt``, capped."""
        return min(
            self.backoff_cap_s,
            self.backoff_base_s * (2.0 ** max(attempt - 1, 0)),
        )


DEFAULT_POLICY = RetryPolicy()


@dataclass
class ChunkOutcomes:
    """Per-run ladder bookkeeping: the chunk loop fills it, the
    journaling writer reads it."""

    status: dict = field(default_factory=dict)       # name -> retried|degraded
    quarantined: dict = field(default_factory=dict)  # name -> error info
    solver: dict = field(default_factory=dict)       # name -> rung that ran
    reassigned: dict = field(default_factory=dict)   # name -> source host

    def mark(self, names, status: str) -> None:
        """Record a status; ``degraded`` wins over ``retried``."""
        for n in names:
            if status == "retried" and self.status.get(n) == "degraded":
                continue
            self.status[n] = status


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
    import numpy as np

    from repic_tpu_torch.ops.solver import (
        SolverBudgetExceeded,
        solve_exact,
        solve_greedy,
        solve_lp_rounding,
    )
    from repic_tpu_torch.solver.dual import (
        record_device_solve,
        solve_dual_decomposition,
    )
    # lazy: the telemetry package imports the runtime
    from repic_tpu_torch.telemetry import metrics as _metrics

    rung_total = _metrics.counter(
        "repic_solver_rung_total",
        "host solver ladder rungs that actually produced a packing",
    )
    member_vertex = np.asarray(member_vertex)
    w = np.asarray(w)
    rungs = SOLVER_LADDER[solver]
    if len(w) == 0:
        return np.zeros(0, bool), rungs[0]
    for rung in rungs[:-1]:
        if faults.check("solver_budget", rung):
            continue  # injected budget exhaustion of this rung
        try:
            if rung == "lp_device":
                if faults.check("solver_diverge", rung):
                    continue  # injected dual-ascent divergence
                st = _solve_device(solve_dual_decomposition, member_vertex,
                                   w, num_vertices, device)
                record_device_solve(st)
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
                    rung_total.inc(rung="exact_fallback")
                    return picked, "exact_fallback"
            else:
                picked = _solve_device(solve_lp_rounding, member_vertex, w,
                                       num_vertices, device)[0]
                picked = picked.cpu().numpy()
        except SolverBudgetExceeded:
            continue
        rung_total.inc(rung=rung)
        return picked, rung
    picked = _solve_device(solve_greedy, member_vertex, w, num_vertices,
                           device)[0]
    rung_total.inc(rung=rungs[-1])
    return picked.cpu().numpy(), rungs[-1]


def _solve_device(fn, member_vertex, w, num_vertices, device):
    """One packing as a batch of one on ``device``."""
    import numpy as np
    import torch

    dev = torch.device(device)
    return fn(
        torch.as_tensor(member_vertex, dtype=torch.int32, device=dev)[None],
        torch.as_tensor(np.asarray(w, np.float32), device=dev)[None],
        torch.ones((1, len(w)), dtype=torch.bool, device=dev),
        int(num_vertices),
    )
