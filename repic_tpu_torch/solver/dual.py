"""Batched dual-decomposition LP solve (the ``lp_device`` rung).

Per micrograph, for the packing problem ``max w.x  s.t.  A x <= 1``:

1. **Dual ascent** on the vertex prices ``lam >= 0``: the threshold
   primal ``x = 1[w - A^T lam > 0]``, the subgradient ``A x - 1``, the
   projected step ``lam <- max(lam + eta_t (A x - 1), 0)`` with
   ``eta_t = eta0 / (1 + t)``; at most ``num_iters`` steps, stopping
   once ``max|dlam| / eta0 <= tol``; tail iterates Polyak-averaged.
2. **Rounding + repair** at three price vectors (zero, final,
   averaged): greedy in reduced-cost order, then a greedy repair pass
   by raw weight over what stays feasible.
3. The best of the three by true objective, the first on a tie (so
   never worse than plain greedy).

The reference runs one ``while_loop`` per micrograph under ``vmap``;
here the ``(M, C)`` batch steps together and a row that has stopped
is frozen, which is what the vmapped loop does.

Float rules that the CUDA kernel (``csrc/dual.cu``) shares:
``sum(lam[member_vertex])`` adds slot 0, 1, ..., K-1 in order; the
price step is one fused multiply-add ``fma(eta, ax - 1, lam)`` — the
reference's CPU program contracts it so — computed here exactly in
float64 and rounded once; the objective sums are float32 in the order
of :func:`objective_sum`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repic_tpu_torch import telemetry
from repic_tpu_torch.analysis.contracts import Contract, checked, spec
from repic_tpu_torch.ops.solver import solve_greedy

DEFAULT_NUM_ITERS = 200
DEFAULT_TOL = 1e-3

_DEVICE_SOLVES = telemetry.counter(
    "repic_solver_device_solves_total",
    "micrograph packings solved by the on-device dual-decomposition "
    "rung (lp_device)",
)
_DEVICE_ITERS = telemetry.counter(
    "repic_solver_device_iterations_total",
    "dual-ascent iterations consumed by instrumented lp_device solves",
)
_DEVICE_REPAIRS = telemetry.counter(
    "repic_solver_device_repairs_total",
    "cliques re-admitted by the lp_device greedy repair pass",
)
# the gap is a unitless certificate in [0, 1], not a latency
_DEVICE_GAP = telemetry.histogram(
    "repic_solver_device_convergence_gap",
    "per-solve duality-gap certificate of the lp_device rung "
    "((dual bound - objective) / dual bound)",
    buckets=(1e-5, 1e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0),
)

# A float32 sum of more than this many terms is taken as sums of
# windows of this many, recursively (XLA's CPU tree reduction).
SUM_WINDOW = 32


class DualSolveStats(NamedTuple):
    """A batch of solves: picks plus diagnostics, all with leading M."""

    picked: torch.Tensor      # (M, C) bool — feasible packing
    iterations: torch.Tensor  # (M,) int32 — dual-ascent steps
    gap: torch.Tensor         # (M,) float32 — duality-gap certificate
    converged: torch.Tensor   # (M,) bool — stopped before the budget
    repairs: torch.Tensor     # (M,) int32 — repair-pass admissions


def gather_sum(prices: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """``sum_k prices[m, mv[m, c, k]]`` added in slot order 0..K-1."""
    b, c, k = mv.shape
    g = torch.gather(prices, 1, mv.reshape(b, c * k)).reshape(b, c, k)
    s = g[..., 0]
    for j in range(1, k):
        s = s + g[..., j]
    return s


def objective_sum(x: torch.Tensor) -> torch.Tensor:
    """Float32 row sums of ``x`` ``(B, L)`` in the reference's order.

    While ``L > SUM_WINDOW`` the row is zero-padded to a multiple of
    the window (half the padding in front, the larger half behind)
    and replaced by its window sums; what is left is summed from 0,
    term by term, in index order.  Each window is summed that way
    too.  That is how the reference's CPU program reduces
    ``jnp.sum(..., axis=-1)``; a near-tie between two rounding
    candidates is decided by these roundings.
    """
    x = x.float()
    while x.shape[-1] > SUM_WINDOW:
        pad = -x.shape[-1] % SUM_WINDOW
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(x.shape[0], -1, SUM_WINDOW)
        acc = torch.zeros(x.shape[:2], dtype=x.dtype, device=x.device)
        for j in range(SUM_WINDOW):
            acc = acc + x[..., j]
        x = acc
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[:, j]
    return acc


def price_step(lam, eta, ax):
    """``max(fma(eta, ax - 1, lam), 0)`` with one rounding: in float64
    the product (float32 x small integer) and the sum are exact."""
    f = lam.double() + eta.double()[:, None] * (ax.double() - 1.0)
    return torch.clamp_min(f.float(), 0.0)


def solve_dual_decomposition(
    member_vertex: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    num_vertices: int,
    *,
    num_iters: int = DEFAULT_NUM_ITERS,
    tol: float = DEFAULT_TOL,
) -> DualSolveStats:
    """Dual-decomposition solve of M packings at once.

    Args:
        member_vertex: ``(M, C, K)`` int vertex ids in ``[0, V)``.
        w: ``(M, C)`` float32 non-negative weights.
        valid: ``(M, C)`` bool; padded rows are inert.
        num_vertices: vertex-space size V.
    """
    b, c, k = member_vertex.shape
    v_ = num_vertices
    dev = w.device
    f32 = torch.float32
    mv = member_vertex.long()
    zero = torch.zeros((), dtype=f32, device=dev)
    wv = torch.where(valid, w, zero)
    tgt = torch.where(
        valid[..., None].expand(b, c, k), mv, torch.full_like(mv, v_)
    ).reshape(b, c * k)
    eta0 = torch.maximum(
        wv.amax(-1), torch.tensor(1e-6, dtype=f32, device=dev)
    )
    tol_t = torch.tensor(tol, dtype=f32, device=dev)
    half = num_iters // 2

    t = torch.zeros(b, dtype=torch.int32, device=dev)
    lam = torch.zeros((b, v_), dtype=f32, device=dev)
    lam_sum = torch.zeros_like(lam)
    n_tail = torch.zeros(b, dtype=torch.int32, device=dev)
    delta = torch.full((b,), float("inf"), dtype=f32, device=dev)
    active = (t < num_iters) & (delta > tol_t)
    while bool(active.any()):
        red = wv - gather_sum(lam, mv)
        x = (red > 0.0) & valid
        ax = torch.zeros((b, v_ + 1), dtype=f32, device=dev).scatter_add(
            1, tgt, x[..., None].expand(b, c, k).reshape(b, c * k).to(f32)
        )[:, :v_]
        eta = eta0 / (1.0 + t.to(f32))
        lam_new = price_step(lam, eta, ax)
        d_new = (lam_new - lam).abs().amax(-1) / eta0
        in_tail = t >= half
        sum_new = torch.where(in_tail[:, None], lam_sum + lam_new, lam_sum)
        act = active[:, None]
        lam = torch.where(act, lam_new, lam)
        lam_sum = torch.where(act, sum_new, lam_sum)
        n_tail = n_tail + (active & in_tail).to(torch.int32)
        delta = torch.where(active, d_new, delta)
        t = t + active.to(torch.int32)
        active = (t < num_iters) & (delta > tol_t)
    lam_avg = torch.where(
        (n_tail > 0)[:, None],
        lam_sum / torch.clamp_min(n_tail, 1).to(f32)[:, None],
        lam,
    )

    # three candidates as one (3M) batch: zero, final, averaged prices
    prices3 = torch.cat([torch.zeros_like(lam), lam, lam_avg])
    mv3 = mv.repeat(3, 1, 1)
    valid3 = valid.repeat(3, 1)
    wv3 = wv.repeat(3, 1)
    w3 = w.repeat(3, 1)
    red3 = wv3 - gather_sum(prices3, mv3)
    prio0 = torch.where(valid3, red3, torch.full_like(red3, -1.0))
    sel0 = solve_greedy(mv3, prio0, valid3, v_)
    used = torch.zeros((3 * b, v_ + 1), dtype=torch.bool, device=dev)
    sel_rep = sel0[..., None].expand(3 * b, c, k).reshape(3 * b, c * k)
    used.scatter_(
        1, torch.where(sel_rep, mv3.reshape(3 * b, c * k),
                       torch.full_like(mv3.reshape(3 * b, c * k), v_)),
        sel_rep,
    )
    hit = torch.gather(used, 1, mv3.reshape(3 * b, c * k))
    free = valid3 & ~sel0 & ~hit.reshape(3 * b, c, k).any(-1)
    sel1 = solve_greedy(mv3, w3, free, v_)
    cands = (sel0 | sel1).reshape(3, b, c)
    reps = sel1.sum(-1, dtype=torch.int32).reshape(3, b)
    vals = objective_sum(
        torch.where(cands, wv[None], zero).reshape(3 * b, c)
    ).reshape(3, b)
    pick = torch.argmax(vals, dim=0)        # first maximum: greedy
    rows = torch.arange(b, device=dev)
    best = cands[pick, rows]
    best_rep = torch.where(
        pick > 0, reps[pick, rows], torch.zeros_like(reps[0])
    )
    best_val = vals[pick, rows]

    red_final = wv - gather_sum(lam, mv)
    bound = torch.where(valid, red_final.clamp_min(0.0), zero).sum(-1) \
        + lam.sum(-1)
    gap = (bound - best_val).clamp_min(0.0) / bound.clamp_min(1e-6)
    return DualSolveStats(
        picked=best,
        iterations=t,
        gap=gap,
        converged=delta <= tol_t,
        repairs=best_rep,
    )


@checked(Contract(
    # the other device solver rungs' contract (ops/solver.py)
    args={
        "member_vertex": spec("C K", "int32"),
        "w": spec("C"),
        "valid": spec("C", "bool"),
    },
    returns=spec("C", "bool"),
    dims={"C": 16, "K": 3},
    static={"num_vertices": 48},
))
def solve_lp_device(
    member_vertex, w, valid, num_vertices,
    *, num_iters: int = DEFAULT_NUM_ITERS, tol: float = DEFAULT_TOL,
) -> torch.Tensor:
    """The ``lp_device`` rung: picks only, ``(M, C)`` bool."""
    return solve_dual_decomposition(
        member_vertex, w, valid, num_vertices,
        num_iters=num_iters, tol=tol,
    ).picked


def record_device_solve(stats: DualSolveStats) -> None:
    """Fold the diagnostics of fetched solves (a batch of any size)
    into the device-solver telemetry: the host boundaries (the ladder's
    ``lp_device`` rung) call it; the chunk program counts its solves
    with :func:`note_program_solves` and keeps the diagnostics on the
    device."""
    iters = stats.iterations.cpu().tolist()
    repairs = stats.repairs.cpu().tolist()
    gaps = stats.gap.cpu().tolist()
    for it, rep, gap in zip(iters, repairs, gaps):
        _DEVICE_SOLVES.inc()
        _DEVICE_ITERS.inc(int(it))
        _DEVICE_REPAIRS.inc(int(rep))
        _DEVICE_GAP.observe(float(gap))


def note_program_solves(n: int) -> None:
    """Count ``n`` micrograph solves run inside a chunk program."""
    if n > 0:
        _DEVICE_SOLVES.inc(int(n))


def solve_lp_device_host(
    member_vertex,
    w,
    num_vertices: int,
    *,
    num_iters: int = DEFAULT_NUM_ITERS,
    tol: float = DEFAULT_TOL,
    device="cuda",
):
    """Host arrays in, host values out: one ``(C, K)`` packing solved
    on ``device`` as a batch of one, its diagnostics recorded, and
    ``(picked, converged)`` returned.  ``converged=False`` is the
    ladder's cue to degrade to the host rungs (the runtime ladder runs
    the same solve through ``runtime/ladder.py: _solve_device``)."""
    import numpy as np

    dev = torch.device(device)
    w = np.asarray(w, np.float32)
    stats = solve_dual_decomposition(
        torch.as_tensor(np.asarray(member_vertex), dtype=torch.int32,
                        device=dev)[None],
        torch.as_tensor(w, device=dev)[None],
        torch.ones((1, len(w)), dtype=torch.bool, device=dev),
        int(num_vertices),
        num_iters=num_iters,
        tol=tol,
    )
    record_device_solve(stats)
    return stats.picked[0].cpu().numpy(), bool(stats.converged[0])
