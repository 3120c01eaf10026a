"""Maximum-weight set packing: the greedy, lp and exact rungs.

Each micrograph's consensus is the packing problem

    maximize  w . x   over  x in {0,1}^C   s.t.  A x <= 1

(each particle in at most one chosen clique).  :func:`solve_greedy`
reproduces sequential greedy in (w desc, index asc) order as rounds of
scatter-``amax``/scatter-``amin``: each round selects every clique
that is the (weight, index) winner at all of its vertices, then drops
the cliques touching a selected vertex.  Padded and dead cliques
scatter into a sentinel slot V.  Batched over any leading axes, as is
:func:`solve_lp_rounding` (subgradient prices, then greedy rounding).
:func:`solve_exact` is host numpy/C++: branch-and-bound over the
connected components of the conflict graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repic_tpu_torch import telemetry
from repic_tpu_torch.analysis.contracts import Contract, checked, spec

_INT_MAX = torch.iinfo(torch.int32).max

# how often the exact rung holds (the reference's counters)
_BUDGET_EXCEEDED = telemetry.counter(
    "repic_solver_budget_exceeded_total",
    "exact-solve budget exhaustions (kind=wall|nodes)",
)
_NODE_LIMIT_FALLBACKS = telemetry.counter(
    "repic_solver_node_limit_fallbacks_total",
    "silent per-component greedy fallbacks after a node-limit hit",
)

#: the device solver rungs' shared contract: (C, K) int32 vertex ids +
#: (C,) weights/mask -> (C,) bool picks, V static (per micrograph; the
#: rungs take any leading batch axes)
_SOLVER_CONTRACT = Contract(
    args={
        "member_vertex": spec("C K", "int32"),
        "w": spec("C"),
        "valid": spec("C", "bool"),
    },
    returns=spec("C", "bool"),
    dims={"C": 16, "K": 3},
    static={"num_vertices": 48},
)


@checked(_SOLVER_CONTRACT)
def solve_greedy(
    member_vertex: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    num_vertices: int,
) -> torch.Tensor:
    """Parallel greedy maximum-weight set packing.

    Args:
        member_vertex: ``(..., C, K)`` int vertex ids in ``[0, V)``.
        w: ``(..., C)`` clique weights (priorities).
        valid: ``(..., C)`` bool mask of real cliques.
        num_vertices: vertex-space size V.

    Returns:
        ``(..., C)`` bool picks.
    """
    lead = w.shape[:-1]
    c, k = member_vertex.shape[-2:]
    b = math.prod(lead)
    v_ = num_vertices
    dev = w.device
    mv = member_vertex.reshape(b, c * k).long()
    w = w.reshape(b, c)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    idx_rep = idx.repeat_interleave(k)[None].expand(b, c * k)
    sentinel = torch.full_like(mv, v_)
    neg_inf = torch.tensor(float("-inf"), dtype=w.dtype, device=dev)
    alive = valid.reshape(b, c) & (w > 0)
    picked = torch.zeros_like(alive)
    while bool(alive.any()):
        wa = torch.where(alive, w, neg_inf)
        keep = alive.repeat_interleave(k, dim=1)
        tgt = torch.where(keep, mv, sentinel)
        best_w = torch.full((b, v_ + 1), float("-inf"), dtype=w.dtype,
                            device=dev).scatter_reduce(
            1, tgt, torch.where(keep, wa.repeat_interleave(k, dim=1),
                                neg_inf),
            "amax",
        )
        at_best = keep & (
            wa.repeat_interleave(k, dim=1) >= torch.gather(best_w, 1, mv)
        )
        tgt_claim = torch.where(at_best, mv, sentinel)
        best_idx = torch.full((b, v_ + 1), _INT_MAX, dtype=torch.int32,
                              device=dev).scatter_reduce(
            1, tgt_claim,
            torch.where(at_best, idx_rep,
                        torch.full_like(idx_rep, _INT_MAX)),
            "amin",
        )
        own = torch.gather(best_idx, 1, mv) == idx_rep
        selected = (
            alive
            & at_best.reshape(b, c, k).all(-1)
            & own.reshape(b, c, k).all(-1)
        )
        sel_rep = selected.repeat_interleave(k, dim=1)
        used = torch.zeros((b, v_ + 1), dtype=torch.bool, device=dev)
        used.scatter_(1, torch.where(sel_rep, mv, sentinel),
                      sel_rep)
        hit = torch.gather(used, 1, mv).reshape(b, c, k).any(-1)
        alive = alive & ~selected & ~hit
        picked = picked | selected
    return picked.reshape(lead + (c,))


def pack_cliques_for_solver(member_idx, valid, num_per_picker):
    """Per-picker particle indices -> global vertex ids
    ``slot * N + index`` (a dense vertex space of ``K * N``); invalid
    cliques get id 0 and are masked by ``valid``."""
    k = member_idx.shape[-1]
    offsets = (
        torch.arange(k, dtype=torch.int32, device=member_idx.device)
        * num_per_picker
    )
    vid = member_idx + offsets
    vid = torch.where(valid[..., None], vid, torch.zeros_like(vid))
    return vid, k * num_per_picker


class SolverBudgetExceeded(RuntimeError):
    """An exact solve ran out of its wall-clock or node budget; the
    host ladder (:func:`repic_tpu_torch.runtime.ladder.
    solve_host_ladder`) then degrades exact -> lp -> greedy."""


@checked(_SOLVER_CONTRACT)
def solve_lp_rounding(
    member_vertex: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    num_vertices: int,
    *,
    num_iters: int = 150,
) -> torch.Tensor:
    """LP relaxation + greedy rounding (the ``lp`` rung), batched.

    ``num_iters`` projected-subgradient steps on the vertex prices
    ``lam >= 0`` (``x = 1[w - A^T lam > 0]``, ``lam <- max(lam +
    eta0 / (1 + t) * (A x - 1), 0)``), the prices of the second half
    averaged; then greedy rounding by plain weight, by the final
    reduced costs and by the averaged ones, keeping the first of the
    best by objective.  Never worse than :func:`solve_greedy`.

    Float rules, as in the reference's CPU program: the K-sum of
    prices in slot order, the price step one fused multiply-add, the
    tail sum in step order, the objective in the order of
    :func:`~repic_tpu_torch.solver.dual.objective_sum`.

    Args/returns as :func:`solve_greedy` (``(..., C, K)`` vertex ids,
    ``(..., C)`` weights and mask -> ``(..., C)`` bool picks).
    """
    from repic_tpu_torch.solver.dual import (
        gather_sum,
        objective_sum,
        price_step,
    )

    lead = w.shape[:-1]
    c, k = member_vertex.shape[-2:]
    b = math.prod(lead)
    v_ = num_vertices
    dev = w.device
    f32 = torch.float32
    mv = member_vertex.reshape(b, c, k).long()
    w = w.reshape(b, c)
    valid = valid.reshape(b, c)
    zero = torch.zeros((), dtype=f32, device=dev)
    wv = torch.where(valid, w, zero)
    tgt = torch.where(
        valid[..., None].expand(b, c, k), mv, torch.full_like(mv, v_)
    ).reshape(b, c * k)
    eta0 = torch.maximum(
        wv.amax(-1) if c else torch.zeros(b, dtype=f32, device=dev),
        torch.tensor(1e-6, dtype=f32, device=dev),
    )
    half = num_iters // 2
    lam = torch.zeros((b, v_), dtype=f32, device=dev)
    lam_sum = torch.zeros_like(lam)
    for it in range(num_iters):
        red = wv - gather_sum(lam, mv)
        x = (red > 0.0) & valid
        ax = torch.zeros((b, v_ + 1), dtype=f32, device=dev).scatter_add(
            1, tgt, x[..., None].expand(b, c, k).reshape(b, c * k).to(f32)
        )[:, :v_]
        eta = eta0 / torch.tensor(1.0 + it, dtype=f32, device=dev)
        lam = price_step(lam, eta, ax)
        if it >= half:
            lam_sum = lam_sum + lam
    lam_avg = lam_sum / torch.tensor(
        float(max(num_iters - half, 1)), dtype=f32, device=dev
    )

    best = solve_greedy(mv, w, valid, v_)
    best_val = objective_sum(torch.where(best, wv, zero))
    for prices in (lam, lam_avg):
        reduced = wv - gather_sum(prices, mv)
        cand = solve_greedy(
            mv, torch.where(valid, reduced, torch.full_like(reduced, -1.0)),
            valid, v_,
        )
        cand_val = objective_sum(torch.where(cand, wv, zero))
        better = cand_val > best_val
        best = torch.where(better[:, None], cand, best)
        best_val = torch.maximum(cand_val, best_val)
    return best.reshape(lead + (c,))


def solve_exact_py(
    member_vertex: np.ndarray,
    w: np.ndarray,
    *,
    node_limit: int = 2_000_000,
    deadline: float | None = None,
    raise_on_limit: bool = False,
    fallback_log: list | None = None,
) -> np.ndarray:
    """Exact maximum-weight set packing (host-side oracle).

    Decomposes the conflict graph (cliques conflict iff they share a
    vertex) into connected components and runs depth-first
    branch-and-bound on each: at each step branch on the heaviest
    remaining clique (take / leave), pruning with the sum-of-remaining
    upper bound.  Exact; the oracle the native core is held to, and
    the interruptible search of the budgeted ``exact`` rung.

    Args:
        member_vertex: ``(C, K)`` int vertex ids (valid cliques only).
        w: ``(C,)`` weights.
        node_limit: safety cap on search nodes per component (falls
            back to greedy within the component if exceeded; practical
            components are tiny so this should never trigger).
        deadline: optional ``time.monotonic()`` cutoff — the search
            checks it every 64 nodes and raises
            :class:`SolverBudgetExceeded` when passed (the host
            ladder then degrades to LP-rounding/greedy).
        raise_on_limit: raise :class:`SolverBudgetExceeded` on a
            node_limit hit instead of the per-component greedy
            fallback.
        fallback_log: optional list; every per-component greedy
            fallback appends ``{"component": id, "cliques": n}`` to
            it (the ladder reports it as the ``exact_fallback`` rung).

    Returns:
        ``(C,)`` bool — optimal selection (unless ``fallback_log``
        came back non-empty: then >= 1 component fell back to
        greedy and the packing is only heuristic there).
    """
    import time as _time

    C = len(w)
    picked = np.zeros(C, dtype=bool)
    if C == 0:
        return picked

    # Conflict adjacency via shared vertices.
    from collections import defaultdict

    by_vertex = defaultdict(list)
    for c in range(C):
        for v in member_vertex[c]:
            by_vertex[int(v)].append(c)

    adj = [set() for _ in range(C)]
    for group in by_vertex.values():
        for i in group:
            adj[i].update(group)
    for c in range(C):
        adj[c].discard(c)

    # Connected components of the conflict graph.
    comp = np.full(C, -1, dtype=np.int64)
    n_comp = 0
    for c in range(C):
        if comp[c] >= 0:
            continue
        stack = [c]
        comp[c] = n_comp
        while stack:
            u = stack.pop()
            for nb in adj[u]:
                if comp[nb] < 0:
                    comp[nb] = n_comp
                    stack.append(nb)
        n_comp += 1

    for cid in range(n_comp):
        if deadline is not None and _time.monotonic() > deadline:
            _BUDGET_EXCEEDED.inc(kind="wall")
            raise SolverBudgetExceeded(
                "exact solve exceeded its wall-clock budget "
                f"({cid}/{n_comp} components searched)"
            )
        nodes = np.where(comp == cid)[0]
        # Sort heaviest-first for strong bounds; stable index tiebreak.
        nodes = nodes[np.lexsort((nodes, -w[nodes]))]
        local_index = {int(n): i for i, n in enumerate(nodes)}
        n = len(nodes)
        local_adj = [
            [
                local_index[int(b)]
                for b in adj[int(nodes[i])]
                if int(b) in local_index
            ]
            for i in range(n)
        ]
        weights = w[nodes].astype(np.float64)
        suffix = np.concatenate([np.cumsum(weights[::-1])[::-1], [0.0]])

        best_val = -1.0
        best_sel: list[int] = []
        nodes_visited = 0
        # Iterative DFS: (position, chosen list, blocked set, value).
        stack2 = [(0, [], frozenset(), 0.0)]
        aborted = False
        while stack2:
            pos, chosen, blocked, val = stack2.pop()
            nodes_visited += 1
            if nodes_visited > node_limit:
                if raise_on_limit:
                    _BUDGET_EXCEEDED.inc(kind="nodes")
                    raise SolverBudgetExceeded(
                        f"exact solve exceeded its node budget "
                        f"({node_limit} nodes)"
                    )
                aborted = True
                break
            if (
                deadline is not None
                and nodes_visited % 64 == 0
                and _time.monotonic() > deadline
            ):
                _BUDGET_EXCEEDED.inc(kind="wall")
                raise SolverBudgetExceeded(
                    "exact solve exceeded its wall-clock budget "
                    f"(component {cid}, {nodes_visited} nodes)"
                )
            # Advance past blocked cliques.
            while pos < n and pos in blocked:
                pos += 1
            if val + suffix[pos] <= best_val:
                continue
            if pos >= n:
                if val > best_val:
                    best_val, best_sel = val, chosen
                continue
            # Branch: leave `pos` (push first so "take" explores first).
            stack2.append((pos + 1, chosen, blocked, val))
            stack2.append(
                (
                    pos + 1,
                    chosen + [pos],
                    blocked | set(local_adj[pos]),
                    val + weights[pos],
                )
            )
        if aborted:
            _NODE_LIMIT_FALLBACKS.inc()
            if fallback_log is not None:
                fallback_log.append(
                    {"component": int(cid), "cliques": int(n)}
                )
            # Greedy fallback (never expected on real data).
            blocked_set: set[int] = set()
            best_sel = []
            for i in range(n):
                if i not in blocked_set:
                    best_sel.append(i)
                    blocked_set.update(local_adj[i])
        for i in best_sel:
            picked[nodes[i]] = True

    return picked


def solve_exact(
    member_vertex: np.ndarray,
    w: np.ndarray,
    *,
    node_limit: int = 2_000_000,
    budget_s: float | None = None,
    fallback_log: list | None = None,
) -> np.ndarray:
    """Exact max-weight set packing, preferring the native C++ core.

    Dispatches to :func:`repic_tpu_torch.native.solve_exact_native`
    (``native/setpack.cpp``, built at first use; a missing toolchain
    raises).

    With ``budget_s`` set, runs the interruptible Python oracle with a
    wall-clock deadline (the native core cannot be preempted
    mid-search) and raises :class:`SolverBudgetExceeded` when either
    the deadline or ``node_limit`` is hit — the contract the runtime's
    degradation ladder builds on.

    ``fallback_log`` (optional list) receives an entry per node-limit
    greedy fallback on the unbudgeted path — see
    :func:`solve_exact_py`.  A non-empty log means the returned
    packing is NOT exact everywhere; the host ladder reports such a
    solve as the ``exact_fallback`` rung.
    """
    if budget_s is not None:
        import time as _time

        return solve_exact_py(
            np.asarray(member_vertex),
            np.asarray(w),
            node_limit=node_limit,
            deadline=_time.monotonic() + budget_s,
            raise_on_limit=True,
        )
    from repic_tpu_torch import native

    return native.solve_exact_native(
        np.asarray(member_vertex),
        np.asarray(w),
        node_limit=node_limit,
        fallback_log=fallback_log,
    )
