"""Maximum-weight set packing: the parallel greedy rung.

Each micrograph's consensus is the packing problem

    maximize  w . x   over  x in {0,1}^C   s.t.  A x <= 1

(each particle in at most one chosen clique).  :func:`solve_greedy`
reproduces sequential greedy in (w desc, index asc) order as rounds of
scatter-``amax``/scatter-``amin``: each round selects every clique
that is the (weight, index) winner at all of its vertices, then drops
the cliques touching a selected vertex.  Padded and dead cliques
scatter into a sentinel slot V.  Batched over any leading axes.
"""

from __future__ import annotations

import math

import torch

_INT_MAX = torch.iinfo(torch.int32).max


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
