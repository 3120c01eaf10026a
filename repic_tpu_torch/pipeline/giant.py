"""Consensus for one giant micrograph, split into x-stripes.

A dense field's interactions are local (IoU > 0 needs |dx| < box), so
the micrograph splits into stripes with a one-box halo:

* **Shard**: picker 0's particles (the anchors) are split into ``S``
  stripes by sorted-x rank, each anchor owned by exactly one stripe.
  A stripe's window for pickers 1..K-1 reaches one box (the largest
  size) past its anchors' x-span, so every clique an owned anchor
  belongs to lies inside it.
* **Compute**: the S stripes are the batch axis of the ordinary
  enumeration (dense or bucketed, with its assembly regimes) and of
  :func:`compact_cliques`.  Anchor ownership means no clique comes
  out twice.
* **Combine**: stripe-local member indices map to global particle ids
  through per-stripe tables, the stripes' cliques form one global
  packing problem, and one solve picks the consensus (greedy, or LP
  rounding for ``solver="lp"``), so a halo particle claimed by
  cliques of two stripes is resolved globally.  One fetch brings the
  result to the host.

Capacities escalate as in :func:`~repic_tpu_torch.pipeline.consensus.
run_consensus_batch`, from ``cap = max(4 * nb, 1024)``, without the
memo.  On one card the stripes run as one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from repic_tpu_torch.ops.cliques import (
    DEFAULT_THRESHOLD,
    compact_cliques,
    enumerate_cliques,
    enumerate_cliques_bucketed,
)
from repic_tpu_torch.ops.solver import solve_greedy, solve_lp_rounding
from repic_tpu_torch.parallel.batching import bucket_size


def build_stripes(sets, n_stripes: int, reach: float):
    """Host-side stripes of one micrograph.

    Args:
        sets: one :class:`~repic_tpu_torch.utils.box_io.BoxSet` per
            picker.
        n_stripes: stripe count ``S``.
        reach: halo width in pixels (the largest box size).

    Returns:
        ``(xy, conf, mask, l2g)``: ``(S, K, nb, 2)`` / ``(S, K, nb)``
        / ``(S, K, nb)`` / ``(S, K, nb)`` with ``nb`` the power-of-two
        stripe capacity; ``l2g[s, p, j]`` is the global index of
        stripe-local particle ``j`` (0 in padded slots).
    """
    k = len(sets)
    xs0 = sets[0].xy[:, 0]
    order = np.argsort(xs0, kind="stable")
    splits = np.array_split(order, n_stripes)
    stripe_idx: list[list[np.ndarray]] = []
    for anchors in splits:
        if len(anchors):
            lo = float(xs0[anchors].min()) - reach
            hi = float(xs0[anchors].max()) + reach
        else:
            lo, hi = 0.0, -1.0  # empty window
        per_picker = [anchors.astype(np.int64)]
        for p in range(1, k):
            xp = sets[p].xy[:, 0]
            per_picker.append(np.where((xp >= lo) & (xp <= hi))[0])
        stripe_idx.append(per_picker)
    nb = bucket_size(
        max((len(idx) for per in stripe_idx for idx in per), default=1)
    )
    s_ = n_stripes
    xy = np.zeros((s_, k, nb, 2), np.float32)
    conf = np.zeros((s_, k, nb), np.float32)
    mask = np.zeros((s_, k, nb), bool)
    l2g = np.zeros((s_, k, nb), np.int32)
    for s, per in enumerate(stripe_idx):
        for p, idx in enumerate(per):
            n = len(idx)
            xy[s, p, :n] = sets[p].xy[idx]
            conf[s, p, :n] = sets[p].conf[idx]
            mask[s, p, :n] = True
            l2g[s, p, :n] = idx
    return xy, conf, mask, l2g


def striped_cliques(
    xy, conf, mask, box_arg, *, threshold, d, cap, grid, cell_cap, pcap
):
    """Enumerate and compact the cliques of all stripes at once (the
    stripes are the batch axis; no solve — that is global)."""
    if grid is not None:
        cs = enumerate_cliques_bucketed(
            xy, conf, mask, box_arg,
            threshold=threshold,
            max_neighbors=d,
            grid=grid,
            cell_capacity=cell_cap,
            clique_capacity=cap,
            partial_capacity=pcap,
        )
    else:
        cs = enumerate_cliques(
            xy, conf, mask, box_arg,
            threshold=threshold,
            max_neighbors=d,
            clique_capacity=cap,
            partial_capacity=pcap,
        )
    return compact_cliques(cs, cap)


def run_consensus_giant(
    sets,
    box_size,
    *,
    n_stripes: int = 1,
    threshold: float = DEFAULT_THRESHOLD,
    max_neighbors: int = 16,
    spatial: bool | None = None,
    solver: str = "greedy",
    device=None,
) -> dict:
    """Consensus for one micrograph through ``n_stripes`` stripes.

    Returns host arrays over the flattened global clique buffer:
    ``member_idx`` (C, K) global per-picker particle indices, ``w``,
    ``confidence``, ``rep_xy``, ``rep_slot``, ``valid`` and ``picked``
    (``picked & valid``), plus ``num_cliques``, ``n_stripes``,
    ``stripe_capacity`` and the accepted ``config`` ``(d, cap,
    cell_cap, pcap)``.  Member indices refer to the order of ``sets``.
    """
    from repic_tpu_torch.ops.spatial import grid_size
    from repic_tpu_torch.pipeline.consensus import (
        SPATIAL_THRESHOLD,
        escalate_capacities,
        resolve_device,
    )

    dev = resolve_device(device)
    k = len(sets)
    sizes = np.asarray(box_size, np.float32)
    reach = float(sizes.max())
    box_arg = (
        torch.from_numpy(sizes).to(dev) if sizes.ndim else float(box_size)
    )
    xy, conf, mask, l2g = build_stripes(sets, n_stripes, reach)
    nb = xy.shape[2]
    n_max = max(s.n for s in sets)
    if spatial is None:
        spatial = nb > SPATIAL_THRESHOLD
    grid = None
    cell_cap = 64
    if spatial:
        extent = float(max(s.xy.max() if s.n else 0.0 for s in sets)) + reach
        grid = grid_size(extent, reach)
    xy_d = torch.from_numpy(xy).to(dev)
    conf_d = torch.from_numpy(conf).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    d = max_neighbors
    cap = max(4 * nb, 1024)
    pcap = cap
    while True:
        cs = striped_cliques(
            xy_d, conf_d, mask_d, box_arg, threshold=threshold, d=d,
            cap=cap, grid=grid, cell_cap=cell_cap, pcap=pcap,
        )
        # the escalate-and-retry discipline of run_consensus_batch: the
        # probe fetch sizing the next attempt is the documented rare
        # path, not a per-item ladder
        probes = torch.stack([
            cs.max_adjacency.amax(), cs.num_valid.amax(),
            cs.max_cell_count.amax(), cs.max_partial.amax(),
        ]).cpu().numpy()  # repic: noqa[RT502]
        d, cap, cell_cap, pcap, retry = escalate_capacities(
            probes, d, cap, cell_cap, pcap, has_grid=grid is not None
        )
        if not retry:
            break
    packed = finalize_giant(
        cs, torch.from_numpy(l2g).to(dev), k=k, n_max=int(n_max),
        solver=solver,
    ).cpu().numpy()
    num_cliques = int(np.ascontiguousarray(packed[0, :1]).view(np.int32)[0])
    body = packed[1:]
    valid = body[:, k + _G_VALID] > 0.5
    return {
        "member_idx": np.ascontiguousarray(body[:, :k]).view(np.int32),
        "w": body[:, k + _G_W],
        "confidence": body[:, k + _G_CONF],
        "rep_xy": body[:, k + _G_X : k + _G_Y + 1],
        "rep_slot": body[:, k + _G_SLOT].astype(np.int32),
        "valid": valid,
        "picked": (body[:, k + _G_PICKED] > 0.5) & valid,
        "num_cliques": num_cliques,
        "n_stripes": n_stripes,
        "stripe_capacity": nb,
        "config": (d, cap, cell_cap, pcap),
    }


# channels of finalize_giant's body after the K member-id channels
_G_PICKED, _G_VALID, _G_W, _G_CONF, _G_X, _G_Y, _G_SLOT = range(7)


def finalize_giant(cs, l2g, *, k: int, n_max: int, solver: str):
    """Stripe-local -> global members, the one global solve, and the
    result packed as one ``(1 + S*cap, K+7)`` float32 tensor: the head
    row holds the valid-clique total as int32 bits in channel 0; the
    body the global member ids (int32 bits), then picked, valid, w,
    confidence, rep_x, rep_y, rep_slot."""
    f32 = torch.float32
    glob = torch.stack(
        [torch.gather(l2g[:, p, :], 1, cs.member_idx[:, :, p].long())
         for p in range(k)],
        dim=-1,
    ).reshape(-1, k)                               # (S*cap, K)
    valid = cs.valid.reshape(-1)
    w = cs.w.reshape(-1)
    vid = glob + torch.arange(k, dtype=torch.int32,
                              device=glob.device)[None, :] * n_max
    vid = torch.where(valid[:, None], vid, torch.zeros_like(vid))
    solve = solve_lp_rounding if solver == "lp" else solve_greedy
    picked = solve(vid[None], w[None], valid[None], k * n_max)[0]
    rep_xy = cs.rep_xy.reshape(-1, 2).to(f32)
    body = torch.cat([
        glob.to(torch.int32).view(f32),
        picked.to(f32)[:, None],
        valid.to(f32)[:, None],
        w.to(f32)[:, None],
        cs.confidence.reshape(-1, 1).to(f32),
        rep_xy,
        cs.rep_slot.reshape(-1, 1).to(f32),
    ], dim=1)
    head = torch.zeros((1, k + 7), dtype=f32, device=body.device)
    head[0, 0] = cs.num_valid.sum().to(torch.int32).view(f32)
    return torch.cat([head, body], dim=0)
