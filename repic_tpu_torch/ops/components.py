"""Connected components of the k-partite overlap graph.

The per-micrograph component statistics (count, largest) of the
``get_cliques`` runtime table and the ``--get_cc`` filter, which keeps
only the cliques inside the largest component.  Components come from
min-label propagation over the masked pairwise adjacency: each round
takes, for every picker pair, each node's minimum neighbour label
across the pair, until no label changes.  The round count is the
graph's diameter, which for particle-overlap graphs is the size of the
largest overlap cluster (small); each round costs one host check.
Batched over micrographs.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repic_tpu_torch.ops.cliques import DEFAULT_THRESHOLD
from repic_tpu_torch.ops.iou import pairwise_iou_matrix

_BIG = 2**30


def connected_component_labels(
    xy: torch.Tensor,
    mask: torch.Tensor,
    box_size,
    *,
    threshold: float = DEFAULT_THRESHOLD,
):
    """Label each particle-node with its component's minimum vertex id.

    Only particles in at least one above-threshold edge are graph
    nodes; the others get ``node_mask`` False.  ``box_size`` is a
    scalar or one size per picker (the clique graph's sizes).

    Args:
        xy/mask: ``(M, K, N, 2)`` / ``(M, K, N)``.

    Returns:
        ``(labels, node_mask, rounds)``: ``(M, K, N)`` int32 labels
        (the minimum global vertex id ``slot * N + index`` of the
        component; undefined where ``node_mask`` is False), the
        ``(M, K, N)`` bool node mask, and the propagation rounds run
        (the last one changes nothing).
    """
    m, k, n, _ = xy.shape
    dev = xy.device
    sizes = torch.as_tensor(box_size, dtype=torch.float32, device=dev)
    per_picker = sizes.dim() > 0
    thr = torch.tensor(threshold, dtype=torch.float32, device=dev)
    adj = {}
    for p, q in itertools.combinations(range(k), 2):
        adj[p, q] = pairwise_iou_matrix(
            xy[:, p], mask[:, p], xy[:, q], mask[:, q],
            sizes[p] if per_picker else sizes,
            sizes[q] if per_picker else None,
        ) > thr                                        # (M, N, N)
    node_mask = torch.zeros((m, k, n), dtype=torch.bool, device=dev)
    for (p, q), a in adj.items():
        node_mask[:, p] |= a.any(2)
        node_mask[:, q] |= a.any(1)
    vid = torch.arange(k * n, dtype=torch.int32, device=dev).reshape(k, n)
    big = torch.tensor(_BIG, dtype=torch.int32, device=dev)
    labels = torch.where(node_mask, vid, big)
    rounds = 0
    while True:
        new = labels.clone()
        for (p, q), a in adj.items():
            from_q = torch.where(a, new[:, q, None, :], big).amin(2)
            from_p = torch.where(a, new[:, p, :, None], big).amin(1)
            new[:, p] = torch.minimum(new[:, p], from_q)
            new[:, q] = torch.minimum(new[:, q], from_p)
        rounds += 1
        if not bool((new != labels).any()):
            return new, node_mask, rounds
        labels = new


def component_stats(labels, node_mask):
    """``(num_components, largest, mean)`` of one micrograph's host
    labels and node mask."""
    lab = np.asarray(labels)[np.asarray(node_mask)]
    if lab.size == 0:
        return 0, 0, 0.0
    _, counts = np.unique(lab, return_counts=True)
    return len(counts), int(counts.max()), float(counts.mean())


def largest_component_label(labels, node_mask):
    """Label of the largest component (ties: the smallest label), or
    -1 — a label no node carries — when the graph has no node."""
    lab = np.asarray(labels)[np.asarray(node_mask)]
    if lab.size == 0:
        return -1
    uniq, counts = np.unique(lab, return_counts=True)
    return int(uniq[np.argmax(counts)])
