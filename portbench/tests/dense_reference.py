"""The plain consensus reference in its dense form, kept for tests: the
overlap of every particle pair of every picker pair (``n_p x n_q``
arrays) and a greedy loop over the rows one at a time.  The benchmark's
reference (``portbench/reference/consensus.py``) has to equal it bit
for bit, in order.

It imports nothing of the program.  From the same particles it works
out again what the program's chunk program derives: the overlap graph,
every k-clique, each clique's confidence, weight and representative,
and the ``lp_device`` packing (dual ascent, rounding and repair), one
micrograph at a time and one clique at a time where the program
batches.

Semantics (REPIC, as the consensus engine states them):

* boxes are squares with their corner at ``(x, y)``; the overlap of
  two boxes is ``inter / (sa^2 + sb^2 - inter)``, and an edge joins
  particles of different pickers whose overlap exceeds the threshold;
* a clique holds one particle of every picker, every pair joined;
* its confidence is the median of its members' confidences, its weight
  the confidence times the median of its edges' overlaps (an even
  count takes the mean of the two middle values), its representative
  the member of the largest summed overlap (the first on a tie);
* cliques are listed by anchor (picker 0's particle), then for each
  further picker by the member's overlap with the anchor, largest
  first, then its index; then by weight, largest first, that order
  kept on ties;
* the packing: at most ``num_iters`` dual-ascent steps on the vertex
  prices (threshold primal, projected subgradient step ``eta0 / (1 +
  t)``, stop once the largest price move over ``eta0`` is at most
  ``tol``, the second half's prices averaged), then greedy rounding by
  reduced cost at zero, final and averaged prices, each followed by a
  greedy repair by weight over the cliques left free, and the first of
  the three with the largest weight sum.

Every float operation rounds to ``precision``: float32 (the
configuration's), or bfloat16 for the control.  Sums of weights for
the final choice are exact (float64).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np

NUM_ITERS = 200
TOL = 1e-3


def to_bf16(x) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), kept
    in float32."""
    x = np.asarray(x, np.float32)
    a = np.ascontiguousarray(x).view(np.uint32)
    r = ((a >> 16) & 1) + np.uint32(0x7FFF)
    return ((a + r) & np.uint32(0xFFFF0000)).view(np.float32).reshape(
        x.shape)


class Arith:
    """The rounding of one precision: ``r(x)`` rounds an op's float32
    result."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.r = (lambda x: np.asarray(x, np.float32)) \
            if precision == "float32" else to_bf16


class Cliques(NamedTuple):
    """One micrograph's cliques, in the packing's order."""

    members: np.ndarray     # (C, K) int64 particle index per picker
    w: np.ndarray           # (C,) float32
    confidence: np.ndarray  # (C,) float32
    rep_slot: np.ndarray    # (C,) int64
    rep_xy: np.ndarray      # (C, 2) float32
    picked: np.ndarray      # (C,) bool


def overlap(ar, xa, ya, sa, xb, yb, sb):
    """Box overlap of every ``a`` against every ``b`` (broadcast)."""
    r = ar.r
    ovx = np.maximum(r(np.minimum(r(xa + sa), r(xb + sb))
                       - np.maximum(xa, xb)), np.float32(0))
    ovx = r(ovx)
    ovy = r(np.maximum(r(np.minimum(r(ya + sa), r(yb + sb))
                         - np.maximum(ya, yb)), np.float32(0)))
    inter = r(ovx * ovy)
    return r(inter / r(r(r(sa * sa) + r(sb * sb)) - inter))


def cliques_of(xy, conf, sizes, threshold: float, ar: Arith):
    """Every k-clique of one micrograph: ``xy[p]`` ``(n_p, 2)``,
    ``conf[p]`` ``(n_p,)`` per picker, ``sizes`` ``(K,)``.  Returns
    ``(members (C, K) in listing order, {(p, q): overlaps})``."""
    r = ar.r
    k = len(xy)
    xy = [r(np.asarray(v, np.float32)) for v in xy]
    sz = [r(np.float32(s)) for s in sizes]
    thr = r(np.float32(threshold))
    iou = {}
    for p, q in itertools.combinations(range(k), 2):
        iou[p, q] = overlap(
            ar, xy[p][:, None, 0], xy[p][:, None, 1], sz[p],
            xy[q][None, :, 0], xy[q][None, :, 1], sz[q])
    adj = {pq: v > thr for pq, v in iou.items()}
    tuples = np.arange(len(xy[0]), dtype=np.int64)[:, None]
    for s in range(1, k):
        rows, cols = np.nonzero(adj[0, s][tuples[:, 0]])
        grown = np.concatenate([tuples[rows], cols[:, None]], axis=1)
        ok = np.ones(len(grown), bool)
        for p in range(1, s):
            ok &= adj[p, s][grown[:, p], grown[:, s]]
        tuples = grown[ok]
    # anchor, then per picker (overlap with the anchor desc, index asc)
    keys = []
    for s in range(k - 1, 0, -1):
        keys += [tuples[:, s], -iou[0, s][tuples[:, 0], tuples[:, s]]]
    keys.append(tuples[:, 0])
    order = np.lexsort(keys) if len(tuples) else np.zeros(0, np.int64)
    return tuples[order], iou


def clique_stats(members, conf, xy, iou, ar: Arith):
    """Confidence, weight, representative slot and coordinates."""
    r = ar.r
    k = members.shape[1]
    c = len(members)
    confs = np.stack([r(np.asarray(conf[p], np.float32))[members[:, p]]
                      for p in range(k)], 1) if c else np.zeros((0, k))
    pairs = list(itertools.combinations(range(k), 2))
    edges = np.stack([iou[p, q][members[:, p], members[:, q]]
                      for p, q in pairs], 1) if c else np.zeros((0, 1))

    def median(v):
        s = np.sort(v, axis=1)
        n = v.shape[1]
        lo, hi = s[:, (n - 1) // 2], s[:, n // 2]
        return r(r(lo + hi) * np.float32(0.5))

    confidence = median(confs).astype(np.float32)
    w = r(confidence * median(edges)).astype(np.float32)
    degs = []
    for slot in range(k):
        acc = None
        for e, (p, q) in enumerate(pairs):
            if slot in (p, q):
                acc = edges[:, e] if acc is None else r(acc + edges[:, e])
        degs.append(acc)
    rep_slot = np.argmax(np.stack(degs, 1), axis=1) if c else \
        np.zeros(0, np.int64)
    xys = [r(np.asarray(v, np.float32)) for v in xy]
    rep_xy = np.zeros((c, 2), np.float32)
    for slot in range(k):
        sel = rep_slot == slot
        rep_xy[sel] = xys[slot][members[sel, slot]]
    return w, confidence, rep_slot, rep_xy


def greedy(mv, prio, alive, n_vertices):
    """Greedy packing in (priority desc, index asc) order over the
    ``alive`` rows."""
    order = np.lexsort((np.arange(len(prio)), -prio.astype(np.float64)))
    used = np.zeros(n_vertices, bool)
    out = np.zeros(len(prio), bool)
    rows = mv.tolist()
    alive = alive.tolist()
    for i in order.tolist():
        if not alive[i]:
            continue
        row = rows[i]
        if any(used[v] for v in row):
            continue
        out[i] = True
        used[row] = True
    return out


def _gather_sum(prices, mv, ar):
    s = prices[mv[:, 0]]
    for j in range(1, mv.shape[1]):
        s = ar.r(s + prices[mv[:, j]])
    return s


def dual_packing(mv, w, n_vertices, ar: Arith, num_iters=NUM_ITERS,
                 tol=TOL):
    """The ``lp_device`` packing of one micrograph's cliques."""
    r = ar.r
    c = len(w)
    if c == 0:
        return np.zeros(0, bool)
    f32 = np.float32
    eta0 = r(max(f32(w.max()), f32(1e-6)))
    tol = r(f32(tol))
    lam = np.zeros(n_vertices, f32)
    lam_sum = np.zeros(n_vertices, f32)
    n_tail, t, delta = 0, 0, f32(np.inf)
    half = num_iters // 2
    while t < num_iters and delta > tol:
        red = r(w - _gather_sum(lam, mv, ar))
        x = red > 0
        ax = np.bincount(mv[x].ravel(), minlength=n_vertices).astype(f32)
        eta = r(eta0 / r(f32(1.0) + f32(t)))
        # one rounding of eta * (ax - 1) + lam
        step = (lam.astype(np.float64)
                + np.float64(eta) * (ax.astype(np.float64) - 1.0))
        lam_new = np.maximum(r(step.astype(f32)), f32(0))
        delta = r(f32(np.abs(r(lam_new - lam)).max()) / eta0)
        if t >= half:
            lam_sum = r(lam_sum + lam_new)
            n_tail += 1
        lam = lam_new
        t += 1
    lam_avg = r(lam_sum / f32(n_tail)) if n_tail else lam
    best, best_val = None, -1.0
    for prices in (np.zeros(n_vertices, f32), lam, lam_avg):
        red = r(w - _gather_sum(prices, mv, ar))
        sel0 = greedy(mv, red, red > 0, n_vertices)
        used = np.zeros(n_vertices, bool)
        used[mv[sel0].ravel()] = True
        free = ~sel0 & ~used[mv].any(1) & (w > 0)
        sel1 = greedy(mv, w, free, n_vertices)
        cand = sel0 | sel1
        val = float(w[cand].astype(np.float64).sum())
        if val > best_val:
            best, best_val = cand, val
    return best


def consensus(xy, conf, sizes, threshold: float,
              precision: str = "float32") -> Cliques:
    """One micrograph's cliques and packing (see the module doc)."""
    ar = Arith(precision)
    k = len(xy)
    members, iou = cliques_of(xy, conf, sizes, threshold, ar)
    w, confidence, rep_slot, rep_xy = clique_stats(members, conf, xy,
                                                   iou, ar)
    order = np.argsort(-w.astype(np.float64), kind="stable")
    members, w, confidence = members[order], w[order], confidence[order]
    rep_slot, rep_xy = rep_slot[order], rep_xy[order]
    n_max = max(len(v) for v in xy)
    mv = members + np.arange(k, dtype=np.int64)[None] * n_max
    picked = dual_packing(mv, w, k * n_max, ar)
    return Cliques(members, w, confidence, rep_slot, rep_xy, picked)
