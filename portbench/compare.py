"""The comparisons that decide ``correct``: the numbers a run compares,
each against its limit (``portbench/limits/<cell>.json``).

Consensus: the program's packed full result of a sampled micrograph,
decoded, against :func:`portbench.reference.consensus.consensus` on the
same particles.  Picking: the program's score map and picks against
:mod:`portbench.reference.picker` on the same micrograph and weights.
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(cell: str) -> dict:
    """The limits of one cell, by name."""
    with open(os.path.join(HERE, "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


def decode_full(packed_row: np.ndarray, k: int) -> dict:
    """One micrograph of the program's packed full result
    (``(C+1, K+7)`` float32: a head row of probes, then per clique the
    K member ids as int32 bits, rep x, rep y, weight, confidence, the
    representative's slot as int32 bits, picked, valid)."""
    body = np.asarray(packed_row[1:], np.float32)
    members = np.ascontiguousarray(body[:, :k]).view(np.int32)
    return dict(
        members=members.astype(np.int64),
        rep_xy=body[:, k:k + 2],
        w=body[:, k + 2],
        confidence=body[:, k + 3],
        rep_slot=np.ascontiguousarray(body[:, k + 4]).view(np.int32),
        picked=body[:, k + 5] > 0.5,
        valid=body[:, k + 6] > 0.5,
    )


def _keys(members: np.ndarray, base: int) -> np.ndarray:
    key = np.zeros(len(members), np.int64)
    for p in range(members.shape[1] - 1, -1, -1):
        key = key * base + members[:, p]
    return key


def key_base(k: int, n_base: int, *member_sets) -> int:
    """The base of the clique keys: ``n_base``, or one more than the
    largest member id where that is larger, so that a key names one
    clique whatever the micrograph's size."""
    top = max([int(m.max()) for m in member_sets if m.size] + [-1])
    base = max(int(n_base), top + 1)
    if base ** k >= 2 ** 63:
        raise ValueError(f"clique keys of {k} ids under {base} overflow "
                         "int64")
    return base


def consensus_numbers(port: dict, ref, n_base: int = 4096) -> dict:
    """The numbers of one micrograph.

    ``clique_diff``: cliques in one set and not the other; ``cliques``:
    the reference's count; ``value_gap``: over the shared cliques, the
    largest relative gap of weight or confidence, 1 where the
    representative differs; ``conflicts``: particles that two picked
    rows share, plus picked rows that are no valid clique;
    ``picks_diff``: picked cliques in one packing and not the other;
    ``picks``: the reference's count; ``objective_gap``: the relative
    gap of the weight sums of the two packings.
    """
    valid = port["valid"]
    members = port["members"][valid]
    picked = port["picked"]
    k = members.shape[1]
    pm = port["members"][picked]
    n_base = key_base(k, n_base, members, ref.members)
    pk = _keys(members, n_base)
    rk = _keys(ref.members, n_base)
    shared, pi, ri = np.intersect1d(pk, rk, assume_unique=False,
                                    return_indices=True)
    clique_diff = (len(np.unique(pk)) - len(shared)) + (len(rk) - len(shared))
    gap = 0.0
    if len(shared):
        pw = port["w"][valid][pi].astype(np.float64)
        rw = ref.w[ri].astype(np.float64)
        pc = port["confidence"][valid][pi].astype(np.float64)
        rc = ref.confidence[ri].astype(np.float64)
        gap = max(float(np.max(np.abs(pw - rw) / np.maximum(rw, 1e-12))),
                  float(np.max(np.abs(pc - rc) / np.maximum(rc, 1e-12))))
        rep_bad = (port["rep_slot"][valid][pi] != ref.rep_slot[ri]) | \
            np.any(port["rep_xy"][valid][pi] != ref.rep_xy[ri], axis=1)
        if rep_bad.any():
            gap = max(gap, 1.0)
    vid = (pm + np.arange(k)[None] * n_base).ravel()
    conflicts = (len(vid) - len(np.unique(vid))) + int(
        np.sum(picked & ~valid))
    ppk = _keys(pm, n_base)
    rpk = rk[ref.picked]
    picks_shared = len(np.intersect1d(ppk, rpk))
    picks_diff = (len(ppk) - picks_shared) + (len(rpk) - picks_shared)
    obj_p = float(port["w"][picked].astype(np.float64).sum())
    obj_r = float(ref.w[ref.picked].astype(np.float64).sum())
    return dict(
        clique_diff=int(clique_diff), cliques=int(len(rk)),
        value_gap=gap, conflicts=int(conflicts),
        picks_diff=int(picks_diff), picks=int(len(rpk)),
        objective_gap=abs(obj_p - obj_r) / max(obj_r, 1e-12),
    )


def fold_consensus(per_mic: list[dict]) -> dict:
    """A run's consensus numbers over its sampled micrographs."""
    cliques = max(sum(d["cliques"] for d in per_mic), 1)
    picks = max(sum(d["picks"] for d in per_mic), 1)
    return {
        "clique_set_diff": sum(d["clique_diff"] for d in per_mic) / cliques,
        "clique_value_gap": max(d["value_gap"] for d in per_mic),
        "packing_conflicts": sum(d["conflicts"] for d in per_mic),
        "picks_differ": sum(d["picks_diff"] for d in per_mic) / picks,
        "objective_gap": max(d["objective_gap"] for d in per_mic),
    }


def pick_numbers(port_map, ref_map, port_picks, ref_picks,
                 cell_px: float) -> dict:
    """The numbers of one micrograph: the mean absolute gap of the
    score maps, and the picks of either side with no pick of the other
    within ``cell_px`` (one score-map cell, in pixels)."""
    port_map = np.asarray(port_map, np.float64)
    ref_map = np.asarray(ref_map, np.float64)
    if port_map.shape != ref_map.shape:
        return dict(mean_gap=np.inf,
                    unmatched=max(len(port_picks), len(ref_picks), 1),
                    picks=max(len(ref_picks), 1))
    def unmatched(a, b):
        if len(a) == 0:
            return 0
        if len(b) == 0:
            return len(a)
        dist = np.hypot(a[:, None, 0] - b[None, :, 0],
                        a[:, None, 1] - b[None, :, 1])
        return int(np.sum(dist.min(1) > cell_px))

    return dict(
        mean_gap=float(np.abs(port_map - ref_map).mean()),
        unmatched=unmatched(port_picks, ref_picks)
        + unmatched(ref_picks, port_picks),
        picks=max(len(ref_picks), 1),
    )


def fold_pick(per_mic: list[dict]) -> dict:
    """A run's picker numbers.  The largest gap of a map is not
    compared: one window whose min-max scaling rounds a pixel to the
    other 8-bit level moves it by up to 1e-3 in sound runs, within 3x
    of the control (PERF.md section 2)."""
    picks = sum(d["picks"] for d in per_mic)
    return {
        "score_mean_gap": max(d["mean_gap"] for d in per_mic),
        "picks_unmatched": sum(d["unmatched"] for d in per_mic) / picks,
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit), ...])``: every number at or
    under its limit; a number with no limit, or a limit with no number,
    is not correct."""
    rows = []
    ok = set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(name), limits.get(name)
        rows.append((name, v, lim))
        if v is None or lim is None or not (float(v) <= float(lim)):
            ok = False
    return ok, rows
