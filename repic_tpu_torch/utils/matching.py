"""Distance-based pick analysis: centre-distance matching metrics (the
port of ``repic_tpu.utils.matching``; numpy only).

A picked coordinate is a true positive iff its centre lies within
``minimum_distance_rate * particle_size`` of an unclaimed ground-truth
coordinate; references claim their closest candidate greedily in file
order.  The analysis reports precision / recall at confidence 0.5 and
a confidence-sorted cumulative curve (TP count, recall, precision,
probability, mean centre deviation of the TPs so far), written as the
five-row CSV ``results.txt`` with its footer.  Degenerate inputs (no
picks above 0.5, no matches, no references) give 0.0 rather than a
division by zero.
"""

import os

import numpy as np


def greedy_center_match(pick_xy, ref_xy, radius):
    """Match picks to references by the reference's greedy protocol.

    Each reference, in order, claims the closest still-unclaimed pick
    strictly within ``radius`` (ties: lowest pick index — the
    reference's stable distance sort).  Each pick matches at most one
    reference and vice versa.

    Args:
        pick_xy: ``(n_pick, 2)`` float64 pick centers.
        ref_xy: ``(n_ref, 2)`` float64 reference centers.
        radius: scalar match radius (``rate * particle_size``).

    Returns:
        matched: ``(n_pick,)`` bool.
        dist: ``(n_pick,)`` float64 — center deviation of matched
            picks; 0 where unmatched.
    """
    pick_xy = np.asarray(pick_xy, np.float64).reshape(-1, 2)
    ref_xy = np.asarray(ref_xy, np.float64).reshape(-1, 2)
    n_pick = len(pick_xy)
    matched = np.zeros(n_pick, bool)
    dist_out = np.zeros(n_pick, np.float64)
    if n_pick == 0 or len(ref_xy) == 0:
        return matched, dist_out
    # one vectorized distance matrix; the claim loop is sequential by
    # specification (order-dependent greedy)
    d = np.sqrt(
        ((ref_xy[:, None, :] - pick_xy[None, :, :]) ** 2).sum(-1)
    )
    for r in range(len(ref_xy)):
        cand = np.where(~matched & (d[r] < radius), d[r], np.inf)
        j = int(np.argmin(cand))
        if cand[j] < np.inf:
            matched[j] = True
            dist_out[j] = cand[j]
    return matched, dist_out


def analyze_distance_matches(per_micrograph, particle_size, rate=0.2):
    """Run the full distance analysis over matched file pairs.

    Args:
        per_micrograph: iterable of ``(pick_xy, pick_conf, ref_xy)``
            triples, one per micrograph, in processing order (the
            global curve's tie order follows it).
        particle_size: particle diameter in pixels.
        rate: match radius as a fraction of ``particle_size``
            (reference default 0.2).

    Returns:
        dict with the reference's aggregates: ``tp_05``, ``total_pick_05``,
        ``total_reference``, ``precision_05``, ``recall_05``, ``n_total``,
        and the cumulative curve arrays ``tp``, ``recall``, ``precision``,
        ``probability``, ``avg_distance`` over all picks sorted by
        confidence descending (stable).
    """
    radius = particle_size * rate
    confs, flags, dists = [], [], []
    tp_05 = total_pick_05 = total_ref = 0
    for pick_xy, pick_conf, ref_xy in per_micrograph:
        pick_conf = np.asarray(pick_conf, np.float64).reshape(-1)
        matched, dist = greedy_center_match(pick_xy, ref_xy, radius)
        total_ref += len(np.asarray(ref_xy).reshape(-1, 2))
        over = pick_conf > 0.5
        total_pick_05 += int(over.sum())
        tp_05 += int((over & matched).sum())
        confs.append(pick_conf)
        flags.append(matched)
        dists.append(dist)

    confs = np.concatenate(confs) if confs else np.zeros(0)
    flags = np.concatenate(flags) if flags else np.zeros(0, bool)
    dists = np.concatenate(dists) if dists else np.zeros(0)
    # stable descending == the reference's sorted(key=score, reverse=True)
    order = np.argsort(-confs, kind="stable")

    # Sequential accumulation in sorted order, exactly as the
    # reference sums (bitwise-reproducible float adds; n is analysis
    # scale, this is not a hot path).
    tp_curve, rec_curve, prec_curve, prob_curve, avg_curve = (
        [], [], [], [], []
    )
    tp = 0
    total_distance = 0.0
    for rank, idx in enumerate(order):
        if flags[idx]:
            tp += 1
            total_distance = total_distance + float(dists[idx])
        tp_curve.append(tp)
        rec_curve.append(tp / total_ref if total_ref else 0.0)
        prec_curve.append(tp / (rank + 1))
        prob_curve.append(float(confs[idx]))
        avg_curve.append(total_distance / tp if tp else 0)
    return {
        "tp_05": tp_05,
        "total_pick_05": total_pick_05,
        "total_reference": total_ref,
        "precision_05": tp_05 / total_pick_05 if total_pick_05 else 0.0,
        "recall_05": tp_05 / total_ref if total_ref else 0.0,
        "n_total": len(order),
        "tp": tp_curve,
        "recall": rec_curve,
        "precision": prec_curve,
        "probability": prob_curve,
        "avg_distance": avg_curve,
    }


def write_results_txt(analysis, out_dir) -> str:
    """The reference's ``results.txt`` surface, byte-compatible
    (autoPicker.py:427-462): five CSV rows, counts, row legend, then
    precision/recall sampled at each multiple of the reference count."""
    from repic_tpu_torch.runtime.atomic import atomic_write

    out_file = os.path.join(out_dir, "results.txt")
    a = analysis
    with atomic_write(out_file) as f:
        f.write(",".join(map(str, a["tp"])) + "\n")
        f.write(",".join(map(str, a["recall"])) + "\n")
        f.write(",".join(map(str, a["precision"])) + "\n")
        f.write(",".join(map(str, a["probability"])) + "\n")
        f.write(",".join(map(str, a["avg_distance"])) + "\n")
        f.write("#total autopick number:%d\n" % a["n_total"])
        f.write("#total manual pick number:%d\n" % a["total_reference"])
        f.write("#the first row is number of true positive\n")
        f.write("#the second row is recall\n")
        f.write("#the third row is precision\n")
        f.write("#the fourth row is probability\n")
        f.write("#the fiveth row is distance\n")
        total_ref = a["total_reference"]
        if total_ref and a["n_total"]:
            times = a["n_total"] // total_ref + 1
            for i in range(times):
                f.write(
                    "#autopick_total sort, take the head number of "
                    "total_manualpick * ratio %d \n" % (i + 1)
                )
                at = (
                    -1 if i == times - 1
                    else (i + 1) * total_ref - 1
                )
                f.write(
                    "precision:%f \trecall:%f \n"
                    % (a["precision"][at], a["recall"][at])
                )
    return out_file
