"""Two-phase consensus, phase 1: cliques and their constraint matrix.

Writes per micrograph what ``repic_tpu``'s ``get_cliques`` writes:

    {base}_weight_vector.pickle          float32 (n,)
    {base}_consensus_coords.pickle       reps / per-picker member lists
    {base}_consensus_confidences.pickle  float32 (n,)
    {base}_constraint_matrix.pickle      scipy COO (|V| x n)
    {base}_runtime.tsv                   runtime, largest CC, #CC

(numpy arrays, lists of tuples and a scipy matrix: either package's
``run_ilp`` reads them).  The cliques come from the batched chunk loop
with one fetch of the whole result per chunk, and the component labels
from one more; the device program's picks are not used.

Particle ids are positional (sequential over micrographs and pickers in
processing order).  Two deliberate differences from the original REPIC
command, as in ``repic_tpu``:

* with ``--multi_out`` the singletons are the particles absent from
  every clique (the original's set difference compares tuples of
  different lengths and re-adds every particle; run_ilp's TSV is the
  same either way);
* each ``--multi_out`` column holds that picker's own coordinate (the
  original's node-name attributes are overwritten with wrong picker
  labels, which scatters coordinates into other pickers' columns).
"""

import os
import pickle
import shutil
import time

import numpy as np

from repic_tpu_torch.utils import box_io

name = "get_cliques"


def add_arguments(parser):
    parser.add_argument(
        "in_dir",
        help="path to input directory containing subdirectories of "
        "particle coordinate files",
    )
    parser.add_argument(
        "out_dir",
        help="path to output directory (WARNING - deleted if it exists)",
    )
    parser.add_argument(
        "box_size", type=int, help="particle detection box size (pixels)"
    )
    parser.add_argument(
        "--multi_out",
        action="store_true",
        help="output clique members sorted by picker name",
    )
    parser.add_argument(
        "--get_cc",
        action="store_true",
        help="keep only cliques in the largest connected component",
    )
    parser.add_argument(
        "--max_neighbors",
        type=int,
        default=16,
        help="initial neighbour capacity of the clique enumerator",
    )
    parser.add_argument(
        "--no_mesh",
        action="store_true",
        help="accepted for compatibility; the port runs on one device",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to run on (default cuda; fails when there is none)",
    )


def _vertex_tuples(ids, xy):
    """(x, y, id) node tuples in the reference's vertex identity."""
    return [
        (float(x), float(y), int(i)) for (x, y), i in zip(xy, ids)
    ]


def _dump(path, value):
    with box_io.atomic_write(path, "wb") as o:
        pickle.dump(value, o, protocol=pickle.HIGHEST_PROTOCOL)


def main(args):
    from scipy.sparse import coo_matrix

    from repic_tpu_torch.ops.cliques import DEFAULT_THRESHOLD
    from repic_tpu_torch.ops.components import (
        component_stats,
        largest_component_label,
    )
    from repic_tpu_torch.pipeline.consensus import (
        cc_labels_host,
        iter_consensus_chunks,
        resolve_device,
    )

    assert os.path.exists(
        args.in_dir
    ), "Error - input directory does not exist"
    dev = resolve_device(args.device)
    if os.path.isdir(args.out_dir):
        shutil.rmtree(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)

    pickers = box_io.discover_picker_dirs(args.in_dir)
    assert pickers, "Error - no picker subdirectories found"
    names = box_io.micrograph_names(os.path.join(args.in_dir, pickers[0]))
    k = len(pickers)
    print(f"Using {pickers[0]} BOX files as starting point")

    t_start = time.time()
    loaded = []
    for mname in names:
        sets = box_io.load_micrograph_set(args.in_dir, pickers, mname)
        if sets is None:
            print(
                f"Skipping micrograph {mname} - not all methods have "
                "picked particles..."
            )
            box_io.write_empty_box(
                os.path.join(args.out_dir, mname + ".box")
            )
        else:
            loaded.append((mname, sets))
    if not loaded:
        return

    # sequential particle ids over micrographs and pickers in
    # processing order
    next_id = 0
    per_micro_load = (time.time() - t_start) / max(len(loaded), 1)
    # the picks are not used: the cheapest device solver will do; one
    # fetch of the whole result per chunk, the labels one more
    for part, _batch, res, cc, chunk_s in iter_consensus_chunks(
        loaded, args.box_size, max_neighbors=args.max_neighbors,
        solver="greedy", device=dev, fetch=True,
        extra_device_outputs=lambda b: cc_labels_host(
            b, float(args.box_size), DEFAULT_THRESHOLD, dev),
    ):
        (labels_b, node_mask_b), _rounds = cc
        # the chunk's device time, shared among its micrographs
        per_micro_runtime = per_micro_load + chunk_s / max(len(part), 1)
        for i, (mname, sets) in enumerate(part):
            t0 = time.time()
            counts = [s.n for s in sets]
            id_base = [next_id + int(np.sum(counts[:p])) for p in range(k)]
            next_id += int(np.sum(counts))

            valid = res.valid[i]
            member_idx = res.member_idx[i][valid]  # (n, K)
            w = res.w[i][valid]
            conf = res.confidence[i][valid]
            rep_slot = res.rep_slot[i][valid]
            rep_xy = res.rep_xy[i][valid]

            if args.get_cc:
                keep_label = largest_component_label(
                    labels_b[i], node_mask_b[i]
                )
                keep = labels_b[i][0, member_idx[:, 0]] == keep_label
                member_idx, w, conf = member_idx[keep], w[keep], conf[keep]
                rep_slot, rep_xy = rep_slot[keep], rep_xy[keep]

            n = len(w)
            num_cc, max_cc, _ = component_stats(labels_b[i], node_mask_b[i])

            node_id = member_idx + np.asarray(id_base)[None, :]  # (n, K)
            node_xy = np.stack(
                [sets[p].xy[member_idx[:, p]] for p in range(k)], axis=1
            )  # (n, K, 2)

            if args.multi_out:
                coords_out = [list(pickers)]
                for c in range(n):
                    coords_out.append(
                        _vertex_tuples(node_id[c], node_xy[c])
                    )
                if not args.get_cc:
                    for p in range(k):
                        present = (
                            np.unique(member_idx[:, p])
                            if n
                            else np.empty(0, np.int64)
                        )
                        for j in np.setdiff1d(
                            np.arange(counts[p]), present
                        ):
                            entry = [None] * k
                            entry[p] = (
                                float(sets[p].xy[j, 0]),
                                float(sets[p].xy[j, 1]),
                                int(id_base[p] + j),
                            )
                            coords_out.append(entry)
            else:
                rep_particle = member_idx[np.arange(n), rep_slot]
                rep_ids = np.asarray(id_base)[rep_slot] + rep_particle
                coords_out = _vertex_tuples(rep_ids, rep_xy)

            # constraint matrix over the participating vertices sorted
            # as (x, y, id) tuples: np.unique(axis=0) sorts the rows
            # that way, and its inverse is each (clique, picker)
            # entry's row
            entries = np.concatenate(
                [
                    node_xy.reshape(n * k, 2).astype(np.float64),
                    node_id.reshape(n * k, 1).astype(np.float64),
                ],
                axis=1,
            )
            uniq, inverse = np.unique(entries, axis=0, return_inverse=True)
            n_vertices = len(uniq)
            cols = np.repeat(np.arange(n, dtype=np.int64), k)
            a_mat = coo_matrix(
                (np.ones(n * k, np.int64), (inverse.reshape(-1), cols)),
                shape=(n_vertices, n),
            )
            print(f"--- {mname}: {n} cliques, {n_vertices} vertices")

            for label, val in zip(
                [
                    "weight_vector",
                    "consensus_coords",
                    "consensus_confidences",
                    "constraint_matrix",
                ],
                [
                    w.astype(np.float32),
                    coords_out,
                    conf.astype(np.float32),
                    a_mat,
                ],
            ):
                _dump(
                    os.path.join(args.out_dir, f"{mname}_{label}.pickle"),
                    val,
                )

            with box_io.atomic_write(
                os.path.join(args.out_dir, f"{mname}_runtime.tsv")
            ) as o:
                runtime = per_micro_runtime + (time.time() - t0)
                o.write(
                    "\t".join(str(v) for v in [runtime, max_cc, num_cc])
                    + "\n"
                )
