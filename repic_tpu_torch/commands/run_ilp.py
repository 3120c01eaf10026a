"""Two-phase consensus, phase 2: solve the packing of each micrograph.

Reads the ``{base}_{constraint_matrix,weight_vector,consensus_coords,
consensus_confidences}.pickle`` files that either package's
``get_cliques`` writes, solves

    maximize w.x  s.t.  A x <= 1,  x binary

checks that no particle is in two chosen cliques, and writes
``{base}.box`` (rows by confidence descending, optional
``--num_particles`` cutoff) or, for multi-out pickles, ``{base}.tsv``
(per-picker columns, then the unchosen particles as confidence-0
rows), appending the solve time to ``{base}_runtime.tsv``.

Backends: ``exact`` (default; branch-and-bound over conflict
components, host C++), ``greedy`` and ``lp`` (the device solvers; on
``cuda`` unless ``--device cpu``).
"""

import glob
import os
import pickle
import time

import numpy as np

name = "run_ilp"


def add_arguments(parser):
    parser.add_argument(
        "in_dir", help="path to input directory containing get_cliques output"
    )
    parser.add_argument(
        "box_size", type=int, help="particle detection box size (pixels)"
    )
    parser.add_argument(
        "--num_particles",
        type=int,
        help="filter for the number of expected particles",
    )
    parser.add_argument(
        "--backend",
        choices=["exact", "greedy", "lp"],
        default="exact",
        help="solver backend (default: exact branch-and-bound on the "
        "host; greedy = parallel greedy dominance; lp = LP relaxation "
        "+ rounding, never worse than greedy)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device of the greedy and lp backends (default cuda; "
        "fails when there is none)",
    )


def _solve(a_mat, w, backend, device="cpu"):
    """Pick cliques; returns a bool mask over the cliques."""
    csc = a_mat.tocsc()
    n = csc.shape[1]
    if n == 0:
        return np.zeros(0, bool)
    counts = np.diff(csc.indptr)
    k = counts.max()
    # member lists padded to k with a private vertex per clique
    mv = np.full((n, k), 0, np.int64)
    extra = csc.shape[0]
    for j in range(n):
        col = csc.indices[csc.indptr[j] : csc.indptr[j + 1]]
        mv[j, : len(col)] = col
        if len(col) < k:
            mv[j, len(col) :] = extra + j  # unique, conflict-free
    if backend == "exact":
        from repic_tpu_torch.ops.solver import solve_exact

        return solve_exact(mv, np.asarray(w, np.float64))
    import torch

    from repic_tpu_torch.ops.solver import solve_greedy, solve_lp_rounding

    solver = solve_lp_rounding if backend == "lp" else solve_greedy
    picked = solver(
        torch.as_tensor(mv, dtype=torch.int32, device=device)[None],
        torch.as_tensor(np.asarray(w, np.float32), device=device)[None],
        torch.ones((1, n), dtype=torch.bool, device=device),
        extra + n,
    )
    return picked[0].cpu().numpy()


def _tsv_cell(v):
    if not v:
        return "N/A\tN/A"
    return f"{int(np.rint(v[0]))}\t{int(np.rint(v[1]))}"


def main(args):
    from repic_tpu_torch.utils.box_io import atomic_write, write_box

    assert os.path.isdir(args.in_dir), "Error - input directory is missing"
    device = "cpu"
    if args.backend != "exact":
        from repic_tpu_torch.pipeline.consensus import resolve_device

        device = resolve_device(args.device)

    for matrix_file in sorted(
        glob.glob(os.path.join(args.in_dir, "*_constraint_matrix.pickle"))
    ):
        start = time.time()
        base = os.path.basename(matrix_file).replace(
            "_constraint_matrix.pickle", ""
        )
        print(f"\n--- {base} ---\n")

        def load(label):
            with open(matrix_file.replace("_constraint_matrix", label),
                      "rb") as f:
                return pickle.load(f)

        a_mat = load("_constraint_matrix")
        w = load("_weight_vector")
        picked = _solve(a_mat, w, args.backend, device)

        # feasibility: no particle in two chosen cliques
        x = picked.astype(np.int64)
        if len(x):
            loads = np.asarray(a_mat.tocsr() @ x)
            assert loads.max() <= 1, (
                "Error - vertices are assigned to multiple cliques"
            )

        coords = load("_consensus_coords")
        confidences = load("_consensus_confidences")
        multi_out = bool(coords) and isinstance(coords[0][0], str)
        if multi_out:
            labels = coords[0]
            coords = coords[1:]
        chosen = [
            (coords[i], float(confidences[i])) for i in np.where(picked)[0]
        ]
        out_file = matrix_file.replace(
            "_constraint_matrix.pickle", ".tsv" if multi_out else ".box"
        )
        if multi_out:
            # per-picker columns; the unchosen vertices re-added as
            # confidence-0 singleton rows, sorted as (x, y, id) tuples
            k = len(labels)
            rows = [c for c, _ in chosen]
            weights = [wt for _, wt in chosen]
            chosen_sets = [
                {tuple(col[i]) for col in rows if col[i]} for i in range(k)
            ]
            all_sets = [
                {tuple(col[i]) for col in coords if col[i]}
                for i in range(k)
            ]
            for i in range(k):
                for node in sorted(all_sets[i] - chosen_sets[i]):
                    entry = [None] * k
                    entry[i] = node
                    rows.append(entry)
                    weights.append(0.0)
            with atomic_write(out_file) as o:
                o.write("\t".join(labels) + "\n")
                o.write("\n".join(
                    "\t".join([_tsv_cell(v) for v in vals] + [str(wt)])
                    for vals, wt in zip(rows, weights)
                ))
        else:
            xy = np.array([[c[0], c[1]] for c, _ in chosen], np.float64)
            wt = np.array([wt for _, wt in chosen], np.float32)
            write_box(out_file, xy.reshape(-1, 2), wt, args.box_size,
                      num_particles=args.num_particles)

        with open(
            matrix_file.replace("_constraint_matrix.pickle", "_runtime.tsv"),
            "a",
        ) as o:
            o.write(str(time.time() - start) + "\n")
