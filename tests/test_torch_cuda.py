"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA GPU: it carries the ``cuda`` marker and
takes the ``cuda_device`` fixture, which skips it, with a reason, where
there is none.  The file imports no JAX and does not need the suite's
``conftest.py`` (which does), so on a machine with a card and without
JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -q

The plain versions are themselves held to the JAX package by the other
``tests/test_torch_*.py`` files on the CPU.
"""

import os

import numpy as np
import pytest

from repic_tpu_torch.ops import iou_pallas as tk
from repic_tpu_torch.ops import megakernel as tmk
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.utils.synthetic import near_tie_packings
from torch_port_common import (  # noqa: F401
    GOLDEN_DIR, SETTINGS, clique_inputs, cuda_device, n, neighbor_inputs,
    solve_inputs, t,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "10017")
BOX = 180.0
# the reference kernels' contract ladders and constants
NEIGHBOR_LADDER = [(64, 128), (96, 256), (40, 70)]
CLIQUE_LADDER = [(3, 64), (3, 96), (2, 40), (4, 24)]
SOLVE_LADDER = [(16, 3), (100, 4), (128, 2)]
PROBE_D, PROBE_CAP, SOLVE_V = 4, 1024, 64


# d <= 16 keeps the top-D list in registers, longer lists in memory
@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24])
@pytest.mark.parametrize("na,mb_", NEIGHBOR_LADDER)
def test_neighbors_kernel_matches_plain(cuda_device, na, mb_, d):
    xa, ma, xb, mb = neighbor_inputs(na, mb_)
    args = [t(a, cuda_device) for a in (xa, ma, xb, mb)]
    before = tk.LAUNCHES
    got = tk.topk_neighbors(*args, BOX, BOX, d=d)
    assert tk.LAUNCHES == before + 1
    want = tk.topk_neighbors_plain(*args, BOX, BOX, d=d)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "k,n_p,d",
    [(k, n_p, PROBE_D) for k, n_p in CLIQUE_LADDER]
    # d = 24: in-memory lists, inside the envelope (D^(K-1) <= 4096);
    # then the envelope's upper picker counts
    + [(3, 64, 24), (3, 96, 24), (2, 40, 24), (5, 16, 4), (6, 12, 4)],
)
def test_candidates_kernel_matches_plain(cuda_device, k, n_p, d):
    xy, conf, mask = clique_inputs(k, n_p)
    args = [t(a, cuda_device)[None] for a in (xy, conf, mask)]
    kw = dict(threshold=0.3, max_neighbors=d, clique_capacity=PROBE_CAP)
    before = tmk.LAUNCHES["fused_clique_candidates"]
    got = tmk.fused_clique_candidates(*args, BOX, **kw)
    assert tmk.LAUNCHES["fused_clique_candidates"] == before + 1
    want = tmk.fused_clique_candidates_plain(*args, BOX, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "c,k,v",
    [(c, k, SOLVE_V) for c, k in SOLVE_LADDER]
    # solve state past shared memory: the kernel's global scratch
    + [(20000, 3, 3072)],
)
def test_dual_solve_kernel_matches_plain(cuda_device, c, k, v):
    mv, w, valid = (t(a, cuda_device)[None]
                    for a in solve_inputs(c, k, v))
    before = tmk.LAUNCHES["fused_dual_solve"]
    got = tmk.fused_dual_solve(mv, w, valid, v)
    assert tmk.LAUNCHES["fused_dual_solve"] == before + 1
    want = tmk.fused_dual_solve_plain(mv, w, valid, v)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.cuda
@pytest.mark.parametrize("gadgets,background", [(1, 60), (2, 200), (4, 5000)])
def test_dual_solve_kernel_near_ties_match_plain(cuda_device, gadgets,
                                                 background):
    """Candidates a rounding apart: the kernel's float32 objective sums
    must take the plain version's order (C = 63 and 206 take one level
    of window sums, C = 5012 two)."""
    *arrays, v = near_tie_packings(32, gadgets, background, seed=1)
    mv, w, valid = (t(a, cuda_device) for a in arrays)
    got = tmk.fused_dual_solve(mv, w, valid, v)
    want = tmk.fused_dual_solve_plain(mv, w, valid, v)
    np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.cuda
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_card_run_matches_goldens(cuda_device, tmp_path, setting):
    solver, pallas = SETTINGS[setting]
    tcons.run_consensus_dir(EXAMPLES, str(tmp_path), int(BOX),
                            solver=solver, use_pallas=pallas,
                            device=cuda_device)
    for f in sorted(os.listdir(os.path.join(GOLDEN_DIR, setting))):
        with open(os.path.join(GOLDEN_DIR, setting, f), "rb") as a, \
                open(tmp_path / f, "rb") as b:
            assert a.read() == b.read(), f
