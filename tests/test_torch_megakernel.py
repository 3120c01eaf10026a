"""Kernels 2 and 3 (the fused chunk program) against the reference.

The plain versions of ``fused_clique_candidates`` and
``fused_dual_solve`` are held to the JAX package's Pallas kernels run
in interpret mode, on the kernels' own contract ladders, with the
reference's compare rules: for the candidates, exact equality of the
valid mask, ``num_valid`` and ``max_adjacency``, and of every output on
valid rows (slots past ``num_valid`` are path-specific on the TPU side);
for the solve, the pick masks exactly equal.  ``test_torch_cuda.py``
holds the CUDA kernels to the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repic_tpu.ops import megakernel as jmk
from repic_tpu_torch.ops import megakernel as tmk
from repic_tpu_torch.pipeline import consensus as tcons
from repic_tpu_torch.parallel.batching import pad_batch, to_device
from repic_tpu_torch.solver import dual as tdual
from repic_tpu_torch.utils.box_io import BoxSet
from repic_tpu_torch.utils.synthetic import near_tie_packings
from torch_port_common import clique_inputs, n, solve_inputs, t

# the reference kernels' contract constants (megakernel.py:425-429)
PROBE_D, PROBE_CAP, PROBE_TILE_A, BOX = 4, 1024, 64, 180.0
CLIQUE_LADDER = [(3, 64), (3, 96), (2, 40), (4, 24)]
# the envelope's upper picker counts, past the reference's ladder
CLIQUE_WIDE_K = [(5, 16), (6, 12)]
SOLVE_LADDER = [(16, 3), (100, 4), (128, 2)]
SOLVE_V = 64

OUT_NAMES = ("member_idx", "valid", "w", "confidence", "rep_slot",
             "rep_xy", "pid", "num_valid", "max_adjacency")


def _assert_candidates_equal(got, want):
    """The reference's ``_compare``: probes and the valid mask exact,
    every output exact on valid rows."""
    got = [n(g) for g in got]
    want = [n(w) for w in want]
    assert int(got[7]) == int(want[7]), "num_valid"
    assert int(got[8]) == int(want[8]), "max_adjacency"
    valid = want[1]
    np.testing.assert_array_equal(got[1], valid, err_msg="valid")
    for i in (0, 2, 3, 4, 5, 6):
        np.testing.assert_array_equal(
            got[i][valid], want[i][valid], err_msg=OUT_NAMES[i]
        )


def _plain_candidates(xy, conf, mask):
    out = tmk.fused_clique_candidates(
        t(xy)[None], t(conf)[None], t(mask)[None], BOX,
        threshold=0.3, max_neighbors=PROBE_D, clique_capacity=PROBE_CAP,
    )
    return [o[0] for o in out]


@pytest.mark.parametrize("k,n_p", CLIQUE_LADDER + CLIQUE_WIDE_K)
def test_candidates_plain_matches_pallas_interpret(k, n_p):
    xy, conf, mask = clique_inputs(k, n_p)
    want = jmk.fused_clique_candidates(
        jnp.asarray(xy), jnp.asarray(conf), jnp.asarray(mask), BOX,
        threshold=0.3, max_neighbors=PROBE_D, clique_capacity=PROBE_CAP,
        tile_a=PROBE_TILE_A, interpret=True,
    )
    got = _plain_candidates(xy, conf, mask)
    assert int(n(want[7])) > 0
    _assert_candidates_equal(got, want)
    # capacity = min(cap, N * D^(K-1)); rows past num_valid are zero
    cap = min(PROBE_CAP, n_p * min(PROBE_D, n_p) ** (k - 1))
    assert got[1].shape == (cap,)
    nv = int(n(got[7]))
    assert not n(got[1])[nv:].any() and not n(got[2])[nv:].any()


@pytest.mark.parametrize("c,k", SOLVE_LADDER)
def test_dual_solve_plain_matches_pallas_interpret(c, k):
    mv, w, valid = solve_inputs(c, k, SOLVE_V)
    want = jmk.fused_dual_solve(
        jnp.asarray(mv), jnp.asarray(w), jnp.asarray(valid), SOLVE_V,
        interpret=True,
    )
    got = tmk.fused_dual_solve(t(mv)[None], t(w)[None], t(valid)[None],
                               SOLVE_V)
    assert got.dtype == torch.bool and got.shape == (1, c)
    np.testing.assert_array_equal(n(got)[0], n(want))


def test_dual_solve_plain_near_ties_match_pallas_interpret(monkeypatch):
    """C = 63 pads to the reference kernel's 128 lanes, which sets the
    order of its objective sums; float64 sums pick otherwise on some of
    these packings."""
    mv, w, valid, v = near_tie_packings(8, 1, 60, seed=1)
    want = np.stack([
        n(jmk.fused_dual_solve(jnp.asarray(mv[b]), jnp.asarray(w[b]),
                               jnp.asarray(valid[b]), v, interpret=True))
        for b in range(len(mv))
    ])
    got = n(tmk.fused_dual_solve(t(mv), t(w), t(valid), v))
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(tdual, "objective_sum",
                        lambda x: x.double().sum(-1).float())
    f64 = n(tmk.fused_dual_solve(t(mv), t(w), t(valid), v))
    assert (f64 != want).any(axis=1).sum() >= 1


def test_dual_solve_batched_is_per_micrograph():
    items = [solve_inputs(64, 3, SOLVE_V, seed=s) for s in range(4)]
    got = tmk.fused_dual_solve(
        *[t(np.stack([it[j] for it in items])) for j in range(3)], SOLVE_V
    )
    for b, (mv, w, valid) in enumerate(items):
        want = jmk.fused_dual_solve(
            jnp.asarray(mv), jnp.asarray(w), jnp.asarray(valid), SOLVE_V,
            interpret=True,
        )
        np.testing.assert_array_equal(n(got)[b], n(want))


@pytest.mark.parametrize("args", [
    (3, 1024, 16), (2, 8192, 64), (1, 1024, 16), (7, 1024, 4),
    (3, 8193, 16), (4, 1024, 64), (6, 64, 5), (6, 64, 6),
])
def test_envelope_matches_reference(args):
    assert tmk.fused_eligible(*args) == jmk.fused_eligible(*args)


def test_candidates_reject_out_of_envelope():
    xy, conf, mask = clique_inputs(4, 24)
    with pytest.raises(ValueError, match="envelope"):
        tmk.fused_clique_candidates(
            t(xy)[None], t(conf)[None], t(mask)[None], BOX,
            max_neighbors=17,
        )


def _boxsets(k, n_p, seed):
    """K pickers that see the same particles, a few pixels apart, on a
    grid spaced wider than a box: every particle overlaps one box per
    picker, so the adjacency stays 1."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1)
    base = grid.reshape(-1, 2)[rng.permutation(64)[:n_p]] * 400.0
    sets = []
    for _ in range(k):
        xy = (base + rng.normal(0, 10.0, base.shape)).astype(np.float32)
        conf = rng.uniform(0.5, 1.0, n_p).astype(np.float32)
        sets.append(BoxSet(xy=xy, conf=conf, wh=np.zeros_like(xy)))
    return sets


def _assert_results_equal(a, b):
    """Equal picks and validity; every other output equal on valid rows
    (slots past the valid count hold path-specific values)."""
    valid = n(b.valid)
    np.testing.assert_array_equal(n(a.valid), valid)
    np.testing.assert_array_equal(n(a.picked), n(b.picked))
    for f in ("member_idx", "w", "confidence", "rep_slot", "rep_xy"):
        np.testing.assert_array_equal(
            n(getattr(a, f))[valid], n(getattr(b, f))[valid], err_msg=f
        )
    for f in ("num_cliques", "max_adjacency"):
        np.testing.assert_array_equal(
            n(getattr(a, f)), n(getattr(b, f)), err_msg=f
        )


def test_out_of_envelope_chunk_demotes_to_staged():
    """K = 7 is past the fused envelope: ``lp_device_fused`` runs the
    staged program (the same result as ``lp_device``) and the demotion
    is counted."""
    batch = pad_batch([("a", _boxsets(7, 20, 1)), ("b", _boxsets(7, 20, 2))])
    before = tmk.DEMOTIONS
    fused, _ = tcons.run_consensus_batch(
        batch, BOX, max_neighbors=2, solver="lp_device_fused", device="cpu"
    )
    assert tmk.DEMOTIONS == before + 1
    staged, _ = tcons.run_consensus_batch(
        batch, BOX, max_neighbors=2, solver="lp_device", device="cpu"
    )
    assert int(n(staged.num_cliques).sum()) > 0
    _assert_results_equal(fused, staged)


def test_fused_consensus_one_matches_staged():
    """Inside the envelope the fused rung gives the staged buffers
    (product-id order, then the shared weight compaction)."""
    batch = pad_batch([(s, _boxsets(3, 48, i))
                       for i, s in enumerate("abc")])
    db = to_device(batch, "cpu")
    kw = dict(max_neighbors=4, clique_capacity=256)
    fused = tcons.consensus_one(db.xy, db.conf, db.mask, BOX,
                                solver="lp_device_fused", **kw)
    staged = tcons.consensus_one(db.xy, db.conf, db.mask, BOX,
                                 solver="lp_device", **kw)
    assert int(n(staged.picked).sum()) > 0
    _assert_results_equal(fused, staged)
