"""Port clique enumeration and compaction against the JAX package.

``enumerate_cliques`` (with and without the kernel-1 neighbour search)
and ``compact_cliques`` get the same seeded inputs as the reference at
K = 2, 3 and 4.  Membership, validity, representatives, confidences
and row order must be exact.  The weight ``w`` is held within 1e-6
relative: it is a product of two medians, and XLA's CPU backend may
contract float expressions inside its fused loops (it does contract
the dual solve's price step), so the port does not claim ``w`` bit for
bit even though every other output is exact.  The 10017 golden clique
sets (executed reference output) close the file, as in
``tests/test_golden_10017.py``.
"""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from repic_tpu.ops import cliques as jc
from repic_tpu.parallel.batching import pad_batch as j_pad_batch
from repic_tpu.utils import box_io as j_box_io
from repic_tpu_torch.ops import cliques as tc
from repic_tpu_torch.parallel.batching import pad_batch, to_device
from repic_tpu_torch.pipeline.consensus import consensus_one
from repic_tpu_torch.utils import box_io
from tests.conftest import REFERENCE_EXAMPLES, needs_reference
from torch_port_common import clique_inputs, n, t

W_RTOL = 1e-6


@functools.partial(
    jax.jit, static_argnames=("max_neighbors", "use_pallas")
)
def _j_enumerate(xy, conf, mask, *, max_neighbors, use_pallas=False):
    return jc.enumerate_cliques(
        xy, conf, mask, 180.0,
        max_neighbors=max_neighbors, use_pallas=use_pallas,
    )


FIELDS = ("member_idx", "valid", "confidence", "rep_slot", "rep_xy")


def _assert_same(got: tc.CliqueSet, want, m=0):
    """Exact on every field but w (relative 1e-6); order included."""
    valid = n(want.valid)
    np.testing.assert_array_equal(n(got.valid)[m], valid)
    for f in FIELDS:
        np.testing.assert_array_equal(
            n(getattr(got, f))[m][valid], n(getattr(want, f))[valid],
            err_msg=f,
        )
    np.testing.assert_allclose(
        n(got.w)[m][valid], n(want.w)[valid], rtol=W_RTOL, atol=0
    )
    assert int(n(got.num_valid)[m]) == int(want.num_valid)
    assert int(n(got.max_adjacency)[m]) == int(want.max_adjacency)


@pytest.mark.parametrize("k,n_p", [(2, 40), (3, 64), (3, 96), (4, 24)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_enumerate_cliques_matches_reference(k, n_p, use_pallas):
    xy, conf, mask = clique_inputs(k, n_p)
    d = 6 if k < 4 else 4
    want = _j_enumerate(xy, conf, mask, max_neighbors=d,
                        use_pallas=use_pallas)
    got = tc.enumerate_cliques(
        t(xy)[None], t(conf)[None], t(mask)[None], 180.0,
        max_neighbors=d, use_pallas=use_pallas,
    )
    assert int(want.num_valid) > 0
    _assert_same(got, want)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_compact_cliques_matches_reference(k):
    xy, conf, mask = clique_inputs(k, 48, seed=10 + k)
    want_cs = _j_enumerate(xy, conf, mask, max_neighbors=4)
    got_cs = tc.enumerate_cliques(
        t(xy)[None], t(conf)[None], t(mask)[None], 180.0, max_neighbors=4
    )
    nv = int(want_cs.num_valid)
    for cap in (nv + 7, max(nv // 2, 1)):
        want = jax.jit(jc.compact_cliques, static_argnums=1)(
            want_cs, cap)
        got = tc.compact_cliques(got_cs, cap)
        _assert_same(got, want)
        # the kept rows are the heaviest, ties in buffer order
        np.testing.assert_array_equal(
            n(got.valid)[0], n(want.valid)
        )


def test_batched_enumeration_is_per_micrograph():
    items = [clique_inputs(3, 32, seed=s) for s in range(3)]
    stack = [t(np.stack([it[j] for it in items])) for j in range(3)]
    got = tc.enumerate_cliques(*stack, 180.0, max_neighbors=4)
    for b, (xy, conf, mask) in enumerate(items):
        want = _j_enumerate(xy, conf, mask, max_neighbors=4)
        _assert_same(got, want, m=b)


def test_median_is_midpoint():
    x = torch.tensor([[1.0, 4.0], [2.0, 8.0], [7.0, 5.0], [3.0, 6.0]])
    np.testing.assert_array_equal(
        n(tc.median0(x)), np.median(n(x), axis=0)
    )


def test_unported_assembly_regimes_raise():
    xy, conf, mask = clique_inputs(3, 64)
    args = (t(xy)[None], t(conf)[None], t(mask)[None], 180.0)
    with pytest.raises(NotImplementedError, match="item 6"):
        tc.enumerate_cliques(*args, max_neighbors=17, clique_capacity=64)
    with pytest.raises(NotImplementedError, match="item 6"):
        tc.enumerate_cliques(*args, max_neighbors=4, clique_capacity=64,
                             anchor_chunk=32)


GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "ref_cliques_10017.json"
)


@needs_reference
def test_10017_clique_sets_match_reference_golden():
    """The port's cliques on 10017 equal the executed reference's:
    same membership, w within 1e-5, confidence within 1e-6 (the
    assertions of tests/test_golden_10017.py)."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    pickers = golden["pickers"]
    loaded = [
        (name, box_io.load_micrograph_set(REFERENCE_EXAMPLES, pickers, name))
        for name in golden["micrographs"]
    ]
    batch = pad_batch(loaded)
    # the port's loader gives the JAX package's arrays exactly
    j_batch = j_pad_batch([
        (name, j_box_io.load_micrograph_set(REFERENCE_EXAMPLES, pickers,
                                            name))
        for name in golden["micrographs"]
    ])
    for a, b in zip(batch[:3], j_batch[:3]):
        np.testing.assert_array_equal(a, b)
    db = to_device(batch, "cpu")
    res = consensus_one(
        db.xy, db.conf, db.mask, float(golden["box_size"]),
        max_neighbors=16, clique_capacity=4096, solver="greedy",
    )
    for i, (name, gd) in enumerate(golden["micrographs"].items()):
        valid = n(res.valid)[i]
        mem = n(res.member_idx)[i][valid]
        w = n(res.w)[i][valid]
        conf = n(res.confidence)[i][valid]
        mine = {
            tuple(sorted((p, int(j)) for p, j in enumerate(row))): (wv, cv)
            for row, wv, cv in zip(mem, w, conf)
        }
        ref = {
            tuple(sorted(map(tuple, m))): (gd["w"][j], gd["conf"][j])
            for j, m in enumerate(gd["members"])
        }
        assert set(mine) == set(ref), f"{name}: clique membership differs"
        for key, (wv, cv) in ref.items():
            np.testing.assert_allclose(mine[key][0], wv, atol=1e-5)
            np.testing.assert_allclose(mine[key][1], cv, atol=1e-6)
