"""Kernel 1 (fused IoU top-D neighbour search) against the reference.

The plain PyTorch version is held to ``pallas_topk_neighbors`` run in
interpret mode on its contract ladder: values, indices and counts
exact (both break ties toward the lower candidate index; empty slots
are -1 with the sentinel index M).  ``test_torch_cuda.py`` holds the
CUDA kernel to the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repic_tpu.ops.iou_pallas import pallas_topk_neighbors
from repic_tpu_torch.ops import iou_pallas as tk
from torch_port_common import n, neighbor_inputs, t

LADDER = [(64, 128), (96, 256), (40, 70)]


def _jax(xa, ma, xb, mb, sa, sb, d):
    return [n(x) for x in pallas_topk_neighbors(
        jnp.asarray(xa), jnp.asarray(ma), jnp.asarray(xb), jnp.asarray(mb),
        sa, sb, d=d, threshold=0.3, tile_m=64, tile_n=128, interpret=True,
    )]


@pytest.mark.parametrize("na,mb_", LADDER)
@pytest.mark.parametrize("d", [8, 16])
def test_plain_matches_pallas_interpret(na, mb_, d):
    xa, ma, xb, mb = neighbor_inputs(na, mb_)
    want = _jax(xa, ma, xb, mb, 180.0, 180.0, d)
    got = [n(x) for x in tk.topk_neighbors(
        t(xa), t(ma), t(xb), t(mb), 180.0, 180.0, d=d, threshold=0.3
    )]
    for g, w, name in zip(got, want, ("values", "indices", "counts")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the CPU wrapper is the plain version
    plain = tk.topk_neighbors_plain(
        t(xa), t(ma), t(xb), t(mb), 180.0, 180.0, d=d, threshold=0.3
    )
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, n(p))


def test_plain_mixed_sizes_and_dense_ties():
    """Clustered candidates (many equal zero IoUs) with per-set sizes."""
    rng = np.random.default_rng(5)
    xa = rng.uniform(0, 600.0, (48, 2)).astype(np.float32)
    xb = (np.repeat(xa, 2, 0) + rng.normal(0, 30.0, (96, 2))).astype(
        np.float32)
    ma = np.ones(48, bool)
    mb = rng.uniform(size=96) > 0.1
    want = _jax(xa, ma, xb, mb, 180.0, 150.0, 12)
    got = tk.topk_neighbors(t(xa), t(ma), t(xb), t(mb), 180.0, 150.0, d=12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), w)


def test_batched_call_is_per_item():
    items = [neighbor_inputs(40, 70, seed=s) for s in range(3)]
    stack = [t(np.stack([it[j] for it in items])) for j in range(4)]
    got = tk.topk_neighbors(*stack, 180.0, 180.0, d=8)
    for b, it in enumerate(items):
        want = _jax(*it, 180.0, 180.0, 8)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(n(g)[b], w)


def test_empty_sets_and_d_past_m():
    xa, ma, xb, mb = neighbor_inputs(10, 5, seed=9)
    v, i, c = tk.topk_neighbors(t(xa), t(ma), t(xb), t(mb), 180.0, 180.0,
                                d=8)
    assert v.shape == (10, 8) and (n(v)[:, 5:] == -1).all()
    assert (n(i)[:, 5:] == 5).all()
    v, i, c = tk.topk_neighbors(t(xa[:0]), t(ma[:0]), t(xb), t(mb),
                                180.0, 180.0, d=4)
    assert v.shape == (0, 4) and c.shape == (0,)
    with pytest.raises(ValueError):
        tk.topk_neighbors(t(xa), t(ma), t(xb), t(mb), 180.0, 180.0,
                          d=tk.MAX_D + 1)
