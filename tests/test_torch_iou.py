"""Port IoU functions against the JAX package's, bitwise.

Both evaluate ``inter / (sa^2 + sb^2 - inter)`` one rounded float32
operation at a time, so the results must be identical bit for bit —
equal and per-picker (mixed) box sizes alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repic_tpu.ops import iou as jiou
from repic_tpu_torch.ops import iou as tiou
from torch_port_common import n, t


def _inputs(seed, na=120, nb=90):
    rng = np.random.default_rng(seed)
    xa = rng.uniform(0, 1500.0, (na, 2)).astype(np.float32)
    # half the b set clustered on a: many overlaps, fractional offsets
    xb = np.concatenate([
        xa[: nb // 2] + rng.normal(0, 40.0, (nb // 2, 2)),
        rng.uniform(0, 1500.0, (nb - nb // 2, 2)),
    ]).astype(np.float32)
    ma = rng.uniform(size=na) > 0.2
    mb = rng.uniform(size=nb) > 0.2
    return xa, ma, xb, mb


SIZES = [(180.0, None), (180.0, 150.0), (97.5, 211.25)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sa,sb", SIZES)
def test_pair_iou_bitwise(seed, sa, sb):
    xa, _, xb, _ = _inputs(seed)
    want = n(jiou.pair_iou(jnp.asarray(xa), jnp.asarray(xb), sa, sb))
    got = n(tiou.pair_iou(t(xa), t(xb), sa, sb))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sa,sb", SIZES)
def test_pair_iou_xy_bitwise(sa, sb):
    xa, _, xb, _ = _inputs(2, 200, 200)
    want = n(jiou.pair_iou_xy(
        jnp.asarray(xa[:, 0]), jnp.asarray(xa[:, 1]),
        jnp.asarray(xb[:, 0]), jnp.asarray(xb[:, 1]), sa, sb,
    ))
    got = n(tiou.pair_iou_xy(
        t(xa[:, 0]), t(xa[:, 1]), t(xb[:, 0]), t(xb[:, 1]), sa, sb
    ))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("sa,sb", SIZES)
def test_pairwise_iou_matrix_bitwise(seed, sa, sb):
    xa, ma, xb, mb = _inputs(seed)
    want = n(jiou.pairwise_iou_matrix(
        jnp.asarray(xa), jnp.asarray(ma), jnp.asarray(xb),
        jnp.asarray(mb), sa, sb,
    ))
    got = n(tiou.pairwise_iou_matrix(t(xa), t(ma), t(xb), t(mb), sa, sb))
    np.testing.assert_array_equal(got, want)
    # masked entries are exactly 0.0
    assert not got[~(ma[:, None] & mb[None, :])].any()


def test_pairwise_iou_matrix_batched_matches_single():
    """A leading batch axis (with per-item sizes) is the per-item call."""
    items = [_inputs(s, 64, 48) for s in range(3)]
    sizes = np.asarray([180.0, 150.0, 120.0], np.float32)
    got = n(tiou.pairwise_iou_matrix(
        t(np.stack([i[0] for i in items])), t(np.stack([i[1] for i in items])),
        t(np.stack([i[2] for i in items])), t(np.stack([i[3] for i in items])),
        t(sizes), t(sizes),
    ))
    for b, (xa, ma, xb, mb) in enumerate(items):
        want = n(jiou.pairwise_iou_matrix(
            jnp.asarray(xa), jnp.asarray(ma), jnp.asarray(xb),
            jnp.asarray(mb), float(sizes[b]),
        ))
        np.testing.assert_array_equal(got[b], want)
