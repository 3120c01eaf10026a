"""The port's connected components against the JAX package's.

Labels (where a node), node mask, component statistics and the
largest component's label are exact against the vmapped reference,
for K = 2..5 pickers with scalar and per-picker (mixed) box sizes, a
micrograph with no edge, and padded slots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repic_tpu.ops import components as jcomp
from repic_tpu_torch.ops import components as tcomp
from torch_port_common import clique_inputs, n, t

SIZES = {2: [180.0, 120.0], 3: [180.0, 150.0, 200.0],
         4: [180.0, 150.0, 200.0, 180.0],
         5: [180.0, 200.0, 220.0, 160.0, 180.0]}


def _batch(k, n_p, m, seed):
    xs, cs, ms = zip(*(clique_inputs(k, n_p, seed=seed + i) for i in range(m)))
    return np.stack(xs), np.stack(ms)


def _jax_labels(xy, mask, box):
    return jax.jit(jax.vmap(
        lambda a, b: jcomp.connected_component_labels(a, b, box)
    ))(xy, mask)


def _assert_same(xy, mask, box_j, box_t):
    want_l, want_m = (n(x) for x in _jax_labels(xy, mask, box_j))
    got_l, got_m, rounds = tcomp.connected_component_labels(
        t(xy), t(mask), box_t)
    got_l, got_m = n(got_l), n(got_m)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_l[got_m], want_l[want_m])
    assert rounds >= 1
    for i in range(len(xy)):
        assert tcomp.component_stats(got_l[i], got_m[i]) == \
            jcomp.component_stats(want_l[i], want_m[i])
        assert tcomp.largest_component_label(got_l[i], got_m[i]) == \
            jcomp.largest_component_label(want_l[i], want_m[i])
    return got_m


@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("mixed", [False, True], ids=["scalar", "mixed"])
def test_labels_match_reference(k, mixed):
    xy, mask = _batch(k, 96, 3, seed=10 * k)
    if mixed:
        sizes = np.asarray(SIZES[k], np.float32)
        got_m = _assert_same(xy, mask, jnp.asarray(sizes), t(sizes))
    else:
        got_m = _assert_same(xy, mask, 180.0, 180.0)
    assert got_m.any()


def test_empty_graph():
    """No above-threshold edge: no node, the largest label is -1."""
    xy = np.zeros((1, 2, 4, 2), np.float32)
    xy[0, 1] += 5000.0
    mask = np.ones((1, 2, 4), bool)
    got_m = _assert_same(xy, mask, 180.0, 180.0)
    assert not got_m.any()
    lab, nm, _ = tcomp.connected_component_labels(t(xy), t(mask), 180.0)
    assert tcomp.largest_component_label(n(lab)[0], n(nm)[0]) == -1
    assert tcomp.component_stats(n(lab)[0], n(nm)[0]) == (0, 0, 0.0)


def test_per_picker_sizes_judge_edges():
    """A 100-px and a 20-px box at one corner have IoU 0.04: no edge
    with per-picker sizes, an edge with one scalar size."""
    xy = np.zeros((1, 2, 1, 2), np.float32)
    mask = np.ones((1, 2, 1), bool)
    _, nm, _ = tcomp.connected_component_labels(
        t(xy), t(mask), t(np.asarray([100.0, 20.0], np.float32)))
    assert not n(nm).any()
    _, nm, _ = tcomp.connected_component_labels(t(xy), t(mask), 100.0)
    assert n(nm).all()
