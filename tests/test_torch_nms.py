"""The port's device NMS against the JAX package's and the host loop, on
the CPU: the cases of ``tests/test_nms.py``, keep masks exact."""

import numpy as np
import pytest

from repic_tpu.ops import nms as jnms
from repic_tpu_torch.models.infer import greedy_suppress_host, peak_detection
from repic_tpu_torch.ops.nms import COORD_LIMIT, greedy_suppress_device
from tests.test_nms import _host_keep
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)


def _device(yx, scores, thr):
    return greedy_suppress_device(yx, scores, thr, device="cpu")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n", [3, 50, 400])
def test_device_matches_host_and_jax_random(seed, n):
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 120, size=(max(n // 8, 1), 2))
    yx = (
        centers[rng.integers(0, len(centers), n)]
        + rng.integers(-4, 5, size=(n, 2))
    ).clip(0)
    scores = rng.standard_normal(n).astype(np.float32)
    thr = 7 / 2.0
    want = _host_keep(yx, scores.astype(np.float64), thr)
    np.testing.assert_array_equal(_device(yx, scores, thr), want)
    np.testing.assert_array_equal(
        greedy_suppress_host(yx, scores.astype(np.float64), thr), want)
    np.testing.assert_array_equal(
        jnms.greedy_suppress_device(yx, scores, thr), want)


def test_ties_and_kill_chain():
    yx = np.array([[0, 0], [0, 1], [0, 2], [10, 10]])
    scores = np.array([1.0, 1.0, 2.0, 1.0], np.float32)
    np.testing.assert_array_equal(_device(yx, scores, 3.5 / 2),
                                  _host_keep(yx, scores, 3.5 / 2))
    # a stronger later neighbour kills i but spares i's later weak
    # neighbours beyond it
    yx = np.array([[0, 0], [0, 1], [0, 2], [1, 0]])
    scores = np.array([2.0, 1.0, 3.0, 1.5], np.float32)
    got = _device(yx, scores, 5.0)
    assert got.tolist() == [False, False, True, False]
    np.testing.assert_array_equal(got, _host_keep(yx, scores, 5.0))


def test_empty_single_and_coordinate_limit():
    assert _device(np.zeros((0, 2), int), np.zeros(0), 2.0).shape == (0,)
    assert _device(np.array([[5, 5]]), np.array([1.0]), 2.0).tolist() == [
        True]
    yx = np.array([[0, 0], [COORD_LIMIT + 10, 0]])
    with pytest.raises(ValueError, match="host path"):
        _device(yx, np.array([1.0, 2.0]), 2.0)
    assert COORD_LIMIT == jnms.COORD_LIMIT
    assert jnms.DEVICE_NMS_MIN_P == 1024


@pytest.mark.parametrize("p", [1024, 4096])
def test_device_matches_host_at_the_card_sizes(p):
    """The candidate counts the card times (padded to 1024 and 4096):
    a seeded clustered field of ``p`` candidates."""
    rng = np.random.default_rng(p)
    yx = rng.integers(0, 2 * int(np.sqrt(p)) * 4, size=(p, 2))
    scores = rng.random(p).astype(np.float32)
    thr = 9 / 2.0
    np.testing.assert_array_equal(
        _device(yx, scores, thr),
        greedy_suppress_host(yx, scores.astype(np.float64), thr))


def test_peak_detection_device_flag_equivalence():
    from scipy import ndimage

    rng = np.random.default_rng(3)
    smap = ndimage.convolve(rng.random((80, 80)).astype(np.float32),
                            np.ones((3, 3)) / 9.0, mode="nearest")
    host = peak_detection(smap, window=5, device_nms=False, device="cpu")
    dev = peak_detection(smap, window=5, device_nms=True, device="cpu")
    np.testing.assert_array_equal(host, dev)


def test_device_nms_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        greedy_suppress_device(np.array([[1, 1]]), np.array([1.0]), 2.0)
