"""The port's CNN picker against the JAX package's, on the CPU.

Inputs are made from numpy seeds and go through ``repic_tpu.models``
and ``repic_tpu_torch.models``; parameters are a flax init converted
with ``params_from_jax``.  Tolerances:

* ``bin2d``, blur, the micrograph z-score: rtol = atol = 1e-6; the
  z-scored micrograph is bitwise the reference's at real micrograph
  sizes and at the small ones where an earlier summation rule was not
  (``tree_sum`` against ``jnp.sum`` at every remainder up to 32 x 32);
* ``bytescale`` and the antialiased resize (every patch size, up and
  down): bitwise, so the rounded uint8 levels are equal; the
  standardized patches bitwise too (op by op, as the loaders call
  them);
* logits of all three architectures, and both scoring modes: 1e-5;
* local maxima and peaks: exact given the same map, on both NMS paths;
* ``pick_micrograph``: every pick at a JAX pick's grid position unless
  JAX's map nearly ties (|d| < 1e-5) inside its window, at most 1%.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repic_tpu.models import cnn as jcnn
from repic_tpu.models import infer as jinf
from repic_tpu.models import preprocess as jpp
from repic_tpu.models.checkpoint import save_checkpoint as jax_save
from repic_tpu_torch.models import cnn as tcnn
from repic_tpu_torch.models import infer as tinf
from repic_tpu_torch.models import preprocess as tpp
from repic_tpu_torch.models.checkpoint import params_from_jax
from repic_tpu_torch.utils import mrc as tmrc
from repic_tpu_torch.utils.synthetic import synthetic_micrograph
from torch_port_common import t  # noqa: F401  (2 torch threads per worker)


def _init(arch="deep", seed=0):
    params = jcnn.PickerCNN(**jcnn.arch_kwargs(arch)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 1)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def params():
    return _init()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------- preprocess


def test_bin2d_blur_zscore_match_jax():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(17, 23)).astype(np.float32)
    np.testing.assert_allclose(
        tpp.bin2d(_t(img)).numpy(), np.asarray(jpp.bin2d(jnp.asarray(img))),
        rtol=1e-6, atol=1e-6)
    # sigma 0.1 truncates to radius 0: the identity
    np.testing.assert_array_equal(tpp.gaussian_blur(_t(img)).numpy(), img)
    img = rng.normal(size=(32, 40)).astype(np.float32)
    np.testing.assert_allclose(
        tpp.gaussian_blur(_t(img), 1.5).numpy(),
        np.asarray(jpp.gaussian_blur(jnp.asarray(img), 1.5)),
        rtol=1e-6, atol=1e-6)
    img = rng.normal(size=(100, 130)).astype(np.float32)
    np.testing.assert_allclose(
        tpp.preprocess_micrograph(_t(img)).numpy(),
        np.asarray(jpp.preprocess_micrograph(jnp.asarray(img))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed,shape", [
    (0, (4096, 4096)), (1, (4096, 4096)), (0, (3838, 3710)),
    (1, (3838, 3710)), (0, (5760, 4092)), (1, (5760, 4092)),
    (0, (3710, 3838)), (0, (400, 430)), (2, (400, 430)), (0, (256, 256)),
    (0, (800, 800)), (1, (800, 800)),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_preprocess_micrograph_bitwise_at_full_size(seed, shape):
    """The mean and variance sum in the reference's order
    (``tree_sum``), so the z-scored micrograph is equal bit for bit --
    what lets the card's score maps meet 1e-4 (a one-ulp input moves a
    bytescale level and a score by up to 7e-4).  The square 4096 ones
    are the picker's seeded micrographs; the others plain noise, among
    them the sizes where an earlier rule summed out of order (the
    transposed 3710 x 3838, 400 x 430, 256 x 256, 800 x 800)."""
    if shape == (4096, 4096):
        raw, centres = synthetic_micrograph(seed)
        assert 600 <= len(centres) <= 950
    else:
        raw = np.random.default_rng(seed).standard_normal(
            shape, dtype=np.float32)
    want = np.asarray(jpp.preprocess_micrograph(jnp.asarray(raw)))
    got = tpp.preprocess_micrograph(_t(raw)).numpy()
    np.testing.assert_array_equal(got, want)


def test_tree_sum_bitwise_at_every_remainder():
    """Every final block XLA's CPU reduce meets, 1 x 1 to 32 x 32 (one
    program of 1,024 sums), on values spread over 24 binades so that any
    other order shows; then sizes that take one or two window levels,
    with the padding peeled (31 mod 32 on either or both axes), unpadded
    narrow windows that vectorize, and a batch of patches."""
    rng = np.random.default_rng(0)

    def noise(shape):
        return (rng.standard_normal(shape)
                * np.exp2(rng.uniform(-12, 12, shape))).astype(np.float32)

    shapes = [(h, w) for h in range(1, 33) for w in range(1, 33)]
    shapes += [(33, 33), (95, 3), (2559, 4), (96, 7), (63, 63),
               (45, 223), (1236, 1279), (1247, 1279), (3, 2047),
               (40000, 3), (100, 10), (133, 143)]
    xs = [noise(s) for s in shapes]
    want = jax.jit(lambda xs: [jnp.sum(x) for x in xs])(xs)
    bad = [s for s, x, w in zip(shapes, xs, want)
           if np.asarray(w).tobytes()
           != tpp.tree_sum(_t(x)).numpy().tobytes()]
    assert not bad, bad
    batch = noise((9, 64, 64))
    np.testing.assert_array_equal(
        tpp.tree_sum(_t(batch)).numpy(),
        np.asarray(jnp.sum(jnp.asarray(batch), axis=(1, 2))))


def test_bytescale_exact_and_standardize():
    rng = np.random.default_rng(1)
    for _ in range(4):
        p = (rng.normal(size=(64, 60, 60)) * 3).astype(np.float32)
        np.testing.assert_array_equal(
            tpp.bytescale(_t(p)).numpy(),
            np.asarray(jpp.bytescale(jnp.asarray(p))))
    p = (rng.normal(size=(8, 16, 16)) * 3 + 5).astype(np.float32)
    got = tpp.standardize_patches(_t(p)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jpp.standardize_patches(jnp.asarray(p))),
        rtol=1e-5, atol=1e-5)
    # as the loaders call it (op by op, not under jit): bit for bit
    np.testing.assert_array_equal(
        got, np.asarray(jpp.standardize_patches(jnp.asarray(p))))
    for g in got:   # the sample std (ddof=1)
        assert abs(g.std(ddof=1) - 1) < 1e-4


@pytest.mark.parametrize("size", [16, 48, 60, 64, 80, 96])
def test_prepare_patches_levels_match_jax(size):
    """Up (size < 64) through F.interpolate, down (size > 64) through
    the port's weight matrices: the resized floats are the reference's
    bits, so the rounded levels are equal."""
    rng = np.random.default_rng(size)
    p = (rng.normal(size=(64, size, size)) * 3).astype(np.float32)
    b = np.asarray(jpp.bytescale(jnp.asarray(p)))
    want = np.asarray(jpp.resize_patches(jnp.asarray(b), 64))
    got = tpp.resize_patches(_t(b), 64).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.clip(np.round(got), 0, 255), np.clip(np.round(want), 0, 255))
    np.testing.assert_allclose(
        tpp.prepare_patches(_t(p), 64).numpy(),
        np.asarray(jpp.prepare_patches(jnp.asarray(p), 64)), atol=1e-4)
    np.testing.assert_array_equal(
        tpp.prepare_patches(_t(p), 64).numpy(),
        np.asarray(jpp.prepare_patches(jnp.asarray(p), 64)))


def test_resize_weights_match_jax():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    for n in list(range(65, 140)) + [192, 300]:
        want = jax.jit(lambda n=n: compute_weight_mat(
            n, 64, 64 / n, 0., _fill_triangle_kernel, True))()
        np.testing.assert_array_equal(tpp.resize_weights(n, 64),
                                      np.asarray(want), err_msg=str(n))


# ----------------------------------------------------------------- model


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_model_logits_match_jax(arch):
    kw = jcnn.arch_kwargs(arch)
    params = _init(arch, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 64, 64, 1)).astype(np.float32)
    want = np.asarray(jcnn.PickerCNN(**kw).apply({"params": params},
                                                 jnp.asarray(x)))
    model = tcnn.build_model("cnn", params_from_jax(params), arch=arch)
    with torch.no_grad():
        got = model(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    x2 = rng.normal(size=(2, 96, 112, 1)).astype(np.float32)
    fp = jcnn.fc_params_as_conv(params)
    want = np.asarray(jcnn.PickerFCN(**kw).apply({"params": fp},
                                                 jnp.asarray(x2)))
    fcn = tcnn.build_model(
        "fcn", params_from_jax(tcnn.fc_params_as_conv(params)), arch=arch)
    with torch.no_grad():
        got = fcn(_t(x2)).numpy()
    assert got.shape == want.shape == (2, 3, 4, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)
    # bfloat16 compute against the reference's float32 (the CLI's
    # "~1e-2" claim)
    bf = tcnn.build_model("cnn", params_from_jax(params), arch=arch,
                          dtype="bfloat16")
    with torch.no_grad():
        got = bf(_t(x)).numpy()
    assert got.dtype == np.float32
    want = np.asarray(jcnn.PickerCNN(**kw).apply({"params": params},
                                                 jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=3e-2)


def test_fcn_window_equals_patch_classifier(params):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 96, 96, 1)).astype(np.float32)
    cnn = tcnn.build_model("cnn", params_from_jax(params))
    fcn = tcnn.build_model("fcn", params_from_jax(
        tcnn.fc_params_as_conv(params)))
    with torch.no_grad():
        dense = fcn(_t(x)).numpy()
        want = cnn(_t(x[:, 16:80, 16:80])).numpy()
    np.testing.assert_allclose(dense[:, 1, 1], want, atol=1e-5)


# -------------------------------------------------------------- scoring


@pytest.mark.parametrize("patch_size", [48, 60, 80])
@pytest.mark.parametrize("mode", ["patch", "fcn"])
def test_score_maps_match_jax(params, mode, patch_size):
    """Both modes on a 256 x 256 preprocessed micrograph, the same input
    to both packages."""
    rng = np.random.default_rng(patch_size)
    img = rng.normal(size=(256, 256)).astype(np.float32)
    if mode == "patch":
        want = jinf.score_micrograph_patches(params, jnp.asarray(img),
                                             patch_size=patch_size)
        got = tinf.score_micrograph_patches(params_from_jax(params), _t(img),
                                            patch_size=patch_size)
    else:
        want = jinf.score_micrograph_fcn(jcnn.fc_params_as_conv(params),
                                         jnp.asarray(img),
                                         patch_size=patch_size)
        got = tinf.score_micrograph_fcn(
            params_from_jax(tcnn.fc_params_as_conv(params)), _t(img),
            patch_size=patch_size)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_patch_scores_do_not_depend_on_the_row_chunk(params, monkeypatch):
    img = _t(np.random.default_rng(4).normal(size=(160, 160)).astype(
        np.float32))
    sd = params_from_jax(params)
    base = tinf.score_micrograph_patches(sd, img, patch_size=60)
    for chunk in (1, 3, 64):
        monkeypatch.setattr(tinf, "ROW_CHUNK", chunk)
        got = tinf.score_micrograph_patches(sd, img, patch_size=60)
        np.testing.assert_allclose(got.numpy(), base.numpy(), atol=1e-6)


# ---------------------------------------------------------------- peaks


@pytest.mark.parametrize("window", [3, 4, 5, 8, 9])
def test_local_maxima_and_peaks_match_jax(window):
    rng = np.random.default_rng(window)
    for _ in range(3):
        smap = rng.random((40, 50))
        np.testing.assert_array_equal(
            tinf.local_maxima_mask(_t(smap.astype(np.float32)),
                                   window).numpy(),
            np.asarray(jinf.local_maxima_mask(jnp.asarray(smap), window)))
        want = jinf.peak_detection(smap, window)
        for device_nms in (False, True):
            got = tinf.peak_detection(smap, window, device_nms=device_nms,
                                      device="cpu")
            np.testing.assert_array_equal(got, want)


def test_peak_detection_auto_takes_the_device_path_as_jax_does():
    """A dense float32 map: at least DEVICE_NMS_MIN_P candidates, so
    both packages take the device path; the peaks are equal."""
    from scipy import ndimage

    from repic_tpu_torch.ops.nms import DEVICE_NMS_MIN_P

    rng = np.random.default_rng(5)
    smap = ndimage.uniform_filter(rng.random((200, 200)), 2).astype(
        np.float32)
    want = jinf.peak_detection(smap, 3)
    got = tinf.peak_detection(smap, 3, device="cpu")
    assert len(want) > DEVICE_NMS_MIN_P // 2
    np.testing.assert_array_equal(got, want)


def test_peak_detection_edge_maps():
    assert len(tinf.peak_detection(np.ones((20, 20)), 5, device="cpu")) == 0
    smap = np.zeros((30, 30))
    smap[12, 17] = 1.0
    peaks = tinf.peak_detection(smap, 5, device="cpu")
    assert peaks.tolist() == [[17.0, 12.0, 1.0]]


# ------------------------------------------------------------ end to end


def _grid(coords, particle_size, mode, step=4):
    patch = int(particle_size / 3)
    if mode == "fcn":
        scale = 64 / patch
        step = max(1, int(round(step * scale))) / scale
    return np.rint((coords[:, :2] / 3 - patch / 2) / step).astype(int)


@pytest.mark.parametrize("mode", ["patch", "fcn"])
def test_pick_micrograph_matches_jax(params, mode):
    size = 180
    checked = unmatched = 0
    for seed in range(3):
        raw = np.random.default_rng(seed).normal(size=(768, 768)).astype(
            np.float32)
        want = jinf.pick_micrograph(params, raw, size, mode=mode)
        got = tinf.pick_micrograph(params, raw, size, mode=mode,
                                   device="cpu")
        img = jpp.preprocess_micrograph(jnp.asarray(raw))
        if mode == "fcn":
            smap = jinf.score_micrograph_fcn(jcnn.fc_params_as_conv(params),
                                             img, patch_size=size // 3)
        else:
            smap = jinf.score_micrograph_patches(params, img,
                                                 patch_size=size // 3)
        smap = np.asarray(smap)
        window = max(int(0.6 * (size // 3) / 4), 1)
        jax_cells = {tuple(c) for c in _grid(want, size, mode)}
        for (x, y) in _grid(got, size, mode):
            checked += 1
            if (x, y) in jax_cells:
                continue
            # a near-tie in JAX's map inside the window is the only
            # excuse
            win = smap[max(y - window, 0):y + window + 1,
                       max(x - window, 0):x + window + 1].ravel()
            d = np.abs(win[:, None] - win[None, :])
            assert (d[d > 0] < 1e-5).any(), (seed, x, y)
            unmatched += 1
        assert len(got) == pytest.approx(len(want), abs=1 + len(want) // 100)
    assert checked > 50 and unmatched <= checked // 100


# ------------------------------------------------------------------ CLI


def _mrc_dir(tmp_path, n=2, size=400):
    rng = np.random.default_rng(7)
    d = tmp_path / "mrcs"
    d.mkdir()
    for i in range(n):
        tmrc.write_mrc(str(d / f"mic{i}.mrc"),
                       rng.normal(size=(size, size)).astype(np.float32))
    return d


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f if line.strip()
                and not line.startswith(("data_", "loop_", "_"))]


@pytest.mark.parametrize("fmt", ["box", "star"])
def test_pick_cli_on_cpu_matches_jax(params, tmp_path, fmt):
    from repic_tpu.main import main as jax_cli
    from repic_tpu_torch.main import main as port_cli
    from repic_tpu_torch.telemetry import events

    mrc_dir = _mrc_dir(tmp_path)
    ckpt = str(tmp_path / "model.ckpt")
    jax_save(ckpt, params, {"particle_size": 120, "patch_norm": "reference"})
    jax_cli(["pick", ckpt, str(mrc_dir), str(tmp_path / "j"),
             "--format", fmt])
    port_cli(["pick", ckpt, str(mrc_dir), str(tmp_path / "t"),
              "--format", fmt, "--device", "cpu"])
    for i in range(2):
        want = _rows(tmp_path / "j" / f"mic{i}.{fmt}")
        got = _rows(tmp_path / "t" / f"mic{i}.{fmt}")
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g[:-1] == w[:-1]   # positions (and box sizes)
            assert abs(float(g[-1]) - float(w[-1])) < 1e-5
    # the run's telemetry beside the coordinate files
    names = set(os.listdir(tmp_path / "t"))
    assert {"_events.jsonl", "_metrics.json", "_metrics.prom"} <= names
    spans = [r for r in events.read_events(str(tmp_path / "t"))
             if r.get("ev") == "span" and r["name"] == "pick_micrograph"]
    assert sorted(s["micrograph"] for s in spans) == ["mic0", "mic1"]


def test_pick_cli_defaults_to_cuda(params, tmp_path):
    from repic_tpu_torch.main import main as port_cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    ckpt = str(tmp_path / "model.ckpt")
    jax_save(ckpt, params, {"particle_size": 120})
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_cli(["pick", ckpt, str(_mrc_dir(tmp_path, n=1)),
                  str(tmp_path / "o")])


def test_pick_cli_trace_dir_and_device_time(params, tmp_path):
    from repic_tpu_torch.main import main as port_cli
    from repic_tpu_torch.telemetry import events, probes

    ckpt = str(tmp_path / "model.ckpt")
    jax_save(ckpt, params, {"particle_size": 120})
    trace = tmp_path / "trace"
    try:
        port_cli(["pick", ckpt, str(_mrc_dir(tmp_path, n=1)),
                  str(tmp_path / "o"), "--device", "cpu", "--trace-dir",
                  str(trace), "--device-time", "--mode", "fcn"])
    finally:
        probes.set_device_time(False)
    assert trace.exists() and os.listdir(trace)
    records = events.read_events(str(tmp_path / "o"))
    span = next(r for r in records if r.get("ev") == "span"
                and r["name"] == "pick_micrograph")
    assert "device_tail_s" in span and "host_s" in span
    crumb = next(r for r in records if r.get("ev") == "event"
                 and r.get("name") == "trace_dir")
    assert json.loads(json.dumps(crumb))["path"] == str(trace.resolve())
