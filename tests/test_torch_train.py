"""The port's training half (``repic_tpu_torch.models.cnn`` training
pieces, ``models/train.py``, ``commands/fit.py``) against the JAX
package's, on the CPU.

Parameters are a flax init converted with ``params_from_jax``; the
dropout mask is the one flax draws, recorded at its ``nn.Dropout``
call (``torch_port_common.jax_dropout_mask``).  The port's own init
cannot reproduce JAX's threefry bits, so a step is held to JAX through
the parameters and masks it is given, and a fit from scratch by what it
learns.  Tolerances:

* ``fc_l2_penalty``: rel 1e-6; the training forward's logits: 1e-5;
* one step: loss rel 1e-6, logits 1e-5, every updated parameter abs
  1e-6, every momentum leaf 1e-4 of the leaf's largest magnitude; the
  learning rate bitwise; 20 chained steps on the fixture's patches:
  parameters within 1e-6, losses rel 1e-5; a bfloat16 step: loss rel
  1e-2 against JAX's bfloat16 step, logits 1e-2 of their largest
  magnitude, each leaf's update within 0.15 of its largest update;
* ``init_params``: each layer's std within 5% of flax's, every value
  within two of its standard deviations;
* ``fit`` on ``tests/test_train.py``'s fixture (6 epochs, batch 16):
  the reference test's limits (val error <= 10%, 75% of the planted
  particles picked, bfloat16 within 1.5 points of float32).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from repic_tpu.models import cnn as jcnn
from repic_tpu.models.checkpoint import load_checkpoint as jax_load
from repic_tpu.models.train import _make_update_step
from repic_tpu_torch.models import cnn as tcnn
from repic_tpu_torch.models import data as tdata
from repic_tpu_torch.models.checkpoint import (
    load_checkpoint,
    params_from_jax,
    save_checkpoint,
)
from repic_tpu_torch.models.train import (
    TrainConfig,
    fit,
    learning_rate,
    train_step,
)
from repic_tpu_torch.utils import mrc as tmrc
from test_train import PARTICLE, make_micrograph
from torch_port_common import (  # noqa: F401  (2 torch threads per worker)
    flat_tree,
    t,
    unflat_tree,
)
from torch_train_common import jax_dropout_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINING = os.path.join(REPO, "tests", "golden", "torch_port_training")


def _jax_init(arch="deep", seed=0):
    params = jcnn.PickerCNN(**jcnn.arch_kwargs(arch)).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 1)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _torch_model(params, arch="deep", dtype=torch.float32):
    model = tcnn.PickerCNN(**tcnn.arch_kwargs(arch), dtype=dtype,
                           device="meta")
    model.load_state_dict(params_from_jax(params), assign=True)
    return model.requires_grad_(True)


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 64, 64, 1)).astype(np.float32)
    y = rng.integers(0, 2, n).astype(np.int32)
    return x, y


def _sgd(decay_steps=8):
    return optax.sgd(optax.exponential_decay(0.01, decay_steps, 0.95,
                                             staircase=True), momentum=0.9)


# -------------------------------------------------------------- model


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_fc_l2_penalty_matches_jax(arch):
    params = _jax_init(arch, seed=3)
    want = float(jcnn.fc_l2_penalty(params))
    got = float(tcnn.fc_l2_penalty(params_from_jax(params)))
    assert abs(got / want - 1) < 1e-6


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_training_forward_with_the_jax_mask(arch):
    params = _jax_init(arch, seed=1)
    model = jcnn.PickerCNN(**jcnn.arch_kwargs(arch))
    x, _ = _batch(2, n=8)
    key = jax.random.PRNGKey(11)
    mask = jax_dropout_mask(model, params, jnp.asarray(x), key)
    want = np.asarray(model.apply({"params": params}, x, train=True,
                                  rngs={"dropout": key}))
    with torch.no_grad():
        got = _torch_model(params, arch)(t(x), train=True,
                                         dropout_mask=t(mask)).numpy()
    assert mask.shape == (8, 4 * tcnn.ARCHS[arch]["conv_spec"][-1][1])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_dropout_draws_from_the_generator():
    params = _jax_init()
    model = _torch_model(params)
    x, _ = _batch(3, n=64)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        with torch.no_grad():
            outs.append(model(t(x), train=True, generator=gen).numpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    with torch.no_grad():
        plain = model(t(x)).numpy()
    assert not np.allclose(outs[0], plain)


def test_init_params_statistics_match_flax():
    """Per layer: std within 5% of flax's lecun_normal init, every
    kernel value within two standard deviations, biases zero."""
    want = params_from_jax(_jax_init("deep", seed=0))
    gen = torch.Generator().manual_seed(1234)
    got = tcnn.init_params("deep", gen, "cpu")
    assert list(got) == list(
        tcnn.PickerCNN(device="meta").state_dict())
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == torch.float32
        if name.endswith("bias"):
            assert not g.any()
            continue
        fan_in = g[0].numel()
        sigma = (1.0 / fan_in) ** 0.5 / tcnn.TRUNCATED_NORMAL_STD
        assert abs(float(g.std()) / float(w.std()) - 1) < 0.05, name
        assert float(g.abs().max()) <= 2 * sigma, name
    again = tcnn.init_params("deep", torch.Generator().manual_seed(1234),
                             "cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_params_to_jax_inverts_params_from_jax(arch):
    tree = _jax_init(arch, seed=4)
    back = tcnn.params_to_jax(params_from_jax(tree))
    assert flat_tree(back).keys() == flat_tree(tree).keys()
    for k, v in flat_tree(tree).items():
        np.testing.assert_array_equal(flat_tree(back)[k], v)
        assert flat_tree(back)[k].dtype == np.float32


# -------------------------------------------------------- the schedule


@pytest.mark.parametrize("decay_steps", [1, 8, 24, 184, 1000])
def test_learning_rate_bitwise_equals_optax(decay_steps):
    sched = optax.exponential_decay(0.01, decay_steps, 0.95, staircase=True)
    counts = [0, decay_steps - 1, decay_steps, 10 * decay_steps,
              25 * decay_steps + 3]
    for c in counts:
        want = np.asarray(sched(c))
        got = learning_rate(c, 0.01, decay_steps, 0.95)
        assert got.dtype == np.float32
        assert got.tobytes() == want.tobytes(), (c, got, want)


# ------------------------------------------------------------- a step


def _jax_step(params, opt_state, x, y, key, tx, model):
    return _make_update_step(model, tx)(
        params, opt_state, jnp.asarray(x), jnp.asarray(y), key)


def _assert_step_close(model, momentum, want_params, want_trace):
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, want_params))
    want_t = params_from_jax(jax.tree_util.tree_map(np.asarray, want_trace))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
        scale = float(want_t[name].abs().max())
        np.testing.assert_allclose(momentum[name].numpy(),
                                   want_t[name].numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("arch", sorted(tcnn.ARCHS))
def test_one_train_step_matches_jax(arch):
    params = _jax_init(arch, seed=2)
    jmodel = jcnn.PickerCNN(**jcnn.arch_kwargs(arch))
    tx = _sgd()
    x, y = _batch(5)
    key = jax.random.PRNGKey(5)
    mask = jax_dropout_mask(jmodel, params, jnp.asarray(x), key)
    new_params, opt_state, loss, logits = _jax_step(
        params, tx.init(params), x, y, key, tx, jmodel)
    model = _torch_model(params, arch)
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    got_loss, got_logits = train_step(
        model, momentum, t(x), t(y.astype(np.int64)),
        learning_rate(0, 0.01, 8, 0.95), dropout_mask=t(mask))
    assert abs(float(got_loss) / float(loss) - 1) < 1e-6
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               atol=1e-5)
    _assert_step_close(model, momentum, new_params, opt_state[0].trace)


def test_twenty_chained_steps_match_jax(datasets):
    """20 steps over the fixture's patches as ``fit`` cycles them, each
    with its own key and recorded mask, the learning rate crossing two
    decay boundaries (every 8 steps).  The drift measured here stays
    under 2e-7 in the parameters and 2e-6 in the loss.  (On pure-noise
    batches a ReLU or max-pool input near a tie flips between the two
    packages within a few steps and the runs part by 1e-5-1e-3: a
    step's kink, not the update.)"""
    (x_all, y_all), _ = datasets
    order = np.random.default_rng(0).permutation(len(x_all))
    x_all, y_all = x_all[order], y_all[order]
    params = _jax_init("deep", seed=6)
    jmodel = jcnn.PickerCNN()
    tx = _sgd(8)
    opt_state = tx.init(params)
    update = _make_update_step(jmodel, tx)
    model = _torch_model(params)
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    drift = 0.0
    for step in range(20):
        off = (step * 16) % (len(x_all) - 16)
        x, y = x_all[off:off + 16], y_all[off:off + 16]
        key = jax.random.PRNGKey(1000 + step)
        mask = jax_dropout_mask(jmodel, params, jnp.asarray(x), key)
        params, opt_state, loss, _ = update(params, opt_state, jnp.asarray(x),
                                            jnp.asarray(y), key)
        got_loss, _ = train_step(model, momentum, t(x),
                                 t(y.astype(np.int64)),
                                 learning_rate(step, 0.01, 8, 0.95),
                                 dropout_mask=t(mask))
        assert abs(float(got_loss) / float(loss) - 1) < 1e-5, step
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        drift = max(drift, max(
            float((p.detach() - want[k]).abs().max())
            for k, p in model.named_parameters()))
    assert drift < 1e-6, drift


def test_bf16_step_matches_jax_bf16():
    """bfloat16 compute, float32 master weights: the port's step against
    JAX's bfloat16 step on the same mask, at rel 1e-2."""
    params = _jax_init("deep", seed=8)
    jmodel = jcnn.PickerCNN(dtype=jnp.bfloat16)
    x, y = _batch(9)
    key = jax.random.PRNGKey(3)
    mask = jax_dropout_mask(jmodel, params, jnp.asarray(x), key)
    tx = _sgd()
    new_params, _, loss, logits = _jax_step(
        params, tx.init(params), x, y, key, tx, jmodel)
    model = _torch_model(params, dtype=torch.bfloat16)
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    got_loss, got_logits = train_step(
        model, momentum, t(x), t(y.astype(np.int64)),
        learning_rate(0, 0.01, 8, 0.95), dropout_mask=t(mask))
    assert got_logits.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert abs(float(got_loss) / float(loss) - 1) < 1e-2
    logits = np.asarray(logits)
    assert np.abs(got_logits.numpy() - logits).max() <= (
        1e-2 * np.abs(logits).max())
    # bfloat16 rounds every layer's output and gradient: the updates
    # part by 4-10% of a leaf's largest update (three seeds measured)
    start = params_from_jax(params)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    for name, p in model.named_parameters():
        step_want = want[name] - start[name]
        step_got = p.detach() - start[name]
        assert float((step_got - step_want).abs().max()) <= (
            0.15 * float(step_want.abs().max())), name


def test_golden_step_equals_live_jax():
    """The committed step (``--only training``) is what JAX computes
    now, and the port's step from it is within the tolerances above --
    the golden the card is held to."""
    g = dict(np.load(os.path.join(TRAINING, "step.npz")))
    params = unflat_tree(g, "params/")
    jmodel = jcnn.PickerCNN()
    key = jax.random.PRNGKey(5)
    mask = jax_dropout_mask(jmodel, params, jnp.asarray(g["batch"]), key)
    np.testing.assert_array_equal(mask, g["mask"])
    updated, opt_state, loss, _ = _jax_step(
        params, _sgd().init(params), g["batch"], g["labels"], key,
        _sgd(), jmodel)
    for k, v in flat_tree(updated).items():
        np.testing.assert_array_equal(np.asarray(v), g["updated/" + k])
    model = _torch_model(params)
    momentum = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    lr = learning_rate(0, 0.01, 8, 0.95)
    assert lr.tobytes() == g["lr"].tobytes()
    got_loss, got_logits = train_step(
        model, momentum, t(g["batch"]), t(g["labels"].astype(np.int64)),
        lr, dropout_mask=t(g["mask"]))
    assert abs(float(got_loss) / float(g["loss"]) - 1) < 1e-6
    np.testing.assert_allclose(got_logits.numpy(), g["logits"], atol=1e-5)
    _assert_step_close(model, momentum, unflat_tree(g, "updated/"),
                       unflat_tree(g, "trace/"))
    for ds in (1, 8, 24, 184):
        counts = [0, ds - 1, ds, 10 * ds]
        got = np.array([learning_rate(c, 0.01, ds, 0.95) for c in counts])
        assert got.tobytes() == g[f"lr/{ds}"].tobytes()


# ---------------------------------------------------------------- fit


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    from tests.golden.make_torch_port_golden import write_training_fixture

    return write_training_fixture(str(tmp_path_factory.mktemp("fit")))


@pytest.fixture(scope="module")
def datasets(fixture_dirs):
    train = tdata.load_dataset(*fixture_dirs["train"], PARTICLE,
                               device="cpu")
    val = tdata.load_dataset(*fixture_dirs["val"], PARTICLE, device="cpu")
    return train, val


@pytest.fixture(scope="module")
def trained(datasets):
    train, val = datasets
    config = TrainConfig(batch_size=16, max_epochs=6, patience=10,
                         verbose=False)
    return fit(*train, *val, config, init_params=_jax_init(),
               device="cpu")


def test_fit_learns_synthetic_blobs(trained):
    assert trained.best_val_error <= 10.0
    assert trained.history[0]["val_error"] >= trained.best_val_error
    assert [h["epoch"] for h in trained.history] == list(range(7))
    assert trained.history[0]["lr"] == float(np.float32(0.01))
    assert all(v.dtype == np.float32
               for v in flat_tree(trained.params).values())


def test_fit_from_scratch_learns(datasets):
    train, val = datasets
    result = fit(*train, *val, TrainConfig(batch_size=16, max_epochs=6,
                                           verbose=False), device="cpu")
    assert result.best_val_error <= 10.0


def test_fit_warm_start(datasets, trained):
    train, val = datasets
    result = fit(*train, *val, TrainConfig(batch_size=16, max_epochs=2,
                                           patience=5, verbose=False),
                 init_params=trained.params, device="cpu")
    assert result.best_val_error <= trained.best_val_error + 5.0


def test_best_parameters_are_a_copy(datasets, trained):
    """The best-validation snapshot must not follow the live tensors:
    the kept parameters equal those of a second run cut just after the
    best epoch's evaluation, not the last step's."""
    train, val = datasets
    errors = [h["val_error"] for h in trained.history]
    best = int(np.argmin(errors))
    assert best < len(errors) - 1  # training went on after the best
    steps = best * (len(train[0]) // 16) + 1
    cut = fit(*train, *val, TrainConfig(
        batch_size=16, max_epochs=(steps * 16 + 8) / len(train[0]),
        patience=10, verbose=False), init_params=_jax_init(), device="cpu")
    assert len(cut.history) == best + 1
    for k, v in flat_tree(cut.params).items():
        np.testing.assert_array_equal(flat_tree(trained.params)[k], v)


def test_trained_model_picks_planted_particles(trained):
    from repic_tpu_torch.models.infer import pick_micrograph

    img, centers = make_micrograph(np.random.default_rng(99))
    coords = pick_micrograph(trained.params, img, PARTICLE, mode="patch",
                             device="cpu")
    strong = coords[coords[:, 2] > 0.5]
    found = sum(
        1 for cx, cy in centers
        if len(strong)
        and np.hypot(strong[:, 0] - cx, strong[:, 1] - cy).min()
        < PARTICLE / 2)
    assert found >= len(centers) * 0.75


def test_bf16_training_matches_f32(datasets, trained):
    train, val = datasets
    result = fit(*train, *val, TrainConfig(
        batch_size=16, max_epochs=6, patience=10, verbose=False,
        compute_dtype="bfloat16"), init_params=_jax_init(), device="cpu")
    assert result.best_val_error <= trained.best_val_error + 1.5
    assert all(v.dtype == np.float32
               for v in flat_tree(result.params).values())


def test_fit_is_deterministic(datasets):
    train, val = datasets
    runs = [fit(*train, *val, TrainConfig(batch_size=16, max_epochs=2,
                                          verbose=False), device="cpu")
            for _ in range(2)]
    for k, v in flat_tree(runs[0].params).items():
        np.testing.assert_array_equal(flat_tree(runs[1].params)[k], v)
    assert runs[0].history == runs[1].history


def test_fit_emits_train_telemetry(datasets, tmp_path):
    from repic_tpu_torch import telemetry
    from repic_tpu_torch.telemetry.events import read_events

    train, val = datasets
    rt = telemetry.start_run(str(tmp_path))
    try:
        fit(*train, *val, TrainConfig(batch_size=16, max_epochs=3,
                                      verbose=False), device="cpu")
    finally:
        telemetry.finish_run(rt)
    epochs = [e for e in read_events(str(tmp_path))
              if e.get("ev") == "event" and e.get("name") == "train_epoch"]
    assert [e["epoch"] for e in epochs] == [0, 1, 2, 3]
    assert "steps_per_sec" not in epochs[0]
    assert all("steps_per_sec" in e for e in epochs[1:])
    metrics = open(tmp_path / "_metrics.prom").read()
    for name in ("repic_train_steps_per_sec",
                 "repic_train_loss_fetches_total",
                 "repic_train_eval_fetches_total"):
        assert name in metrics


# ---------------------------------------------------------- checkpoints


def test_jax_pick_reads_a_port_checkpoint(trained, tmp_path):
    """A checkpoint the port's fit wrote is read by the JAX package's
    ``load_checkpoint`` and picks, through ``pick_micrograph``, where
    the port's pick picks on it."""
    from repic_tpu.models.infer import pick_micrograph as jax_pick
    from repic_tpu_torch.models.infer import pick_micrograph

    path = str(tmp_path / "port.rptpu")
    save_checkpoint(path, trained.params,
                    {"particle_size": PARTICLE, "patch_norm": "reference",
                     "arch": "deep"})
    jparams, meta = jax_load(path)
    assert meta["particle_size"] == PARTICLE
    img, _ = make_micrograph(np.random.default_rng(98))
    want = jax_pick(jparams, img, PARTICLE, mode="patch")
    got = pick_micrograph(load_checkpoint(path)[0], img, PARTICLE,
                          mode="patch", device="cpu")
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], atol=1e-5)


def test_port_picks_with_a_jax_fit_checkpoint(tmp_path):
    """The committed checkpoint of a JAX ``fit`` (``--only training``)
    picks the JAX ``pick`` command's particles through the port's
    ``pick`` command: the same positions, scores within 1e-5."""
    from repic_tpu_torch.main import main as cli

    mrc_dir = tmp_path / "mrc"
    mrc_dir.mkdir()
    img, _ = make_micrograph(np.random.default_rng(99))
    tmrc.write_mrc(str(mrc_dir / "held_out.mrc"), img)
    cli(["pick", os.path.join(TRAINING, "fit.ckpt"), str(mrc_dir),
         str(tmp_path / "out"), "--device", "cpu"])
    rows = [np.loadtxt(p, ndmin=2) for p in (
        tmp_path / "out" / "held_out.box",
        os.path.join(TRAINING, "picks", "held_out.box"))]
    assert rows[0].shape == rows[1].shape and len(rows[0]) > 0
    np.testing.assert_array_equal(rows[0][:, :4], rows[1][:, :4])
    np.testing.assert_allclose(rows[0][:, 4], rows[1][:, 4], atol=1e-5)
    _, meta = load_checkpoint(os.path.join(TRAINING, "fit.ckpt"))
    assert meta["particle_size"] == PARTICLE


# ------------------------------------------------------------------ CLI


def _fit_cli(*argv):
    from repic_tpu_torch.main import main as cli

    cli(["fit", *argv])


def test_fit_cli_labels(fixture_dirs, tmp_path, capsys):
    model_path = str(tmp_path / "m.rptpu")
    _fit_cli(*fixture_dirs["train"], model_path,
             "--val_label_dir", fixture_dirs["val"][1],
             "--val_mrc_dir", fixture_dirs["val"][0],
             "--particle_size", str(PARTICLE), "--batch_size", "16",
             "--max_epochs", "3", "--device", "cpu")
    out = capsys.readouterr().out
    assert "train: 72 patches (36 positive), val: 24 patches" in out
    assert f"saved {model_path} (best val error" in out
    params, meta = load_checkpoint(model_path)
    assert meta == {"particle_size": PARTICLE, "patch_norm": "reference",
                    "arch": "deep", "best_val_error": meta["best_val_error"],
                    "epochs": 3, "seed": 1234}
    jparams, jmeta = jax_load(model_path)
    assert jmeta == meta
    assert flat_tree(jparams).keys() == flat_tree(_jax_init()).keys()
    for name in ("_events.jsonl", "_metrics.json", "_metrics.prom"):
        assert (tmp_path / name).exists()


def test_fit_cli_extracted_source(fixture_dirs, tmp_path):
    tdata.extract_dataset(*fixture_dirs["train"], PARTICLE,
                          str(tmp_path / "mol.pickle"), device="cpu")
    model_path = str(tmp_path / "m.rptpu")
    _fit_cli(str(tmp_path), "mol.pickle", model_path,
             "--source", "extracted", "--particle_size", str(PARTICLE),
             "--batch_size", "8", "--max_epochs", "2", "--val_ratio",
             "0.25", "--device", "cpu")
    _, meta = load_checkpoint(model_path)
    assert meta["particle_size"] == PARTICLE


def test_fit_cli_retrain_checks_patch_norm(fixture_dirs, tmp_path):
    ckpt = str(tmp_path / "g.rptpu")
    save_checkpoint(ckpt, _jax_init(), {"particle_size": PARTICLE,
                                        "patch_norm": "global"})
    with pytest.raises(SystemExit, match="--patch_norm differs"):
        _fit_cli(*fixture_dirs["train"], str(tmp_path / "m.rptpu"),
                 "--val_label_dir", fixture_dirs["val"][1],
                 "--val_mrc_dir", fixture_dirs["val"][0],
                 "--particle_size", str(PARTICLE), "--retrain_from", ckpt,
                 "--device", "cpu")


def test_fit_cli_messages_match_jax(fixture_dirs, tmp_path):
    from repic_tpu.main import main as jax_cli

    cases = [
        [*fixture_dirs["train"], "m", "--particle_size", "120"],
        [*fixture_dirs["train"], "m", "--particle_size", "120",
         "--source", "relion_star", "--val_label_dir", "x"],
        [str(tmp_path), str(tmp_path), "m", "--particle_size", "120",
         "--val_label_dir", str(tmp_path)],
    ]
    for argv in cases:
        with pytest.raises(SystemExit) as want:
            jax_cli(["--platform", "cpu", "fit", *argv])
        with pytest.raises(SystemExit) as got:
            _fit_cli(*argv, "--device", "cpu")
        assert str(got.value) == str(want.value)


def test_fit_cli_defaults_to_cuda(fixture_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _fit_cli(*fixture_dirs["train"], str(tmp_path / "m"),
                 "--val_label_dir", fixture_dirs["val"][1],
                 "--particle_size", "120")
