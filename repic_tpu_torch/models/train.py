"""Training loop for the CNN picker (the port of
``repic_tpu.models.train``).

The reference's DeepPicker protocol, as a PyTorch update step driven by
a host loop:

* SGD with momentum 0.9 at 0.01, staircase decay x0.95 every 8 epochs'
  worth of steps (:func:`learning_rate`, float32 as optax computes it);
* loss = mean softmax cross-entropy + L2(5e-4) on the FC kernels only;
* dropout 0.5 on the flattened features, masks drawn from one
  ``torch.Generator`` on the device seeded with ``config.seed``;
* sequential batch offsets cycling the pre-shuffled training set, a
  validation error every epoch, the best parameters kept (a copy),
  early stop after 32 epochs without improvement; at most 200 epochs.

:func:`train_step` writes optax's update out: ``trace = g + 0.9 *
trace`` then ``p = p + (-lr) * trace``, gradients from autograd.  A
step issues no host sync: the loss and the logits stay on the device, and the loop
fetches the loss, the last batch's logits and the validation miss count
once per epoch, as the reference does.

On the card, float32 training runs with TF32 off and deterministic
cuDNN (:func:`repic_tpu_torch.models.infer._fp32_flags`), each
convolution's weight gradient a GEMM (``cnn._GemmWeightGradConv``), so
a seed gives the same checkpoint bytes run after run; ``bfloat16``
keeps float32 master weights and casts each layer.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from repic_tpu_torch import telemetry
from repic_tpu_torch.analysis.contracts import Contract, checked, spec
from repic_tpu_torch.models.checkpoint import params_from_jax
from repic_tpu_torch.models.cnn import (
    PickerCNN,
    arch_kwargs,
    compute_dtype,
    fc_l2_penalty,
    init_params as fresh_params,
    params_to_jax,
)
from repic_tpu_torch.models.infer import _fp32_flags
from repic_tpu_torch.telemetry import events as tlm_events

# Training telemetry: throughput and host-sync cadence.  Each loss/eval
# fetch is a host<->device round trip; the counters make a per-step
# fetch visible in the run report.
_log = tlm_events.get_logger("train")

_STEPS_PER_SEC = telemetry.gauge(
    "repic_train_steps_per_sec",
    "training steps per wall-clock second, updated per epoch",
)
_LOSS_FETCHES = telemetry.counter(
    "repic_train_loss_fetches_total",
    "host fetches of the training loss (once per epoch by design)",
)
_EVAL_FETCHES = telemetry.counter(
    "repic_train_eval_fetches_total",
    "host fetches of accumulated validation miss counts",
)


@dataclass
class TrainConfig:
    batch_size: int = 128
    learning_rate: float = 0.01
    lr_decay_factor: float = 0.95
    momentum: float = 0.9
    max_epochs: int = 200
    patience: int = 32
    decay_epochs: int = 8
    seed: int = 1234
    log_every: int = 1  # epochs between progress lines
    verbose: bool = True
    # "bfloat16": conv/matmul compute in bfloat16; parameters, logits,
    # loss and momentum stay float32 (master weights)
    compute_dtype: str = "float32"


@dataclass
class TrainResult:
    params: dict  # best-validation parameters, the reference's tree
    best_val_error: float
    epochs_run: int
    history: list = field(default_factory=list)


_libm = None


def _powf(x: float, y: float) -> np.float32:
    """C's ``powf`` (the call XLA's CPU backend compiles ``jnp.power``
    on float32 into)."""
    global _libm
    if _libm is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.powf.restype = ctypes.c_float
        lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _libm = lib
    return np.float32(_libm.powf(np.float32(x), np.float32(y)))


def _flush(x: np.float32) -> np.float32:
    """Subnormals to zero, as XLA's CPU code runs."""
    return np.float32(0) if abs(x) < np.finfo(np.float32).tiny else x


def learning_rate(count: int, init: float, decay_steps: int,
                  rate: float) -> np.float32:
    """optax's ``exponential_decay(init, decay_steps, rate,
    staircase=True)`` at ``count``, in float32 as it is computed:
    ``floor(float(count) / decay_steps)`` as the exponent, ``init *
    powf(rate, p)``, ``init`` itself at count 0."""
    if count <= 0:
        return np.float32(init)
    p = np.floor(np.float32(count) / np.float32(decay_steps))
    return _flush(np.float32(init) * _flush(_powf(rate, p)))


def _train_step_example():
    """Seeded inputs for the ``@checked`` contract: a fresh deep-
    architecture model with zero momentum traces, one 8-patch batch
    and its labels, the learning rate; on the CPU (``check`` moves
    them)."""
    g = torch.Generator().manual_seed(0)
    model = PickerCNN(**arch_kwargs("deep"))
    model.load_state_dict(fresh_params("deep", generator=g))
    momentum = {name: torch.zeros_like(p)
                for name, p in model.named_parameters()}
    batch = torch.randn((8, 64, 64, 1), generator=g)
    labels = torch.randint(0, 2, (8,), generator=g)
    return model, momentum, batch, labels, 0.01


@checked(Contract(
    example=_train_step_example,
    # the update is in place; the loss is a f32 scalar and the logits
    # are (B, 2) f32
    returns=lambda inputs: (
        spec(""), spec((inputs[2].shape[0], 2))),
))
def train_step(model: PickerCNN, momentum: dict, batch, labels, lr, *,
               decay: float = 0.9, dropout_mask=None, generator=None):
    """One update of ``model``'s parameters and ``momentum`` (a dict of
    trace tensors by parameter name), in place: forward with dropout,
    mean softmax cross-entropy plus :func:`fc_l2_penalty`, backward,
    then ``trace = g + decay * trace`` and ``p = p + (-lr) * trace``.
    Returns the loss and the logits, on the device."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    logits = model(batch, train=True, dropout_mask=dropout_mask,
                   generator=generator)
    loss = F.cross_entropy(logits, labels) + fc_l2_penalty(params)
    loss.backward()
    step = -float(lr)
    with torch.no_grad():
        for name, p in params.items():
            trace = momentum[name]
            trace.mul_(decay).add_(p.grad)
            p.add_(trace * step)
    return loss.detach(), logits.detach()


def error_rate(logits: np.ndarray, labels: np.ndarray) -> float:
    """Percent misclassified."""
    pred = np.argmax(logits, axis=1)
    return 100.0 * float(np.mean(pred != labels))


@torch.no_grad()
def evaluate(model: PickerCNN, data: torch.Tensor, labels: torch.Tensor,
             batch_size: int = 1024) -> float:
    """Percent misclassified over ``data`` in ``batch_size`` slices.
    The per-batch miss counts stay on the device; their sum is fetched
    once."""
    if len(labels) == 0:
        return 0.0
    wrong = torch.zeros((), dtype=torch.int64, device=data.device)
    for i in range(0, len(data), batch_size):
        logits = model(data[i:i + batch_size])
        wrong += (logits.argmax(dim=1) != labels[i:i + batch_size]).sum()
    total_wrong = int(wrong)  # the one fetch
    _EVAL_FETCHES.inc()
    telemetry.record_transfer(8)
    return 100.0 * total_wrong / len(labels)


def _shuffle(data, labels, rng):
    perm = rng.permutation(len(data))
    return data[perm], labels[perm]


def fit(
    train_data: np.ndarray,
    train_labels: np.ndarray,
    val_data: np.ndarray,
    val_labels: np.ndarray,
    config: TrainConfig = TrainConfig(),
    *,
    init_params=None,
    arch: str = "deep",
    device=None,
) -> TrainResult:
    """Train a :class:`PickerCNN` on ``device`` (``cuda`` unless the
    caller asks for the CPU); returns the best-validation parameters as
    the reference's tree.

    ``arch`` selects the filter pyramid (``cnn.ARCHS``).
    ``init_params`` warm-starts from the reference's parameter tree
    (numpy leaves, as ``load_checkpoint`` returns it); without it the
    parameters are :func:`~repic_tpu_torch.models.cnn.init_params` drawn
    from the dropout generator before its first mask.
    """
    from repic_tpu_torch.pipeline.consensus import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(config.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)

    train_data, train_labels = _shuffle(train_data, train_labels, rng)
    val_data, val_labels = _shuffle(val_data, val_labels, rng)

    train_size = len(train_data)
    batch_size = min(config.batch_size, train_size)
    steps_per_epoch = max(train_size // batch_size, 1)
    decay_steps = max(config.decay_epochs * steps_per_epoch, 1)

    def schedule(count):
        return learning_rate(count, config.learning_rate, decay_steps,
                             config.lr_decay_factor)

    if init_params is None:
        state = fresh_params(arch, gen, dev)
    else:
        state = {k: v.to(dev) for k, v in params_from_jax(init_params).items()}
    model = PickerCNN(**arch_kwargs(arch),
                      dtype=compute_dtype(config.compute_dtype),
                      device="meta")
    model.load_state_dict(state, assign=True)
    model.requires_grad_(True)
    momentum = {name: torch.zeros_like(p)
                for name, p in model.named_parameters()}

    x_train = torch.from_numpy(np.ascontiguousarray(train_data, np.float32)).to(dev)
    y_train = torch.from_numpy(np.asarray(train_labels, np.int64)).to(dev)
    x_val = torch.from_numpy(np.ascontiguousarray(val_data, np.float32)).to(dev)
    y_val = torch.from_numpy(np.asarray(val_labels, np.int64)).to(dev)

    best_val = float("inf")
    best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    patience = config.patience
    history = []
    t0 = time.time()
    epochs_run = 0
    step_mark, t_mark = 0, t0  # steps/sec gauge anchors

    max_steps = int(config.max_epochs * train_size) // batch_size
    with _fp32_flags():
        for step in range(max_steps):
            offset = (step * batch_size) % max(train_size - batch_size, 1)
            batch = x_train[offset:offset + batch_size]
            labels = y_train[offset:offset + batch_size]
            loss, logits = train_step(
                model, momentum, batch, labels, schedule(step),
                decay=config.momentum, generator=gen,
            )

            if step % steps_per_epoch == 0:
                epochs_run = step // steps_per_epoch
                val_err = evaluate(model, x_val, y_val)
                train_err = error_rate(logits.cpu().numpy(),
                                       labels.cpu().numpy())
                # one loss fetch per epoch; history and the progress
                # line share it
                loss_val = float(loss)
                _LOSS_FETCHES.inc()
                telemetry.record_transfer(4)
                now = time.time()
                steps_per_sec = (step - step_mark) / max(now - t_mark, 1e-9)
                step_mark, t_mark = step, now
                if step > 0:
                    _STEPS_PER_SEC.set(round(steps_per_sec, 3))
                history.append({
                    "epoch": epochs_run,
                    "loss": loss_val,
                    "train_error": train_err,
                    "val_error": val_err,
                    "lr": float(schedule(step)),
                })
                tlm_events.event(
                    "train_epoch",
                    epoch=epochs_run,
                    loss=round(loss_val, 6),
                    train_error=round(train_err, 4),
                    val_error=round(val_err, 4),
                    # epoch 0 fires before any step ran: no rate there
                    **({"steps_per_sec": round(steps_per_sec, 3)}
                       if step > 0 else {}),
                )
                if config.verbose and epochs_run % config.log_every == 0:
                    dt = time.time() - t0
                    _log.info(
                        f"epoch {epochs_run}: loss {loss_val:.4f} "
                        f"train_err {train_err:.2f}% "
                        f"val_err {val_err:.2f}% ({dt:.1f}s)"
                    )
                if val_err < best_val:
                    best_val = val_err
                    best_state = {k: v.detach().clone()
                                  for k, v in model.state_dict().items()}
                    patience = config.patience
                else:
                    patience -= 1
                if patience == 0:
                    if config.verbose:
                        _log.info(
                            f"validation error has not improved in "
                            f"{config.patience} epochs; stopping"
                        )
                    break

    return TrainResult(
        params=params_to_jax(best_state),
        best_val_error=best_val,
        epochs_run=epochs_run,
        history=history,
    )
