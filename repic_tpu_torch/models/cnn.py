"""The CNN particle picker's model, as ``torch.nn`` modules (the port of
``repic_tpu.models.cnn``).

A binary particle/background classifier over 64 x 64 patches:

    conv 9x9x8  -> relu -> maxpool 2x2   (all VALID)
    conv 5x5x16 -> relu -> maxpool 2x2
    conv 3x3x32 -> relu -> maxpool 2x2
    conv 2x2x64 -> relu -> maxpool 2x2
    flatten(2x2x64) -> fc 128 relu -> fc num_class

:class:`PickerCNN` scores patch batches; :class:`PickerFCN` runs the
same weights fully convolutionally over a whole micrograph (the FC head
as a 2 x 2 conv then a 1 x 1 conv, output stride 16).

Layouts follow the reference at the module boundary: inputs are
``(B, H, W, 1)`` and the FCN's logits ``(B, H', W', num_class)``.
Inside, the tensors are NCHW with OIHW kernels; the flattened 2 x 2 x C
feature window keeps the reference's (row, col, channel) order, so
``fc1``'s weight is the reference's dense kernel transposed
(:func:`repic_tpu_torch.models.checkpoint.params_from_jax`).

``dtype`` is the compute dtype: parameters stay float32 and each layer
casts its input, weight and bias to it (``torch.bfloat16`` for
``--bf16``), as flax's ``dtype=`` does; logits come back float32.
The convolutions are cuDNN's on the card.

Training adds dropout 0.5 on the flattened features
(:meth:`PickerCNN.forward` with ``train=True``), the L2 penalty on the
two FC kernels (:func:`fc_l2_penalty`), flax's default initialisation
(:func:`init_params`) and the way back to the reference's parameter
tree (:func:`params_to_jax`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (kernel_size, features) per conv block
CONV_SPEC = ((9, 8), (5, 16), (3, 32), (2, 64))
PATCH_SIZE = 64  # model input resolution
FC_WIDTH = 128
FC_WEIGHT_DECAY = 5e-4  # L2 on the two FC weight matrices only
DROPOUT_RATE = 0.5
# flax's lecun_normal: the std of a standard normal truncated to (-2, 2)
TRUNCATED_NORMAL_STD = 0.87962566103423978
# 64x64 -> 2x2xC after four VALID conv+pool blocks (every ARCHS entry
# lands on a 2x2 feature map)
FEAT_SPATIAL = 2
FEAT_CHANNELS = CONV_SPEC[-1][1]
# output stride of the fully-convolutional head: the four pool strides
FCN_STRIDE = 16

# Three filter pyramids sharing the patch/FCN machinery; "deep" is the
# reference-parity DeepPicker stack.
ARCHS = {
    "deep": {"conv_spec": CONV_SPEC, "fc_width": 128},
    "wide": {
        "conv_spec": ((7, 16), (5, 32), (3, 64), (2, 128)),
        "fc_width": 192,
    },
    "slim": {
        "conv_spec": ((5, 8), (3, 16), (3, 32), (2, 32)),
        "fc_width": 64,
    },
}


def feature_spatial(conv_spec, patch: int = PATCH_SIZE) -> int:
    """Feature-map edge after the VALID conv+pool pyramid."""
    s = patch
    for k, _ in conv_spec:
        s = (s - k + 1) // 2
    return s


for _name, _a in ARCHS.items():  # every arch must land on 2x2
    assert feature_spatial(_a["conv_spec"]) == FEAT_SPATIAL, _name


def arch_kwargs(arch: str) -> dict:
    if arch not in ARCHS:
        raise ValueError(
            f"unknown picker architecture {arch!r} "
            f"(have {sorted(ARCHS)})"
        )
    return ARCHS[arch]


def compute_dtype(name: str) -> torch.dtype:
    """Map a CLI-friendly dtype name to the computation dtype."""
    table = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in table:
        raise ValueError(
            f"unknown compute dtype {name!r} (have {sorted(table)})"
        )
    return table[name]


class _GemmWeightGradConv(torch.autograd.Function):
    """``F.conv2d`` (VALID, stride 1) whose weight gradient is one GEMM
    over the unfolded input.  cuDNN's deterministic weight-gradient
    algorithm for the second conv layer is off by 1.4e-4 of the
    gradient's magnitude, its other algorithms are not repeatable; the
    GEMM is both exact to float32 sums and repeatable.  The input's
    gradient and the forward stay cuDNN's."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv2d(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        grad_x = None
        if ctx.needs_input_grad[0]:
            grad_x = torch.nn.grad.conv2d_input(x.shape, weight, grad)
        kh, kw = weight.shape[-2:]
        windows = x.unfold(2, kh, 1).unfold(3, kw, 1)  # (B, C, H', W', kh, kw)
        grad_w = torch.einsum("boyx,bcyxij->ocij", grad, windows)
        return grad_x, grad_w, grad.sum((0, 2, 3))


def _conv(x, layer: nn.Conv2d, dtype):
    w, b = layer.weight.to(dtype), layer.bias.to(dtype)
    if torch.is_grad_enabled() and layer.weight.requires_grad:
        return _GemmWeightGradConv.apply(x, w, b)
    return F.conv2d(x, w, b)


class Backbone(nn.Module):
    """The four VALID conv+pool blocks shared by both heads; NCHW in,
    NCHW out, in the compute dtype."""

    def __init__(self, conv_spec=CONV_SPEC, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        cin = 1
        for i, (k, f) in enumerate(conv_spec):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(cin, f, k, device=device))
            cin = f
        self.n_layers = len(conv_spec)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(self.n_layers):
            x = F.relu(_conv(x, getattr(self, f"conv{i + 1}"), self.dtype))
            x = F.max_pool2d(x, 2, 2)
        return x


class PickerCNN(nn.Module):
    """Binary classifier over 64x64 patches.

    Input ``(B, 64, 64, 1)`` standardized patches; output ``(B,
    num_class)`` float32 logits."""

    def __init__(self, num_class: int = 2, conv_spec=CONV_SPEC,
                 fc_width: int = FC_WIDTH, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.backbone = Backbone(conv_spec, dtype, device)
        flat = FEAT_SPATIAL * FEAT_SPATIAL * conv_spec[-1][1]
        self.fc1 = nn.Linear(flat, fc_width, device=device)
        self.fc2 = nn.Linear(fc_width, num_class, device=device)

    def forward(self, x, *, train: bool = False, dropout_mask=None,
                generator=None):
        """Logits of ``x``; ``train=True`` applies dropout 0.5 to the
        flattened features, ``where(keep, x / 0.5, 0)`` with ``keep``
        the boolean ``dropout_mask`` (``(B, 4C)``, indexed like the
        reference's NHWC flatten) or, without one, a mask drawn from
        ``generator`` on ``x``'s device."""
        x = self.backbone(x.permute(0, 3, 1, 2))
        # (row, col, channel) flatten order, as the reference's NHWC
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if train:
            if dropout_mask is None:
                dropout_mask = torch.rand(
                    x.shape, generator=generator, device=x.device
                ) < 1.0 - DROPOUT_RATE
            x = torch.where(dropout_mask, x / (1.0 - DROPOUT_RATE),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        dt = self.dtype
        x = F.relu(F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt)))
        x = F.linear(x, self.fc2.weight.to(dt), self.fc2.bias.to(dt))
        return x.float()


class PickerFCN(nn.Module):
    """The same classifier at every 64x64 window, stride 16.

    Input ``(B, H, W, 1)`` with ``H, W >= 64``; output ``(B, H', W',
    num_class)`` float32 logits.  :func:`fc_params_as_conv` maps
    :class:`PickerCNN` parameters onto it."""

    def __init__(self, num_class: int = 2, conv_spec=CONV_SPEC,
                 fc_width: int = FC_WIDTH, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.backbone = Backbone(conv_spec, dtype, device)
        self.fc1_conv = nn.Conv2d(conv_spec[-1][1], fc_width, FEAT_SPATIAL,
                                  device=device)
        self.fc2_conv = nn.Conv2d(fc_width, num_class, 1, device=device)

    def forward(self, x):
        x = self.backbone(x.permute(0, 3, 1, 2))
        x = F.relu(_conv(x, self.fc1_conv, self.dtype))
        x = _conv(x, self.fc2_conv, self.dtype)
        return x.permute(0, 2, 3, 1).float()


def fc_params_as_conv(params: dict) -> dict:
    """Re-shape :class:`PickerCNN` parameters (the reference's layout,
    numpy leaves) for :class:`PickerFCN`.

    ``fc1`` has kernel ``(4C, W)`` where ``4C`` flattens a 2x2xC
    feature window in (row, col, channel) order; the equivalent conv
    kernel is ``(2, 2, C, W)``.  ``fc2`` becomes a 1x1 conv.  The
    backbone transfers unchanged."""
    p = dict(params)
    fc1 = p.pop("fc1")
    fc2 = p.pop("fc2")
    in_dim, width = fc1["kernel"].shape
    channels = in_dim // (FEAT_SPATIAL * FEAT_SPATIAL)
    p["fc1_conv"] = {
        "kernel": fc1["kernel"].reshape(
            FEAT_SPATIAL, FEAT_SPATIAL, channels, width
        ),
        "bias": fc1["bias"],
    }
    p["fc2_conv"] = {
        "kernel": fc2["kernel"][None, None, :, :],
        "bias": fc2["bias"],
    }
    return p


def build_model(kind: str, state_dict: dict, *, arch: str = "deep",
                dtype: str = "float32") -> nn.Module:
    """A :class:`PickerCNN` (``kind="cnn"``) or :class:`PickerFCN`
    (``"fcn"``) holding ``state_dict``'s tensors (no copy, no random
    init), in eval mode."""
    cls = {"cnn": PickerCNN, "fcn": PickerFCN}[kind]
    model = cls(**arch_kwargs(arch), dtype=compute_dtype(dtype),
                device="meta")
    model.load_state_dict(state_dict, assign=True)
    return model.eval()


def fc_l2_penalty(params: dict) -> torch.Tensor:
    """L2 weight decay on the FC kernels only: ``5e-4 * (|fc1|^2 / 2 +
    |fc2|^2 / 2)`` over a state dict (or ``named_parameters``)."""
    return FC_WEIGHT_DECAY * (
        0.5 * torch.sum(params["fc1.weight"] ** 2)
        + 0.5 * torch.sum(params["fc2.weight"] ** 2)
    )


def init_params(arch: str = "deep", generator=None, device=None) -> dict:
    """A fresh :class:`PickerCNN` state dict with flax's defaults:
    every kernel ``lecun_normal`` (a normal truncated at two standard
    deviations, std ``sqrt(1 / fan_in) / 0.8796``, ``fan_in`` the
    kernel's input size times its window), every bias zero.  Drawn on
    ``device`` from ``generator`` (which must live there), layer by
    layer in the module's order."""
    kw = arch_kwargs(arch)
    shapes = PickerCNN(**kw, device="meta").state_dict()
    out = {}
    for name, meta in shapes.items():
        t = torch.zeros(meta.shape, dtype=torch.float32, device=device)
        if name.endswith("weight"):
            fan_in = meta[0].numel()
            std = (1.0 / fan_in) ** 0.5 / TRUNCATED_NORMAL_STD
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
        out[name] = t
    return out


def params_to_jax(state_dict: dict) -> dict:
    """The reference's parameter tree (nested dicts of float32 numpy
    arrays: HWIO conv kernels, ``(in, out)`` dense kernels) of a port
    state dict -- the inverse of
    :func:`repic_tpu_torch.models.checkpoint.params_from_jax`."""
    tree: dict = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        a = t.detach().float().cpu()
        if leaf == "weight":
            leaf = "kernel"
            a = a.permute(2, 3, 1, 0) if a.dim() == 4 else a.t()
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(a.numpy())
    return tree
