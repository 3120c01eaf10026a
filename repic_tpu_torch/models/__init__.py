"""The CNN picker: model, checkpoints, preprocessing, scoring and peak
picking, training data and the training loop (the port of
``repic_tpu.models``)."""

from repic_tpu_torch.models.cnn import (
    PickerCNN,
    PickerFCN,
    fc_l2_penalty,
    fc_params_as_conv,
)

__all__ = [
    "PickerCNN",
    "PickerFCN",
    "fc_params_as_conv",
    "fc_l2_penalty",
]
