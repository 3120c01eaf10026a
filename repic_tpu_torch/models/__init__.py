"""The CNN picker's inference path: model, checkpoints, preprocessing,
scoring and peak picking (the port of ``repic_tpu.models``; training
waits for its own slice)."""

from repic_tpu_torch.models.cnn import PickerCNN, PickerFCN, fc_params_as_conv

__all__ = ["PickerCNN", "PickerFCN", "fc_params_as_conv"]
