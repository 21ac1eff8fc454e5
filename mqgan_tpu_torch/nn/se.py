"""Masked squeeze-and-excitation over NCHW images (counterpart of
``mqgan_tpu/nn/se.py`` ``ChannelSELayerMasked``): squeeze = the masked mean
over (H, W); excitation = Dense -> ReLU -> Dense -> sigmoid, one scale per
channel."""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.nn.conv import Dense


class ChannelSELayerMasked(nn.Module):
    def __init__(self, num_channels: int, reduction_ratio: int = 2):
        super().__init__()
        reduced = max(1, num_channels // reduction_ratio)
        self.fc1 = Dense(num_channels, reduced)
        self.fc2 = Dense(reduced, num_channels)

    def forward(self, x: torch.Tensor,
                pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, C, H, W); pad_mask (B, H, W), True = padded."""
        if pad_mask is None:
            squeeze = x.mean(dim=(2, 3))
        else:
            valid = (~pad_mask).to(x.dtype)[:, None]  # (B, 1, H, W)
            denom = valid.sum(dim=(2, 3)).clamp_min(1.0)  # (B, 1)
            squeeze = (x * valid).sum(dim=(2, 3)) / denom
        excite = torch.sigmoid(self.fc2(torch.relu(self.fc1(squeeze))))
        return x * excite[:, :, None, None]
