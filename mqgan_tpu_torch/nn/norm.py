"""Normalization layers for (B, T, C) tensors (counterpart of
``mqgan_tpu/nn/norm.py``), the norms of a ``ResidualBlock1D`` built with
``norm="layer"`` or ``norm="instance"``.

``ChannelLayerNorm`` is a LayerNorm over the channels (the reference's
TransposeLayerNorm in a channels-last layout) with flax's numerics: the
statistics and the affine in fp32, the result in ``dtype`` or, without
one, in the promotion of the input's dtype with the fp32 parameters (as
flax infers it). ``InstanceNorm1d`` is torch's ``InstanceNorm1d(affine=True)``
on (B, T, C): per-(row, channel) statistics over time, biased variance,
epsilon inside the square root, computed in fp32, the result in ``dtype``
or the input's dtype. Neither masks padded frames, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class ChannelLayerNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        # ``ln`` holds flax's ``LayerNorm_0`` scale and bias
        self.ln = nn.LayerNorm(channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.ln.normalized_shape, self.ln.weight,
                         self.ln.bias, self.eps)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))


class InstanceNorm1d(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=1, keepdim=True)
        var = (x32 - mean).square().mean(dim=1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype or x.dtype)


def make_norm(norm: str, channels: int) -> nn.Module:
    """A block's norm: "weight" (weight-normed convs) has none."""
    if norm == "layer":
        return ChannelLayerNorm(channels)
    if norm == "instance":
        return InstanceNorm1d(channels)
    if norm == "weight":
        return nn.Identity()
    raise ValueError(f"norm must be 'weight', 'layer' or 'instance', got {norm!r}")
