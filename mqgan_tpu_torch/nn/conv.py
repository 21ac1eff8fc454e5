"""Weight-normed convolutions (counterpart of ``mqgan_tpu/nn/conv.py``).

Parameters are kept in PyTorch's layouts — Conv1d (O, I, K), Conv2d
(O, I, kH, kW), Linear (O, I) — as ``v`` (direction), ``g`` (per-output
magnitude, (O,)) and ``bias``. The effective kernel is g * v / ||v|| with
the norm over every axis but O (torch ``weight_norm(dim=0)``, and the same
quantity as JAX's norm over (K, I) of its (K, I, O) kernel). ``folded()``
gives it for inference. Activations stay channels-last at the public
functions; the 1-D conv transposes to (B, C, T) internally.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / max(||v||, 1e-12), norm per output channel (axis 0), fp32."""
    v = v.float()
    norm = v.flatten(1).norm(dim=1).clamp_min(1e-12)
    shape = (-1,) + (1,) * (v.ndim - 1)
    return v * (g.float() / norm).reshape(shape)


def same_padding_1d(kernel_size: int, causal: bool, dilation: int = 1) -> tuple:
    """(lo, hi) time padding: causal pads d*(k-1) on the left only, SAME
    pads d*(k//2) on both sides (torch 'same' for odd k)."""
    if causal:
        return dilation * (kernel_size - 1), 0
    return dilation * (kernel_size // 2), dilation * (kernel_size // 2)


class WNConv1d(nn.Module):
    """1-D conv over (B, T, C) with optional weight norm and dilation."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 *, causal: bool = False, weight_norm: bool = True,
                 bias: bool = True, dilation: int = 1):
        super().__init__()
        shape = (out_channels, in_channels, kernel_size)
        self.kernel_size = kernel_size
        self.causal = causal
        self.dilation = dilation
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(out_channels))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def folded(self) -> torch.Tensor:
        """Effective (O, I, K) kernel in fp32."""
        if self.weight_norm:
            return weight_norm_kernel(self.v, self.g)
        return self.weight.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = same_padding_1d(self.kernel_size, self.causal, self.dilation)
        y = F.conv1d(F.pad(x.transpose(1, 2), (lo, hi)),
                     self.folded().to(x.dtype), dilation=self.dilation)
        y = y.transpose(1, 2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Dense(nn.Linear):
    """``nn.Linear`` over the last axis in the input's dtype (params stay
    fp32 and are cast at use, like flax ``nn.Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class WNConv2d(nn.Module):
    """2-D SAME conv (odd square kernel, stride 1) over NCHW images."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, *, weight_norm: bool = True):
        super().__init__()
        shape = (out_channels, in_channels, kernel_size, kernel_size)
        self.kernel_size = kernel_size
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(out_channels))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def folded(self) -> torch.Tensor:
        if self.weight_norm:
            return weight_norm_kernel(self.v, self.g)
        return self.weight.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.folded().to(x.dtype)
        return F.conv2d(x, w, self.bias.to(x.dtype),
                        padding=self.kernel_size // 2)
