"""Weight-normed convolutions (counterpart of ``mqgan_tpu/nn/conv.py``).

Parameters are kept in PyTorch's layouts — Conv1d (O, I, K), Conv2d
(O, I, kH, kW), Linear (O, I) — as ``v`` (direction), ``g`` (per-output
magnitude, (O,)) and ``bias``. The effective kernel is g * v / ||v|| with
the norm over every axis but O (torch ``weight_norm(dim=0)``, and the same
quantity as JAX's norm over (K, I) of its (K, I, O) kernel). ``folded()``
gives it for inference, and ``fold_weight_norm_`` replaces (v, g) by it for
good (a serving copy, deploy/export.py). Both convs take stride, groups and
explicit (lo, hi) padding per spatial dim, as the JAX ``WNConv`` does. The 1-D conv is
channels-last at ``forward`` and transposes to (B, C, T) internally
(``conv_nct`` takes (B, C, T) as it is); the 2-D conv runs on NCHW.

Under sequence-parallel training (``parallel/seqtrain.py``) ``forward``
takes ``seq``, this rank's shard of the time axis (the 1-D conv's T, the
2-D conv's H): the halo exchange gives the window the rank's outputs
need, zero-filled past the crop's ends as the padding is, and the conv runs
unpadded along time.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t in ``dtype``: t itself when it already is (no op is recorded
    when a program is traced)."""
    return t if t.dtype == dtype else t.to(dtype)


def weight_norm_kernel(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g * v / max(||v||, 1e-12), norm per output channel (axis 0), fp32."""
    v = cast(v, torch.float32)
    norm = v.flatten(1).norm(dim=1).clamp_min(1e-12)
    shape = (-1,) + (1,) * (v.ndim - 1)
    return v * (cast(g, torch.float32) / norm).reshape(shape)


def fold_weight_norm_(module: nn.Module) -> nn.Module:
    """Replace every weight-normed conv's (v, g) in ``module`` by its folded
    kernel, in place (inference: the same kernel, computed once)."""
    for m in module.modules():
        if isinstance(m, (WNConv1d, WNConv2d)) and m.weight_norm:
            weight = m.folded().detach()
            del m.v, m.g
            m.weight_norm = False
            m.weight = nn.Parameter(weight, requires_grad=False)
    return module


def same_padding_1d(kernel_size: int, causal: bool, dilation: int = 1) -> tuple:
    """(lo, hi) time padding: causal pads d*(k-1) on the left only, SAME
    pads d*(k//2) on both sides (torch 'same' for odd k)."""
    if causal:
        return dilation * (kernel_size - 1), 0
    return dilation * (kernel_size // 2), dilation * (kernel_size // 2)


class WNConv1d(nn.Module):
    """1-D conv over (B, T, C) with optional weight norm, dilation, stride,
    groups and explicit padding (the JAX ``WNConv`` with one spatial dim).

    ``padding``: None gives SAME (d*(k//2) on both sides) or, with
    ``causal``, d*(k-1) on the left; a (lo, hi) pair pads the time axis
    explicitly. The kernel is (O, I/groups, K): JAX's grouped (K, I/g, O)
    transposed, normalised per O over (I/g, K) as JAX does over (K, I/g).
    ``conv_nct`` runs the same conv on a channels-first (B, C, T) input."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 *, causal: bool = False, weight_norm: bool = True,
                 bias: bool = True, dilation: int = 1, stride: int = 1,
                 groups: int = 1, padding: tuple | None = None):
        super().__init__()
        shape = (out_channels, in_channels // groups, kernel_size)
        self.kernel_size = kernel_size
        self.causal = causal
        self.dilation = dilation
        self.stride = stride
        self.groups = groups
        self.padding = (same_padding_1d(kernel_size, causal, dilation)
                        if padding is None else tuple(padding))
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(out_channels))
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def folded(self) -> torch.Tensor:
        """Effective (O, I/groups, K) kernel in fp32."""
        if self.weight_norm:
            return weight_norm_kernel(self.v, self.g)
        return cast(self.weight, torch.float32)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.padding
        if lo == hi:
            return F.conv1d(x, cast(self.folded(), x.dtype), stride=self.stride,
                            padding=lo, dilation=self.dilation,
                            groups=self.groups)
        return F.conv1d(F.pad(x, (lo, hi)), cast(self.folded(), x.dtype),
                        stride=self.stride, dilation=self.dilation,
                        groups=self.groups)

    def conv_nct(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T) -> (B, C_out, T')."""
        y = self._conv(x)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None]
        return y

    def forward(self, x: torch.Tensor, seq=None) -> torch.Tensor:
        if seq is None:
            y = self._conv(x.transpose(1, 2)).transpose(1, 2)
        else:
            w = cast(self.folded(), x.dtype)
            y, _ = seq.conv(
                x, 1, self.kernel_size,
                lambda xw: F.conv1d(xw.transpose(1, 2), w, stride=self.stride,
                                    dilation=self.dilation,
                                    groups=self.groups).transpose(1, 2),
                stride=self.stride, pad=self.padding, dilation=self.dilation)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class Dense(nn.Linear):
    """``nn.Linear`` over the last axis in the input's dtype (params stay
    fp32 and are cast at use, like flax ``nn.Dense(dtype=...)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else cast(self.bias, x.dtype)
        return F.linear(x, cast(self.weight, x.dtype), bias)


def _pair(x) -> tuple:
    return (x, x) if isinstance(x, int) else tuple(x)


class WNConv2d(nn.Module):
    """2-D conv over NCHW images with optional weight norm, stride, groups
    and explicit padding (the JAX ``WNConv`` with two spatial dims).

    ``kernel_size`` and ``stride``: an int or an (h, w) pair. ``padding``:
    None gives SAME for odd kernels (k//2 on both sides of each dim); a
    ((lo, hi), (lo, hi)) pair pads each dim explicitly."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=3, *, weight_norm: bool = True, stride=1,
                 groups: int = 1, padding=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        shape = (out_channels, in_channels // groups, kh, kw)
        self.kernel_size = (kh, kw)
        self.stride = _pair(stride)
        self.groups = groups
        self.padding = (((kh // 2, kh // 2), (kw // 2, kw // 2)) if padding is None
                        else tuple(tuple(p) for p in padding))
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
        return cast(self.weight, torch.float32)

    def forward(self, x: torch.Tensor, seq=None) -> torch.Tensor:
        """``seq``: x's H (dim 2) is time, sharded (module docstring)."""
        w = cast(self.folded(), x.dtype)
        b = cast(self.bias, x.dtype)
        (h_lo, h_hi), (w_lo, w_hi) = self.padding
        if seq is not None:
            y, _ = seq.conv(x, 2, self.kernel_size[0], lambda xw: F.conv2d(
                F.pad(xw, (w_lo, w_hi)), w, b, stride=self.stride,
                groups=self.groups), stride=self.stride[0], pad=(h_lo, h_hi))
            return y
        if h_lo == h_hi and w_lo == w_hi:
            return F.conv2d(x, w, b, stride=self.stride, padding=(h_lo, w_lo),
                            groups=self.groups)
        return F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), w, b,
                        stride=self.stride, groups=self.groups)
