"""CBAM-style channel and time gates for (B, T, C) sequences, non-causal
(counterpart of ``mqgan_tpu/nn/attention.py`` ``CAM1D``, ``SAM1D``,
``CBAM1D``). The causal variants are not ported: the generator's causal
blocks drop CBAM.

These modules hold the CBAM parameters of a ``ResidualBlock1D``; inside the
block the gate chain runs in ``ops/block_kernels.py``. Their own forward is
the module-by-module form of the same function.

Under sequence-parallel training (``seq``, ``parallel/seqtrain.py``) the
CAM's masked sum, count and max are reduced over the seq group, with
their gradients (the max's split over the tied frames of every rank), and
the SAM's conv over time exchanges its halos.
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.core.masking import apply_mask
from mqgan_tpu_torch.nn.conv import Dense, WNConv1d
from mqgan_tpu_torch.nn.pooling import (Reduce, masked_avg_pool, masked_max_pool,
                                        partial_pool, pooled_mean, reduce_pools,
                                        seq_pools)


class CAM1D(nn.Module):
    """Masked max+avg pool over T -> shared MLP C -> C/r -> C -> sigmoid."""

    def __init__(self, channels: int, reduction_ratio: int = 8):
        super().__init__()
        hidden = channels // reduction_ratio
        self.mlp_0 = Dense(channels, hidden)
        self.mlp_2 = Dense(hidden, channels)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                stats_mask: torch.Tensor | None = None,
                reduce: Reduce | None = None, seq=None) -> torch.Tensor:
        """``stats_mask`` / ``reduce`` make the gate exact under sequence
        parallelism (JAX's ``stats_mask`` / ``seq_axis``): values stay
        masked by ``pad_mask``, the pooled statistics leave out the
        ``stats_mask`` frames (each clip frame counted in one window) and
        ``reduce`` combines the windows' fp32 partials (nn/pooling.py).
        ``seq`` (training): the same reductions over the seq group, with
        gradients."""
        def mlp(v):
            return self.mlp_2(torch.relu(self.mlp_0(v)))

        if seq is not None:
            mx, av = seq_pools(x, pad_mask, seq)
        elif stats_mask is None and reduce is None:
            mx = masked_max_pool(x, pad_mask)
            av = masked_avg_pool(x, pad_mask)
        else:
            total, mx, count = reduce_pools(*partial_pool(
                x, pad_mask if stats_mask is None else stats_mask), reduce)
            mx, av = mx.to(x.dtype), pooled_mean(total, count).to(x.dtype)
        gate = torch.sigmoid(mlp(mx) + mlp(av))[:, None, :]
        return apply_mask(gate * x, pad_mask)


class SAM1D(nn.Module):
    """Per-frame max+mean over C -> k-tap 2 -> 1 conv -> sigmoid time gate;
    logits of padded frames are forced to -1e4."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = WNConv1d(2, 1, kernel_size, weight_norm=False, bias=False)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                seq=None) -> torch.Tensor:
        mx = apply_mask(x.amax(dim=-1, keepdim=True), pad_mask)
        av = apply_mask(x.mean(dim=-1, keepdim=True), pad_mask)
        logits = self.conv(torch.cat([mx, av], dim=-1), seq)
        logits = apply_mask(logits, pad_mask, fill_value=-1e4)
        gate = apply_mask(torch.sigmoid(logits), pad_mask)
        return apply_mask(gate * x, pad_mask)


class CBAM1D(nn.Module):
    """CAM -> SAM -> residual add, re-masked."""

    def __init__(self, channels: int, reduction_ratio: int = 8,
                 sam_kernel_size: int = 7):
        super().__init__()
        self.channel_attention = CAM1D(channels, reduction_ratio)
        self.spatial_attention = SAM1D(sam_kernel_size)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                stats_mask: torch.Tensor | None = None,
                reduce: Reduce | None = None, seq=None) -> torch.Tensor:
        y = self.channel_attention(x, pad_mask, stats_mask, reduce, seq)
        y = self.spatial_attention(y, pad_mask, seq)
        return apply_mask(y + x, pad_mask)
