"""Masked global pooling over time for (B, T, C) tensors (counterpart of
``mqgan_tpu/nn/pooling.py`` ``masked_max_pool`` / ``masked_avg_pool``).
The causal pools are not ported: the generator's CBAM is non-causal."""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def masked_max_pool(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, C), (B, T) -> (B, C): max over valid time steps."""
    return x.masked_fill(pad_mask[..., None], _NEG_INF).amax(dim=1)


def masked_avg_pool(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, C), (B, T) -> (B, C): mean over valid steps, count >= 1."""
    valid = (~pad_mask).to(x.dtype)[..., None]
    total = (x * valid).sum(dim=1)
    count = valid.sum(dim=1)
    return total / count.clamp_min(1.0)
