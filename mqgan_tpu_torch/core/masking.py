"""Sequence masks (counterpart of ``mqgan_tpu/core/masking.py``).

A pad mask is (B, T) bool with **True = padded**; activations are
channels-last (B, T, ...). The kernels take per-row valid lengths instead
and rebuild contiguous-suffix masks from them (the framework convention).
"""

from __future__ import annotations

import torch


def sequence_mask(max_length: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool, True where index >= length."""
    positions = torch.arange(max_length, device=lengths.device)
    return positions[None, :] >= lengths[:, None]


def apply_mask(x: torch.Tensor, pad_mask: torch.Tensor | None,
               fill_value: float = 0.0) -> torch.Tensor:
    """Fill padded positions of x (B, T, ...) with ``fill_value``."""
    if pad_mask is None:
        return x
    shape = tuple(pad_mask.shape) + (1,) * (x.ndim - pad_mask.ndim)
    return x.masked_fill(pad_mask.reshape(shape), fill_value)


def lengths_from_mask(pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T) pad mask -> (B,) int32 valid lengths (contiguous masks)."""
    return (~pad_mask).sum(dim=1, dtype=torch.int32)
