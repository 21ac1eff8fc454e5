"""Finite Scalar Quantization, inference side (counterpart of
``mqgan_tpu/quant/fsq.py``: ``FSQSpec``, ``bound``, ``quantize``,
``codes_to_indices``, ``indices_to_codes``).

All math runs in fp32 whatever the model's compute dtype, as in the JAX
package. Rounding is half to even (``torch.round``, like ``jnp.round``).
Training-time noise dropout belongs to the training slice and is not here.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FSQSpec:
    levels: Tuple[int, ...]

    @property
    def codebook_dim(self) -> int:
        return len(self.levels)

    @property
    def codebook_size(self) -> int:
        return int(np.prod(self.levels))

    @property
    def basis(self) -> np.ndarray:
        return np.cumprod([1] + list(self.levels[:-1])).astype(np.int32)

    @property
    def half_width(self) -> np.ndarray:
        return (np.asarray(self.levels, np.int32) // 2).astype(np.float32)


def bound_constants(levels: Sequence[int], eps: float = 1e-3):
    """(half_l, offset, shift) as fp32 numpy rows, computed as the JAX
    package computes them."""
    lv = np.asarray(levels, np.float32)
    half_l = ((lv - np.float32(1.0)) * np.float32(1.0 + eps)
              / np.float32(2.0)).astype(np.float32)
    offset = np.where(lv % 2 == 0, 0.5, 0.0).astype(np.float32)
    shift = np.arctanh(offset / half_l).astype(np.float32)
    return half_l, offset, shift


def bound(z: torch.Tensor, levels: Sequence[int], eps: float = 1e-3) -> torch.Tensor:
    """Per-dim bounded squash tanh(z + shift) * half_l - offset, fp32."""
    half_l, offset, shift = (torch.from_numpy(a).to(z.device)
                             for a in bound_constants(levels, eps))
    return torch.tanh(z.float() + shift) * half_l - offset


def quantize(z: torch.Tensor, spec: FSQSpec) -> torch.Tensor:
    """z (..., d) -> normalized codes in [-1, 1]^d, fp32 (inference)."""
    half = torch.from_numpy(spec.half_width).to(z.device)
    return torch.round(bound(z, spec.levels)) / half


def codes_to_indices(zhat: torch.Tensor, spec: FSQSpec) -> torch.Tensor:
    """Normalized codes (..., d) -> packed int32 indices (...,)."""
    half = torch.from_numpy(spec.half_width).to(zhat.device)
    basis = torch.from_numpy(spec.basis.astype(np.float32)).to(zhat.device)
    return ((zhat * half + half) * basis).sum(dim=-1).to(torch.int32)


def indices_to_codes(indices: torch.Tensor, spec: FSQSpec) -> torch.Tensor:
    """(...,) int -> (..., d) normalized codes in [-1, 1], fp32."""
    idx = indices.long()[..., None]
    basis = torch.from_numpy(spec.basis.astype(np.int64)).to(indices.device)
    lv = torch.tensor(spec.levels, dtype=torch.int64, device=indices.device)
    half = torch.from_numpy(spec.half_width).to(indices.device)
    level_idx = torch.remainder(torch.div(idx, basis, rounding_mode="floor"), lv)
    return (level_idx.float() - half) / half
