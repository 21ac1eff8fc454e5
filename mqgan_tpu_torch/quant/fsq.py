"""Finite Scalar Quantization (counterpart of ``mqgan_tpu/quant/fsq.py``:
``FSQSpec``, ``round_ste``, ``floor_ste``, ``bound``,
``symmetry_preserving_bound``, ``quantize``, ``codes_to_indices``,
``indices_to_codes`` and the ``FSQ`` module).

All math runs in fp32 whatever the model's compute dtype, as in the JAX
package. Rounding is half to even (``torch.round``, like ``jnp.round``),
with straight-through gradients. Training-time noise dropout draws from an
explicit ``torch.Generator`` on the latent's device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mqgan_tpu_torch.nn.conv import Dense


@dataclasses.dataclass(frozen=True)
class FSQSpec:
    levels: Tuple[int, ...]
    preserve_symmetry: bool = False
    noise_dropout: float = 0.0

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


def round_ste(z: torch.Tensor) -> torch.Tensor:
    """Round half to even, with the identity as its gradient."""
    return z + (torch.round(z) - z).detach()


def floor_ste(z: torch.Tensor) -> torch.Tensor:
    return z + (torch.floor(z) - z).detach()


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


def symmetry_preserving_bound(z: torch.Tensor,
                              levels: Sequence[int]) -> torch.Tensor:
    """2/(L-1) * floor_ste((L-1)(tanh(z)+1)/2 + 0.5) - 1, fp32."""
    lm1 = torch.tensor(levels, dtype=torch.float32, device=z.device) - 1.0
    bracket = floor_ste(lm1 * (torch.tanh(z.float()) + 1.0) / 2.0 + 0.5)
    return (2.0 / lm1) * bracket - 1.0


def quantize(z: torch.Tensor, spec: FSQSpec, *, training: bool = False,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """z (..., d) -> normalized codes in [-1, 1]^d, fp32, with
    straight-through gradients.

    Training-time noise dropout (rate ``spec.noise_dropout``, per sample of
    the leading axis): with probability p a sample skips quantization;
    independently with probability p it becomes z + uniform(-0.5, 0.5) /
    half_width. The draws come from ``generator``, which must be given."""
    half = torch.from_numpy(spec.half_width).to(z.device)
    if spec.preserve_symmetry:
        q = round_ste(symmetry_preserving_bound(z, spec.levels)) / half
    else:
        q = round_ste(bound(z, spec.levels)) / half
    if not training or spec.noise_dropout == 0.0:
        return q
    if generator is None:
        raise ValueError("training-time FSQ noise needs a generator")
    bshape = (z.shape[0],) + (1,) * (z.ndim - 1)

    def coin():
        return (torch.rand((z.shape[0],), generator=generator, device=z.device)
                < spec.noise_dropout).reshape(bshape)

    skip = coin()
    q = torch.where(skip, z, q)
    offs = coin()
    offset = (torch.rand(z.shape, generator=generator, device=z.device,
                         dtype=z.dtype) - 0.5) / half
    return torch.where(offs, z + offset, q)


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


class FSQ(nn.Module):
    """The FSQ module (counterpart of the JAX ``FSQ``): optional learned
    projections when ``dim`` differs from levels x codebooks,
    ``num_codebooks`` groups packed independently (indices gain a trailing
    codebook axis), ``channel_first`` inputs (B, d, ...). Forward returns
    (codes in the input's dtype, int32 indices); indices always come from
    the clean quantization, also under noise dropout."""

    def __init__(self, levels, dim: int | None = None, num_codebooks: int = 1,
                 keep_num_codebooks_dim: bool | None = None,
                 channel_first: bool = False, projection_has_bias: bool = True,
                 preserve_symmetry: bool = False, noise_dropout: float = 0.0):
        super().__init__()
        self.spec = FSQSpec(tuple(levels), preserve_symmetry, noise_dropout)
        self.num_codebooks = num_codebooks
        self.keep_num_codebooks_dim = (keep_num_codebooks_dim
                                       if keep_num_codebooks_dim is not None
                                       else num_codebooks > 1)
        if num_codebooks > 1 and not self.keep_num_codebooks_dim:
            raise ValueError("num_codebooks > 1 needs keep_num_codebooks_dim")
        self.channel_first = channel_first
        self.effective_codebook_dim = len(self.spec.levels) * num_codebooks
        self.dim = dim if dim is not None else self.effective_codebook_dim
        self.has_projections = self.dim != self.effective_codebook_dim
        if self.has_projections:
            self.project_in = Dense(self.dim, self.effective_codebook_dim,
                                    bias=projection_has_bias)
            self.project_out = Dense(self.effective_codebook_dim, self.dim,
                                     bias=projection_has_bias)

    @property
    def codebook_size(self) -> int:
        return self.spec.codebook_size

    def forward(self, z: torch.Tensor, training: bool = False,
                generator: torch.Generator | None = None):
        moved = self.channel_first or z.ndim >= 4
        if moved:
            z = torch.movedim(z, 1, -1)
        lead_shape = z.shape[:-1]
        z = z.reshape(z.shape[0], -1, z.shape[-1])
        if self.has_projections:
            z = self.project_in(z)
        b, n, _ = z.shape
        z = z.reshape(b, n, self.num_codebooks, self.spec.codebook_dim)
        z32 = z.float()
        codes = quantize(z32, self.spec, training=training, generator=generator)
        noisy = training and self.spec.noise_dropout > 0.0
        clean = quantize(z32, self.spec) if noisy else codes
        indices = codes_to_indices(clean.detach(), self.spec)
        out = codes.reshape(b, n, self.effective_codebook_dim).to(z.dtype)
        if self.has_projections:
            out = self.project_out(out)
        out = out.reshape(lead_shape + (out.shape[-1],))
        indices = indices.reshape(lead_shape + (self.num_codebooks,))
        if moved:
            out = torch.movedim(out, -1, 1)
        if not self.keep_num_codebooks_dim:
            indices = indices[..., 0]
        return out, indices

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        return indices_to_codes(indices, self.spec)
