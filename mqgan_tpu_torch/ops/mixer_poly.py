"""Chebyshev fast path for the deterministic MelMixer2D pointwise MLP
(counterpart of ``mqgan_tpu/ops/mixer_poly.py``; plain PyTorch, as the JAX
version is XLA and not a kernel).

The mixer's expand -> APTx -> contract stage is a scalar map of the
depthwise-conv output, g(z) = sum_f w2[f] * aptx(w1[f] z + b1[f]) + b2. It
is sampled on a Chebyshev grid over the batch's [min, max] and replaced by
a degree-N interpolant evaluated with the Clenshaw recurrence.
"""

from __future__ import annotations

import math

import torch

from mqgan_tpu_torch.nn.activations import aptx


def mixer_scalar_g(z, w1, b1, w2, b2):
    """The exact scalar map of the mixer MLP, vectorized over z (fp32)."""
    u = z[..., None] * w1 + b1
    return (w2 * aptx(u)).sum(dim=-1) + b2


def _chebyshev_fit(g_nodes: torch.Tensor, degree: int) -> torch.Tensor:
    grid = g_nodes.shape[0]
    j = torch.arange(grid, dtype=torch.float32, device=g_nodes.device)
    theta = (j + 0.5) * (math.pi / grid)
    k = torch.arange(degree + 1, dtype=torch.float32, device=g_nodes.device)
    basis = torch.cos(k[:, None] * theta[None, :])
    coef = (2.0 / grid) * (basis @ g_nodes)
    coef[0] = coef[0] * 0.5
    return coef


def _clenshaw(t: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    two_t = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for kk in range(coef.shape[0] - 1, 0, -1):
        b1, b2 = two_t * b1 - b2 + coef[kk], b1
    return t * b1 - b2 + coef[0]


def poly_mixer_apply(z: torch.Tensor, pad_mask: torch.Tensor | None,
                     w1, b1, w2, b2, *, degree: int = 160,
                     grid: int = 4096) -> torch.Tensor:
    """z (B, T, C) masked depthwise output -> g(z), in z's dtype. Padded
    positions return exactly b2."""
    zf = z.float()
    w1f, b1f, w2f = w1.float(), b1.float(), w2.float()
    b2f = torch.as_tensor(b2, dtype=torch.float32, device=z.device)

    zmin, zmax = zf.min(), zf.max()
    half = torch.clamp_min(0.5 * (zmax - zmin), 1e-6)
    mid = 0.5 * (zmax + zmin)

    j = torch.arange(grid, dtype=torch.float32, device=z.device)
    nodes_t = torch.cos((j + 0.5) * (math.pi / grid))
    g_nodes = mixer_scalar_g(mid + half * nodes_t, w1f, b1f, w2f, b2f)
    coef = _chebyshev_fit(g_nodes, degree)

    out = _clenshaw((zf - mid) / half, coef)
    if pad_mask is not None:
        out = torch.where(pad_mask[:, :, None], b2f, out)
    return out.to(z.dtype)
