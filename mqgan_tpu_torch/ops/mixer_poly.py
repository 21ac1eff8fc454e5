"""Chebyshev serving mode of the deterministic MelMixer2D (counterpart of
``mqgan_tpu/ops/mixer_poly.py``).

The mixer's expand -> APTx -> contract stage is a scalar map of the
depthwise-conv output, g(z) = sum_f w2[f] * aptx(w1[f] z + b1[f]) + b2. It
is sampled on a Chebyshev grid over the batch's [min, max] and replaced by
a degree-N interpolant evaluated with the Clenshaw recurrence.

``fused_poly_mixer`` runs the whole mode from the mixer's input x as the
op ``mqgan::mel_mixer_poly``: on a CUDA tensor its CUDA implementation
``poly_mixer_kernel`` launches the kernels of ``csrc/mel_mixer.cu`` (the
conv, the mask and the batch's min/max; g at the nodes and the cosine
projection, as ``poly_mixer_apply`` computes them; the Clenshaw
evaluation), one C call, no host sync; on a CPU tensor it is the plain
version ``poly_mixer_plain``.
``poly_mixer_apply`` is the plain mode from the masked conv output, as the
JAX function takes it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import Tensor

from mqgan_tpu_torch.core.masking import apply_mask, sequence_mask
from mqgan_tpu_torch.nn.activations import aptx
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.ops.mixer_kernels import (MixerWeights, check_mixer_args,
                                               check_mixer_shape)

POLY_DEGREE, POLY_GRID = 160, 4096  # the JAX defaults
MAX_POLY_DEGREE = 1023  # csrc/mel_mixer.cu kMaxCoef - 1
TILE_T, TILE_C = 64, 32  # csrc/mel_mixer.cu kTileT, kTileC: a (min, max) per tile


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
                     w1, b1, w2, b2, *, degree: int = POLY_DEGREE,
                     grid: int = POLY_GRID) -> torch.Tensor:
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


def poly_mixer_plain(x: torch.Tensor, lengths: torch.Tensor, w: MixerWeights,
                     *, degree: int = POLY_DEGREE,
                     grid: int = POLY_GRID) -> torch.Tensor:
    """The plain mode from the mixer's input: the depthwise conv in x's
    dtype (weights and bias rounded to it, as ``WNConv2d`` runs it), the row
    mask, then ``poly_mixer_apply``."""
    k = w.dwk.shape[0]
    s = F.conv2d(x[:, None], w.dwk.to(x.dtype)[None, None],
                 w.consts[:1].to(x.dtype), padding=k // 2)[:, 0]
    pad = sequence_mask(x.shape[1], lengths)
    return poly_mixer_apply(apply_mask(s, pad), pad, w.w1, w.b1, w.w2,
                            w.consts[1], degree=degree, grid=grid)


def poly_mixer_kernel(x: Tensor, lengths: Tensor, dwk: Tensor, consts: Tensor,
                      w1: Tensor, b1: Tensor, w2: Tensor, degree: int,
                      grid: int) -> Tensor:
    """The kernels on CUDA tensors (the op's CUDA implementation)."""
    w = MixerWeights(dwk, consts, w1, b1, w2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_poly_mixer: unsupported device {x.device}")
    bf16 = check_mixer_args(x, lengths, w)
    b, t, c = x.shape
    k, p = w.dwk.shape[0], w.w1.shape[0]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    f32 = dict(dtype=torch.float32, device=x.device)
    n_tiles = b * -(-t // TILE_T) * -(-c // TILE_C)
    partials = torch.empty((n_tiles, 2), **f32)
    stats = torch.empty(2, **f32)  # mid, half
    g_nodes = torch.empty(grid, **f32)
    coef = torch.empty(degree + 1, **f32)
    z = torch.empty_like(x)  # the masked conv output, pass 1 -> pass 5
    pt = _cuda.ptr
    _cuda.launch("mqgan_mel_mixer_poly", x.device, pt(x), pt(lengths), pt(w.dwk),
                 pt(w.consts), pt(w.w1), pt(w.b1), pt(w.w2), pt(z), pt(partials),
                 pt(stats), pt(g_nodes), pt(coef), pt(out), b, t, c, p, k, degree,
                 grid, bf16)
    _cuda.COUNTERS.add("mel_mixer_poly")
    return out


def _poly_mixer_cpu(x: Tensor, lengths: Tensor, dwk: Tensor, consts: Tensor,
                    w1: Tensor, b1: Tensor, w2: Tensor, degree: int,
                    grid: int) -> Tensor:
    return poly_mixer_plain(x, lengths, MixerWeights(dwk, consts, w1, b1, w2),
                            degree=degree, grid=grid)


poly_mixer_op = _cuda.register_op("mel_mixer_poly", _poly_mixer_cpu,
                                  poly_mixer_kernel,
                                  lambda x, *rest: torch.empty_like(x))


def fused_poly_mixer(x: Tensor, lengths: Tensor, w: MixerWeights, *,
                     degree: int = POLY_DEGREE, grid: int = POLY_GRID) -> Tensor:
    """x (B, T, C) in the compute dtype, lengths (B,) int32 valid frames
    (contiguous masks) -> the Chebyshev mode's (B, T, C) in the compute
    dtype."""
    check_mixer_shape("fused_poly_mixer", w.dwk.shape[0])
    if not 1 <= degree <= MAX_POLY_DEGREE or grid < 1:
        raise ValueError(f"fused_poly_mixer: degree {degree} outside the "
                         f"kernel (1..{MAX_POLY_DEGREE}) or grid {grid} < 1")
    _cuda.check_device("fused_poly_mixer", x)
    return _cuda.dispatch(poly_mixer_op, poly_mixer_kernel, x, lengths, *w, degree, grid)
