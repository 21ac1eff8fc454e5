"""MelMixer2D at inference (counterpart of ``mqgan_tpu/ops/mixer_kernels.py``
``fused_mel_mixer``), fp32 inside:

    s   = (5x5 single-plane conv over (T, C), zero outside the plane) + bias
    s   = s * valid
    out = (A*s + B + 0.5 * sum_p w2_p * z_p * tanh(z_p)) * valid + b_out,
          z_p = w1_p * s + b1_p,   A = 0.5 sum w2*w1,   B = 0.5 sum w2*b1

which is conv_out(aptx(pw(s))) with the fixed APTx folded: the (B, T, C, P)
hidden never exists. Padded rows come out exactly equal to ``b_out``.

``fused_mel_mixer`` launches the CUDA kernel (``csrc/mel_mixer.cu``) on a
CUDA tensor and takes the plain PyTorch version ``mel_mixer_plain`` only for
a CPU tensor. The plain version evaluates the hidden in time chunks so its
peak memory stays bounded (the whole hidden is 34 GB fp32 at B=64, T=512,
C=P=512).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from mqgan_tpu_torch.ops import _cuda

MAX_DW_K = 7  # the kernel's shared halo tile is sized for taps <= 7
MAX_P = 2048  # (w1, b1, w2) per p live in shared memory
HIDDEN_CHUNK_BYTES = 1 << 28  # plain version: fp32 hidden per time chunk


class MixerWeights(NamedTuple):
    """Folded mixer weights, fp32."""

    dwk: torch.Tensor  # (k, k) depthwise kernel over (T, C)
    consts: torch.Tensor  # (4,): dw bias, conv_out bias, A, B
    w1: torch.Tensor  # (P,) folded pw kernel
    b1: torch.Tensor  # (P,)
    w2: torch.Tensor  # (P,) conv_out kernel


def mel_mixer_plain(x: torch.Tensor, lengths: torch.Tensor,
                    w: MixerWeights) -> torch.Tensor:
    b, t, c = x.shape
    k = w.dwk.shape[0]
    dw_bias, out_bias, a_lin, b_lin = w.consts
    s = F.conv2d(x.float()[:, None], w.dwk[None, None], padding=k // 2)[:, 0]
    s = s + dw_bias
    valid = (torch.arange(t, device=x.device)[None, :]
             < lengths[:, None]).float()[..., None]
    s = s * valid
    p = w.w1.shape[0]
    tc = max(1, HIDDEN_CHUNK_BYTES // max(1, b * c * p * 4))
    acc = torch.empty_like(s)
    for t0 in range(0, t, tc):
        z = s[:, t0:t0 + tc, :, None] * w.w1 + w.b1  # (B, tc, C, P)
        acc[:, t0:t0 + tc] = (z * torch.tanh(z)) @ w.w2
    out = (a_lin * s + b_lin + 0.5 * acc) * valid + out_bias
    return out.to(x.dtype)


def check_mixer_shape(name: str, k: int, p: int | None = None) -> None:
    """Raise on a tap count (or P) outside the mixer kernels."""
    if k % 2 == 0 or k > MAX_DW_K:
        raise ValueError(f"{name}: taps {k} outside the kernel (odd, <= {MAX_DW_K})")
    if p is not None and not 1 <= p <= MAX_P:
        raise ValueError(f"{name}: P={p} outside the kernel (1..{MAX_P})")


def check_mixer_args(x: torch.Tensor, lengths: torch.Tensor,
                     w: MixerWeights) -> int:
    """Check the arguments of a mixer kernel launch; returns the bf16 flag."""
    b = x.shape[0]
    k, p = w.dwk.shape[0], w.w1.shape[0]
    dev = x.device
    bf16 = _cuda.cuda_dtype_flag(x.dtype)
    _cuda.check(x, "x")
    _cuda.check(lengths, "lengths", dtype=torch.int32, shape=(b,), device=dev)
    _cuda.check(w.dwk, "dwk", dtype=torch.float32, shape=(k, k), device=dev)
    _cuda.check(w.consts, "consts", dtype=torch.float32, shape=(4,), device=dev)
    for field in ("w1", "b1", "w2"):
        _cuda.check(getattr(w, field), field, dtype=torch.float32, shape=(p,),
                    device=dev)
    return bf16


def fused_mel_mixer(x: torch.Tensor, lengths: torch.Tensor,
                    w: MixerWeights) -> torch.Tensor:
    """x (B, T, C) in the compute dtype, lengths (B,) int32 valid frames
    (contiguous masks) -> (B, T, C) in the compute dtype."""
    check_mixer_shape("fused_mel_mixer", w.dwk.shape[0], w.w1.shape[0])
    if x.device.type == "cpu":
        return mel_mixer_plain(x, lengths, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mel_mixer: unsupported device {x.device}")
    bf16 = check_mixer_args(x, lengths, w)
    b, t, c = x.shape
    k, p = w.dwk.shape[0], w.w1.shape[0]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    pt = _cuda.ptr
    _cuda.launch("mqgan_mel_mixer", x.device, pt(x), pt(lengths), pt(w.dwk),
                 pt(w.consts), pt(w.w1), pt(w.b1), pt(w.w2), pt(out),
                 b, t, c, p, k, bf16)
    _cuda.COUNTERS.add("mel_mixer")
    return out
