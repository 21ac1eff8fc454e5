"""One whole ResidualBlock1D at inference (counterpart of
``mqgan_tpu/ops/block_kernels.py`` ``fused_residual_block``):

    res = x, or a 1x1 projection of x when channels change
    h   = aptx(mask(conv1(x)))                     k-tap conv, fp32 accumulation
    z   = conv2(h)
    non-causal blocks only, CBAM:
        gate_c = sigmoid(MLP(masked max over T) + MLP(masked mean over T))
        y      = z * gate_c * valid
        gate_t = sigmoid(7-tap conv of per-frame (max, mean) over C of y),
                 logits of padded frames forced to -1e4
        z      = (y * gate_t + z) * valid
    out = aptx((z + res) * valid)

Both activations use the block's one trainable APTx (beta, gamma). Values
are rounded to the compute dtype where the JAX kernel rounds them; the
pooled statistics, MLP and gates are fp32 inside. Conv1 reads the padded
frames of x as they are (they carry real values) and sees zeros only
outside [0, T).

``fused_residual_block`` launches the CUDA kernels of
``csrc/residual_block.cu`` on a CUDA tensor and takes the plain PyTorch
version ``residual_block_plain`` only for a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mqgan_tpu_torch.nn.conv import same_padding_1d
from mqgan_tpu_torch.ops import _cuda

_NEG_INF = -1e30  # masked max-pool fill
_SAM_FILL = -1e4  # time-gate logit fill at padded frames


class BlockWeights(NamedTuple):
    """Folded weights of one block. Matmul operands are in the compute
    dtype, biases and the small CBAM/APTx parameters in fp32."""

    act: torch.Tensor  # (2,) fp32: beta, gamma
    w1: torch.Tensor  # (K, Cin, Cout)
    b1: torch.Tensor  # (Cout,)
    w2: torch.Tensor  # (K, Cout, Cout)
    b2: torch.Tensor  # (Cout,)
    proj_w: Optional[torch.Tensor] = None  # (Cin, Cout) when Cin != Cout
    proj_b: Optional[torch.Tensor] = None  # (Cout,)
    cw1: Optional[torch.Tensor] = None  # (Cout, H) CBAM MLP, non-causal only
    cb1: Optional[torch.Tensor] = None  # (H,)
    cw2: Optional[torch.Tensor] = None  # (H, Cout)
    cb2: Optional[torch.Tensor] = None  # (Cout,)
    sam_w: Optional[torch.Tensor] = None  # (sam_k, 2) fp32


def _shifted_conv(x, w, b, causal: bool):
    """(B, T, Cin) -> (B, T, Cout) fp32: k shifted matmuls + bias."""
    k, t = w.shape[0], x.shape[1]
    lo, hi = same_padding_1d(k, causal)
    xp = F.pad(x.float(), (0, 0, lo, hi))
    acc = torch.zeros(x.shape[:2] + (w.shape[2],), dtype=torch.float32,
                      device=x.device)
    for j in range(k):
        acc = acc + xp[:, j:j + t] @ w[j].float()
    return acc + b


def _aptx(z, beta, gamma):
    return (1.0 + torch.tanh(beta * z)) * (gamma * z)


def plain_conv_stages(x: torch.Tensor, lengths: torch.Tensor,
                      w: BlockWeights, *, causal: bool) -> tuple:
    """(res, h, z) of the plain block in the compute dtype: the residual
    (x or its projection), h = aptx(conv1(x) * valid) and z = conv2(h),
    the three GEMMs of the kernel with their epilogues."""
    cdt = x.dtype
    beta, gamma = w.act[0].to(cdt), w.act[1].to(cdt)
    valid = (torch.arange(x.shape[1], device=x.device)[None, :]
             < lengths[:, None])[..., None].to(cdt)  # (B, T, 1)
    if w.proj_w is not None:
        res = (x.float() @ w.proj_w.float() + w.proj_b).to(cdt)
    else:
        res = x
    h = _shifted_conv(x, w.w1, w.b1, causal).to(cdt)
    h = _aptx(h * valid, beta, gamma)
    return res, h, _shifted_conv(h, w.w2, w.b2, causal).to(cdt)


def residual_block_plain(x: torch.Tensor, lengths: torch.Tensor,
                         w: BlockWeights, *, causal: bool) -> torch.Tensor:
    cdt = x.dtype
    t = x.shape[1]
    beta, gamma = w.act[0].to(cdt), w.act[1].to(cdt)
    valid_b = (torch.arange(t, device=x.device)[None, :]
               < lengths[:, None])[..., None]  # (B, T, 1) bool
    valid = valid_b.to(cdt)
    res, _, z = plain_conv_stages(x, lengths, w, causal=causal)

    if not causal:
        mx = torch.where(valid_b, z, torch.tensor(_NEG_INF, dtype=cdt,
                                                  device=x.device))
        mx = mx.amax(dim=1).float()  # (B, C)
        count = lengths.float().clamp_min(1.0)[:, None]
        av = (z * valid).float().sum(dim=1) / count
        pooled = torch.stack([mx, av], dim=1).to(cdt)  # (B, 2, C)
        hidden = torch.relu(pooled.float() @ w.cw1.float() + w.cb1)
        mlp_out = hidden.to(cdt).float() @ w.cw2.float() + w.cb2
        gate_c = torch.sigmoid(mlp_out[:, 0] + mlp_out[:, 1]).to(cdt)

        y = z * gate_c[:, None, :] * valid
        valid_f = valid_b.float()
        mx_t = y.amax(dim=2, keepdim=True).float() * valid_f
        av_t = y.float().mean(dim=2, keepdim=True) * valid_f
        sam_k = w.sam_w.shape[0]
        pad = sam_k // 2
        mxp = F.pad(mx_t, (0, 0, pad, pad))
        avp = F.pad(av_t, (0, 0, pad, pad))
        logits = torch.zeros_like(mx_t)
        for j in range(sam_k):
            logits = (logits + w.sam_w[j, 0] * mxp[:, j:j + t]
                      + w.sam_w[j, 1] * avp[:, j:j + t])
        logits = torch.where(valid_b, logits, torch.tensor(
            _SAM_FILL, dtype=torch.float32, device=x.device))
        gate_t = (torch.sigmoid(logits) * valid_f).to(cdt)
        z = (y * gate_t + z) * valid

    return _aptx((z + res) * valid, beta, gamma)


def fused_residual_block(x: torch.Tensor, lengths: torch.Tensor,
                         w: BlockWeights, *, causal: bool) -> torch.Tensor:
    """x (B, T, Cin) in the compute dtype, lengths (B,) int32 valid frames
    (contiguous masks) -> (B, T, Cout) in the compute dtype."""
    if x.device.type == "cpu":
        return residual_block_plain(x, lengths, w, causal=causal)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_block: unsupported device {x.device}")
    b, t, cin = x.shape
    k, _, cout = w.w1.shape
    cdt, dev = x.dtype, x.device
    bf16 = _cuda.cuda_dtype_flag(cdt)
    if bf16 and (cin % 8 or cout % 8):
        raise ValueError(f"fused_residual_block: bf16 kernel needs channels "
                         f"% 8 == 0, got {cin}->{cout}")
    if bf16 and any(t_.data_ptr() % 16 for t_ in (x, w.w1, w.w2)
                    + ((w.proj_w,) if w.proj_w is not None else ())):
        raise ValueError("fused_residual_block: bf16 kernel needs 16-byte "
                         "aligned x and conv weights")
    if -(-b * t // 64) > 65535:
        raise ValueError(f"fused_residual_block: B*T={b * t} exceeds the "
                         f"kernel's grid")
    _cuda.check(x, "x")
    _cuda.check(lengths, "lengths", dtype=torch.int32, shape=(b,), device=dev)
    _cuda.check(w.act, "act", dtype=torch.float32, shape=(2,), device=dev)
    _cuda.check(w.w1, "w1", dtype=cdt, shape=(k, cin, cout), device=dev)
    _cuda.check(w.w2, "w2", dtype=cdt, shape=(k, cout, cout), device=dev)
    for name in ("b1", "b2"):
        _cuda.check(getattr(w, name), name, dtype=torch.float32,
                    shape=(cout,), device=dev)
    if (w.proj_w is None) != (cin == cout):
        raise ValueError("fused_residual_block: a projection is needed "
                         "exactly when Cin != Cout")
    if w.proj_w is not None:
        _cuda.check(w.proj_w, "proj_w", dtype=cdt, shape=(cin, cout), device=dev)
        _cuda.check(w.proj_b, "proj_b", dtype=torch.float32, shape=(cout,),
                    device=dev)
    hid, sam_k = 0, 0
    if causal:
        if w.cw1 is not None:
            raise ValueError("fused_residual_block: causal blocks have no CBAM")
    else:
        if w.cw1 is None or w.sam_w is None:
            raise ValueError("fused_residual_block: non-causal blocks need "
                             "their CBAM weights")
        hid, sam_k = w.cw1.shape[1], w.sam_w.shape[0]
        _cuda.check(w.cw1, "cw1", dtype=cdt, shape=(cout, hid), device=dev)
        _cuda.check(w.cb1, "cb1", dtype=torch.float32, shape=(hid,), device=dev)
        _cuda.check(w.cw2, "cw2", dtype=cdt, shape=(hid, cout), device=dev)
        _cuda.check(w.cb2, "cb2", dtype=torch.float32, shape=(cout,), device=dev)
        _cuda.check(w.sam_w, "sam_w", dtype=torch.float32, shape=(sam_k, 2),
                    device=dev)
        if sam_k % 2 == 0 or hid > cout:
            raise ValueError(f"fused_residual_block: SAM taps {sam_k} must be "
                             f"odd and the CBAM hidden {hid} <= {cout}")

    out = torch.empty((b, t, cout), dtype=cdt, device=dev)
    if out.numel() == 0:
        return out
    h = torch.empty_like(out)
    res = torch.empty_like(out) if w.proj_w is not None else None
    z = pooled = gate_c = sam_stats = None
    if not causal:
        z = torch.empty_like(out)
        pooled = torch.empty((b, 2, cout), dtype=torch.float32, device=dev)
        gate_c = torch.empty((b, cout), dtype=cdt, device=dev)
        sam_stats = torch.empty((b, t, 2), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    _cuda.launch(
        "mqgan_residual_block", dev,
        p(x), p(lengths), p(w.act), p(w.w1), p(w.b1), p(w.w2), p(w.b2),
        p(w.proj_w), p(w.proj_b), p(w.cw1), p(w.cb1), p(w.cw2), p(w.cb2),
        p(w.sam_w), p(h), p(z), p(res), p(pooled), p(gate_c), p(sam_stats),
        p(out), b, t, cin, cout, k, hid, sam_k, int(causal), bf16)
    _cuda.COUNTERS.add("residual_block")
    return out
