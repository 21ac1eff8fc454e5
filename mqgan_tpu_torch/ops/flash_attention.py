"""Causal flash attention for training, forward and backward (counterpart of
the JAX library flash attention that ``mqgan_tpu/models/token_transformer.py``
``_attend_flash`` calls).

    S   = q k^T * scale, causal        fp32
    lse = logsumexp over keys          (B, H, T) fp32
    o   = softmax(S) v                 P rounded to v's dtype before P v

q, k, v and o are (B, T, H, D) as the attention module holds them; the
kernels read and write that layout in place (no transpose, no pad to a tile
multiple). ``causal_attention`` is the op ``mqgan::flash_fwd`` with its
backward ``mqgan::flash_bwd`` (``torch.library.register_autograd``): on a
CUDA tensor they launch the hand-written kernels of
``csrc/flash_attention.cu`` (forward ``flash_fwd``, backward
``flash_bwd_dq`` then ``flash_bwd_dkv``) or raise; on a CPU tensor they are
the plain versions ``flash_attention_fwd_plain`` /
``flash_attention_bwd_plain`` (whose halves, ``flash_attention_bwd_dq_plain``
and ``flash_attention_bwd_dkv_plain``, mirror the two backward kernels). The
counters are ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from mqgan_tpu_torch.ops import _cuda

HEAD_DIMS = (32, 64, 128)


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _causal_scores(q, k, scale):
    """(B, H, Tq, Tk) scaled scores in the accumulation dtype, and the mask
    of visible keys (key <= query)."""
    acc = _acc_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    t = q.shape[1]
    visible = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    return s, visible


def flash_attention_fwd_plain(q, k, v, scale: float):
    """(o (B, T, H, D) in q's dtype, lse (B, H, T) fp32 — fp64 for fp64
    inputs) from the materialised scores."""
    s, visible = _causal_scores(q, k, scale)
    s = s.masked_fill(~visible, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(lse.dtype), v.to(lse.dtype))
    return o.to(q.dtype), lse


def _probs_and_dscores(q, k, v, o, lse, do, scale):
    """P = exp(S - lse) on visible keys (else 0) and dS = P * (dO V^T -
    delta) with delta = rowsum(dO * O), in the accumulation dtype."""
    acc = _acc_dtype(q)
    s, visible = _causal_scores(q, k, scale)
    p = torch.where(visible, torch.exp(s - lse.to(acc)[..., None]), 0.0)
    delta = (do.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2)  # (B, H, T)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    return p, p * (dp - delta[..., None])


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale: float):
    """dQ = dS K * scale (the ``flash_bwd_dq`` kernel's output)."""
    _, ds = _probs_and_dscores(q, k, v, o, lse, do, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype)) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, scale: float):
    """(dK = dS^T Q * scale, dV = P^T dO) (the ``flash_bwd_dkv`` kernel's
    outputs)."""
    p, ds = _probs_and_dscores(q, k, v, o, lse, do, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of the causal attention by the explicit formulas:
    P = exp(S - lse), dV = P^T dO, dS = P * (dO V^T - rowsum(dO * O)),
    dQ = dS K * scale, dK = dS^T Q * scale."""
    return (flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale),
            *flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, scale))


def _check_cuda(name: str, *tensors: torch.Tensor) -> tuple:
    """Raise unless every tensor is a contiguous (B, T, H, D) CUDA tensor of
    the first one's shape and dtype (bf16 or fp32, D in HEAD_DIMS, 16-byte
    aligned); returns (B, T, H, D)."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if first.dim() != 4:
        raise ValueError(f"{name}: expected (B, T, H, D), got {tuple(first.shape)}")
    b, t, h, d = first.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head size {d} has no kernel (supported: "
                         f"{', '.join(map(str, HEAD_DIMS))})")
    for i, x in enumerate(tensors):
        _cuda.check(x, f"{name} input {i}", dtype=first.dtype,
                    shape=first.shape, device=first.device)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} input {i}: not 16-byte aligned")
    _cuda.cuda_dtype_flag(first.dtype)
    return b, t, h, d


def flash_attention_fwd(q, k, v, scale: float):
    """(o, lse): the ``flash_fwd`` kernel on CUDA tensors, the plain version
    on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, scale)
    b, t, h, d = _check_cuda("flash_attention_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    if t and b * h:
        pt = _cuda.ptr
        _cuda.launch("mqgan_flash_fwd", q.device, pt(q), pt(k), pt(v), pt(o),
                     pt(lse), b, t, h, d, _cuda.cuda_dtype_flag(q.dtype), scale)
        _cuda.COUNTERS.add("flash_fwd")
    return o, lse


def flash_attention_bwd_dq(q, k, v, o, lse, do, scale: float):
    """(dq, delta = rowsum(dO * O) (B, H, T) fp32): the ``flash_bwd_dq``
    kernel; CUDA tensors only."""
    b, t, h, d = _check_cuda("flash_attention_bwd_dq", q, k, v, o, do)
    _cuda.check(lse, "lse", dtype=torch.float32, shape=(b, h, t), device=q.device)
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    if t and b * h:
        pt = _cuda.ptr
        _cuda.launch("mqgan_flash_bwd_dq", q.device, pt(q), pt(k), pt(v), pt(o),
                     pt(do), pt(lse), pt(delta), pt(dq), b, t, h, d,
                     _cuda.cuda_dtype_flag(q.dtype), scale)
        _cuda.COUNTERS.add("flash_bwd_dq")
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv): the ``flash_bwd_dkv`` kernel, after ``flash_bwd_dq`` has
    written ``delta``; CUDA tensors only."""
    b, t, h, d = _check_cuda("flash_attention_bwd_dkv", q, k, v, do)
    for name, x in (("lse", lse), ("delta", delta)):
        _cuda.check(x, name, dtype=torch.float32, shape=(b, h, t), device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if t and b * h:
        pt = _cuda.ptr
        _cuda.launch("mqgan_flash_bwd_dkv", q.device, pt(q), pt(k), pt(v), pt(do),
                     pt(lse), pt(delta), pt(dk), pt(dv), b, t, h, d,
                     _cuda.cuda_dtype_flag(q.dtype), scale)
        _cuda.COUNTERS.add("flash_bwd_dkv")
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv): ``flash_bwd_dq`` then ``flash_bwd_dkv`` on CUDA
    tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


def _flash_fwd_cpu(q: Tensor, k: Tensor, v: Tensor,
                   scale: float) -> tuple[Tensor, Tensor]:
    # contiguous, as the kernels write them
    return tuple(t.contiguous() for t in flash_attention_fwd_plain(q, k, v, scale))


def _flash_bwd_cpu(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                   do: Tensor, scale: float) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(t.contiguous()
                 for t in flash_attention_bwd_plain(q, k, v, o, lse, do, scale))


def _flash_bwd_cuda(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                    do: Tensor, scale: float) -> tuple[Tensor, Tensor, Tensor]:
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    return (dq, *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))


def _lse_fake(q):
    b, t, h, _ = q.shape
    lse_dtype = torch.float64 if q.dtype == torch.float64 else torch.float32
    return q.new_empty((b, h, t), dtype=lse_dtype)


flash_fwd_op = _cuda.register_op(
    "flash_fwd", _flash_fwd_cpu, flash_attention_fwd,
    lambda q, k, v, scale: (torch.empty_like(q), _lse_fake(q)))
flash_bwd_op = _cuda.register_op(
    "flash_bwd", _flash_bwd_cpu, _flash_bwd_cuda,
    lambda q, k, v, o, lse, do, scale: (torch.empty_like(q), torch.empty_like(k),
                                        torch.empty_like(v)))


def _flash_setup_context(ctx, inputs, output):
    q, k, v, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.scale = scale
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    dq, dk, dv = _cuda.dispatch(flash_bwd_op, _flash_bwd_cuda, q, k, v, o, lse,
                                do.contiguous(), ctx.scale)
    return dq, dk, dv, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup_context)


def causal_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """softmax(q k^T * scale, causal) v for (B, T, H, D) q, k, v; returns
    (B, T, H, D) in q's dtype. Differentiable in q, k and v."""
    _cuda.check_device("causal_attention", q)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return flash_fwd_op(q, k, v, float(scale))[0]  # the op carries the backward
    return _cuda.dispatch(flash_fwd_op, flash_attention_fwd, q, k, v, float(scale))[0]
