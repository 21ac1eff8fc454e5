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

``fused_residual_block`` is the op ``mqgan::residual_block``: on a CUDA
tensor its CUDA implementation ``residual_block_kernel`` launches the
kernels of ``csrc/residual_block.cu``, on a CPU tensor it is the plain
PyTorch version ``residual_block_plain``. The ops take the block's weights
as the flat tensors of ``BlockWeights`` (None where a block has none).

``split_residual_block(x, lengths, w, lo, hi, reduce)`` runs a
non-causal block split at its CBAM statistics, for one window of a clip
whose windows meet at the channel gate (parallel/seqpar.py):
``residual_block_begin`` (the conv GEMMs, then
the fp32 max and sum of z over each row's frames [lo, hi)), ``reduce`` over
the windows (nn/pooling.py ``reduce_pools``: the count, hi - lo, rides as
the sum's last column), and ``residual_block_finish`` (the gate MLP on the
reduced max and sum / max(count, 1), the SAM statistics and the tail).
``residual_block_plain_begin`` / ``_finish`` are their plain versions; the
range [0, length) with no reduction is the unsplit block, in the same
order of operations. The two parts are the ops ``mqgan::residual_block_begin``
(which returns the projection as a fresh tensor, empty without one, where
the split block reuses x) and ``mqgan::residual_block_finish``.

Shapes on the card: any Cin and Cout in fp32 and bf16. The bf16 conv GEMM
copies 16 bytes at a time where Cin, Cout and every operand's address allow
it (``copy_width``), else 8, 4 or 2 bytes, or one element; B*T is bounded
by the grid (B*T <= 4,194,240 a launch).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor
import torch.nn.functional as F

from mqgan_tpu_torch.nn.conv import same_padding_1d
from mqgan_tpu_torch.nn.pooling import Reduce, reduce_pools
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


def _valid(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) bool: frame t of row b lies below its length."""
    return (torch.arange(x.shape[1], device=x.device)[None, :]
            < lengths[:, None])[..., None]


def residual_block_plain_begin(x: torch.Tensor, lengths: torch.Tensor,
                               w: BlockWeights, lo: torch.Tensor,
                               hi: torch.Tensor) -> tuple:
    """The split block's first part, non-causal: (res, z, partial), with
    partial (B, 2, C) fp32 the max (row 0) and the sum (row 1) of z over
    each row's frames [lo, hi)."""
    res, _, z = plain_conv_stages(x, lengths, w, causal=False)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    keep = ((pos >= lo[:, None]) & (pos < hi[:, None]))[..., None]
    mx = torch.where(keep, z, torch.tensor(_NEG_INF, dtype=z.dtype,
                                           device=x.device)).amax(dim=1)
    total = (z * keep.to(z.dtype)).float().sum(dim=1)
    return res, z, torch.stack([mx.float(), total], dim=1)


def residual_block_plain_finish(x: torch.Tensor, lengths: torch.Tensor,
                                w: BlockWeights, res: torch.Tensor,
                                z: torch.Tensor, pooled: torch.Tensor,
                                counts: torch.Tensor) -> torch.Tensor:
    """The split block's second part: the CBAM gates and the tail from the
    reduced pooled (B, 2, C) fp32 (max, sum) and counts (B,) fp32."""
    cdt = x.dtype
    t = x.shape[1]
    beta, gamma = w.act[0].to(cdt), w.act[1].to(cdt)
    valid_b = _valid(x, lengths)
    valid = valid_b.to(cdt)
    mean = pooled[:, 1] / counts.clamp_min(1.0)[:, None]
    pooled = torch.stack([pooled[:, 0], mean], dim=1).to(cdt)  # (B, 2, C)
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


def residual_block_plain(x: torch.Tensor, lengths: torch.Tensor,
                         w: BlockWeights, *, causal: bool) -> torch.Tensor:
    if not causal:
        lo = torch.zeros_like(lengths)
        res, z, partial = residual_block_plain_begin(x, lengths, w, lo, lengths)
        return residual_block_plain_finish(x, lengths, w, res, z, partial,
                                           lengths.float())
    cdt = x.dtype
    beta, gamma = w.act[0].to(cdt), w.act[1].to(cdt)
    valid = _valid(x, lengths).to(cdt)
    res, _, z = plain_conv_stages(x, lengths, w, causal=causal)
    return _aptx((z + res) * valid, beta, gamma)


def copy_width(cin: int, cout: int, *tensors: Tensor) -> int:
    """Elements a copy of the bf16 conv GEMM moves: the widest of 8, 4, 2
    and 1 that divides Cin, Cout and every tensor's address in elements. 8
    (16 bytes) is the kernel's fast path, built on its own."""
    for vec in (8, 4, 2):
        if (cin % vec == 0 and cout % vec == 0
                and all(t_.data_ptr() % (2 * vec) == 0 for t_ in tensors)):
            return vec
    return 1


def _block_dims(x: torch.Tensor, lengths: torch.Tensor, w: BlockWeights,
                causal: bool) -> tuple:
    """Check a CUDA launch's arguments; returns (B, T, Cin, Cout, K, H,
    sam_k, is_bf16, elements a copy)."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_block: unsupported device {x.device}")
    b, t, cin = x.shape
    k, _, cout = w.w1.shape
    cdt, dev = x.dtype, x.device
    bf16 = _cuda.cuda_dtype_flag(cdt)
    vec = copy_width(cin, cout, x, w.w1, w.w2,
                     *(() if w.proj_w is None else (w.proj_w,))) if bf16 else 1
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
    return b, t, cin, cout, k, hid, sam_k, bf16, vec


def residual_block_begin_kernel(x: Tensor, lengths: Tensor, *args) -> tuple:
    """The split launch's first part on CUDA tensors (the op's CUDA
    implementation): args are the flat ``BlockWeights`` then lo, hi;
    returns (z, partial, the projection or an empty tensor)."""
    w, lo, hi = BlockWeights(*args[:-2]), args[-2], args[-1]
    b, t, cin, cout, k, _, _, bf16, vec = _block_dims(x, lengths, w, False)
    for name, r in (("stats_lo", lo), ("stats_hi", hi)):
        _cuda.check(r, name, dtype=torch.int32, shape=(b,), device=x.device)
    h = torch.empty((b, t, cout), dtype=x.dtype, device=x.device)
    z = torch.empty_like(h)
    proj = torch.empty_like(h) if w.proj_w is not None else x.new_empty((0,))
    partial = torch.empty((b, 2, cout), dtype=torch.float32, device=x.device)
    if h.numel() == 0:
        return z, partial.zero_(), proj
    p = _cuda.ptr
    _cuda.launch(
        "mqgan_residual_block_begin", x.device,
        p(x), p(lengths), p(w.act), p(w.w1), p(w.b1), p(w.w2), p(w.b2),
        p(w.proj_w), p(w.proj_b), p(lo), p(hi), p(h), p(z),
        p(proj) if w.proj_w is not None else None, p(partial),
        b, t, cin, cout, k, bf16, vec)
    _cuda.COUNTERS.add("residual_block_split")
    return z, partial, proj


def residual_block_finish_kernel(x: Tensor, lengths: Tensor, *args) -> Tensor:
    """The split launch's second part on CUDA tensors (the op's CUDA
    implementation): args are the flat ``BlockWeights`` then res, z,
    pooled (B, 2, C) fp32 the reduced (max, sum) and counts (B,) fp32 the
    frames they cover."""
    w = BlockWeights(*args[:-4])
    res, z, pooled, counts = args[-4:]
    b, t, _, cout, _, hid, sam_k, bf16, _ = _block_dims(x, lengths, w, False)
    dev = x.device
    _cuda.check(z, "z", dtype=x.dtype, shape=(b, t, cout), device=dev)
    _cuda.check(res, "res", dtype=x.dtype, shape=(b, t, cout), device=dev)
    _cuda.check(pooled, "pooled", dtype=torch.float32, shape=(b, 2, cout),
                device=dev)
    _cuda.check(counts, "counts", dtype=torch.float32, shape=(b,), device=dev)
    out = torch.empty_like(z)
    if out.numel() == 0:
        return out
    gate_c = torch.empty((b, cout), dtype=x.dtype, device=dev)
    sam_stats = torch.empty((b, t, 2), dtype=torch.float32, device=dev)
    p = _cuda.ptr
    _cuda.launch(
        "mqgan_residual_block_finish", dev,
        p(z), p(res), p(lengths), p(w.act), p(w.cw1), p(w.cb1), p(w.cw2),
        p(w.cb2), p(w.sam_w), p(pooled), p(counts), p(gate_c), p(sam_stats),
        p(out), b, t, cout, hid, sam_k, bf16)
    return out


def split_residual_block(x: torch.Tensor, lengths: torch.Tensor,
                         w: BlockWeights, lo: torch.Tensor, hi: torch.Tensor,
                         reduce: Optional[Reduce]) -> torch.Tensor:
    """A non-causal block whose CBAM statistics are the frames [lo, hi) of
    each row, combined over the windows by ``reduce`` (None: this window
    alone)."""
    z, partial, proj = _cuda.dispatch(residual_block_begin_op, residual_block_begin_kernel,
                                      x, lengths, *w, lo, hi)
    res = x if w.proj_w is None else proj
    count = (hi - lo).clamp_min(0).float()
    total, mx, count = reduce_pools(partial[:, 1], partial[:, 0], count, reduce)
    pooled = torch.stack([mx, total], dim=1).contiguous()
    return _cuda.dispatch(residual_block_finish_op, residual_block_finish_kernel, x,
                          lengths, *w, res, z, pooled, count.contiguous())


def residual_block_kernel(x: Tensor, lengths: Tensor, *args) -> Tensor:
    """The whole block on CUDA tensors (the op's CUDA implementation):
    args are the flat ``BlockWeights`` then causal."""
    w, causal = BlockWeights(*args[:-1]), args[-1]
    b, t, cin, cout, k, hid, sam_k, bf16, vec = _block_dims(x, lengths, w, causal)
    cdt, dev = x.dtype, x.device
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
        p(out), b, t, cin, cout, k, hid, sam_k, int(causal), bf16, vec)
    _cuda.COUNTERS.add("residual_block")
    return out


# The ops. Their CPU implementations (the plain versions) and fakes take
# the block's weights as the flat tensors of BlockWeights.

_OptT = Optional[Tensor]


def _residual_block_cpu(
        x: Tensor, lengths: Tensor, act: Tensor, w1: Tensor, b1: Tensor,
        w2: Tensor, b2: Tensor, proj_w: _OptT, proj_b: _OptT, cw1: _OptT,
        cb1: _OptT, cw2: _OptT, cb2: _OptT, sam_w: _OptT,
        causal: bool) -> Tensor:
    w = BlockWeights(act, w1, b1, w2, b2, proj_w, proj_b, cw1, cb1, cw2, cb2, sam_w)
    return residual_block_plain(x, lengths, w, causal=causal)


def _residual_block_begin_cpu(
        x: Tensor, lengths: Tensor, act: Tensor, w1: Tensor, b1: Tensor,
        w2: Tensor, b2: Tensor, proj_w: _OptT, proj_b: _OptT, cw1: _OptT,
        cb1: _OptT, cw2: _OptT, cb2: _OptT, sam_w: _OptT, lo: Tensor,
        hi: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    w = BlockWeights(act, w1, b1, w2, b2, proj_w, proj_b, cw1, cb1, cw2, cb2, sam_w)
    res, z, partial = residual_block_plain_begin(x, lengths, w, lo, hi)
    return z, partial, res if proj_w is not None else x.new_empty((0,))


def _residual_block_finish_cpu(
        x: Tensor, lengths: Tensor, act: Tensor, w1: Tensor, b1: Tensor,
        w2: Tensor, b2: Tensor, proj_w: _OptT, proj_b: _OptT, cw1: _OptT,
        cb1: _OptT, cw2: _OptT, cb2: _OptT, sam_w: _OptT, res: Tensor,
        z: Tensor, pooled: Tensor, counts: Tensor) -> Tensor:
    w = BlockWeights(act, w1, b1, w2, b2, proj_w, proj_b, cw1, cb1, cw2, cb2, sam_w)
    return residual_block_plain_finish(x, lengths, w, res, z, pooled, counts)


def _block_out(x, w2):
    """Fake output: (B, T, Cout) in x's dtype."""
    return x.new_empty((x.shape[0], x.shape[1], w2.shape[-1]))


def _begin_fake(x, lengths, act, w1, b1, w2, b2, proj_w, *rest):
    z = _block_out(x, w2)
    partial = x.new_empty((x.shape[0], 2, w2.shape[-1]), dtype=torch.float32)
    return z, partial, _block_out(x, w2) if proj_w is not None else x.new_empty((0,))


residual_block_op = _cuda.register_op(
    "residual_block", _residual_block_cpu, residual_block_kernel,
    lambda x, lengths, act, w1, b1, w2, *rest: _block_out(x, w2))
residual_block_begin_op = _cuda.register_op(
    "residual_block_begin", _residual_block_begin_cpu,
    residual_block_begin_kernel, _begin_fake)
residual_block_finish_op = _cuda.register_op(
    "residual_block_finish", _residual_block_finish_cpu,
    residual_block_finish_kernel,
    lambda x, lengths, act, w1, b1, w2, *rest: _block_out(x, w2))


def fused_residual_block(x: Tensor, lengths: Tensor, w: BlockWeights, *,
                         causal: bool) -> Tensor:
    """x (B, T, Cin) in the compute dtype, lengths (B,) int32 valid frames
    (contiguous masks) -> (B, T, Cout) in the compute dtype."""
    _cuda.check_device("fused_residual_block", x)
    return _cuda.dispatch(residual_block_op, residual_block_kernel, x, lengths, *w, causal)


def residual_block_begin(x: Tensor, lengths: Tensor, w: BlockWeights,
                         lo: Tensor, hi: Tensor) -> tuple:
    """The split launch's first part (see the module docstring): (res, z,
    partial), res being x itself where the block has no projection."""
    _cuda.check_device("residual_block_begin", x)
    z, partial, proj = _cuda.dispatch(residual_block_begin_op, residual_block_begin_kernel,
                                      x, lengths, *w, lo, hi)
    return (x if w.proj_w is None else proj), z, partial


def residual_block_finish(x: Tensor, lengths: Tensor, w: BlockWeights,
                          res: Tensor, z: Tensor, pooled: Tensor,
                          counts: Tensor) -> Tensor:
    """The split launch's second part: pooled (B, 2, C) fp32 the reduced
    (max, sum), counts (B,) fp32 the frames they cover."""
    _cuda.check_device("residual_block_finish", x)
    return _cuda.dispatch(residual_block_finish_op, residual_block_finish_kernel, x,
                          lengths, *w, res, z, pooled, counts)
