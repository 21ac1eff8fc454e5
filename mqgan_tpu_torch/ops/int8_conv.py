"""The int8 refiner conv (counterpart of ``mqgan_tpu/nn/unet.py``
``_int8_conv``, which the JAX package leaves to XLA's conv with int8
operands and an int32 accumulator; no Pallas kernel):

    sw  = max(max|k| per output channel, 1e-8) / 127     the compute dtype
    wq  = clip(round(k / sw), -127, 127)                  int8
    sx  = max(max|x|, 1e-8) / 127                         fp32, on the device
    xq  = clip(round(x / sx), -127, 127)                  int8
    y   = (conv3x3_same(xq, wq) * (sx * sw) + bias).to(x.dtype)

k is the weight-norm-folded kernel cast to the compute dtype, as JAX
quantizes it; both scales divide (no reciprocal), rounding is half to even;
the conv accumulates in int32 and the rescale multiplies then adds in fp32.

x is the refiner's (B, Cin, T, F) image in channels-last memory and y its
(B, Cout, T, F) output, likewise; wq is (Cout, 3, 3, Cin) int8, sw and bias
(Cout,) fp32 (sw holds the compute dtype's values).

``int8_conv`` is the op ``mqgan::int8_conv``: on a CUDA tensor its CUDA
implementation ``int8_conv_kernel`` launches ``csrc/int8_conv.cu`` (the max,
the quantize pass and the conv, one C call; counter ``int8_conv``), on a CPU
tensor it is the plain version ``int8_conv_plain``, whose conv sums the
int8 products exactly in float64 (a 9 * Cin * 127**2 sum exceeds fp32's
2**24) before the int32 cast.

The kernel's tiles come from ``int8_tile_plan``, a pure function of the
shape: 128-pixel tiles (a ``box_w`` x ``box_h`` rectangle of one image, the
pair that pads B*H*W least), BN output channels (64, 128 or 256, fitted to
Cout), BK = 128 bytes of Cin a slice where Cin % 128 == 0, else 64, and
as many ring stages as shared memory holds (at most 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import Tensor

from mqgan_tpu_torch.ops import _cuda

QMAX = 127.0
SCALE_FLOOR = 1e-8


# the kernel's tiling (csrc/int8_conv.cu)
BM = 128                           # pixels a tile: two consumer warpgroups of 64
BN_CHOICES = (256, 128, 64)        # output channels a tile (the wgmma's N)
BOX_WIDTHS = (128, 64, 32, 16, 8)  # a tile's width in pixels; height = 128 / width
N_TILE_COST = 64                   # an N tile's fixed cost, in channels' worth
MAX_STAGES = 8
SMEM_LIMIT = 232_448               # a block's shared memory on an H100
STAGING_BYTES = 2 * 64 * 40 * 4    # the epilogue's padded 64 x 32 words, each warpgroup
BARRIER_BYTES = 2 * MAX_STAGES * 8
SMEM_ALIGN = 1024                  # the 128-byte swizzle's repeat


@dataclass(frozen=True)
class TilePlan:
    """The kernel's tiling of one call: tile t covers output pixels (b, h0 ..
    h0 + box_h - 1, w0 .. w0 + box_w - 1) and channels n0 .. n0 + bn - 1,
    clipped to the image and Cout (``tile``)."""

    batch: int
    height: int
    width: int
    cin: int
    cout: int
    bm: int
    bn: int
    bk: int
    stages: int
    box_w: int
    box_h: int
    smem_bytes: int

    @property
    def tiles_w(self) -> int:
        return -(-self.width // self.box_w)

    @property
    def tiles_h(self) -> int:
        return -(-self.height // self.box_h)

    @property
    def tiles_n(self) -> int:
        return -(-self.cout // self.bn)

    @property
    def tiles(self) -> int:
        return self.batch * self.tiles_h * self.tiles_w * self.tiles_n

    def tile(self, t: int) -> tuple:
        """(b, h0, w0, n0) of tile t: N tiles innermost, then w, h, b (the
        kernel's tile_at)."""
        m, n = divmod(t, self.tiles_n)
        mh, wt = divmod(m, self.tiles_w)
        b, ht = divmod(mh, self.tiles_h)
        return b, ht * self.box_h, wt * self.box_w, n * self.bn


def _smem_bytes(stages: int, bn: int, bk: int) -> int:
    return stages * (BM + bn) * bk + STAGING_BYTES + BARRIER_BYTES + SMEM_ALIGN


def int8_tile_plan(b: int, h: int, w: int, cin: int, cout: int) -> TilePlan:
    """The kernel's tiling of a (b, cin, h, w) -> (b, cout, h, w) conv.
    Raises ValueError for a shape the kernel does not take."""
    if min(b, h, w) < 1:
        raise ValueError(f"int8_conv: empty image B={b} H={h} W={w}")
    if cin < 16 or cin % 16:
        raise ValueError(f"int8_conv: the kernel needs Cin % 16 == 0, got {cin}")
    if cout < 32 or cout % 16:
        raise ValueError(f"int8_conv: the kernel needs Cout % 16 == 0 and Cout >= 32, "
                         f"got {cout}")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"int8_conv: B*H*W={b * h * w} exceeds 2**31 - 1 pixels")
    bk = 128 if cin % 128 == 0 else 64
    # the BN whose tiles cost least (the padded channels plus a fixed cost a
    # tile), among those whose last tile is at least half used; ties: wider
    fits = [bn for bn in BN_CHOICES if cout - (-(-cout // bn) - 1) * bn >= bn // 2]
    bn = min(fits, key=lambda n: (-(-cout // n) * (n + N_TILE_COST), -n))
    # the rectangle that pads the image least; ties: wider (longer rows)
    def covered(bw: int) -> int:
        return -(-w // bw) * bw * -(-h // (BM // bw)) * (BM // bw)

    box_w = min(BOX_WIDTHS, key=lambda bw: (covered(bw), -bw))
    stages = min(MAX_STAGES, (SMEM_LIMIT - _smem_bytes(0, bn, bk)) // ((BM + bn) * bk))
    return TilePlan(b, h, w, cin, cout, BM, bn, bk, stages, box_w, BM // box_w,
                    _smem_bytes(stages, bn, bk))


def _div(a: Tensor, b: float) -> Tensor:
    """a / b as a true division (a scalar divisor on the card would become a
    multiply by its rounded reciprocal), the divisor made on a's device."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def quantize_weights(kernel: Tensor) -> tuple:
    """kernel (Cout, Cin, 3, 3) in the compute dtype -> (wq (Cout, 3, 3,
    Cin) int8, sw (Cout,) fp32), computed in the compute dtype."""
    sw = _div(kernel.abs().amax(dim=(1, 2, 3)).clamp_min(SCALE_FLOOR), QMAX)
    wq = torch.round(kernel / sw[:, None, None, None]).clamp(-QMAX, QMAX)
    return (wq.to(torch.int8).permute(0, 2, 3, 1).contiguous(),
            sw.float().contiguous())


def activation_scale(x: Tensor) -> Tensor:
    """sx = max(max|x|, 1e-8) / 127, a fp32 device scalar."""
    return _div(x.abs().amax().float().clamp_min(SCALE_FLOOR), QMAX)


def quantize_activations(x: Tensor, sx: Tensor) -> Tensor:
    """xq = clip(round(x / sx), -127, 127) as int8, x's layout."""
    return torch.round(x.float() / sx).clamp(-QMAX, QMAX).to(torch.int8)


def int8_conv_accumulators(xq: Tensor, wq: Tensor) -> Tensor:
    """The exact int32 sums: xq (B, H, W, Cin) int8, wq (Cout, 3, 3, Cin)
    int8 -> (B, H, W, Cout) int32, nine shifted products in float64."""
    b, h, w, _ = xq.shape
    xp = F.pad(xq.double(), (0, 0, 1, 1, 1, 1))
    wd = wq.double()
    acc = torch.zeros((b, h, w, wq.shape[0]), dtype=torch.float64, device=xq.device)
    for dh in range(3):
        for dw in range(3):
            acc += xp[:, dh:dh + h, dw:dw + w] @ wd[:, dh, dw].t()
    return acc.to(torch.int32)


def _nhwc_out(x: Tensor, cout: int, dtype=None) -> Tensor:
    """An empty (B, Cout, H, W) tensor in channels-last memory."""
    b, _, h, w = x.shape
    return x.new_empty((b, h, w, cout), dtype=dtype).permute(0, 3, 1, 2)


def int8_conv_plain(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor) -> Tensor:
    """The function in plain PyTorch (module docstring)."""
    sx = activation_scale(x)
    xq = quantize_activations(x.permute(0, 2, 3, 1), sx)
    acc = int8_conv_accumulators(xq, wq)
    y = acc.float() * (sx * sw) + bias
    out = _nhwc_out(x, wq.shape[0])
    out.permute(0, 2, 3, 1).copy_(y.to(x.dtype))
    return out


def _check(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor) -> tuple:
    """Check a launch's arguments; returns (the bf16 flag, the tile plan)."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    b, cin, h, w = x.shape
    cout = wq.shape[0]
    dev = x.device
    bf16 = _cuda.cuda_dtype_flag(x.dtype)
    if not x.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("int8_conv: x must be channels-last contiguous")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv: x and wq must be 16-byte aligned")
    _cuda.check(wq, "wq", dtype=torch.int8, shape=(cout, 3, 3, cin), device=dev)
    _cuda.check(sw, "sw", dtype=torch.float32, shape=(cout,), device=dev)
    _cuda.check(bias, "bias", dtype=torch.float32, shape=(cout,), device=dev)
    plan = int8_tile_plan(b, h, w, cin, cout) if x.numel() else None
    return bf16, plan


def int8_conv_kernel(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor,
                     accumulators: bool = False):
    """The kernel on CUDA tensors (the op's CUDA implementation). With
    ``accumulators``: (xq (B, H, W, Cin) int8, the int32 sums (B, H, W,
    Cout)) of the same launch, in place of y (a check of the kernel)."""
    bf16, plan = _check(x, wq, sw, bias)
    b, cin, h, w = x.shape
    cout = wq.shape[0]
    dev = x.device
    out = _nhwc_out(x, cout, torch.int32 if accumulators else None)
    xq = torch.empty((b, h, w, cin), dtype=torch.int8, device=dev)
    if out.numel():
        amax = torch.empty((1,), dtype=torch.int32, device=dev)
        pt = _cuda.ptr
        _cuda.launch("mqgan_int8_conv", dev, pt(x), pt(wq), pt(sw), pt(bias),
                     pt(amax), pt(xq), pt(out), b, h, w, cin, cout, bf16,
                     int(accumulators), plan.bn, plan.bk, plan.stages, plan.box_w,
                     plan.box_h, plan.smem_bytes)
        _cuda.COUNTERS.add("int8_conv")
    if accumulators:
        return xq, out.permute(0, 2, 3, 1)
    return out


def _int8_conv_cpu(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor) -> Tensor:
    return int8_conv_plain(x, wq, sw, bias)


int8_conv_op = _cuda.register_op(
    "int8_conv", _int8_conv_cpu, int8_conv_kernel,
    lambda x, wq, sw, bias: _nhwc_out(x, wq.shape[0]))


def int8_conv(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor) -> Tensor:
    """x (B, Cin, H, W) in the compute dtype -> (B, Cout, H, W), both in
    channels-last memory (module docstring)."""
    _cuda.check_device("int8_conv", x)
    return _cuda.dispatch(int8_conv_op, int8_conv_kernel,
                          x.contiguous(memory_format=torch.channels_last), wq, sw, bias)
