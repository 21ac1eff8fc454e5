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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from mqgan_tpu_torch.ops import _cuda

QMAX = 127.0
SCALE_FLOOR = 1e-8


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


def _check(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor) -> int:
    """Check a launch's arguments; returns the bf16 flag."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {x.device}")
    b, cin, h, w = x.shape
    cout = wq.shape[0]
    dev = x.device
    bf16 = _cuda.cuda_dtype_flag(x.dtype)
    if not x.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("int8_conv: x must be channels-last contiguous")
    if cin % 16 or not cin:
        raise ValueError(f"int8_conv: the kernel needs Cin % 16 == 0, got {cin}")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv: x and wq must be 16-byte aligned")
    if -(-b * h * w // 128) >= 2 ** 31 or -(-cout // 64) > 65535:
        raise ValueError(f"int8_conv: B*H*W={b * h * w}, Cout={cout} exceed the grid")
    _cuda.check(wq, "wq", dtype=torch.int8, shape=(cout, 3, 3, cin), device=dev)
    _cuda.check(sw, "sw", dtype=torch.float32, shape=(cout,), device=dev)
    _cuda.check(bias, "bias", dtype=torch.float32, shape=(cout,), device=dev)
    return bf16


def int8_conv_kernel(x: Tensor, wq: Tensor, sw: Tensor, bias: Tensor,
                     accumulators: bool = False):
    """The kernel on CUDA tensors (the op's CUDA implementation). With
    ``accumulators``: (xq (B, H, W, Cin) int8, the int32 sums (B, H, W,
    Cout)) of the same launch, in place of y (a check of the kernel)."""
    bf16 = _check(x, wq, sw, bias)
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
                     int(accumulators))
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
    return int8_conv_op(x.contiguous(memory_format=torch.channels_last),
                        wq, sw, bias)
