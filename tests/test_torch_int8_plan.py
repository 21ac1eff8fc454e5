"""PyTorch port: the int8 conv's tile plan (``ops/int8_conv.py``
``int8_tile_plan``, the tiling ``csrc/int8_conv.cu`` launches), its plain
version against the JAX package's ``_int8_conv`` at ragged shapes, and the
ops' dispatch under ``torch.export``, on the CPU:

- over every int8 conv of the flagship, hifimusic and narrow refiners at T
  in {77, 128, 512, 1024}: the tiles cover every output pixel and channel
  exactly once, no N tile is more than half empty (but where Cout is below
  16, whose one tile is the narrowest, BN = 32), the ring has at least three
  stages and fits the H100's 227 KB of shared memory, BK is 128 bytes where
  Cin % 128 == 0 and 64 otherwise, the kernel's padded Cin is the next
  multiple of 16; every Cin and Cout is taken (narrow refiners' Cin and Cout
  off 16, Cout below 32), an empty image raises;
- ``int8_conv_plain`` against ``mqgan_tpu/nn/unet.py`` ``_int8_conv`` at
  B=3, H in {1, 13}, W in {100, 144}, Cin in {16, 192}, fp32, within
  1e-4 * max(1, max|y|), away from a rounding tie (x / sx or k / sw within
  1e-5 of a half: the two frameworks may divide in other ways there);
- the kernel's decomposition at Cin off 16 replayed on the CPU: xq and wq
  padded with zero codes to the plan's Cin, summed tile by tile, tap by tap
  and BK slice by slice, equal the true-Cin int32 sums exactly;
- ``quantize_weights`` lays wq out at that padded Cin once, zero codes past
  Cin, the codes those of the true Cin, and the plain version and the
  replay give the same sums and outputs from it;
- an exported program records the ``mqgan::`` ops (a traced call takes the
  op, an eager call on a card its kernel wrapper).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from mqgan_tpu.nn.unet import _int8_conv
from mqgan_tpu_torch.nn.unet import UNetRefiner
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_head
from mqgan_tpu_torch.ops.int8_conv import (BN_CHOICES, SMEM_LIMIT, int8_conv,
                                           int8_conv_accumulators, int8_conv_plain,
                                           int8_tile_plan, quantize_weights)

TOL = 1e-4
TIE = 1e-5
# (mels, refiner base channels, depth): configs/model_config_hifispeech.yaml
# (the flagship), configs/model_config_hifimusic.yaml, and the narrow test
# config of tests/test_torch_bridge.py; the hidden projection adds mels / 8
REFINERS = {"flagship": (128, 64, 3), "hifimusic": (160, 96, 3), "narrow": (16, 4, 2),
            "base24": (16, 24, 3), "base13": (16, 13, 2)}
TS = (77, 128, 512, 1024)


def _int8_convs(mels: int, base: int, depth: int, t: int) -> list:
    """(name, cin, cout, h, w) of a refiner's int8 convs at clip length t."""
    ref = UNetRefiner(mels + mels // 8, base, depth, mels, int8=True)
    t_pad = -(-t // 2 ** depth) * 2 ** depth
    levels = [(f"down{i}", blk, i + 1) for i, blk in enumerate(ref.downs)]
    levels += [("mid", ref.mid, depth)]
    levels += [(f"up{i}", blk, depth - 1 - i) for i, blk in enumerate(ref.ups)]
    out = []
    for name, blk, level in levels:
        for j in (1, 2):
            cout, cin = getattr(blk, f"conv{j}").v.shape[:2]
            out.append((f"{name}.conv{j}", cin, cout, t_pad >> level, mels + mels // 8))
    return out


def _check_plan(b, h, w, cin, cout, name):
    """The plan's rules (module docstring) and its coverage of the output."""
    plan = int8_tile_plan(b, h, w, cin, cout)
    assert plan.bm == plan.box_w * plan.box_h == 128, name
    assert plan.bk == (128 if cin % 128 == 0 else 64), name
    assert plan.bn in BN_CHOICES and (plan.bn != 32 or cout < 64), name
    assert plan.cin_padded % 16 == 0 and cin <= plan.cin_padded < cin + 16, name
    assert 3 <= plan.stages and plan.smem_bytes <= SMEM_LIMIT, name
    # the last N tile is at least half used (below Cout = 16 no tile can be)
    assert (cout - (plan.tiles_n - 1) * plan.bn >= plan.bn // 2
            or (cout < 16 and plan.bn == 32)), name
    cover = np.zeros((b, h, w, cout), np.uint8)
    for i in range(plan.tiles):
        bb, h0, w0, n0 = plan.tile(i)
        cover[bb, h0:h0 + plan.box_h, w0:w0 + plan.box_w, n0:n0 + plan.bn] += 1
    assert (cover == 1).all(), name
    if plan.tiles_n > 1:  # N tiles of one M tile are neighbours in the list
        assert plan.tile(0)[:3] == plan.tile(1)[:3]
    return plan


@pytest.mark.parametrize("config", sorted(REFINERS))
@pytest.mark.parametrize("t", TS)
def test_tile_plan_covers_each_output_once(config, t):
    b = 2
    convs = _int8_convs(*REFINERS[config], t)
    for name, cin, cout, h, w in convs:
        _check_plan(b, h, w, cin, cout, name)
    assert len(convs) >= (8 if config in ("narrow", "base13") else 14)


@pytest.mark.parametrize("shape", [(1, 8, 16, 8, 64), (1, 8, 16, 24, 64),
                                   (1, 8, 16, 64, 8), (1, 8, 16, 64, 16),
                                   (1, 8, 16, 64, 40),
                                   (0, 8, 16, 64, 64), (1, 0, 16, 64, 64)])
def test_tile_plan_refuses_what_the_kernel_does_not_take(shape):
    """Only an empty image is refused; the Cin and Cout off 16 and below 32
    that the kernel once refused now get a plan (Cin padded to 16, BN 32
    below Cout = 64)."""
    b, h, w, cin, cout = shape
    if min(b, h, w) < 1:
        with pytest.raises(ValueError, match="int8_conv"):
            int8_tile_plan(b, h, w, cin, cout)
        return
    plan = _check_plan(b, h, w, cin, cout, str(shape))
    assert plan.cin_padded == -(-cin // 16) * 16
    assert plan.bn == (32 if cout < 32 else 64)


def _replayed_sums(xq, wq, plan):
    """The int32 sums as the kernel takes them: xq (B, H, W, Cin) and wq
    (Cout, 3, 3, Cin or the padded Cin) padded with zero codes to the plan's Cin, then per
    tile (box_h x box_w pixels, bn channels) the 9 taps' boxes (zero past
    the image: the SAME padding and the ragged edges) by BK slices."""
    b, h, w, cin = xq.shape
    cout, cp = wq.shape[0], plan.cin_padded
    hp = plan.tiles_h * plan.box_h + 2
    wp = plan.tiles_w * plan.box_w + 2
    xpad = torch.zeros((b, hp, wp, cp), dtype=torch.int64)
    xpad[:, 1:h + 1, 1:w + 1, :cin] = xq.long()
    wpad = torch.zeros((plan.tiles_n * plan.bn, 3, 3, cp), dtype=torch.int64)
    wpad[:cout, ..., :wq.shape[-1]] = wq.long()  # wq at Cin, or at cp as laid out
    out = torch.zeros((b, plan.tiles_h * plan.box_h, plan.tiles_w * plan.box_w,
                       plan.tiles_n * plan.bn), dtype=torch.int64)
    for i in range(plan.tiles):
        bb, h0, w0, n0 = plan.tile(i)
        acc = torch.zeros((plan.box_h, plan.box_w, plan.bn), dtype=torch.int64)
        for c0 in range(0, cp, plan.bk):
            for tap in range(9):
                dh, dw = divmod(tap, 3)
                box = xpad[bb, h0 + dh:h0 + dh + plan.box_h, w0 + dw:w0 + dw + plan.box_w,
                           c0:c0 + plan.bk]
                acc += box @ wpad[n0:n0 + plan.bn, dh, dw, c0:c0 + plan.bk].t()
        out[bb, h0:h0 + plan.box_h, w0:w0 + plan.box_w, n0:n0 + plan.bn] = acc
    return out[:, :h, :w, :cout].to(torch.int32)


@pytest.mark.parametrize("cin,cout", [(8, 16), (24, 48), (13, 26), (40, 8), (3, 70)])
def test_padded_cin_sums_equal_the_true_cin(cin, cout):
    b, h, w = 2, 5, 19
    rng = np.random.default_rng(cin * 1000 + cout)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (cout, 3, 3, cin)).astype(np.int8))
    plan = int8_tile_plan(b, h, w, cin, cout)
    assert plan.cin_padded == -(-cin // 16) * 16
    assert torch.equal(_replayed_sums(xq, wq, plan), int8_conv_accumulators(xq, wq))


@pytest.mark.parametrize("cin", [3, 13, 16, 24, 40])
def test_quantize_weights_pads_cin_with_zero_codes(cin):
    """wq comes at Cin rounded up to 16, contiguous, zero past Cin, its
    codes those of the true Cin; the plain conv and the kernel's replay
    give from it what they give from the true-Cin codes."""
    b, h, w, cout = 2, 5, 19, 20
    rng = np.random.default_rng(cin)
    kernel = torch.from_numpy(rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
    wq, sw = quantize_weights(kernel)
    cp = -(-cin // 16) * 16
    assert wq.shape == (cout, 3, 3, cp) and wq.dtype == torch.int8 and wq.is_contiguous()
    assert not wq[..., cin:].any()
    codes = torch.round(kernel / sw[:, None, None, None]).clamp(-127, 127)
    assert torch.equal(wq[..., :cin], codes.to(torch.int8).permute(0, 2, 3, 1))
    x = torch.from_numpy(rng.standard_normal((b, cin, h, w)).astype(np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    true_cin = wq[..., :cin].contiguous()
    assert torch.equal(int8_conv_plain(x, wq, sw, bias), int8_conv_plain(x, true_cin, sw, bias))
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8))
    plan = int8_tile_plan(b, h, w, cin, cout)
    assert torch.equal(_replayed_sums(xq, wq, plan), int8_conv_accumulators(xq, true_cin))


def _tie(values, scale) -> np.ndarray:
    r = np.asarray(values, np.float64) / np.asarray(scale, np.float64)
    return np.abs(r - np.floor(r) - 0.5) < TIE


@pytest.mark.parametrize("h", [1, 13])
@pytest.mark.parametrize("w", [100, 144])
@pytest.mark.parametrize("cin", [16, 192])
def test_plain_matches_jax_at_ragged_shapes(h, w, cin):
    b, cout = 3, 32
    rng = np.random.default_rng(100 * h + w + cin)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    kernel = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(_int8_conv(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    wq, sw = quantize_weights(torch.from_numpy(kernel).permute(3, 2, 0, 1).contiguous())
    got = int8_conv_plain(xt, wq, sw, torch.from_numpy(bias)).permute(0, 2, 3, 1).numpy()
    # away from a tie: no pixel whose 3x3 window holds an activation at a
    # tie, no channel whose kernel holds a weight at one
    sx = max(np.abs(x).max(), 1e-8) / 127.0
    near = np.pad(_tie(x, sx).any(axis=-1), ((0, 0), (1, 1), (1, 1)))
    near = np.stack([near[:, i:i + h, j:j + w] for i in range(3) for j in range(3)]).any(0)
    sk = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-8) / 127.0
    far = ~near[..., None] & ~_tie(kernel, sk).any(axis=(0, 1, 2))
    assert far.mean() > 0.9
    err = np.abs(got - want)[far].max()
    print(f"B={b} H={h} W={w} Cin={cin}: max err vs JAX {err:.3e} over {far.mean():.4f} "
          f"of the outputs")
    assert err <= TOL * max(1.0, np.abs(want).max())


class _TwoKernels(nn.Module):
    """An int8 conv and an FSQ head, through the ops' eager entry points."""

    def __init__(self, seen: list):
        super().__init__()
        self.seen = seen
        rng = np.random.default_rng(5)
        wq, sw = quantize_weights(torch.from_numpy(rng.standard_normal((16, 16, 3, 3))
                                                   .astype(np.float32)))
        self.register_buffer("wq", wq)
        self.register_buffer("sw", sw)
        self.register_buffer("bias", torch.zeros(16))
        self.register_buffer("w", torch.from_numpy(rng.standard_normal((16, 4))
                                                   .astype(np.float32)))
        self.register_buffer("b", torch.zeros(4))
        self.register_buffer("consts", torch.tensor(
            [[3.5, 2.0, 2.0, 2.0], [0.5, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0],
             [4.0, 2.0, 2.0, 2.0], [1.0, 8.0, 40.0, 200.0]]))

    def forward(self, x):
        self.seen.append(_cuda.tracing(x))
        y = int8_conv(x, self.wq, self.sw, self.bias)
        h = y.permute(0, 2, 3, 1).reshape(-1, 16)
        return fsq_encode_head(h, self.w, self.b, self.consts)


def test_export_records_the_ops_and_eager_calls_skip_them():
    seen = []
    mod = _TwoKernels(seen).eval()
    x = torch.randn(2, 16, 4, 8).contiguous(memory_format=torch.channels_last)
    eager = mod(x)
    with torch.no_grad():
        program = torch.export.export(mod, (x,))
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {"mqgan.int8_conv.default", "mqgan.fsq_head.default"} <= targets, targets
    assert seen[0] is False and seen[-1] is True  # eager, then traced
    assert torch.equal(program.module()(x), eager)
    # the dispatch: the op for a CPU or a traced tensor, never the wrapper
    calls = []
    out = _cuda.dispatch(lambda t: calls.append("op") or t,
                         lambda t: calls.append("kernel") or t, x)
    assert out is x and calls == ["op"]
