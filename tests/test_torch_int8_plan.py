"""PyTorch port: the int8 conv's tile plan (``ops/int8_conv.py``
``int8_tile_plan``, the tiling ``csrc/int8_conv.cu`` launches), its plain
version against the JAX package's ``_int8_conv`` at ragged shapes, and the
ops' dispatch under ``torch.export``, on the CPU:

- over every int8 conv of the flagship, hifimusic and narrow refiners at T
  in {77, 128, 512, 1024}: the tiles cover every output pixel and channel
  exactly once, no N tile is more than half empty, the ring has at least
  three stages and fits the H100's 227 KB of shared memory, BK is 128 bytes
  where Cin % 128 == 0 and 64 otherwise; a shape the kernel does not take
  (Cin or Cout not a multiple of 16, Cout below 32, an empty image)
  raises;
- ``int8_conv_plain`` against ``mqgan_tpu/nn/unet.py`` ``_int8_conv`` at
  B=3, H in {1, 13}, W in {100, 144}, Cin in {16, 192}, fp32, within
  1e-4 * max(1, max|y|), away from a rounding tie (x / sx or k / sw within
  1e-5 of a half: the two frameworks may divide in other ways there);
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
                                           int8_conv_plain, int8_tile_plan,
                                           quantize_weights)

TOL = 1e-4
TIE = 1e-5
# (mels, refiner base channels, depth): configs/model_config_hifispeech.yaml
# (the flagship), configs/model_config_hifimusic.yaml, and the narrow test
# config of tests/test_torch_bridge.py; the hidden projection adds mels / 8
REFINERS = {"flagship": (128, 64, 3), "hifimusic": (160, 96, 3), "narrow": (16, 4, 2)}
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


@pytest.mark.parametrize("config", sorted(REFINERS))
@pytest.mark.parametrize("t", TS)
def test_tile_plan_covers_each_output_once(config, t):
    b = 2
    taken = 0
    for name, cin, cout, h, w in _int8_convs(*REFINERS[config], t):
        if cin % 16 or cout % 16 or cout < 32:
            with pytest.raises(ValueError, match="% 16"):
                int8_tile_plan(b, h, w, cin, cout)
            continue
        taken += 1
        plan = int8_tile_plan(b, h, w, cin, cout)
        assert plan.bm == plan.box_w * plan.box_h == 128, name
        assert plan.bk == (128 if cin % 128 == 0 else 64), name
        assert plan.bn in BN_CHOICES, name
        assert 3 <= plan.stages and plan.smem_bytes <= SMEM_LIMIT, name
        # the last N tile is at least half used
        assert cout - (plan.tiles_n - 1) * plan.bn >= plan.bn // 2, name
        cover = np.zeros((b, h, w, cout), np.uint8)
        for i in range(plan.tiles):
            bb, h0, w0, n0 = plan.tile(i)
            cover[bb, h0:h0 + plan.box_h, w0:w0 + plan.box_w, n0:n0 + plan.bn] += 1
        assert (cover == 1).all(), name
        if plan.tiles_n > 1:  # N tiles of one M tile are neighbours in the list
            assert plan.tile(0)[:3] == plan.tile(1)[:3]
    assert taken >= (0 if config == "narrow" else 14)


@pytest.mark.parametrize("shape", [(1, 8, 16, 8, 64), (1, 8, 16, 24, 64),
                                   (1, 8, 16, 64, 8), (1, 8, 16, 64, 16),
                                   (1, 8, 16, 64, 40),
                                   (0, 8, 16, 64, 64), (1, 0, 16, 64, 64)])
def test_tile_plan_refuses_what_the_kernel_does_not_take(shape):
    b, h, w, cin, cout = shape
    with pytest.raises(ValueError, match="int8_conv"):
        int8_tile_plan(b, h, w, cin, cout)


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
