"""PyTorch port: the bf16 conv GEMM of the residual-block kernel
(``csrc/residual_block.cu`` ``conv_gemm_mma``) replayed in torch on the CPU
and held against the plain block's conv stages.

The replay follows the kernel's decomposition: C[M, N] = A[M, K] W[K, N]
with M = B*T flattened, K = k*Cin, N = Cout, cut into 128 x 128 block tiles
and 64-deep k-steps. Each A tile is gathered in 8-wide chunks whose tap j
and channel i advance step by step as the kernel tracks them; row (b, t) at
column j*Cin + i reads x[b, t + j - lo, i], and the copy is zero-filled
where t + j - lo falls outside [0, T) (so a shifted row never reads the
next clip of the flattened M), for rows m >= M and for k >= K. B tiles are
zero past K and N. The epilogue runs on the fp32 accumulators at the
kernel's rounding points: bias; for conv1 round, mask, APTx; for the causal
tail round, add the residual, round, mask, APTx. The CUDA kernel itself is
held against the plain block on the card by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.ops.block_kernels import (plain_conv_stages,
                                               residual_block_plain)
from mqgan_tpu_torch.utils.init import seeded_init_

BM, BN, BK, CHUNK = 128, 128, 64, 8
PLAIN, CONV1, TAIL = 0, 1, 2  # the kernel's epilogues
TOL = 1e-5  # fp32: the same sums in another order
BF16_REL_L2 = 2e-2  # the card's bf16 gate


def _round(dtype):
    if dtype == torch.float32:
        return lambda v: v
    return lambda v: v.to(dtype).float()


def _aptx(z, beta, gamma, rnd):
    """APTx rounded after every op, as aptx<T> in common.cuh."""
    th = rnd(torch.tanh(rnd(beta * z)))
    return rnd(1.0 + th) * rnd(gamma * z)


class Tracks(list):
    """Each chunk column's (tap, channel) for the next k-step, as the kernel
    tracks them, and K."""

    def __init__(self, cin, taps):
        super().__init__((col // cin, col % cin) for col in range(0, BK, CHUNK))
        self.k_total = taps * cin


def gather_a(x, m0, k0, lo, tracks):
    """The (BM, BK) A tile at rows m0.., columns k0..: one 8-wide copy per
    (row, chunk), zero-filled where it is out; advances ``tracks``."""
    b, t, cin = x.shape
    flat = x.reshape(b * t, cin)
    m = torch.arange(m0, m0 + BM)
    bi, ti = m // t, m % t
    tile = torch.zeros((BM, BK), dtype=torch.float32)
    for ci, col in enumerate(range(0, BK, CHUNK)):
        tap, chan = tracks[ci]
        ts = ti + tap - lo
        ok = (m < b * t) & (ts >= 0) & (ts < t) & (k0 + col < tracks.k_total)
        src = (bi * t + ts.clamp(0, t - 1)).clamp(0, b * t - 1)
        tile[:, col:col + CHUNK] = torch.where(
            ok[:, None], flat[src, chan:chan + CHUNK].float(), 0.0)
        chan += BK
        while chan >= cin:
            chan -= cin
            tap += 1
        tracks[ci] = (tap, chan)
    return tile


def conv_gemm(x, w, bias, lengths, lo, epi, act=None, res=None):
    """(B, T, Cout) in x's dtype as ``conv_gemm_mma`` computes it; w is
    (k, Cin, Cout)."""
    b, t, cin = x.shape
    taps, _, cout = w.shape
    rnd = _round(x.dtype)
    m_total, k_total = b * t, taps * cin
    w2 = torch.zeros((math.ceil(k_total / BK) * BK, math.ceil(cout / BN) * BN))
    w2[:k_total, :cout] = w.reshape(k_total, cout).float()
    out = torch.zeros((math.ceil(m_total / BM) * BM, cout))
    for m0 in range(0, m_total, BM):
        for n0 in range(0, cout, BN):
            tracks = Tracks(cin, taps)
            acc = torch.zeros((BM, BN))
            for k0 in range(0, k_total, BK):
                acc += gather_a(x, m0, k0, lo, tracks) @ w2[k0:k0 + BK, n0:n0 + BN]
            n1 = min(n0 + BN, cout)
            out[m0:m0 + BM, n0:n1] = acc[:, :n1 - n0]
    v = out[:m_total] + bias.float()
    if epi == PLAIN:
        return v.reshape(b, t, cout).to(x.dtype)
    ti = torch.arange(m_total) % t
    valid = (ti < lengths.repeat_interleave(t)).float()[:, None]
    beta, gamma = rnd(act[0]), rnd(act[1])
    s = rnd(v)
    if epi == TAIL:
        s = rnd(s + res.reshape(m_total, cout).float())
    s = rnd(s * valid)
    return _aptx(s, beta, gamma, rnd).reshape(b, t, cout).to(x.dtype)


def tiled_block_stages(x, lengths, wts, causal):
    """(res, h, z or the causal output) through the replayed GEMMs, as the
    block kernel chains them."""
    k = wts.w1.shape[0]
    lo = k - 1 if causal else k // 2
    res = x
    if wts.proj_w is not None:
        res = conv_gemm(x, wts.proj_w[None], wts.proj_b, lengths, 0, PLAIN)
    h = conv_gemm(x, wts.w1, wts.b1, lengths, lo, CONV1, wts.act)
    if causal:
        return res, h, conv_gemm(h, wts.w2, wts.b2, lengths, lo, TAIL, wts.act, res)
    return res, h, conv_gemm(h, wts.w2, wts.b2, lengths, lo, PLAIN)


CASES = [
    # cin, cout, k, causal, B, T, lengths: ragged widths, B*T crossing a
    # 128-row tile inside a clip, shifted rows at every clip edge
    (24, 40, 7, True, 3, 77, (77, 60, 1)),
    (24, 40, 7, False, 3, 77, (77, 60, 1)),
    (40, 40, 5, False, 2, 130, (130, 3)),
    (32, 136, 3, True, 2, 70, (70, 41)),
    (16, 24, 1, False, 3, 50, (50, 1, 33)),
    (136, 32, 3, False, 1, 129, (100,)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k,causal,b,t,lengths", CASES)
def test_tiled_conv_gemm_matches_plain(cin, cout, k, causal, b, t, lengths, dtype):
    blk = seeded_init_(ResidualBlock1D(cin, cout, k, causal=causal), 17)
    wts = blk.requires_grad_(False).kernel_weights(dtype)
    rng = np.random.default_rng(cin * 100 + k + t)
    x = torch.from_numpy(rng.standard_normal((b, t, cin)).astype(np.float32)).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32)
    got = tiled_block_stages(x, lens, wts, causal)
    want = plain_conv_stages(x, lens, wts, causal=causal)
    if causal:  # the tail GEMM's output is the whole block
        want = want[:2] + (residual_block_plain(x, lens, wts, causal=True),)
    for name, g, w in zip(("res", "h", "z" if not causal else "out"), got, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        if dtype == torch.float32:
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL,
                                       err_msg=name)
        else:
            rel = float((g.float() - w.float()).norm() / w.float().norm())
            assert rel <= BF16_REL_L2, (name, rel)


def test_shifted_rows_stay_in_their_clip():
    """A clip of zeros beside a clip of large values: the zero clip's rows
    whose shift reaches past its end read zeros, never the next clip."""
    cin, cout, k, t = 16, 24, 7, 40
    blk = seeded_init_(ResidualBlock1D(cin, cout, k, causal=False), 3)
    wts = blk.requires_grad_(False).kernel_weights(torch.float32)
    x = torch.zeros((2, t, cin))
    x[1] = 1e3
    lens = torch.tensor([t, t], dtype=torch.int32)
    gemm = conv_gemm(x, wts.w1, wts.b1, lens, k // 2, PLAIN)
    np.testing.assert_array_equal(gemm[0].numpy(), wts.b1.expand(t, cout).numpy())
