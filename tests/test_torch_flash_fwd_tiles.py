"""PyTorch port: the tiling of the bf16 flash-attention forward kernel
(``csrc/flash_attention.cuh`` ``flash_fwd_mma``) replayed in torch on the CPU
and held against the plain forward.

The replay follows the kernel's decomposition, not its lane layout: 64-row
query tiles cut into 16-row warp strips, each over the key tiles 0 ..
diagonal; the online softmax in base 2 with the scale folded in (scores
times scale * log2 e, exp2 of the difference to the running max, alpha =
exp2(m_old - m_new) rescaling the running sum and the O accumulator); the
causal mask on the diagonal tile only; rows >= T read as zeros; O scaled
by 1/l at the end, lse = m ln 2 + log l; P rounded to bf16 before P V in
the bf16 case. The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.ops.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain)

ROWS, STRIP = 64, 16  # a block's tile, a warp's strip
B, H = 1, 2
LOG2E, LN2 = math.log2(math.e), math.log(2.0)
TOL = 1e-5  # fp32: the same function in base 2 and summed in other orders
BF16_REL_L2 = 2e-2  # the card's bf16 gate


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, n, D) fp32, rows >= T zero (the kernel's
    zero-filled loads)."""
    b, t, h, d = x.shape
    out = torch.zeros((b, h, n, d), dtype=torch.float32)
    out[:, :, :t] = x.float().transpose(1, 2)
    return out


def tiled_fwd(q, k, v, scale, rnd=lambda x: x):
    """(o, lse) as ``flash_fwd_mma`` computes them; ``rnd`` rounds P where
    the kernel rounds it (to the A operand of P V)."""
    t, d = q.shape[1], q.shape[3]
    n_tiles = math.ceil(t / ROWS)
    n = n_tiles * ROWS
    qp, kp, vp = (_padded(x, n) for x in (q, k, v))
    o = torch.zeros_like(qp)
    lse = torch.zeros(qp.shape[:3])
    scale2 = scale * LOG2E
    for qt in reversed(range(n_tiles)):  # longest rows first
        for w in range(ROWS // STRIP):
            r0 = qt * ROWS + w * STRIP
            rows = slice(r0, r0 + STRIP)
            query = torch.arange(r0, r0 + STRIP)[:, None]
            m = torch.full((B, H, STRIP), -math.inf)
            l = torch.zeros((B, H, STRIP))
            acc = torch.zeros((B, H, STRIP, d))
            for kt in range(qt + 1):  # above-diagonal tiles skipped
                keys = slice(kt * ROWS, (kt + 1) * ROWS)
                s2 = (qp[:, :, rows] @ kp[:, :, keys].transpose(-1, -2)) * scale2
                if kt == qt:  # the diagonal tile only
                    key = torch.arange(kt * ROWS, (kt + 1) * ROWS)[None, :]
                    s2 = torch.where(key > query, -math.inf, s2)
                m_new = torch.maximum(m, s2.amax(-1))  # finite: key kt * 64
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s2 - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + rnd(p) @ vp[:, :, keys]
                m = m_new
            o[:, :, rows] = acc * (1.0 / l)[..., None]
            lse[:, :, rows] = m * LN2 + torch.log(l)
    return o[:, :, :t].transpose(1, 2).to(q.dtype), lse[..., :t]


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, t, H, d)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 64, 65, 129, 200])
def test_tiled_forward_matches_plain_fp32(t, d):
    q, k, v, _ = _inputs(t, d, seed=t * 1000 + d)
    scale = d ** -0.5
    o, lse = tiled_fwd(q, k, v, scale)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, scale)
    assert o.shape == (B, t, H, d) and lse.shape == (B, H, t)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t,d", [(129, 64), (200, 128), (65, 32)])
def test_tiled_forward_bf16_rounding(t, d):
    """bf16 inputs; P rounded to bf16 before P V, fp32 accumulation, O
    rounded to bf16: within the card's bf16 gate of the plain forward; lse
    (fp32 in both) within the fp32 tolerance."""
    q, k, v = (x.bfloat16() for x in _inputs(t, d, seed=7 + t + d)[:3])
    scale = d ** -0.5
    o, lse = tiled_fwd(q, k, v, scale, rnd=lambda x: x.bfloat16().float())
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, scale)
    assert o.dtype == torch.bfloat16
    rel = float((o.float() - o_p.float()).norm() / o_p.float().norm())
    assert rel <= BF16_REL_L2, rel
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=TOL, rtol=TOL)


def test_backward_reads_the_tiled_lse():
    """The backward kernels recompute P = exp2(S scale log2 e - lse log2 e)
    from the forward's lse: fed the replay's base-2 lse, the plain backward
    gives what it gives fed the plain lse."""
    t, d = 129, 64
    q, k, v, do = _inputs(t, d, seed=11)
    scale = d ** -0.5
    o, lse = tiled_fwd(q, k, v, scale)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, scale)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)
