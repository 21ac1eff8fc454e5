"""PyTorch port: the tiling of the bf16 flash-attention forward kernel
(``csrc/flash_attention.cuh`` ``flash_fwd_mma``) replayed in torch on the CPU
and held against the plain forward.

The replay follows the kernel's decomposition, not its lane layout: 64-row
query tiles cut into 16-row warp strips (a tile's strips side by side, as
its warps run), each over the key tiles 0 .. diagonal; the online softmax in base 2 with the scale folded in (scores
times scale * log2 e, exp2 of the difference to the running max, alpha =
exp2(m_old - m_new) rescaling the running sum and the O accumulator); the
causal mask on the diagonal tile only; rows >= T read as zeros; O scaled
by 1/l at the end, lse = m ln 2 + log l; P rounded to bf16 before P V in
the bf16 case. Past D = 256 (``csrc/flash_attention_chunked.cu``) a block
owns 128 output columns and S = Q K^T is summed over D in 128-column chunks
(the forward in order 0 .. G-1, the backward's S and dP in the order group +
1, ..., group mod G); the replay of that decomposition is held against the
plain forward and backward. The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.
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


CHUNK = 128  # columns of a chunk and of an output group past D = 256


def chunked_product(a, b, order):
    """a @ b^T summed over 128-column chunks of the last dim in ``order``
    (the chunked kernels' S = Q K^T and dP = dO V^T)."""
    out = None
    for ch in order:
        cols = slice(ch * CHUNK, (ch + 1) * CHUNK)
        part = a[..., cols] @ b[..., cols].transpose(-1, -2)
        out = part if out is None else out + part
    return out


def tiled_fwd(q, k, v, scale, rnd=lambda x: x):
    """(o, lse) as ``flash_fwd_mma`` (and, past D = 256, the chunked
    forward: S summed over the chunks in order) computes them; ``rnd``
    rounds P where the kernel rounds it (to the A operand of P V)."""
    t, d = q.shape[1], q.shape[3]
    n_tiles = math.ceil(t / ROWS)
    n = n_tiles * ROWS
    qp, kp, vp = (_padded(x, n) for x in (q, k, v))
    o = torch.zeros_like(qp)
    lse = torch.zeros(qp.shape[:3])
    scale2 = scale * LOG2E
    n_w = ROWS // STRIP
    for qt in reversed(range(n_tiles)):  # longest rows first
        # the tile's 4 warp strips (16 query rows each) side by side
        tile = slice(qt * ROWS, (qt + 1) * ROWS)
        qw = qp[:, :, tile].reshape(B, H, n_w, STRIP, d)
        query = torch.arange(qt * ROWS, (qt + 1) * ROWS).reshape(n_w, STRIP, 1)
        m = torch.full((B, H, n_w, STRIP), -math.inf)
        l = torch.zeros((B, H, n_w, STRIP))
        acc = torch.zeros((B, H, n_w, STRIP, d))
        for kt in range(qt + 1):  # above-diagonal tiles skipped
            keys = slice(kt * ROWS, (kt + 1) * ROWS)
            kk, vk = kp[:, :, None, keys], vp[:, :, None, keys]
            if d > 2 * CHUNK:
                s2 = chunked_product(qw, kk, range(d // CHUNK)) * scale2
            else:
                s2 = (qw @ kk.transpose(-1, -2)) * scale2
            if kt == qt:  # the diagonal tile only
                key = torch.arange(kt * ROWS, (kt + 1) * ROWS)[None, None, :]
                s2 = torch.where(key > query, -math.inf, s2)
            m_new = torch.maximum(m, s2.amax(-1))  # finite: key kt * 64
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s2 - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + rnd(p) @ vk
            m = m_new
        o[:, :, tile] = (acc * (1.0 / l)[..., None]).flatten(2, 3)
        lse[:, :, tile] = (m * LN2 + torch.log(l)).flatten(2, 3)
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


def chunked_bwd(q, k, v, o, lse, do, scale):
    """(dq, dk, dv) as the chunked backward kernels compute them: for each
    output group of 128 columns, S and dP summed over the chunks in the
    order group + 1, ..., group (mod G), P = exp2(S scale log2 e - lse log2
    e) on visible keys, dS = P (dP - delta); the group's columns of dQ = dS
    K scale, dK = dS^T Q scale, dV = P^T dO."""
    t, d = q.shape[1], q.shape[3]
    g_all = d // CHUNK
    qp, kp, vp, op, dop = (x.float().transpose(1, 2) for x in (q, k, v, o, do))
    visible = torch.ones((t, t), dtype=torch.bool).tril()
    delta = (dop * op).sum(-1)
    outs = [torch.zeros_like(qp) for _ in range(3)]
    for grp in range(g_all):
        order = [(grp + 1 + i) % g_all for i in range(g_all)]
        s2 = chunked_product(qp, kp, order) * (scale * LOG2E)
        dp = chunked_product(dop, vp, order)
        p = torch.where(visible, torch.exp2(s2 - lse[..., None] * LOG2E), 0.0)
        ds = p * (dp - delta[..., None])
        cols = slice(grp * CHUNK, (grp + 1) * CHUNK)
        outs[0][..., cols] = ds @ kp[..., cols] * scale
        outs[1][..., cols] = ds.transpose(-1, -2) @ qp[..., cols] * scale
        outs[2][..., cols] = p.transpose(-1, -2) @ dop[..., cols]
    return tuple(x.transpose(1, 2).to(q.dtype) for x in outs)


@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("t", [1, 70])
def test_chunked_scores_match_plain_fp32(t, d):
    """Past D = 256: the forward's chunked S and the backward's rotated
    chunk order, fp32, against the plain forward and backward."""
    q, k, v, do = _inputs(t, d, seed=t * 10 + d)
    scale = d ** -0.5
    o, lse = tiled_fwd(q, k, v, scale)
    o_p, lse_p = flash_attention_fwd_plain(q, k, v, scale)
    np.testing.assert_allclose(o.numpy(), o_p.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=TOL, rtol=TOL)
    got = chunked_bwd(q, k, v, o, lse, do, scale)
    want = flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_chunked_forward_bf16_rounding():
    """D = 384 in bf16: P rounded before P V, within the card's bf16 gate."""
    t, d = 70, 384
    q, k, v = (x.bfloat16() for x in _inputs(t, d, seed=5)[:3])
    scale = d ** -0.5
    o, _ = tiled_fwd(q, k, v, scale, rnd=lambda x: x.bfloat16().float())
    o_p, _ = flash_attention_fwd_plain(q, k, v, scale)
    rel = float((o.float() - o_p.float()).norm() / o_p.float().norm())
    assert rel <= BF16_REL_L2, rel
