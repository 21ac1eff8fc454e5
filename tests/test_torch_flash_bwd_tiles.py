"""PyTorch port: the tiling of the bf16 flash-attention backward kernels
(``csrc/flash_attention.cuh`` ``flash_bwd_dq_mma`` and ``flash_bwd_dkv_mma``)
replayed in torch on the CPU and held against the plain backward.

The replay follows the kernels' decomposition, not their lane layouts:
64-row tiles cut into 16-row warp strips (a tile's strips side by side, as
its warps run); dQ per query strip over the key
tiles 0 .. diagonal; dK/dV per key strip over the query tiles diagonal ..
end, on the transposed scores S^T = K_w Q^T with lse and delta indexed by
column, in passes of 64 query columns (32 at D=128); tiles above the
diagonal skipped, the mask applied only on the diagonal tile (and, for
dK/dV, the ragged last tile); rows >= T read as zeros; fp32 accumulation
across tiles in the kernels' order. The CUDA kernels themselves are held
against the plain versions on the card by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.ops.flash_attention import (flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain)

ROWS, STRIP = 64, 16  # a block's tile, a warp's strip
B, H = 1, 2
TOL = 1e-5  # fp32: the same function summed in other orders
BF16_REL_L2 = 2e-2  # the card's bf16 gate


def _padded(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, T, H, D) -> (B, H, n, D) fp32, rows >= T zero (the kernels'
    zero-filled loads)."""
    b, t, h, d = x.shape
    out = torch.zeros((b, h, n, d), dtype=torch.float32)
    out[:, :, :t] = x.float().transpose(1, 2)
    return out


def _padded_stat(s: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(s.shape[:2] + (n,), dtype=torch.float32)
    out[..., : s.shape[-1]] = s.float()
    return out


def _unpadded(x: torch.Tensor, t: int, dtype) -> torch.Tensor:
    return x[:, :, :t].transpose(1, 2).to(dtype)


def _strips(x: torch.Tensor, tile: int) -> torch.Tensor:
    """Rows [tile * 64, tile * 64 + 64) of a padded (B, H, n, ...) tensor as
    its 4 warp strips, (B, H, 4, 16, ...): the strips run side by side,
    each row's sums in the kernel's order."""
    rows = x[:, :, tile * ROWS:(tile + 1) * ROWS]
    return rows.reshape(rows.shape[:2] + (ROWS // STRIP, STRIP) + rows.shape[3:])


def tiled_dq(q, k, v, o, lse, do, scale, rnd=lambda x: x):
    """dQ as ``flash_bwd_dq_mma`` computes it; ``rnd`` rounds dS where the
    kernel rounds it (to the A operand of dS K)."""
    t = q.shape[1]
    n_tiles = math.ceil(t / ROWS)
    n = n_tiles * ROWS
    qp, kp, vp, dop = (_padded(x, n) for x in (q, k, v, do))
    # the prologue: delta = rowsum(dO * O) in fp32, rows >= T zero
    delta = _padded_stat((do.float() * o.float()).sum(-1).transpose(1, 2), n)
    lsep = _padded_stat(lse, n)
    dq = torch.zeros_like(qp)
    for qt in reversed(range(n_tiles)):  # longest rows first
        # the tile's 4 warp strips (16 query rows each) side by side
        qw, dow = _strips(qp, qt), _strips(dop, qt)
        lse_w, delta_w = _strips(lsep, qt), _strips(delta, qt)
        query = torch.arange(qt * ROWS, (qt + 1) * ROWS).reshape(-1, STRIP, 1)
        acc = torch.zeros_like(qw)
        for kt in range(qt + 1):  # above-diagonal tiles skipped
            keys = slice(kt * ROWS, (kt + 1) * ROWS)
            kk, vk = kp[:, :, None, keys], vp[:, :, None, keys]
            s = qw @ kk.transpose(-1, -2)
            dp = dow @ vk.transpose(-1, -2)
            p = torch.exp(s * scale - lse_w[..., None])
            if kt == qt:  # the diagonal tile only
                key = torch.arange(kt * ROWS, (kt + 1) * ROWS)[None, None, :]
                p = torch.where(key <= query, p, 0.0)
            ds = p * (dp - delta_w[..., None])
            acc = acc + rnd(ds) @ kk
        dq[:, :, qt * ROWS:(qt + 1) * ROWS] = (acc * scale).flatten(2, 3)
    return _unpadded(dq, t, q.dtype)


def tiled_dkv(q, k, v, lse, delta, do, scale, rnd=lambda x: x):
    """(dK, dV) as ``flash_bwd_dkv_mma`` computes them from the dQ kernel's
    delta (B, H, T); ``rnd`` rounds P^T and dS^T where the kernel rounds
    them."""
    t, d = q.shape[1], q.shape[3]
    cols = ROWS if d <= 64 else 32  # query columns per pass
    n_tiles = math.ceil(t / ROWS)
    n = n_tiles * ROWS
    qp, kp, vp, dop = (_padded(x, n) for x in (q, k, v, do))
    lsep, deltap = _padded_stat(lse, n), _padded_stat(delta, n)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for kt in range(n_tiles):  # the longest column first
        # the tile's 4 warp strips (16 key rows each) side by side
        kw, vw = _strips(kp, kt), _strips(vp, kt)
        key = torch.arange(kt * ROWS, (kt + 1) * ROWS).reshape(-1, STRIP, 1)
        dk_acc, dv_acc = torch.zeros_like(kw), torch.zeros_like(vw)
        for qt in range(kt, n_tiles):
            masked = qt == kt or (qt + 1) * ROWS > t
            for c0 in range(qt * ROWS, (qt + 1) * ROWS, cols):
                qs = slice(c0, c0 + cols)
                qc, doc = qp[:, :, None, qs], dop[:, :, None, qs]
                st = kw @ qc.transpose(-1, -2)
                dpt = vw @ doc.transpose(-1, -2)
                # lse and delta indexed by column (query)
                pt = torch.exp(st * scale - lsep[:, :, None, None, qs])
                if masked:
                    query = torch.arange(c0, c0 + cols)[None, None, :]
                    pt = torch.where((key <= query) & (query < t), pt, 0.0)
                dst = pt * (dpt - deltap[:, :, None, None, qs])
                dv_acc = dv_acc + rnd(pt) @ doc
                dk_acc = dk_acc + rnd(dst) @ qc
        dk[:, :, kt * ROWS:(kt + 1) * ROWS] = (dk_acc * scale).flatten(2, 3)
        dv[:, :, kt * ROWS:(kt + 1) * ROWS] = dv_acc.flatten(2, 3)
    return _unpadded(dk, t, k.dtype), _unpadded(dv, t, v.dtype)


def _tiled_bwd(q, k, v, o, lse, do, scale, rnd=lambda x: x):
    dq = tiled_dq(q, k, v, o, lse, do, scale, rnd)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    return (dq, *tiled_dkv(q, k, v, lse, delta, do, scale, rnd))


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, t, H, d)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [1, 17, 64, 65, 129, 200])
def test_tiled_backward_matches_plain_fp32(t, d):
    q, k, v, do = _inputs(t, d, seed=t * 1000 + d)
    scale = d ** -0.5
    o, lse = flash_attention_fwd_plain(q, k, v, scale)
    got = _tiled_bwd(q, k, v, o, lse, do, scale)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (B, t, H, d), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("t,d", [(129, 64), (200, 128)])
def test_tiled_backward_bf16_rounding(t, d):
    """bf16 inputs; P and dS rounded to bf16 where the kernels round them
    (the A operands of the second products), fp32 accumulation, outputs
    rounded to bf16: within the card's bf16 gate of the plain backward."""
    q, k, v, do = (x.bfloat16() for x in _inputs(t, d, seed=7 + t + d))
    scale = d ** -0.5
    o, lse = flash_attention_fwd_plain(q, k, v, scale)
    got = _tiled_bwd(q, k, v, o, lse, do, scale,
                     rnd=lambda x: x.bfloat16().float())
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        rel = float((g.float() - w.float()).norm() / w.float().norm())
        assert rel <= BF16_REL_L2, (name, rel)
