"""PyTorch port: the decomposition of the FSQ encode head kernel
(``csrc/fsq_head.cu``) replayed in torch on the CPU and held against the
plain ``fsq_encode_plain``.

The replay follows the kernel lane by lane: rows in groups of R = 2, lane l
owning vectors l, l + 32, ... of VEC channels each (8 bf16 or 4 fp32 per
16-byte load, 1 when C is not a multiple of that), its R x DP
partials (DP = d rounded up to a power of two) accumulated by fused
multiply-adds in the order the kernel issues them; the transposing butterfly
(step s: the lane with bit s set keeps the upper half of its live values and
adds its partner's upper half) and the plain xor steps after it; the
per-lane tail (lane L holds row r, dim j of value bitrev(L mod R*DP)):
tanh, the separately rounded multiply and subtract, half-to-even rounding,
and the pack summed over the DP lanes of a row. The CUDA kernel itself is
held against the plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_plain, fsq_head_constants
from mqgan_tpu_torch.quant.fsq import FSQSpec

LANES = 32
MIDPOINT_TOL = 1e-4  # the plain pre-round value's distance to a midpoint
LEVELS = {1: (8,), 2: (8, 5), 3: (8, 5, 5), 4: (8, 5, 5, 5), 5: (8, 8, 8, 5, 5),
          6: (8, 8, 5, 5, 5, 5), 7: (8, 5, 5, 5, 5, 5, 5),
          8: (8, 5, 5, 5, 5, 5, 5, 5)}


def kernel_shape(d: int):
    """(DP, R, M): d padded to a power of two, rows per group, partials."""
    dp = 1 if d <= 1 else 2 if d <= 2 else 4 if d <= 4 else 8
    r = min(2, LANES // dp)
    return dp, r, r * dp


def vec_width(c: int, dtype: torch.dtype) -> int:
    """Channels per load: 16 bytes' worth when C is a multiple of it."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    return vec if c % vec == 0 else 1


def fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def bitrev(x: int, bits: int) -> int:
    return int(format(x, f"0{bits}b")[::-1], 2) if bits else 0


def butterfly(a: torch.Tensor) -> torch.Tensor:
    """a (32, ..., M) per-lane partials -> (32, ...): lane L's fully
    reduced value, as the kernel's shuffles leave it."""
    lanes = torch.arange(LANES)
    m = a.shape[-1]
    s = 0
    while a.shape[-1] > 1:
        half = a.shape[-1] // 2
        upper = ((lanes >> s) & 1).bool().reshape((LANES,) + (1,) * (a.dim() - 1))
        lo, hi = a[..., :half], a[..., half:]
        keep, send = torch.where(upper, hi, lo), torch.where(upper, lo, hi)
        a = keep + send[lanes ^ (1 << s)]
        s += 1
    a = a[..., 0]
    off = m
    while off < LANES:
        a = a + a[lanes ^ off]
        off *= 2
    return a


def replay(h, w, b, consts, vec):
    """(N,) int32 indices as ``fsq_head_kernel`` computes them."""
    n, c = h.shape
    d = w.shape[1]
    dp, r_rows, m = kernel_shape(d)
    groups = -(-n // r_rows)
    hp = torch.zeros((groups * r_rows, c))
    hp[:n] = h.float()
    hp = hp.reshape(groups, r_rows, c)
    wp = torch.zeros((c, dp))
    wp[:, :d] = w
    acc = torch.zeros((LANES, groups, r_rows, dp))
    for lane in range(LANES):
        for v in range(lane, c // vec, LANES):
            for e in range(vec):
                ch = v * vec + e
                acc[lane] = fma(hp[:, :, ch, None], wp[ch], acc[lane])
    z_all = butterfly(acc.reshape(LANES, groups, m))  # (32, G)
    logm = m.bit_length() - 1
    half_l, offset, shift, half_w, basis = consts
    term = torch.zeros((LANES, groups))
    rows = torch.zeros(LANES, dtype=torch.long)
    for lane in range(LANES):
        k = bitrev(lane % m, logm)
        rows[lane], j = divmod(k, dp)
        if j < d:
            z = z_all[lane] + b[j]
            bounded = torch.tanh(z + shift[j]) * half_l[j] - offset[j]
            term[lane] = (torch.round(bounded) + half_w[j]) * basis[j]
    lanes = torch.arange(LANES)
    off = r_rows
    while off < m:
        term = term + term[lanes ^ off]
        off *= 2
    out = torch.zeros((groups, r_rows), dtype=torch.int32)
    for lane in range(r_rows):  # the writers: j == 0
        out[:, rows[lane]] = term[lane].to(torch.int32)
    return out.reshape(-1)[:n]


def _case(rng, n, c, d, dtype):
    spec = FSQSpec(LEVELS[d])
    h = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.standard_normal((c, d)) * 2.0 / np.sqrt(c))
                         .astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((d,)) * 0.1).astype(np.float32))
    consts = torch.from_numpy(fsq_head_constants(spec))
    return h, w, b, consts, spec


def _near_midpoint(h, w, b, consts):
    z = h.float() @ w + b
    bounded = torch.tanh(z + consts[2]) * consts[0] - consts[1]
    frac = bounded - torch.floor(bounded)
    return ((frac - 0.5).abs() < MIDPOINT_TOL).any(dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(1, 9))
def test_replay_matches_plain(rng, d, dtype):
    """Ragged N (not a multiple of the group), C = 384: 48 bf16 or 96 fp32
    vectors, so some lanes take one more vector than others."""
    n = 8 * 5 + 3
    h, w, b, consts, spec = _case(rng, n, 384, d, dtype)
    assert vec_width(384, dtype) == 16 // h.element_size()
    got = replay(h, w, b, consts, vec_width(384, dtype))
    want = fsq_encode_plain(h, w, b, consts)
    far = ~_near_midpoint(h, w, b, consts)
    assert far.float().mean() > 0.95
    assert torch.equal(got[far], want[far])
    assert int(got.min()) >= 0 and int(got.max()) < spec.codebook_size
    assert len(set(want.tolist())) >= min(n // 3, spec.codebook_size // 2)  # spread


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,d", [(1, 44, 4), (9, 37, 8), (13, 768, 4)])
def test_replay_ragged_and_scalar_loads(rng, n, c, d, dtype):
    """N = 1, N off the group, a C that takes scalar loads (VEC = 1) and the
    flagship C = 768."""
    h, w, b, consts, _ = _case(rng, n, c, d, dtype)
    got = replay(h, w, b, consts, vec_width(c, dtype))
    want = fsq_encode_plain(h, w, b, consts)
    far = ~_near_midpoint(h, w, b, consts)
    assert torch.equal(got[far], want[far])


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8])
def test_butterfly_leaves_bitreversed_sums(d):
    """Integer partials (summed exactly in fp32): lane L ends with the sum
    over all 32 lanes of value bitrev(L mod M), the (row, dim) the tail
    reads."""
    _, _, m = kernel_shape(d)
    a = (torch.arange(LANES)[:, None] * 100 + torch.arange(m)[None, :]).float()
    got = butterfly(a)
    logm = m.bit_length() - 1
    for lane in range(LANES):
        k = bitrev(lane % m, logm)
        assert float(got[lane]) == float(a[:, k].sum())
