"""PyTorch port: the plain versions of the causal flash-attention kernels
against the JAX library's own reference (``mha_reference`` and its VJP) on
the CPU, and the autograd op against torch autograd of the naive attention.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference, mha_reference_no_custom_vjp)

from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.ops.flash_attention import (
    causal_attention, copy_width, flash_attention_bwd, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain, head_size_ok)

# fp32 on the CPU, the same function summed in other orders
TOL = 1e-5
B, H, D = 2, 4, 8  # emb 32 over 4 heads


def _inputs(rng, t, d=D, dtype=np.float32):
    return [rng.standard_normal((B, t, H, d)).astype(dtype) for _ in range(3)]


def _bhtd(x):
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)))


# (T, D): D = 8 at four lengths, then the head sizes the kernels take by
# zero-filling their tiles (16, 40, 80: not a multiple of 32; 96 = 768 / 8
# heads) and the one they split across two blocks (256)
T_D = ([pytest.param(t, D, id=str(t)) for t in (1, 7, 37, 130)]
       + [pytest.param(t, d, id=f"{t}-d{d}")
          for t, d in ((37, 16), (130, 40), (37, 80), (130, 96), (37, 256))])


@pytest.mark.parametrize("t,d", T_D)
def test_plain_forward_matches_jax_reference(rng, t, d):
    q, k, v = _inputs(rng, t, d)
    scale = d ** -0.5
    want = np.transpose(np.asarray(mha_reference(
        _bhtd(q), _bhtd(k), _bhtd(v), None, causal=True, sm_scale=scale)),
        (0, 2, 1, 3))
    _, l, m = jax.jit(functools.partial(
        mha_reference_no_custom_vjp, causal=True, sm_scale=scale,
        save_residuals=True))(_bhtd(q), _bhtd(k), _bhtd(v))
    o, lse = flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)), scale)
    assert o.shape == (B, t, H, d) and lse.shape == (B, H, t)
    np.testing.assert_allclose(o.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(m + jnp.log(l)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("t,d", T_D)
def test_plain_backward_matches_jax_vjp(rng, t, d):
    q, k, v = _inputs(rng, t, d)
    do = rng.standard_normal((B, t, H, d)).astype(np.float32)
    scale = d ** -0.5

    # the library's reference VJP takes sm_scale=1 only: scale q inside
    def ref(qq, kk, vv):
        return mha_reference(qq * scale, kk, vv, None, causal=True, sm_scale=1.0)

    grads = jax.jit(lambda *a: jax.vjp(ref, *a[:3])[1](a[3]))(
        _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do))
    want = [np.transpose(np.asarray(g), (0, 2, 1, 3)) for g in grads]
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_fwd_plain(tq, tk, tv, scale)
    got = flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL, err_msg=name)


def _naive(q, k, v, scale):
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("t,d", [(1, 8), (37, 8), (130, 32), (37, 16), (130, 40),
                                 (37, 80), (130, 96), (37, 256)])
def test_autograd_op_matches_naive_autograd_fp64(rng, t, d):
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(rng, t, d, np.float64))
    do = torch.from_numpy(rng.standard_normal((B, t, H, d)))
    scale = d ** -0.5
    out = causal_attention(q, k, v, scale)
    got = torch.autograd.grad(out, (q, k, v), do)
    ref = _naive(q, k, v, scale)
    want = torch.autograd.grad(ref, (q, k, v), do)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, ref, atol=1e-12, rtol=1e-10)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-10)


def test_plain_bf16_rounds_probabilities_and_stays_close(rng):
    q, k, v = (torch.from_numpy(x) for x in _inputs(rng, 37))
    scale = D ** -0.5
    want, _ = flash_attention_fwd_plain(q, k, v, scale)
    got, lse = flash_attention_fwd_plain(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), scale)
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 2e-2, rel


def test_wrappers_take_plain_on_cpu_and_refuse_other_devices(rng):
    q, k, v = (torch.from_numpy(x) for x in _inputs(rng, 7))
    _cuda.COUNTERS.reset()
    o, lse = flash_attention_fwd(q, k, v, 0.5)
    flash_attention_bwd(q, k, v, o, lse, torch.ones_like(o), 0.5)
    assert _cuda.COUNTERS.snapshot() == {}  # plain versions do not count
    meta = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(meta, meta, meta, 0.5)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_bwd(meta, meta, meta, meta, meta, meta, 0.5)


def _jax_takes(d: int) -> bool:
    """JAX's TPU flash kernel's head-size rule (jax/experimental/pallas/ops/
    tpu/flash_attention.py, the kernel's `divmod(head_dim, MIN_BLOCK_SIZE)`:
    a remainder is refused unless the head is below one block of 128)."""
    repeats, rem = divmod(d, 128)
    return d >= 1 and (rem == 0 or repeats == 0)


def test_head_sizes_and_copy_widths():
    """The kernels take JAX's TPU kernel's head sizes, D 1..128 and every
    multiple of 128 (past 256 through the D-chunked kernels), and copy rows
    in the widest of 16, 8, 4, 2 bytes that a row and every address
    allow."""
    assert [head_size_ok(d) for d in range(0, 1025)] == [_jax_takes(d) for d in range(0, 1025)]
    assert all(head_size_ok(d) for d in (*range(1, 129), 256, 384, 512, 1024))
    assert not any(head_size_ok(d) for d in (0, 129, 200, 255, 300, 513))
    x = torch.zeros(4096, dtype=torch.bfloat16)
    rows = lambda d, off=0: x[off:off + 2 * d].view(1, 1, 2, d)  # noqa: E731
    assert [copy_width(d, rows(d)) for d in (64, 40, 96, 20, 6, 3)] == [8, 8, 8, 4, 2, 1]
    assert copy_width(40, rows(40), rows(40, 2)) == 2  # a 4-byte address
    assert copy_width(40, rows(40, 1)) == 1
    y = torch.zeros(4096, dtype=torch.float32)
    assert [copy_width(d, y[:2 * d].view(1, 1, 2, d)) for d in (40, 6, 3)] == [4, 2, 1]
