"""PyTorch port: the kernels' ``torch.library`` ops (namespace ``mqgan``) on
the CPU: ``opcheck`` of each op's CPU registration (schema, fake
implementation, autograd registration, AOT dispatch with dynamic shapes) at
tiny shapes; each op equal bit for bit to its plain version; the flash
op's gradients against torch autograd of the naive attention. The CUDA
implementations are held against their kernel wrappers on the card by
``chip_smoke.py`` phase 20a."""

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.ops.block_kernels import (residual_block_plain,
                                               residual_block_plain_begin,
                                               residual_block_plain_finish)
from mqgan_tpu_torch.ops.flash_attention import (causal_attention,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fwd_plain)
from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_plain, fsq_head_constants
from mqgan_tpu_torch.ops.int8_conv import int8_conv_plain, quantize_weights
from mqgan_tpu_torch.ops.mixer_kernels import mel_mixer_plain
from mqgan_tpu_torch.ops.mixer_poly import poly_mixer_plain
from mqgan_tpu_torch.ops.stft_kernels import log_mel_plain, log_mel_tables
from mqgan_tpu_torch.quant.fsq import FSQSpec
from mqgan_tpu_torch.utils.init import seeded_init_

B, T = 2, 9
# n_fft 101, hop 50: 700 samples give JAX's (700 - 1) // 50 + 1 = 14 frames
ODD_SPEC = SpectrogramConfig(sampling_rate=16000, filter_length=101, hop_length=50,
                             win_length=101, n_mel_channels=8, mel_fmax=8000.0)
LENGTHS = (9, 4)
FLASH_TOL = 1e-5  # tests/test_torch_flash.py: fp32, other summation orders


def _t(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _lengths():
    return torch.tensor(LENGTHS, dtype=torch.int32)


def _block(causal, cin=8, cout=12):
    blk = seeded_init_(ResidualBlock1D(cin, cout, 3, causal=causal), 1)
    w = blk.kernel_weights(torch.float32)
    return type(w)(*(None if t is None else t.detach() for t in w))


def _bluestein_args(wav, t):
    """The arguments of ``mqgan::log_mel_bluestein`` from a config's tables."""
    return (wav, t.fbank, t.cos, t.sin, t.premul, t.chirp, t.plan, t.twiddles,
            t.spectrum, t.split, t.bands, t.weights, t.hop, t.n_fft)


def _cases():
    """name -> (op, args, the plain version's outputs)."""
    rng = np.random.default_rng(0)
    lengths = _lengths()
    spec = FSQSpec((8, 5, 5, 5))
    h = _t(rng, B * T, 16)
    fw, fb = _t(rng, 16, 4), _t(rng, 4)
    consts = torch.from_numpy(fsq_head_constants(spec))
    x8 = _t(rng, B, T, 8)
    cbam = _block(False)
    causal = _block(True)
    lo, hi = torch.zeros_like(lengths), lengths.clone()
    res, z, part = residual_block_plain_begin(x8, lengths, cbam, lo, hi)
    pooled = part.contiguous()
    counts = lengths.float()
    mix = seeded_init_(MelMixer2D(6), 2).kernel_weights()
    mix = type(mix)(*(t.detach() for t in mix))
    xm = _t(rng, B, T, 6)
    tables = log_mel_tables(SpectrogramConfig(sampling_rate=16000, filter_length=256,
                                              hop_length=64, win_length=256,
                                              n_mel_channels=16, mel_fmax=8000.0),
                            "cpu")
    mixed = log_mel_tables(SpectrogramConfig(sampling_rate=16000, filter_length=96,
                                             hop_length=24, win_length=96,
                                             n_mel_channels=16, mel_fmax=8000.0), "cpu")
    odd = log_mel_tables(ODD_SPEC, "cpu")
    even = log_mel_tables(SpectrogramConfig(sampling_rate=16000, filter_length=88,
                                            hop_length=22, win_length=88,
                                            n_mel_channels=16, mel_fmax=8000.0), "cpu")
    wav = _t(rng, B, 700)
    q, k, v = (_t(rng, B, T, 2, 8) for _ in range(3))
    o, lse = flash_attention_fwd_plain(q, k, v, 0.35)
    do = _t(rng, B, T, 2, 8)
    x_img = _t(rng, B, 16, 6, 5).contiguous(memory_format=torch.channels_last)
    wq, sw = quantize_weights(_t(rng, 8, 16, 3, 3))
    bias = _t(rng, 8)
    ops = torch.ops.mqgan
    return {
        "fsq_head": (ops.fsq_head, (h, fw, fb, consts),
                     (fsq_encode_plain(h, fw, fb, consts),)),
        "residual_block": (ops.residual_block, (x8, lengths, *cbam, False),
                           (residual_block_plain(x8, lengths, cbam, causal=False),)),
        "residual_block_causal": (ops.residual_block, (x8, lengths, *causal, True),
                                  (residual_block_plain(x8, lengths, causal,
                                                        causal=True),)),
        "residual_block_begin": (ops.residual_block_begin,
                                 (x8, lengths, *cbam, lo, hi), (z, part, res)),
        "residual_block_finish": (ops.residual_block_finish,
                                  (x8, lengths, *cbam, res, z, pooled, counts),
                                  (residual_block_plain_finish(
                                      x8, lengths, cbam, res, z, pooled, counts),)),
        "mel_mixer": (ops.mel_mixer, (xm, lengths, *mix),
                      (mel_mixer_plain(xm, lengths, mix),)),
        "mel_mixer_poly": (ops.mel_mixer_poly, (xm, lengths, *mix, 40, 256),
                           (poly_mixer_plain(xm, lengths, mix, degree=40,
                                             grid=256),)),
        "log_mel": (ops.log_mel, (wav, tables.fbank, tables.cos, tables.sin,
                                  tables.window, tables.twiddles, tables.bands,
                                  tables.weights, tables.hop, tables.n_fft),
                    (log_mel_plain(wav, tables.cos, tables.sin, tables.fbank,
                                   tables.hop),)),
        "log_mel_dft": (ops.log_mel_dft, (wav, tables.cos, tables.sin, tables.fbank,
                                          tables.hop),
                        (log_mel_plain(wav, tables.cos, tables.sin, tables.fbank,
                                       tables.hop),)),
        # odd n_fft, a hop that divides the samples: JAX's frame count
        "log_mel_dft_odd": (ops.log_mel_dft, (wav, odd.cos, odd.sin, odd.fbank, odd.hop),
                            (log_mel_plain(wav, odd.cos, odd.sin, odd.fbank, odd.hop),)),
        "log_mel_mixed": (ops.log_mel_mixed, (wav, mixed.fbank, mixed.cos, mixed.sin,
                                              mixed.window, mixed.plan, mixed.twiddles,
                                              mixed.bands, mixed.weights, mixed.hop,
                                              mixed.n_fft),
                          (log_mel_plain(wav, mixed.cos, mixed.sin, mixed.fbank,
                                         mixed.hop),)),
        # odd n_fft 101 (JAX's frame count) and even 88 = 8 * 11
        **{name: (ops.log_mel_bluestein, _bluestein_args(wav, t),
                  (log_mel_plain(wav, t.cos, t.sin, t.fbank, t.hop),))
           for name, t in (("log_mel_bluestein", odd), ("log_mel_bluestein_even", even))},
        "flash_fwd": (ops.flash_fwd, (q, k, v, 0.35), (o, lse)),
        # with inputs that require grad: the registered backward too
        "flash_fwd_grad": (ops.flash_fwd, tuple(t.clone().requires_grad_()
                                                for t in (q, k, v)) + (0.35,),
                           (o, lse)),
        "flash_bwd": (ops.flash_bwd, (q, k, v, o, lse, do, 0.35),
                      flash_attention_bwd_plain(q, k, v, o, lse, do, 0.35)),
        "int8_conv": (ops.int8_conv, (x_img, wq, sw, bias),
                      (int8_conv_plain(x_img, wq, sw, bias),)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_cpu_registration(name):
    op, args, _ = CASES[name]
    torch.library.opcheck(op.default, args)


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_equals_its_plain_version_bit_for_bit(name):
    op, args, want = CASES[name]
    _cuda.COUNTERS.reset()
    got = op(*args)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), name
    assert _cuda.COUNTERS.snapshot() == {}  # plain versions do not count


def test_every_kernel_entry_point_is_an_op():
    _cuda.load_ops()
    names = {"fsq_head", "residual_block", "residual_block_begin",
             "residual_block_finish", "mel_mixer", "mel_mixer_poly", "log_mel",
             "log_mel_mixed", "log_mel_bluestein", "log_mel_dft", "flash_fwd",
             "flash_bwd", "int8_conv"}
    for name in names:
        assert hasattr(torch.ops.mqgan, name), name
    # one CUDA implementation per C entry point
    entries = {"fsq_head": "mqgan_fsq_head", "residual_block": "mqgan_residual_block",
               "residual_block_begin": "mqgan_residual_block_begin",
               "residual_block_finish": "mqgan_residual_block_finish",
               "mel_mixer": "mqgan_mel_mixer", "mel_mixer_poly": "mqgan_mel_mixer_poly",
               "log_mel": "mqgan_log_mel", "log_mel_mixed": "mqgan_log_mel_mixed",
               "log_mel_bluestein": "mqgan_log_mel_bluestein",
               "log_mel_dft": "mqgan_log_mel_dft",
               "int8_conv": "mqgan_int8_conv"}
    assert set(entries.values()) | {"mqgan_flash_fwd", "mqgan_flash_bwd_dq",
                                    "mqgan_flash_bwd_dkv"} == set(_cuda._SIGNATURES)


def test_fake_implementations_build_nothing():
    """Tracing through the ops under fake tensors neither builds nor loads
    the kernels' library."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    loaded = _cuda.LIBRARY._cdll
    for name, (op, args, _) in CASES.items():
        real = op(*args)
        real = real if isinstance(real, (tuple, list)) else (real,)
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
            out = op(*fake)
        out = out if isinstance(out, (tuple, list)) else (out,)
        for o, r in zip(out, real):
            assert (o.shape, o.dtype, o.stride()) == (r.shape, r.dtype, r.stride()), name
    assert _cuda.LIBRARY._cdll is loaded


@pytest.mark.parametrize("samples", [700, 699])
def test_fakes_give_jax_frame_count_at_odd_n_fft(samples):
    """The fake implementations of ``mqgan::log_mel``, ``mqgan::log_mel_bluestein``
    and ``mqgan::log_mel_dft``
    (the shapes a traced program records) give the frames of JAX's
    ``frame_signal`` at an odd n_fft, as the CPU implementations do:
    (samples - 1) // hop + 1, 14 at 700 samples (not 700 // 50 + 1)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mqgan_tpu.signal.stft import frame_signal as jax_frame_signal

    t = log_mel_tables(ODD_SPEC, "cpu")
    wav = torch.zeros((2, samples))
    want = jax_frame_signal(np.zeros((2, samples), np.float32), 101, 50).shape[1]
    assert want == (samples - 1) // 50 + 1
    cases = ((torch.ops.mqgan.log_mel, (wav, t.fbank, t.cos, t.sin, None, None, None,
                                         None, t.hop, t.n_fft)),
             (torch.ops.mqgan.log_mel_bluestein, _bluestein_args(wav, t)),
             (torch.ops.mqgan.log_mel_dft, (wav, t.cos, t.sin, t.fbank, t.hop)))
    for op, args in cases:
        assert op(*args).shape == (2, want, 8)
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
            assert op(*fake).shape == (2, want, 8)


@pytest.mark.parametrize("t", [1, 17])
def test_flash_op_gradients_equal_plain_attention(t):
    rng = np.random.default_rng(t)
    q, k, v = (_t(rng, B, t, 2, 8).requires_grad_() for _ in range(3))
    do = _t(rng, B, t, 2, 8)
    scale = 8 ** -0.5
    out = causal_attention(q, k, v, scale)
    got = torch.autograd.grad(out, (q, k, v), do)
    o, lse = flash_attention_fwd_plain(q.detach(), k.detach(), v.detach(), scale)
    plain = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), o, lse,
                                      do, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), float("-inf"))
    naive = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    want = torch.autograd.grad(naive, (q, k, v), do)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=FLASH_TOL,
                                   rtol=FLASH_TOL)
