"""PyTorch port: the log-mel kernel module (tables, plain version) against
the JAX Pallas kernel in interpret mode, and ``MelFrontend`` against the JAX
front end, on the CPU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.config import SpectrogramConfig as JaxSpectrogramConfig
from mqgan_tpu.ops.stft_kernels import _log_mel_frames_pallas
from mqgan_tpu.ops.stft_kernels import dft_mel_tables as jax_dft_mel_tables
from mqgan_tpu.signal.mel import MelFrontend as JaxMelFrontend
from mqgan_tpu.signal.stft import frame_signal as jax_frame_signal
from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel, log_mel_plain,
                                              log_mel_tables)
from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL, MelFrontend
from mqgan_tpu_torch.signal.stft import hann_window
from tests.test_torch_bridge import max_err

# the JAX kernel test's spec (tests/test_pallas_kernels.py)
SPEC = dict(sampling_rate=16000, filter_length=512, hop_length=128,
            win_length=512, n_mel_channels=80, mel_fmin=0.0, mel_fmax=8000.0)
LOG_CLIP = np.float32(np.log(np.float32(LOG_CLIP_VAL)))


def _specs(**kw):
    return SpectrogramConfig(**dict(SPEC, **kw)), JaxSpectrogramConfig(**dict(SPEC, **kw))


@functools.lru_cache(maxsize=None)
def _wav(b, n, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32) * 0.3


@pytest.mark.parametrize("kw", [{}, dict(filter_length=1024, win_length=800),
                                dict(sampling_rate=44100, filter_length=2048,
                                     hop_length=512, win_length=2048,
                                     n_mel_channels=128, mel_fmax=22050.0)])
def test_dft_mel_tables_match_jax(kw):
    cfg, jcfg = _specs(**kw)
    got = dft_mel_tables(cfg)
    want = jax_dft_mel_tables(jcfg)
    f, m = cfg.n_freqs, cfg.n_mel_channels
    for g, w, shape in zip(got, want, [(cfg.filter_length, f)] * 2 + [(f, m)]):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        err = max_err(g.numpy(), np.asarray(w)[:shape[0], :shape[1]])
        print(f"table {shape} max err {err:.1e}")
        assert err <= 1e-7


@pytest.mark.parametrize("b,n", [(2, 16000), (1, 10000)])
def test_log_mel_plain_matches_jax_kernel(b, n):
    """The plain version against the Pallas kernel in interpret mode; 126
    and 79 frames per clip: frame counts that are not multiples of the TPU
    kernel's 128-frame tile."""
    cfg, jcfg = _specs()
    wav = _wav(b, n)
    frames = jax_frame_signal(jnp.asarray(wav), 512, 128)
    cos, sin, fbank = jax_dft_mel_tables(jcfg)
    want = np.asarray(_log_mel_frames_pallas(
        frames.reshape(-1, 512), cos, sin, fbank, n_fft=512, n_mels=80,
        interpret=True)).reshape(b, -1, 80)
    got = log_mel_plain(torch.from_numpy(wav), *dft_mel_tables(cfg), 128).numpy()
    print(f"log_mel_plain vs JAX kernel {got.shape}: max err {max_err(got, want):.3e}")
    assert got.shape == want.shape == (b, n // 128 + 1, 80)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_mel_frontend_matches_jax():
    cfg, jcfg = _specs()
    wav = _wav(2, 16000, seed=1).copy()
    wav[1, :4000] = 0.0  # 0.25 s of silence: frames 0..29 see only zeros
    fe = MelFrontend(cfg, device="cpu")
    want = np.asarray(JaxMelFrontend(jcfg)(jnp.asarray(wav)))
    got = fe(wav)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
    print(f"MelFrontend vs JAX {got.shape}: max err {max_err(got, want):.3e}")
    assert got.shape == want.shape == (2, fe.frames_for(16000), 80)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(got[1, :30], LOG_CLIP)
    np.testing.assert_array_equal(want[1, :30], LOG_CLIP)
    # (samples,) -> (frames, n_mels)
    single = fe(torch.from_numpy(wav[0])).numpy()
    assert single.shape == (126, 80)
    np.testing.assert_allclose(single, got[0], atol=1e-6, rtol=0)


def test_mel_frontend_160_mels_matches_jax():
    cfg, jcfg = _specs(n_mel_channels=160, mel_fmax=7600.0, hop_length=100)
    wav = _wav(1, 12345, seed=2)
    got = MelFrontend(cfg, device="cpu")(wav).numpy()
    want = np.asarray(JaxMelFrontend(jcfg)(jnp.asarray(wav)))
    print(f"MelFrontend 160 mels: max err {max_err(got, want):.3e}")
    assert got.shape == want.shape == (1, 124, 160)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)


def test_mel_frontend_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MelFrontend(_specs()[0])


def test_log_mel_rejects_other_devices():
    for cfg in (_specs()[0], _specs(filter_length=1200, win_length=1200)[0]):
        tables = log_mel_tables(cfg, "meta")
        with pytest.raises(ValueError, match="unsupported device"):
            log_mel(torch.zeros((1, 4096), device="meta"), tables)


def test_library_yardstick_computes_the_same_function():
    """chip_smoke.py times the torch.stft chain beside the kernel; it must
    compute the kernel's function (cuFFT on the card, pocketfft here)."""
    from chip_smoke import log_mel_library

    cfg = _specs(filter_length=1024, win_length=800, hop_length=200)[0]
    wav = torch.from_numpy(_wav(2, 9001, seed=3))
    cos, sin, fbank = dft_mel_tables(cfg)
    want = log_mel_plain(wav, cos, sin, fbank, 200)
    got = log_mel_library(wav, hann_window(800), fbank, 1024, 200, 800)
    print(f"torch.stft chain vs plain: max err {max_err(got, want):.2e}")
    assert got.shape == want.shape == (2, 46, 80)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
