"""PyTorch port: the signal front end (window, framing, STFT/iSTFT, HTK
filterbank, spec config, audio IO) against the JAX package on the CPU."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from mqgan_tpu.core.config import SpecConfig as JaxSpecConfig
from mqgan_tpu.signal import audio as jax_audio
from mqgan_tpu.signal import stft as jax_stft
from mqgan_tpu.signal.mel import melscale_fbanks as jax_melscale_fbanks
from mqgan_tpu_torch.core.config import SpecConfig
from mqgan_tpu_torch.signal import audio, stft
from mqgan_tpu_torch.signal.mel import melscale_fbanks
from tests.test_torch_bridge import max_err

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("win,n_fft", [(800, 800), (800, 1024), (2048, 2048)])
def test_windows_match_jax(win, n_fft):
    want_h = np.asarray(jax_stft.hann_window(win))
    want_p = np.asarray(jax_stft._padded_window(win, n_fft))
    got_h = stft.hann_window(win).numpy()
    got_p = stft._padded_window(win, n_fft).numpy()
    print(f"hann max err {max_err(got_h, want_h):.1e}, padded {max_err(got_p, want_p):.1e}")
    np.testing.assert_allclose(got_h, want_h, atol=1e-7, rtol=0)
    np.testing.assert_allclose(got_p, want_p, atol=1e-7, rtol=0)


def test_frame_signal_equals_jax(rng):
    x = rng.standard_normal((2, 3001)).astype(np.float32)
    want = np.asarray(jax_stft.frame_signal(jnp.asarray(x), 512, 128))
    got = stft.frame_signal(torch.from_numpy(x), 512, 128).numpy()
    print(f"frame_signal {got.shape}: max err {max_err(got, want):.1e}")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert stft.num_frames(3001, 128) == want.shape[1]


@pytest.mark.parametrize("n_fft,hop,win", [(512, 128, 512), (2048, 512, 2048),
                                           (1024, 256, 800)])
def test_stft_matches_jax(rng, n_fft, hop, win):
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    want = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft, hop, win))
    got = stft.stft(torch.from_numpy(x), n_fft, hop, win).numpy()
    print(f"stft max err {max_err(np.abs(got - want), 0):.3e}")
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_istft_matches_jax(rng):
    n_fft, hop, win = 1024, 256, 1024
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    mag, ph = (np.array(a) for a in jax_stft.stft_mag_phase(jnp.asarray(x), n_fft, hop, win))
    want = np.asarray(jax_stft.istft(jnp.asarray(mag), jnp.asarray(ph), n_fft, hop, win))
    st = stft.TorchSTFT(n_fft, hop, win)
    got = st.inverse(torch.from_numpy(mag), torch.from_numpy(ph)).numpy()
    print(f"istft max err {max_err(got, want):.3e}")
    assert got.shape == want.shape == (2, 1, 8192)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # transform -> inverse reproduces the interior of the signal
    back = st(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(back[:, 0, 256:-256], x[:, 256:-256], atol=1e-3)


@pytest.mark.parametrize("args", [(1025, 0.0, 22050.0, 128, 44100),
                                  (1025, 0.0, 22050.0, 160, 44100),
                                  (129, 0.0, 8000.0, 16, 16000)])
def test_melscale_fbanks_equal_jax(args):
    got, want = melscale_fbanks(*args), jax_melscale_fbanks(*args)
    print(f"fbanks {got.shape}: max err {max_err(got, want):.1e}")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["hifispeech", "hifimusic"])
def test_spec_config_from_yaml_matches_jax(name):
    path = os.path.join(REPO, "configs", f"spec_config_{name}.yaml")
    got, want = SpecConfig.from_yaml(path), JaxSpecConfig.from_yaml(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.spectrogram.n_freqs == want.spectrogram.n_freqs == 1025
    got.validate()
    with pytest.raises(ValueError, match="win_length"):
        dataclasses.replace(got, spectrogram=dataclasses.replace(
            got.spectrogram, win_length=4096)).validate()


def test_audio_io_matches_jax(tmp_path, rng):
    stereo = np.clip(rng.standard_normal((2, 16000)) * 0.3, -1, 1)
    wavfile.write(tmp_path / "i16.wav", 22050,
                  (stereo.T * 32767).astype(np.int16))
    wavfile.write(tmp_path / "f32.wav", 44100, stereo[0].astype(np.float32))
    np.save(tmp_path / "raw.npy", stereo[1].astype(np.float32))
    for name in ("i16.wav", "f32.wav", "raw.npy"):
        wav, sr = audio.load_audio(str(tmp_path / name))
        j_wav, j_sr = jax_audio.load_audio(str(tmp_path / name))
        assert sr == j_sr and wav.dtype == np.float32
        np.testing.assert_array_equal(wav, j_wav)
        mono = audio.to_mono(wav)
        np.testing.assert_array_equal(mono, jax_audio.to_mono(j_wav))
        if sr:
            np.testing.assert_array_equal(audio.resample(mono, sr, 16000),
                                          jax_audio.resample(mono, sr, 16000))
    (tmp_path / "x.mp3").write_bytes(b"xx")
    with pytest.raises(audio.UnsupportedFormatError):
        audio.load_audio(str(tmp_path / "x.mp3"))
