"""PyTorch port: the log-mel front end past 256 mels, on the CPU.

The JAX package's ``MelFrontend`` computes any positive ``n_mel_channels``.
The port's ``MelFrontend`` is held to it at 5e-4 (the front end's
tolerance, ``tests/test_pallas_kernels.py``) at 320 and 1025 mels on the FFT
route's n_fft 2048 (1025 bins) and at 320 mels on one n_fft of each other
route (1200 mixed-radix, 1201 Bluestein, 9605 DFT); on the CPU each route is
the plain version, and ``log_mel_route`` names the kernel a card would
launch. The band table of every route's kernel and the fake implementations
of the four ops (the shapes a traced program records) give JAX's shapes at
these n_mels. The kernels themselves are held against the plain version on
the card by ``chip_smoke.py`` phase 3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.core.config import SpectrogramConfig as JaxSpectrogramConfig
from mqgan_tpu.signal.mel import MelFrontend as JaxMelFrontend
from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops.stft_kernels import banded_fbank, log_mel_route, log_mel_tables
from mqgan_tpu_torch.signal.mel import MelFrontend
from mqgan_tpu_torch.signal.stft import frame_count

TOL = 5e-4
# (n_fft, hop, n_mels, samples, the route a card takes)
CASES = ((2048, 512, 320, 16_000, "fft"), (2048, 512, 1025, 16_000, "fft"),
         (1200, 300, 320, 12_000, "mixed"), (1201, 300, 320, 12_000, "bluestein"),
         (9605, 2401, 320, 12_000, "dft"))


def _specs(n_fft, hop, n_mels):
    """(port, JAX) configs at 44.1 kHz, the window n_fft long."""
    spec = dict(filter_length=n_fft, hop_length=hop, win_length=n_fft,
                n_mel_channels=n_mels)
    return SpectrogramConfig(**spec), JaxSpectrogramConfig(**spec)


def _wav(samples, seed):
    """Two clips of noise and a sine, the first silent for its first 2,000
    samples."""
    rng = np.random.default_rng(seed)
    t = np.arange(samples) / 44100.0
    wav = 0.1 * rng.standard_normal((2, samples)) + 0.3 * np.sin(2 * np.pi * 440.0 * t)
    wav[0, :2000] = 0.0
    return wav.astype(np.float32)


@pytest.mark.parametrize("n_fft,hop,n_mels,samples,route", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_mel_frontend_matches_jax_past_256_mels(n_fft, hop, n_mels, samples, route):
    cfg, jcfg = _specs(n_fft, hop, n_mels)
    assert log_mel_route(n_fft, n_mels, hop) == route
    wav = _wav(samples, n_fft + n_mels)
    got = MelFrontend(cfg, device="cpu")(wav).numpy()
    want = np.asarray(JaxMelFrontend(jcfg)(jnp.asarray(wav)))
    print(f"n_fft {n_fft} ({route}), {n_mels} mels: {got.shape}, max err "
          f"{np.abs(got - want).max():.2e}")
    assert got.shape == want.shape == (2, frame_count(samples, n_fft, hop), n_mels)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n_mels", [257, 320, 1025, 2000])
def test_every_route_takes_any_n_mels(n_mels):
    assert [log_mel_route(n, n_mels, 300) for n in (2048, 1200, 1201, 9605)] == [
        "fft", "mixed", "bluestein", "dft"]


def _op_args(t, wav):
    """The op of an FFT route and its arguments from a config's CPU tables."""
    ops = torch.ops.mqgan
    if t.route == "fft":
        return ops.log_mel, (wav, t.fbank, t.cos, t.sin, t.window, t.twiddles, t.bands,
                             t.weights, t.hop, t.n_fft)
    if t.route == "mixed":
        return ops.log_mel_mixed, (wav, t.fbank, t.cos, t.sin, t.window, t.plan,
                                   t.twiddles, t.bands, t.weights, t.hop, t.n_fft)
    if t.route == "bluestein":
        return ops.log_mel_bluestein, (wav, t.fbank, t.cos, t.sin, t.premul, t.chirp,
                                       t.plan, t.twiddles, t.spectrum, t.split, t.bands,
                                       t.weights, t.hop, t.n_fft)
    raise ValueError(t.route)


@pytest.mark.parametrize("n_fft,hop,n_mels,samples,route", CASES[:4],
                         ids=[f"{c[0]}-{c[2]}" for c in CASES[:4]])
def test_bands_and_fakes_give_jax_shapes(n_fft, hop, n_mels, samples, route):
    """The band table rebuilds the filterbank exactly (an empty filter as
    (0, 0)); the CPU and fake implementations of the route's op and of the
    DFT op give JAX's shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, jcfg = _specs(n_fft, hop, n_mels)
    t = log_mel_tables(cfg, "cpu")
    assert t.route == route
    fbank = t.fbank.numpy()
    bands, weights = banded_fbank(fbank)
    assert bands.shape == (n_mels, 3)
    rebuilt = np.zeros_like(fbank)
    for mel, (lo, hi, off) in enumerate(bands):
        rebuilt[lo:hi, mel] = weights[off:off + hi - lo]
    np.testing.assert_array_equal(rebuilt, fbank)
    wav = torch.from_numpy(_wav(samples, 0))
    want = (2, JaxMelFrontend(jcfg)(jnp.asarray(wav.numpy())).shape[1], n_mels)
    # the route's op, and the DFT kernel's (it takes any n_fft)
    for op, args in (_op_args(t, wav),
                     (torch.ops.mqgan.log_mel_dft, (wav, t.cos, t.sin, t.fbank, t.hop))):
        assert tuple(op(*args).shape) == want
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(a) if torch.is_tensor(a) else a for a in args]
            assert tuple(op(*fake).shape) == want
