"""PyTorch port: the FFT log-mel kernel's tables and route, on the CPU.

The kernel (``csrc/log_mel.cu``) runs only on a card; what it reads is built
here and checked here: the banded filterbank against the dense one, the
twiddle table against numpy, the route chosen by shape, and a numpy replay
of the kernel's passes (reflect index arithmetic, radix-16, radix-4 and
radix-2 Stockham passes, the real-FFT split, the bands, the log) driven by
these tables against ``np.fft.rfft`` and against ``log_mel_plain``."""

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops.stft_kernels import (banded_fbank, fft_twiddles,
                                              log_mel, log_mel_plain,
                                              log_mel_route, log_mel_tables)
from mqgan_tpu_torch.signal.mel import mel_filterbank

SPECS = {
    "hifispeech 128 mels": SpectrogramConfig(),
    "hifimusic 160 mels": SpectrogramConfig(n_mel_channels=160),
    "16k 80 mels": SpectrogramConfig(sampling_rate=16000, filter_length=512,
                                     hop_length=128, win_length=512,
                                     n_mel_channels=80, mel_fmax=8000.0),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_banded_fbank_covers_the_filterbank(name):
    fbank = mel_filterbank(SPECS[name])
    bands, weights = banded_fbank(fbank)
    assert bands.dtype == np.int32 and bands.shape == (fbank.shape[1], 3)
    covered = np.zeros_like(fbank, dtype=bool)
    for mel, (lo, hi, off) in enumerate(bands):
        covered[lo:hi, mel] = True
        np.testing.assert_array_equal(weights[off:off + hi - lo], fbank[lo:hi, mel])
    assert not (fbank[~covered]).any()  # every nonzero lies inside its band
    print(f"{name}: {np.count_nonzero(fbank)} nonzeros, {weights.size} banded "
          f"weights of {fbank.size}")
    # the banded product, as the kernel sums it, against mag @ fbank
    mag = np.random.default_rng(0).uniform(0, 3, (7, fbank.shape[0])).astype(np.float32)
    got = np.stack([[np.dot(row[lo:hi], weights[off:off + hi - lo])
                     for lo, hi, off in bands] for row in mag])
    want = (torch.from_numpy(mag) @ torch.from_numpy(fbank)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_banded_fbank_takes_any_filterbank():
    fbank = np.zeros((9, 4), np.float32)
    fbank[2, 0] = fbank[6, 0] = 1.0  # a zero inside the band stays in it
    fbank[8, 2] = 0.5  # mel 1 and 3: no nonzero
    bands, weights = banded_fbank(fbank)
    np.testing.assert_array_equal(bands, [[2, 7, 0], [0, 0, 5], [8, 9, 5], [0, 0, 6]])
    np.testing.assert_array_equal(weights, [1, 0, 0, 0, 1, 0.5])


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_fft_twiddles_match_numpy(n_fft):
    tw = fft_twiddles(n_fft)
    assert tw.dtype == np.float32 and tw.shape[1] == 2
    z = tw[:, 0] + 1j * tw[:, 1].astype(np.float64)
    m = n_fft // 2
    np.testing.assert_allclose(z[:16], np.exp(-2j * np.pi * np.arange(16) / 16),
                               atol=1e-7, rtol=0)
    np.testing.assert_allclose(z[-(m + 1):], np.exp(-2j * np.pi * np.arange(m + 1) / n_fft),
                               atol=1e-7, rtol=0)
    # every entry is W_n^q for an integer q
    q = np.round(np.angle(z) / (-2 * np.pi) * n_fft) % n_fft
    np.testing.assert_allclose(z, np.exp(-2j * np.pi * q / n_fft), atol=1e-7, rtol=0)


def _dft4(a0, a1, a2, a3):
    v0, v1, v2, v3 = a0 + a2, a0 - a2, a1 + a3, -1j * (a1 - a3)
    return v0 + v2, v1 + v3, v0 - v2, v1 - v3


def _replay_kernel(wav: np.ndarray, tables) -> tuple[np.ndarray, np.ndarray]:
    """(|X| (frames, M + 1), log-mel (B, T, n_mels)) as the kernel computes
    them, pass by pass, from its tables (complex128 arithmetic)."""
    n_fft, hop = tables.n_fft, tables.hop
    m = n_fft // 2
    tw = tables.twiddles.numpy().astype(np.float64)
    tw = tw[:, 0] + 1j * tw[:, 1]
    b, samples = wav.shape
    t = samples // hop + 1
    # load: reflect padding as index arithmetic, the window as it loads
    pos = np.arange(t)[:, None] * hop + np.arange(n_fft)[None, :] - n_fft // 2
    pos = np.abs(pos)
    pos = np.where(pos >= samples, 2 * (samples - 1) - pos, pos)
    x = wav[:, pos].astype(np.float64) * tables.window.numpy()
    z = (x[..., 0::2] + 1j * x[..., 1::2]).reshape(b * t, m)
    # radix-16 as 4 x 4: u[4a + b] = z[i + (4a + b) M/16] -> Y[16 i + c + 4d]
    t16 = m // 16
    i = np.arange(t16)
    u = z[:, i[:, None] + t16 * np.arange(16)[None, :]]
    u = [u[..., q] for q in range(16)]
    for bb in range(4):
        u[bb], u[4 + bb], u[8 + bb], u[12 + bb] = _dft4(u[bb], u[4 + bb], u[8 + bb], u[12 + bb])
    for c in range(1, 4):
        for bb in range(1, 4):
            u[4 * c + bb] = u[4 * c + bb] * tw[bb * c]
    for c in range(4):
        u[4 * c:4 * c + 4] = _dft4(*u[4 * c:4 * c + 4])
    y = np.zeros_like(z)
    for c in range(4):
        for d in range(4):
            y[:, 16 * i + c + 4 * d] = u[4 * c + d]
    off, p = 16, 16
    while 4 * p <= m:  # radix-4: z[i + q M/4] -> 4 (i - k) + k + q p
        quarter = m // 4
        i = np.arange(quarter)
        k = i & (p - 1)
        a = [y[:, i + q * quarter] * (tw[off + (q - 1) * p + k] if q else 1)
             for q in range(4)]
        out = np.zeros_like(y)
        for q, v in enumerate(_dft4(*a)):
            out[:, 4 * (i - k) + k + q * p] = v
        y, off, p = out, off + 3 * p, 4 * p
    if 2 * p == m:  # radix-2
        i = np.arange(p)
        a0, a1 = y[:, i], y[:, i + p] * tw[off + i]
        y = np.concatenate([a0 + a1, a0 - a1], axis=1)
        off += p
    k = np.arange(m + 1)
    za, zb = y[:, k % m], np.conj(y[:, (m - k) % m])
    spec = (za + zb) / 2 + tw[off + k] * (za - zb) / 2j
    mag = np.abs(spec)
    bands, weights = tables.bands.numpy(), tables.weights.numpy()
    mel = np.stack([mag[:, lo:hi] @ weights[o:o + hi - lo] for lo, hi, o in bands], axis=1)
    return mag, np.log(np.maximum(mel, 1e-5)).reshape(b, t, -1)


@pytest.mark.parametrize("n_fft,hop,n_mels,samples", [
    (256, 64, 40, 130), (512, 128, 80, 2000), (1024, 256, 64, 3000),
    (2048, 512, 128, 1025), (4096, 1024, 128, 9000)])
def test_replay_of_the_kernel_matches_rfft_and_plain(n_fft, hop, n_mels, samples):
    """The kernel's passes, replayed in numpy from the tables it reads, give
    np.fft.rfft of the reflect-padded windowed frames and the plain
    version's log-mel. samples = n_fft/2 + 1 and 130 > 128 put most frames
    on a reflected edge."""
    cfg = SpectrogramConfig(sampling_rate=16000, filter_length=n_fft, hop_length=hop,
                            win_length=n_fft * 3 // 4, n_mel_channels=n_mels,
                            mel_fmax=8000.0)
    tables = log_mel_tables(cfg, "cpu")
    assert tables.route == "fft"
    wav = np.random.default_rng(n_fft).standard_normal((2, samples)).astype(np.float32)
    wav[1, :samples // 2] = 0.0
    mag, got = _replay_kernel(wav, tables)
    frames = torch.nn.functional.pad(torch.from_numpy(wav).double(),
                                     (n_fft // 2, n_fft // 2), mode="reflect")
    frames = frames.unfold(-1, n_fft, hop) * tables.window.double()
    want = np.abs(np.fft.rfft(frames.numpy(), axis=-1)).reshape(mag.shape)
    err = np.abs(mag - want).max()
    print(f"n_fft {n_fft}: replay vs rfft max err {err:.2e} (max |X| {want.max():.1f})")
    assert err <= 1e-6 * want.max()
    plain = log_mel_plain(torch.from_numpy(wav), tables.cos, tables.sin,
                          tables.fbank, hop).numpy()
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=0)
    np.testing.assert_allclose(log_mel(torch.from_numpy(wav), tables).numpy(), plain,
                               atol=0, rtol=0)


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_route_is_fft_for_powers_of_two(n_fft):
    assert log_mel_route(n_fft, 128, 512) == "fft"
    assert log_mel_route(n_fft, 256, 1) == "fft"


@pytest.mark.parametrize("n_fft", [1200, 800, 1000, 2, 128, 8192, 2050])
def test_route_is_dft_otherwise(n_fft):
    assert log_mel_route(n_fft, 80, 300) == "dft"


@pytest.mark.parametrize("n_fft,n_mels,hop", [(1201, 80, 300), (0, 80, 300),
                                              (2048, 0, 512), (2048, 257, 512),
                                              (1200, 300, 300), (2048, 128, 0)])
def test_route_rejects_what_no_kernel_takes(n_fft, n_mels, hop):
    with pytest.raises(ValueError):
        log_mel_route(n_fft, n_mels, hop)


def test_tables_hold_what_each_route_reads():
    cpu = log_mel_tables(SpectrogramConfig(), "cpu")
    assert cpu.route == "fft" and cpu.cos.shape == (2048, 1025)
    assert cpu.bands.shape == (128, 3) and cpu.weights.numel() == 2019
    assert tuple(cpu.window.shape) == (2048,)
    card = log_mel_tables(SpectrogramConfig(), "meta")  # as a card's, no cos/sin
    assert card.cos is None and card.sin is None and card.twiddles.device.type == "meta"
    dft = log_mel_tables(SpectrogramConfig(sampling_rate=16000, filter_length=1200,
                                           hop_length=300, win_length=1200,
                                           n_mel_channels=80, mel_fmax=8000.0), "meta")
    assert dft.route == "dft" and dft.cos.shape == (1200, 601) and dft.twiddles is None
    with pytest.raises(ValueError, match="tables are on meta"):
        log_mel(torch.zeros((1, 4096)), card)
