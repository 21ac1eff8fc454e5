"""Fused |STFT| -> mel -> log front end (counterpart of
``mqgan_tpu/ops/stft_kernels.py``).

    out = log(max(|STFT(wav)| @ fbank, 1e-5))
    (center, reflect pad, periodic Hann window padded to n_fft, power 1)

Two CUDA kernels compute it; ``log_mel_route`` chooses one by shape, before
any launch, and each route launches its kernel or raises:

- ``"fft"`` (``csrc/log_mel.cu``, counter ``log_mel``), for power-of-two
  n_fft from 256 to 4096: an fp32 real FFT of each frame in shared memory,
  its magnitudes, the filterbank's bands, the log. Frames are read in place
  from the unpadded waveform (reflect padding in the index arithmetic).
- ``"dft"`` (``csrc/log_mel_dft.cu``, counter ``log_mel_dft``), for any
  other even n_fft: the DFT as an fp32 product with cos/sin tables (the
  window folded in), frames read in place from the reflect-padded waveform.

``log_mel_plain`` is the plain PyTorch version of the function (the DFT as
matmuls); the wrappers take it only for CPU tensors. There is no separate
front-end class as in the JAX package (``PallasMelFrontend``):
``signal/mel.py`` ``MelFrontend`` runs ``log_mel``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL, mel_filterbank
from mqgan_tpu_torch.signal.stft import _padded_window, frame_signal, num_frames

FFT_MIN, FFT_MAX = 256, 4096  # n_fft range of the FFT kernel (powers of two)
MAX_MELS = 256  # both kernels: the DFT kernel's (64, n_mels) accumulator
PLAIN_CHUNK = 8192  # frames per matmul in the plain version


def log_mel_route(n_fft: int, n_mels: int, hop: int) -> str:
    """"fft" or "dft": the kernel that computes this shape on the card;
    raises ValueError for a shape neither takes."""
    if n_fft <= 0 or n_fft % 2:
        raise ValueError(f"log_mel: n_fft {n_fft} must be even and positive")
    if not 0 < n_mels <= MAX_MELS or hop <= 0:
        raise ValueError(f"log_mel: n_mels {n_mels} (1..{MAX_MELS}) or hop "
                         f"{hop} out of range")
    if n_fft & (n_fft - 1) == 0 and FFT_MIN <= n_fft <= FFT_MAX:
        return "fft"
    return "dft"


def dft_mel_tables(cfg: SpectrogramConfig, dtype=np.float32):
    """(cos, sin, fbank) CPU tensors of ``dtype``: cos/sin (n_fft, F) with
    the (fp32) window folded in, built in float64 and then cast; fbank
    (F, n_mels). float64 tables make the plain version a reference of the
    function for accuracy checks."""
    n_fft = cfg.filter_length
    n = np.arange(n_fft)[:, None]
    k = np.arange(cfg.n_freqs)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    win = _padded_window(cfg.win_length, n_fft).numpy()[:, None]
    cos = (np.cos(ang) * win).astype(dtype)
    sin = (np.sin(ang) * win).astype(dtype)
    return (torch.from_numpy(cos), torch.from_numpy(sin),
            torch.from_numpy(mel_filterbank(cfg).astype(dtype)))


def fft_twiddles(n_fft: int) -> np.ndarray:
    """(L, 2) fp32 (re, im) twiddles of the FFT kernel, in the order its
    passes read them; W_L = exp(-2 pi i / L), M = n_fft / 2:

      16 entries       W_16^j, j < 16 (the first pass's radix-16 butterfly)
      per radix-4 pass over sub-transforms of p = 16, 64, ... (4p <= M):
                       W_4p^k, W_4p^2k, W_4p^3k for k < p (three runs of p)
      a radix-2 pass when log2 M is odd (p = M/2): W_M^k, k < p
      M + 1 entries    W_n_fft^k, k <= M (the real-FFT split)

    Each entry is W_n_fft^q for an integer q, computed in float64 and cast."""
    m = n_fft // 2
    parts = [np.arange(16) * (n_fft // 16)]
    p = 16
    while 4 * p <= m:
        parts += [mult * np.arange(p) * (n_fft // (4 * p)) for mult in (1, 2, 3)]
        p *= 4
    if 2 * p == m:
        parts.append(2 * np.arange(p))
    parts.append(np.arange(m + 1))
    ang = -2.0 * np.pi * np.concatenate(parts) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle_rows(n_fft: int) -> int:
    return fft_twiddles(n_fft).shape[0]


def banded_fbank(fbank: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(bands, weights) of an (F, n_mels) filterbank: bands (n_mels, 3)
    int32 rows (lo, hi, offset), where [lo, hi) spans mel m's first to last
    nonzero bin (0, 0 for an all-zero filter) and weights[offset + f - lo]
    = fbank[f, m] for lo <= f < hi. Read from the given filterbank, so any
    filterbank keeps the exact function."""
    fbank = np.asarray(fbank, dtype=np.float32)
    bands = np.zeros((fbank.shape[1], 3), dtype=np.int32)
    runs, off = [], 0
    for mel in range(fbank.shape[1]):
        nz = np.flatnonzero(fbank[:, mel])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands[mel] = lo, hi, off
        runs.append(fbank[lo:hi, mel])
        off += hi - lo
    return bands, np.concatenate(runs).astype(np.float32)


@dataclass(frozen=True)
class LogMelTables:
    """What ``log_mel`` reads besides the waveform, for one spectrogram
    config on one device (``log_mel_tables``). ``cos``/``sin`` are kept for
    the CPU (plain version) and the DFT route only; ``window``,
    ``twiddles``, ``bands`` and ``weights`` for the FFT route only."""

    route: str
    n_fft: int
    hop: int
    fbank: torch.Tensor
    cos: torch.Tensor | None = None
    sin: torch.Tensor | None = None
    window: torch.Tensor | None = None
    twiddles: torch.Tensor | None = None
    bands: torch.Tensor | None = None
    weights: torch.Tensor | None = None


def log_mel_tables(cfg: SpectrogramConfig, device) -> LogMelTables:
    """Build the tables on the host once per config and move them to
    ``device``."""
    dev = torch.device(device)
    n_fft = cfg.filter_length
    route = log_mel_route(n_fft, cfg.n_mel_channels, cfg.hop_length)
    cos, sin, fbank = dft_mel_tables(cfg)
    tables = dict(route=route, n_fft=n_fft, hop=cfg.hop_length,
                  fbank=fbank.to(dev))
    if dev.type == "cpu" or route == "dft":
        tables.update(cos=cos.to(dev), sin=sin.to(dev))
    if route == "fft":
        bands, weights = banded_fbank(fbank.numpy())
        tables.update(window=_padded_window(cfg.win_length, n_fft).to(dev),
                      twiddles=torch.from_numpy(fft_twiddles(n_fft)).to(dev),
                      bands=torch.from_numpy(bands).to(dev),
                      weights=torch.from_numpy(weights).to(dev))
    return LogMelTables(**tables)


def log_mel_plain(wav: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  fbank: torch.Tensor, hop: int) -> torch.Tensor:
    """wav (B, samples) -> (B, samples // hop + 1, n_mels) log-mel: the
    tables as matmuls over the frames, PLAIN_CHUNK frames at a time, in the
    tables' dtype (fp32, or float64 for a reference)."""
    n_fft = cos.shape[0]
    frames = frame_signal(wav.to(cos.dtype), n_fft, hop)  # (B, T, n_fft)
    b, t, _ = frames.shape
    flat = frames.reshape(b * t, n_fft)
    out = torch.empty((b * t, fbank.shape[1]), dtype=cos.dtype,
                      device=wav.device)
    for i in range(0, b * t, PLAIN_CHUNK):
        chunk = flat[i:i + PLAIN_CHUNK]
        re, im = chunk @ cos, chunk @ sin
        mel = torch.sqrt(re * re + im * im) @ fbank
        out[i:i + PLAIN_CHUNK] = torch.log(torch.clamp(mel, min=LOG_CLIP_VAL))
    return out.reshape(b, t, -1)


def _check_wav(wav: torch.Tensor, n_fft: int) -> None:
    if wav.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {wav.device}")
    if wav.ndim != 2:
        raise ValueError(f"log_mel: wav must be (B, samples), got {tuple(wav.shape)}")
    _cuda.check(wav, "wav", dtype=torch.float32)
    if wav.shape[1] <= n_fft // 2:
        raise ValueError(f"log_mel: {wav.shape[1]} samples; reflect padding "
                         f"needs more than n_fft // 2 = {n_fft // 2}")


def log_mel(wav: torch.Tensor, tables: LogMelTables) -> torch.Tensor:
    """wav (B, samples) fp32 -> (B, samples // hop + 1, n_mels) fp32,
    through the kernel of ``tables.route`` (the plain version for a CPU
    tensor)."""
    if wav.device.type == "cpu":
        if tables.cos is None:
            raise ValueError(f"log_mel: the tables are on {tables.fbank.device}, "
                             f"the waveform on the CPU")
        return log_mel_plain(wav, tables.cos, tables.sin, tables.fbank, tables.hop)
    if tables.route == "dft":
        return log_mel_dft(wav, tables.cos, tables.sin, tables.fbank, tables.hop)
    n_fft, hop = tables.n_fft, tables.hop
    _check_wav(wav, n_fft)
    dev = wav.device
    n_freq, n_mels = tables.fbank.shape
    if log_mel_route(n_fft, n_mels, hop) != "fft" or n_freq != n_fft // 2 + 1:
        raise ValueError(f"log_mel: tables of n_fft {n_fft}, F {n_freq}, "
                         f"{n_mels} mels are not the FFT kernel's")
    _cuda.check(tables.window, "window", dtype=torch.float32, shape=(n_fft,),
                device=dev)
    _cuda.check(tables.twiddles, "twiddles", dtype=torch.float32,
                shape=(_twiddle_rows(n_fft), 2), device=dev)
    _cuda.check(tables.bands, "bands", dtype=torch.int32, shape=(n_mels, 3),
                device=dev)
    _cuda.check(tables.weights, "weights", dtype=torch.float32, device=dev)
    b, samples = wav.shape
    frames = num_frames(samples, hop)
    out = torch.empty((b, frames, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    if wav.numel() >= 2 ** 31:
        raise ValueError("log_mel: the batch must hold < 2**31 samples")
    pt = _cuda.ptr
    _cuda.launch("mqgan_log_mel", dev, pt(wav), pt(tables.window),
                 pt(tables.twiddles), pt(tables.bands), pt(tables.weights),
                 pt(out), b, frames, samples, hop, n_fft, n_mels)
    _cuda.COUNTERS.add("log_mel")
    return out


def log_mel_dft(wav: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                fbank: torch.Tensor, hop: int) -> torch.Tensor:
    """The DFT kernel: wav (B, samples) fp32 -> (B, samples // hop + 1,
    n_mels) fp32, for any even n_fft (``log_mel`` sends it the shapes the
    FFT kernel does not take)."""
    if wav.device.type == "cpu":
        return log_mel_plain(wav, cos, sin, fbank, hop)
    n_fft, n_freq = cos.shape
    n_mels = fbank.shape[1]
    log_mel_route(n_fft, n_mels, hop)
    _check_wav(wav, n_fft)
    dev = wav.device
    _cuda.check(cos, "cos", dtype=torch.float32, device=dev)
    _cuda.check(sin, "sin", dtype=torch.float32, shape=(n_fft, n_freq), device=dev)
    _cuda.check(fbank, "fbank", dtype=torch.float32, shape=(n_freq, n_mels),
                device=dev)
    if n_freq != n_fft // 2 + 1:
        raise ValueError(f"log_mel_dft: tables ({n_fft}, {n_freq}) must be "
                         f"(n_fft, n_fft // 2 + 1)")
    b, samples = wav.shape
    frames = num_frames(samples, hop)
    out = torch.empty((b, frames, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    pad = n_fft // 2
    wav_pad = F.pad(wav, (pad, pad), mode="reflect")
    if wav_pad.numel() >= 2 ** 31:
        raise ValueError("log_mel_dft: the padded batch must hold < 2**31 samples")
    pt = _cuda.ptr
    _cuda.launch("mqgan_log_mel_dft", dev, pt(wav_pad), pt(cos), pt(sin),
                 pt(fbank), pt(out), b, frames, wav_pad.shape[1], hop, n_fft,
                 n_freq, n_mels)
    _cuda.COUNTERS.add("log_mel_dft")
    return out
