"""Fused |STFT| -> mel -> log front end (counterpart of
``mqgan_tpu/ops/stft_kernels.py``).

    out = log(max(|STFT(wav)| @ fbank, 1e-5))
    (center, reflect pad, periodic Hann window padded to n_fft, power 1)

Three CUDA kernels compute it; ``log_mel_route`` chooses one by shape,
before any launch, and each route launches its kernel or raises:

- ``"fft"`` (``csrc/log_mel.cu``, counter ``log_mel``), for power-of-two
  n_fft from 256 to 4096: an fp32 real FFT of each frame in shared memory,
  its magnitudes, the filterbank's bands, the log. Frames are read in place
  from the unpadded waveform (reflect padding in the index arithmetic).
- ``"mixed"`` (``csrc/log_mel_mixed.cu``, counter ``log_mel_mixed``), for
  the other even n_fft from 4 to 8192 whose n_fft / 2 has no prime factor
  above 7 (1200, 1000, 800, 480, 1764, 128, 8192, ...): the same design
  with Stockham passes of radix 4, 2, 3, 5 and 7 (``mixed_plan``).
- ``"dft"`` (``csrc/log_mel_dft.cu``, counter ``log_mel_dft``), for the
  rest (odd n_fft, a prime factor above 7, n_fft 2 or past 8192): the DFT
  as an fp32 product with cos/sin tables (the window folded in), frames
  read in place from the reflect-padded waveform.

Every route gives the frames of the JAX package's ``frame_signal``
(``frame_count``: one fewer than ``samples // hop + 1`` at an odd n_fft
where hop divides the samples). ``log_mel_plain`` is the plain PyTorch
version of the function (the DFT as matmuls); the wrappers take it only for
CPU tensors. Each kernel is an op, ``mqgan::log_mel``, ``mqgan::log_mel_mixed``
and ``mqgan::log_mel_dft``, whose CUDA implementation (``log_mel_kernel``,
``log_mel_mixed_kernel``, ``log_mel_dft_kernel``) launches it and whose CPU
implementation is ``log_mel_plain``. There is no separate front-end class
as in the JAX package (``PallasMelFrontend``): ``signal/mel.py``
``MelFrontend`` runs ``log_mel``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL, mel_filterbank
from mqgan_tpu_torch.signal.stft import _padded_window, frame_count, frame_signal

FFT_MIN, FFT_MAX = 256, 4096  # n_fft range of the FFT kernel (powers of two)
# n_fft range of the mixed-radix kernel (even): one butterfly pass at least,
# one frame of M = n_fft / 2 points in its 4096-point block at most
MIXED_MIN, MIXED_MAX = 4, 8192
MIXED_RADICES = (4, 2, 3, 5, 7)  # its passes' radices, in plan order
MIXED_BLOCK_POINTS = 2048  # its FFT points per block: whole frames up to this
MAX_MELS = 256  # all kernels: the DFT kernel's (64, n_mels) accumulator
PLAIN_CHUNK = 8192  # frames per matmul in the plain version


def mixed_radices(m: int) -> tuple[int, ...] | None:
    """The passes of an m-point mixed-radix FFT: radix 4 while 4 divides,
    then at most one 2, then 3s, 5s and 7s; None when m has a prime factor
    above 7."""
    radices = []
    for r in MIXED_RADICES:
        while m % r == 0:
            radices.append(r)
            m //= r
    return tuple(radices) if m == 1 else None


def log_mel_route(n_fft: int, n_mels: int, hop: int) -> str:
    """"fft", "mixed" or "dft": the kernel that computes this shape on the
    card; raises ValueError for a shape none takes."""
    if n_fft <= 0:
        raise ValueError(f"log_mel: n_fft {n_fft} must be positive")
    if not 0 < n_mels <= MAX_MELS or hop <= 0:
        raise ValueError(f"log_mel: n_mels {n_mels} (1..{MAX_MELS}) or hop "
                         f"{hop} out of range")
    if n_fft & (n_fft - 1) == 0 and FFT_MIN <= n_fft <= FFT_MAX:
        return "fft"
    if (n_fft % 2 == 0 and MIXED_MIN <= n_fft <= MIXED_MAX
            and mixed_radices(n_fft // 2) is not None):
        return "mixed"
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


def mixed_plan(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(plan, twiddles) of the mixed-radix kernel, M = n_fft / 2 points,
    W_L = exp(-2 pi i / L):

      plan      (P, 3) int32 rows (r, p, offset), one a pass in the order
                they run: radix r over sub-transforms of p points done so
                far (p = 1 for the first), its twiddles at ``offset``
      twiddles  (L, 2) fp32 (re, im): per pass after the first, W_rp^qk
                for q = 1 .. r - 1, k < p ((r - 1) runs of p); then M + 1
                entries W_n_fft^k, k <= M (the real-FFT split)

    Each entry is W_n_fft^q for an integer q, computed in float64 and cast."""
    m = n_fft // 2
    radices = mixed_radices(m)
    if not radices:
        raise ValueError(f"log_mel_mixed: n_fft {n_fft} has no mixed-radix plan")
    rows, parts, p, off = [], [], 1, 0
    for r in radices:
        rows.append((r, p, off))
        if p > 1:
            k = np.arange(p)
            parts += [q * k * (n_fft // (r * p)) for q in range(1, r)]
            off += (r - 1) * p
        p *= r
    parts.append(np.arange(m + 1))
    ang = -2.0 * np.pi * np.concatenate(parts) / n_fft
    return (np.asarray(rows, dtype=np.int32),
            np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32))


def mixed_frames(n_fft: int) -> int:
    """Frames a block of the mixed-radix kernel transforms: as many whole
    frames of n_fft / 2 points as MIXED_BLOCK_POINTS holds, at least one."""
    return max(1, MIXED_BLOCK_POINTS // (n_fft // 2))


@functools.lru_cache(maxsize=None)
def _mixed_rows(n_fft: int) -> tuple[int, int]:
    """(passes, twiddle rows) of ``mixed_plan(n_fft)``."""
    plan, tw = mixed_plan(n_fft)
    return plan.shape[0], tw.shape[0]


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
    ``twiddles``, ``bands`` and ``weights`` for the FFT and mixed routes
    (each route's own twiddles), ``plan`` for the mixed route only."""

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
    plan: torch.Tensor | None = None


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
    if route in ("fft", "mixed"):
        bands, weights = banded_fbank(fbank.numpy())
        if route == "fft":
            twiddles = fft_twiddles(n_fft)
        else:
            plan, twiddles = mixed_plan(n_fft)
            tables.update(plan=torch.from_numpy(plan).to(dev))
        tables.update(window=_padded_window(cfg.win_length, n_fft).to(dev),
                      twiddles=torch.from_numpy(twiddles).to(dev),
                      bands=torch.from_numpy(bands).to(dev),
                      weights=torch.from_numpy(weights).to(dev))
    return LogMelTables(**tables)


def log_mel_plain(wav: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  fbank: torch.Tensor, hop: int) -> torch.Tensor:
    """wav (B, samples) -> (B, frame_count(samples, n_fft, hop), n_mels)
    log-mel: the tables as matmuls over the frames, PLAIN_CHUNK frames at a
    time, in the tables' dtype (fp32, or float64 for a reference)."""
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


def log_mel_kernel(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                   sin: Optional[Tensor], window: Optional[Tensor],
                   twiddles: Optional[Tensor], bands: Optional[Tensor],
                   weights: Optional[Tensor], hop: int, n_fft: int) -> Tensor:
    """The FFT kernel on CUDA tensors (the op's CUDA implementation; it
    reads window, twiddles, bands, weights and fbank's shape)."""
    _check_wav(wav, n_fft)
    dev = wav.device
    n_freq, n_mels = fbank.shape
    if log_mel_route(n_fft, n_mels, hop) != "fft" or n_freq != n_fft // 2 + 1:
        raise ValueError(f"log_mel: tables of n_fft {n_fft}, F {n_freq}, "
                         f"{n_mels} mels are not the FFT kernel's")
    for name, t in (("window", window), ("twiddles", twiddles), ("bands", bands),
                    ("weights", weights)):
        if t is None:
            raise ValueError(f"log_mel: the FFT kernel needs its {name} table")
    _cuda.check(window, "window", dtype=torch.float32, shape=(n_fft,),
                device=dev)
    _cuda.check(twiddles, "twiddles", dtype=torch.float32,
                shape=(_twiddle_rows(n_fft), 2), device=dev)
    _cuda.check(bands, "bands", dtype=torch.int32, shape=(n_mels, 3),
                device=dev)
    _cuda.check(weights, "weights", dtype=torch.float32, device=dev)
    b, samples = wav.shape
    frames = frame_count(samples, n_fft, hop)
    out = torch.empty((b, frames, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    if wav.numel() >= 2 ** 31:
        raise ValueError("log_mel: the batch must hold < 2**31 samples")
    pt = _cuda.ptr
    _cuda.launch("mqgan_log_mel", dev, pt(wav), pt(window), pt(twiddles),
                 pt(bands), pt(weights), pt(out), b, frames, samples, hop,
                 n_fft, n_mels)
    _cuda.COUNTERS.add("log_mel")
    return out


def log_mel_mixed_kernel(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                         sin: Optional[Tensor], window: Tensor, plan: Tensor,
                         twiddles: Tensor, bands: Tensor, weights: Tensor,
                         hop: int, n_fft: int) -> Tensor:
    """The mixed-radix FFT kernel on CUDA tensors (the op's CUDA
    implementation; it reads window, plan, twiddles, bands, weights and
    fbank's shape)."""
    _check_wav(wav, n_fft)
    dev = wav.device
    n_freq, n_mels = fbank.shape
    if log_mel_route(n_fft, n_mels, hop) != "mixed" or n_freq != n_fft // 2 + 1:
        raise ValueError(f"log_mel_mixed: tables of n_fft {n_fft}, F {n_freq}, "
                         f"{n_mels} mels are not the mixed-radix kernel's")
    passes, rows = _mixed_rows(n_fft)
    _cuda.check(window, "window", dtype=torch.float32, shape=(n_fft,), device=dev)
    _cuda.check(plan, "plan", dtype=torch.int32, shape=(passes, 3), device=dev)
    _cuda.check(twiddles, "twiddles", dtype=torch.float32, shape=(rows, 2),
                device=dev)
    _cuda.check(bands, "bands", dtype=torch.int32, shape=(n_mels, 3), device=dev)
    _cuda.check(weights, "weights", dtype=torch.float32, device=dev)
    b, samples = wav.shape
    frames = frame_count(samples, n_fft, hop)
    out = torch.empty((b, frames, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    if wav.numel() >= 2 ** 31:
        raise ValueError("log_mel_mixed: the batch must hold < 2**31 samples")
    pt = _cuda.ptr
    _cuda.launch("mqgan_log_mel_mixed", dev, pt(wav), pt(window), pt(plan),
                 pt(twiddles), pt(bands), pt(weights), pt(out), b, frames,
                 samples, hop, n_fft, n_mels, passes, rows - n_freq,
                 mixed_frames(n_fft))
    _cuda.COUNTERS.add("log_mel_mixed")
    return out


def log_mel_dft_kernel(wav: Tensor, cos: Tensor, sin: Tensor, fbank: Tensor,
                       hop: int) -> Tensor:
    """The DFT kernel on CUDA tensors (the op's CUDA implementation)."""
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
    frames = frame_count(samples, n_fft, hop)
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


def _log_mel_cpu(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                 sin: Optional[Tensor], window: Optional[Tensor],
                 twiddles: Optional[Tensor], bands: Optional[Tensor],
                 weights: Optional[Tensor], hop: int, n_fft: int) -> Tensor:
    if cos is None or sin is None:
        raise ValueError("log_mel: the plain version needs the cos/sin tables")
    return log_mel_plain(wav, cos, sin, fbank, hop)


def _log_mel_mixed_cpu(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                       sin: Optional[Tensor], window: Tensor, plan: Tensor,
                       twiddles: Tensor, bands: Tensor, weights: Tensor, hop: int,
                       n_fft: int) -> Tensor:
    return _log_mel_cpu(wav, fbank, cos, sin, window, twiddles, bands, weights, hop,
                        n_fft)


def _log_mel_dft_cpu(wav: Tensor, cos: Tensor, sin: Tensor, fbank: Tensor,
                     hop: int) -> Tensor:
    return log_mel_plain(wav, cos, sin, fbank, hop)


def _log_mel_fake(wav, fbank, cos, *rest):
    hop, n_fft = rest[-2:]
    return wav.new_empty((wav.shape[0], frame_count(wav.shape[1], n_fft, hop),
                          fbank.shape[1]),
                         dtype=torch.float32 if cos is None else cos.dtype)


log_mel_op = _cuda.register_op("log_mel", _log_mel_cpu, log_mel_kernel,
                               _log_mel_fake)
log_mel_mixed_op = _cuda.register_op("log_mel_mixed", _log_mel_mixed_cpu,
                                     log_mel_mixed_kernel, _log_mel_fake)
log_mel_dft_op = _cuda.register_op(
    "log_mel_dft", _log_mel_dft_cpu, log_mel_dft_kernel,
    lambda wav, cos, sin, fbank, hop: wav.new_empty(
        (wav.shape[0], frame_count(wav.shape[1], cos.shape[0], hop), fbank.shape[1]),
        dtype=cos.dtype))


def log_mel(wav: Tensor, tables: LogMelTables) -> Tensor:
    """wav (B, samples) fp32 -> (B, frame_count(samples, n_fft, hop),
    n_mels) fp32, through the kernel of ``tables.route`` (the plain version
    for a CPU tensor)."""
    if wav.device.type == "cpu" and tables.cos is None:
        raise ValueError(f"log_mel: the tables are on {tables.fbank.device}, "
                         f"the waveform on the CPU")
    if wav.device.type == "cuda" and tables.route == "dft":
        return log_mel_dft(wav, tables.cos, tables.sin, tables.fbank, tables.hop)
    if wav.device.type == "cuda" and tables.route == "mixed":
        return log_mel_mixed(wav, tables.fbank, tables.cos, tables.sin, tables.window,
                             tables.plan, tables.twiddles, tables.bands,
                             tables.weights, tables.hop, tables.n_fft)
    _cuda.check_device("log_mel", wav)
    return _cuda.dispatch(log_mel_op, log_mel_kernel, wav, tables.fbank, tables.cos,
                          tables.sin, tables.window, tables.twiddles, tables.bands,
                          tables.weights, tables.hop, tables.n_fft)


def log_mel_mixed(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                  sin: Optional[Tensor], window: Tensor, plan: Tensor,
                  twiddles: Tensor, bands: Tensor, weights: Tensor, hop: int,
                  n_fft: int) -> Tensor:
    """The mixed-radix FFT kernel: wav (B, samples) fp32 -> (B, frames,
    n_mels) fp32, for the shapes ``log_mel_route`` gives "mixed" (the plain
    version, from cos/sin, for a CPU tensor)."""
    _cuda.check_device("log_mel_mixed", wav)
    return _cuda.dispatch(log_mel_mixed_op, log_mel_mixed_kernel, wav, fbank, cos, sin,
                          window, plan, twiddles, bands, weights, hop, n_fft)


def log_mel_dft(wav: Tensor, cos: Tensor, sin: Tensor, fbank: Tensor,
                hop: int) -> Tensor:
    """The DFT kernel: wav (B, samples) fp32 -> (B, frames, n_mels) fp32,
    for any n_fft (``log_mel`` sends it the shapes neither FFT kernel
    takes)."""
    _cuda.check_device("log_mel_dft", wav)
    return _cuda.dispatch(log_mel_dft_op, log_mel_dft_kernel, wav, cos, sin, fbank, hop)
