"""Fused |STFT| -> mel -> log front end (counterpart of
``mqgan_tpu/ops/stft_kernels.py``).

    out = log(max(|STFT(wav)| @ fbank, 1e-5))
    (center, reflect pad, periodic Hann window padded to n_fft, power 1)

Four CUDA kernels compute it; ``log_mel_route`` chooses one by shape,
before any launch, and each route launches its kernel or raises:

- ``"fft"`` (``csrc/log_mel.cu``, counter ``log_mel``), for power-of-two
  n_fft from 256 to 4096: an fp32 real FFT of each frame in shared memory,
  its magnitudes, the filterbank's bands, the log. Frames are read in place
  from the unpadded waveform (reflect padding in the index arithmetic).
- ``"mixed"`` (``csrc/log_mel_mixed.cu``, counter ``log_mel_mixed``), for
  the other even n_fft from 4 to 8192 whose n_fft / 2 has no prime factor
  above 7 (1200, 1000, 800, 480, 1764, 128, 8192, ...): the same design
  with Stockham passes of radix 4, 2, 3, 5 and 7 (``mixed_plan``).
- ``"bluestein"`` (``csrc/log_mel_bluestein.cu``, counter
  ``log_mel_bluestein``), for the other n_fft from 3 whose chirp-z length
  L fits the kernel's BLUESTEIN_MAX_POINTS = 14406 points: every odd n_fft
  to 9603 (1201, ...), every other even n_fft to 14406 (2050, 1144, 88,
  10000, ...). Bluestein's chirp-z transform: the frame times a chirp, an
  L-point circular convolution with the conjugate chirp by two in-place
  mixed-radix FFTs (radix 4, 2, 3, 5, 7; L chosen by ``bluestein_length``,
  tables by ``bluestein_plan``), the chirp again; the chirp-z stage in
  fp64, the real-FFT split (even n_fft), magnitudes, bands and log in
  fp32, one frame at a time.
- ``"dft"`` (``csrc/log_mel_dft.cu``, counter ``log_mel_dft``), for the
  rest (n_fft 1 and 2, odd n_fft past 9603, even n_fft past 14406): the
  DFT as an fp32 product with cos/sin tables (the window folded in),
  frames read in place from the reflect-padded waveform.

Every route gives the frames of the JAX package's ``frame_signal``
(``frame_count``: one fewer than ``samples // hop + 1`` at an odd n_fft
where hop divides the samples). ``log_mel_plain`` is the plain PyTorch
version of the function (the DFT as matmuls); the wrappers take it only for
CPU tensors. Each kernel is an op, ``mqgan::log_mel``, ``mqgan::log_mel_mixed``,
``mqgan::log_mel_bluestein`` and ``mqgan::log_mel_dft``, whose CUDA
implementation (``log_mel_kernel``, ``log_mel_mixed_kernel``,
``log_mel_bluestein_kernel``, ``log_mel_dft_kernel``) launches it and whose
CPU implementation is ``log_mel_plain``. There is no separate front-end class
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
# the Bluestein kernel: n_fft from 3; L points of its frames in one block,
# one fp64 buffer of 16 B a point (225 KB at 14406), at most
BLUESTEIN_MIN, BLUESTEIN_MAX_POINTS = 3, 14406
BLUESTEIN_BLOCK_POINTS = 2048  # its L points per block: whole frames up to this
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


def bluestein_sizes(n_fft: int) -> tuple[int, int, int]:
    """(M, K, least L) of the Bluestein kernel's chirp-z transform: for an
    even n_fft the M = n_fft / 2 point complex DFT of the real-FFT split,
    all K = M outputs; for an odd one the M = n_fft point DFT of the real
    samples, its K = n_fft // 2 + 1 bins. The L-point circular convolution
    wraps onto no output when L >= M + K - 1."""
    m = n_fft // 2 if n_fft % 2 == 0 else n_fft
    k = m if n_fft % 2 == 0 else n_fft // 2 + 1
    return m, k, m + k - 1


def _least_smooth(n: int) -> int:
    """The least length at or above n with no prime factor above 7."""
    while mixed_radices(n) is None:
        n += 1
    return n


@functools.lru_cache(maxsize=None)
def bluestein_length(n_fft: int) -> int:
    """L of the Bluestein kernel at n_fft: of the lengths with no prime
    factor above 7 from the minimum (``bluestein_sizes``) up to 1.25 times
    it and BLUESTEIN_MAX_POINTS, the one of fewest point-passes L P (P its
    passes, ``mixed_radices``: each moves the frame through shared memory
    once and ends at a barrier), the shortest of equal count. On an H100
    this chose the fastest of 17 candidates at n_fft 2050 (2401 = 7^4) and
    at 1201 (1875 = 3 5^4) (tools/log_mel_bluestein_times.py, PERF.md row
    4c)."""
    least = bluestein_sizes(n_fft)[2]
    top = max(_least_smooth(least), min(int(1.25 * least), BLUESTEIN_MAX_POINTS))
    return min((n for n in range(least, top + 1) if mixed_radices(n) is not None),
               key=lambda n: (n * len(mixed_radices(n)), n))


def log_mel_route(n_fft: int, n_mels: int, hop: int) -> str:
    """"fft", "mixed", "bluestein" or "dft": the kernel that computes this
    shape on the card; raises ValueError for a shape none takes."""
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
    if (n_fft >= BLUESTEIN_MIN
            and _least_smooth(bluestein_sizes(n_fft)[2]) <= BLUESTEIN_MAX_POINTS):
        return "bluestein"
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


@dataclass(frozen=True)
class BluesteinPlan:
    """The Bluestein kernel's tables at one n_fft (``bluestein_plan``),
    computed in float64: the chirp-z stage's stay float64 (the kernel runs
    that stage in fp64), the real-FFT split's are cast to fp32 once. M, K
    and L as in ``bluestein_sizes``; c[n] = exp(-i pi (n^2 mod 2M) / M), the
    chirp, with n^2 mod 2M taken in int64; W_S = exp(-2 pi i / S).

      length    L
      plan      (P, 3) int32 rows (r, N, offset), one an in-place pass of
                the forward FFT in the order it runs (decimation in
                frequency; the inverse runs them backwards): radix r over
                sub-transforms of S = r N points, N = L / (r_1 ... r_s)
      twiddles  (rows, 2) float64 (re, im): for each pass but the last (N
                = 1), W_S^n' for n' < N at its row's offset
      split     (M + 1, 2) fp32 W_n_fft^k, k <= M, at an even n_fft (the
                real-FFT split); (0, 2) at an odd one
      premul    float64, what multiplies the samples as they load: at an
                even n_fft (M, 4), the complex pair (w[2n] c[n], i w[2n+1]
                c[n]), so a[n] = x[2n] P0 + x[2n+1] P1 = (x[2n] w[2n] + i
                x[2n+1] w[2n+1]) c[n]; at an odd one (M, 2), w[n] c[n]; w the
                window (ones when none is given)
      chirp     (M, 2) float64 c[n], the post-multiply (the even route's)
      spectrum  (L, 2) float64 FFT_L(b) / L of the filter b[j] = conj c[j],
                j < K, b[L - j] = conj c[j], 0 < j < M, zero elsewhere; bin
                k at ``digit_reversed(L)[k]``, where the forward FFT leaves
                it"""

    length: int
    plan: np.ndarray
    twiddles: np.ndarray
    split: np.ndarray
    premul: np.ndarray
    chirp: np.ndarray
    spectrum: np.ndarray


def _pairs(z: np.ndarray, dtype=np.float64) -> np.ndarray:
    """complex (..., n) -> (..., n, 2) (re, im) of ``dtype``"""
    return np.stack([z.real, z.imag], axis=-1).astype(dtype)


def _in_place_passes(length: int) -> list[tuple[int, int]]:
    """(r, N) of the L-point in-place passes, radices as ``mixed_radices``."""
    rows, n = [], length
    for r in mixed_radices(length):
        n //= r
        rows.append((r, n))
    return rows


def digit_reversed(length: int) -> np.ndarray:
    """pos[k]: where the L-point forward FFT (decimation in frequency, in
    place) leaves bin k = k_1 + r_1 (k_2 + r_2 (...)): sum_s k_s N_s."""
    k, pos = np.arange(length), np.zeros(length, dtype=np.int64)
    for r, n in _in_place_passes(length):
        pos += (k % r) * n
        k //= r
    return pos


def bluestein_plan(n_fft: int, window: np.ndarray | None = None,
                   length: int | None = None) -> BluesteinPlan:
    """The tables of the Bluestein kernel at n_fft, with the (fp32) window
    folded into ``premul``; ``length`` overrides ``bluestein_length`` (it
    must have no prime factor above 7 and be at least the minimum)."""
    m, k, least = bluestein_sizes(n_fft)
    length = bluestein_length(n_fft) if length is None else length
    if n_fft < BLUESTEIN_MIN or length < least or mixed_radices(length) is None:
        raise ValueError(f"log_mel_bluestein: no plan of {length} points at n_fft "
                         f"{n_fft} (7-smooth, >= {least})")
    rows, parts, off = [], [], 0
    for r, n in _in_place_passes(length):
        rows.append((r, n, off))
        if n > 1:
            parts.append(np.exp(-2j * np.pi * np.arange(n) / (r * n)))
            off += n
    n = np.arange(m, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((n * n) % (2 * m)) / m)
    w = (np.ones(n_fft) if window is None
         else np.asarray(window, dtype=np.float32).astype(np.float64))
    if n_fft % 2 == 0:
        premul = np.stack([w[0::2] * chirp, 1j * w[1::2] * chirp], axis=1)
        split = np.exp(-2j * np.pi * np.arange(m + 1) / n_fft)
    else:
        premul, split = w * chirp, np.zeros(0)
    filt = np.zeros(length, dtype=np.complex128)
    filt[:k] = np.conj(chirp[:k])
    filt[length - np.arange(1, m)] = np.conj(chirp[1:])
    spectrum = np.empty(length, dtype=np.complex128)
    spectrum[digit_reversed(length)] = np.fft.fft(filt) / length
    return BluesteinPlan(length, np.asarray(rows, dtype=np.int32),
                         _pairs(np.concatenate(parts + [np.zeros(0)])),
                         _pairs(split, np.float32), _pairs(premul).reshape(m, -1),
                         _pairs(chirp), _pairs(spectrum))


def bluestein_frames(length: int) -> int:
    """Frames a block of the Bluestein kernel transforms: as many whole
    frames of L points as BLUESTEIN_BLOCK_POINTS holds, at least one."""
    return max(1, BLUESTEIN_BLOCK_POINTS // length)


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
    the CPU (plain version) and the DFT route only; ``bands`` and
    ``weights`` for the FFT, mixed and Bluestein routes, ``twiddles`` and
    ``plan`` for each of them that has its own (the FFT route no plan),
    ``window`` for the FFT and mixed routes; ``premul``, ``chirp``,
    ``spectrum`` and ``split`` for the Bluestein route only
    (``BluesteinPlan``)."""

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
    premul: torch.Tensor | None = None
    chirp: torch.Tensor | None = None
    spectrum: torch.Tensor | None = None
    split: torch.Tensor | None = None


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
    if route == "dft":
        return LogMelTables(**tables)
    bands, weights = banded_fbank(fbank.numpy())
    tables.update(bands=torch.from_numpy(bands).to(dev),
                  weights=torch.from_numpy(weights).to(dev))
    window = _padded_window(cfg.win_length, n_fft)
    if route == "bluestein":
        tables.update(bluestein_tensors(bluestein_plan(n_fft, window.numpy()), dev))
        return LogMelTables(**tables)
    if route == "fft":
        twiddles = fft_twiddles(n_fft)
    else:
        plan, twiddles = mixed_plan(n_fft)
        tables.update(plan=torch.from_numpy(plan).to(dev))
    tables.update(window=window.to(dev), twiddles=torch.from_numpy(twiddles).to(dev))
    return LogMelTables(**tables)


def bluestein_tensors(plan: BluesteinPlan, device) -> dict:
    """A Bluestein plan's tables as the ``LogMelTables`` fields the kernel
    reads, on ``device``."""
    return {name: torch.from_numpy(getattr(plan, name)).to(device)
            for name in ("plan", "twiddles", "premul", "chirp", "spectrum", "split")}


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


@functools.lru_cache(maxsize=None)
def _bluestein_rows(length: int) -> tuple[int, int]:
    """(passes, twiddle rows) of the L-point in-place plan."""
    passes = _in_place_passes(length)
    return len(passes), sum(n for _, n in passes if n > 1)


def log_mel_bluestein_kernel(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                             sin: Optional[Tensor], premul: Tensor, chirp: Tensor,
                             plan: Tensor, twiddles: Tensor, spectrum: Tensor,
                             split: Tensor, bands: Tensor, weights: Tensor, hop: int,
                             n_fft: int) -> Tensor:
    """The Bluestein kernel on CUDA tensors (the op's CUDA implementation;
    it reads premul, chirp, plan, twiddles, spectrum, split, bands, weights
    and fbank's shape; L is the spectrum's length)."""
    _check_wav(wav, n_fft)
    dev = wav.device
    n_freq, n_mels = fbank.shape
    if (log_mel_route(n_fft, n_mels, hop) != "bluestein"
            or n_freq != n_fft // 2 + 1):
        raise ValueError(f"log_mel_bluestein: tables of n_fft {n_fft}, F {n_freq}, "
                         f"{n_mels} mels are not the Bluestein kernel's")
    m, _, least = bluestein_sizes(n_fft)
    length = spectrum.shape[0]
    frames = bluestein_frames(length)
    if (length < least or mixed_radices(length) is None
            or frames * length > BLUESTEIN_MAX_POINTS):
        raise ValueError(f"log_mel_bluestein: L {length} at n_fft {n_fft} (7-smooth, "
                         f">= {least}, <= {BLUESTEIN_MAX_POINTS})")
    passes, rows = _bluestein_rows(length)
    odd = n_fft % 2
    f64 = torch.float64
    _cuda.check(premul, "premul", dtype=f64, shape=(m, 2 if odd else 4), device=dev)
    _cuda.check(chirp, "chirp", dtype=f64, shape=(m, 2), device=dev)
    _cuda.check(plan, "plan", dtype=torch.int32, shape=(passes, 3), device=dev)
    _cuda.check(twiddles, "twiddles", dtype=f64, shape=(rows, 2), device=dev)
    _cuda.check(spectrum, "spectrum", dtype=f64, shape=(length, 2), device=dev)
    _cuda.check(split, "split", dtype=torch.float32, shape=(0 if odd else m + 1, 2),
                device=dev)
    _cuda.check(bands, "bands", dtype=torch.int32, shape=(n_mels, 3), device=dev)
    _cuda.check(weights, "weights", dtype=torch.float32, device=dev)
    b, samples = wav.shape
    count = frame_count(samples, n_fft, hop)
    out = torch.empty((b, count, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    if wav.numel() >= 2 ** 31:
        raise ValueError("log_mel_bluestein: the batch must hold < 2**31 samples")
    pt = _cuda.ptr
    _cuda.launch("mqgan_log_mel_bluestein", dev, pt(wav), pt(premul), pt(chirp),
                 pt(plan), pt(twiddles), pt(spectrum), pt(split), pt(bands),
                 pt(weights), pt(out), b, count, samples, hop, n_fft, n_mels, length,
                 passes, frames)
    _cuda.COUNTERS.add("log_mel_bluestein")
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


def _log_mel_bluestein_cpu(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                           sin: Optional[Tensor], premul: Tensor, chirp: Tensor,
                           plan: Tensor, twiddles: Tensor, spectrum: Tensor,
                           split: Tensor, bands: Tensor, weights: Tensor, hop: int,
                           n_fft: int) -> Tensor:
    return _log_mel_cpu(wav, fbank, cos, sin, None, None, None, None, hop, n_fft)


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
log_mel_bluestein_op = _cuda.register_op("log_mel_bluestein", _log_mel_bluestein_cpu,
                                         log_mel_bluestein_kernel, _log_mel_fake)
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
    if wav.device.type == "cuda" and tables.route == "bluestein":
        return log_mel_bluestein(wav, tables.fbank, tables.cos, tables.sin, tables.premul,
                                 tables.chirp, tables.plan, tables.twiddles,
                                 tables.spectrum, tables.split, tables.bands,
                                 tables.weights, tables.hop, tables.n_fft)
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


def log_mel_bluestein(wav: Tensor, fbank: Tensor, cos: Optional[Tensor],
                      sin: Optional[Tensor], premul: Tensor, chirp: Tensor, plan: Tensor,
                      twiddles: Tensor, spectrum: Tensor, split: Tensor, bands: Tensor,
                      weights: Tensor, hop: int, n_fft: int) -> Tensor:
    """The Bluestein kernel: wav (B, samples) fp32 -> (B, frames, n_mels)
    fp32, for the shapes ``log_mel_route`` gives "bluestein" (the plain
    version, from cos/sin, for a CPU tensor)."""
    _cuda.check_device("log_mel_bluestein", wav)
    return _cuda.dispatch(log_mel_bluestein_op, log_mel_bluestein_kernel, wav, fbank,
                          cos, sin, premul, chirp, plan, twiddles, spectrum, split,
                          bands, weights, hop, n_fft)


def log_mel_dft(wav: Tensor, cos: Tensor, sin: Tensor, fbank: Tensor,
                hop: int) -> Tensor:
    """The DFT kernel: wav (B, samples) fp32 -> (B, frames, n_mels) fp32,
    for any n_fft (``log_mel`` sends it the shapes neither FFT kernel
    takes)."""
    _cuda.check_device("log_mel_dft", wav)
    return _cuda.dispatch(log_mel_dft_op, log_mel_dft_kernel, wav, cos, sin, fbank, hop)
