"""STFT / iSTFT with torch.stft / torch.istft semantics (counterpart of
``mqgan_tpu/signal/stft.py``).

center=True with reflect padding of n_fft//2 on both sides, a periodic Hann
window of win_length (zero-padded to n_fft, centred, when shorter), one-sided
FFT, no normalisation. ``istft`` overlap-adds the windowed frames, divides by
the squared-window envelope, trims n_fft//2 from each side and returns
(B, 1, samples), as the reference's ``TorchSTFT.inverse`` does.

``stft`` and ``istft`` call ``torch.stft`` / ``torch.istft`` (cuFFT on the
card), as the JAX package computes them through XLA's FFT: neither is a
kernel of the repository. The log-mel front end does not go through here;
it runs the hand-written log-mel kernels of ``ops/stft_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window (``torch.hann_window(win_length)``), computed in
    float64 and cast."""
    n = np.arange(win_length)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return torch.as_tensor(w.astype(np.float32), dtype=dtype, device=device)


def _padded_window(win_length: int, n_fft: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    w = hann_window(win_length, dtype, device)
    if win_length < n_fft:
        left = (n_fft - win_length) // 2
        w = F.pad(w, (left, n_fft - win_length - left))
    return w


def num_frames(num_samples: int, hop_length: int) -> int:
    """Frames of a centred STFT of num_samples samples."""
    return num_samples // hop_length + 1


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T_samples) -> (B, frames, n_fft) windowless frames (a strided
    view of the reflect-padded signal)."""
    pad = n_fft // 2
    x = F.pad(x, (pad, pad), mode="reflect")
    return x.unfold(-1, n_fft, hop_length)


def stft(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         win_length: int = 2048) -> torch.Tensor:
    """(B, T) real signal -> (B, n_fft//2+1, frames) complex64 (torch.stft's
    frequency-major layout)."""
    x = x.float()
    return torch.stft(x, n_fft, hop_length, win_length,
                      window=hann_window(win_length, device=x.device),
                      center=True, pad_mode="reflect", return_complex=True)


def stft_mag_phase(x, n_fft=2048, hop_length=512, win_length=2048):
    """(|stft|, angle(stft)), the reference ``TorchSTFT.transform``."""
    s = stft(x, n_fft, hop_length, win_length)
    return s.abs(), s.angle()


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int = 2048,
          hop_length: int = 512, win_length: int = 2048) -> torch.Tensor:
    """(B, F, frames) magnitude and phase -> (B, 1, samples)."""
    spec = torch.polar(magnitude.float(), phase.float())
    wav = torch.istft(spec, n_fft, hop_length, win_length,
                      window=hann_window(win_length, device=spec.device),
                      center=True)
    return wav[:, None, :]


class TorchSTFT:
    """The reference ``TorchSTFT`` interface (the JAX package's ``TPUSTFT``)
    for the vocoder path; the window is always the periodic Hann."""

    def __init__(self, filter_length=800, hop_length=200, win_length=800):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length

    def transform(self, x):
        return stft_mag_phase(x, self.filter_length, self.hop_length, self.win_length)

    def inverse(self, magnitude, phase):
        return istft(magnitude, phase, self.filter_length, self.hop_length,
                     self.win_length)

    def __call__(self, x):
        mag, ph = self.transform(x)
        return self.inverse(mag, ph)
