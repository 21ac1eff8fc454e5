"""Mel inversion and Griffin-Lim phase recovery, the fallback vocoder
(counterpart of ``mqgan_tpu/signal/griffin_lim.py``).

Log-mels go back to linear magnitudes through the filterbank's
pseudo-inverse; the phase is recovered by fast (momentum) Griffin-Lim
iterations over ``signal/stft.py`` (cuFFT on the card), all on the device
of the input.
"""

from __future__ import annotations

import numpy as np
import torch

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.signal.mel import mel_filterbank
from mqgan_tpu_torch.signal.stft import istft, stft


def mel_pseudo_inverse(cfg: SpectrogramConfig) -> np.ndarray:
    """(n_mels, n_freqs) Moore-Penrose pseudo-inverse of the filterbank.
    The signed pinv is kept: clamping its negative lobes distorts the
    reconstruction badly; magnitudes are clamped after the projection."""
    return np.linalg.pinv(mel_filterbank(cfg)).astype(np.float32)


def log_mel_to_linear(log_mel: torch.Tensor, inv_fb: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) log-mel -> (B, F, T) linear magnitude."""
    mag = torch.exp(log_mel.float()) @ inv_fb  # undo log(clamp(mel, 1e-5))
    return torch.clamp(mag.transpose(-1, -2), min=0.0)


@torch.no_grad()
def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, n_iter: int = 32,
                momentum: float = 0.99) -> torch.Tensor:
    """Phase recovery from (B, F, T) magnitudes; returns (B, 1, samples)."""
    t = magnitude.shape[-1]
    angles = torch.zeros_like(magnitude)
    prev = torch.zeros(magnitude.shape, dtype=torch.complex64,
                       device=magnitude.device)
    for _ in range(n_iter):
        wav = istft(magnitude, angles, n_fft, hop_length, win_length)
        spec = stft(wav[:, 0, :], n_fft, hop_length, win_length)[:, :, :t]
        update = spec - (momentum / (1.0 + momentum)) * prev
        angles = torch.angle(update)
        prev = spec
    return istft(magnitude, angles, n_fft, hop_length, win_length)


class GriffinLimVocoder:
    """log-mel (B, T, n_mels) or (T, n_mels) -> waveform (B, 1, samples), on
    the device of the input."""

    def __init__(self, cfg: SpectrogramConfig, n_iter: int = 32):
        self.cfg = cfg
        self.n_iter = n_iter
        self._inv_fb = torch.from_numpy(mel_pseudo_inverse(cfg))

    def __call__(self, log_mel) -> torch.Tensor:
        log_mel = torch.as_tensor(log_mel)
        if log_mel.ndim == 2:
            log_mel = log_mel[None]
        mag = log_mel_to_linear(log_mel, self._inv_fb.to(log_mel.device))
        return griffin_lim(mag, self.cfg.filter_length, self.cfg.hop_length,
                           self.cfg.win_length, n_iter=self.n_iter)
