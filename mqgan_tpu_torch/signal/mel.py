"""Log-mel front end (counterpart of ``mqgan_tpu/signal/mel.py``), the
torchaudio ``MelSpectrogram`` of the reference converter:

    power=1.0 (magnitude), center=True reflect pad, Hann window,
    HTK mel scale, no filterbank norm, then log(clamp(mel, 1e-5)).

``MelFrontend`` runs the whole chain through ``ops/stft_kernels.py``
``log_mel``: on the card that is a hand-written kernel (an FFT for
power-of-two n_fft from 256 to 4096, else a DFT product), on the CPU the
plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.signal.stft import num_frames

LOG_CLIP_VAL = 1e-5  # the reference converter's clamp


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int) -> np.ndarray:
    """Triangular HTK-scale filterbank, (n_freqs, n_mels) float32, norm=None
    (``torchaudio.functional.melscale_fbanks(mel_scale="htk")``): FFT bin
    frequencies are linspace(0, sample_rate//2, n_freqs); mel points are
    n_mels+2 uniform points in HTK-mel between f_min and f_max. Built in
    float64, then cast."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = _hz_to_mel_htk(f_min)
    m_max = _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)

    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


def mel_filterbank(cfg: SpectrogramConfig) -> np.ndarray:
    return melscale_fbanks(
        n_freqs=cfg.n_freqs,
        f_min=cfg.mel_fmin,
        f_max=cfg.mel_fmax,
        n_mels=cfg.n_mel_channels,
        sample_rate=cfg.sampling_rate,
    )


class MelFrontend:
    """wav -> log-mel: (B, T_samples) -> (B, frames, n_mels), or
    (T_samples,) -> (frames, n_mels); time-major, like the JAX front end."""

    def __init__(self, cfg: SpectrogramConfig, device=None):
        """device: None means CUDA (raises without a card); pass "cpu"
        explicitly to run the plain PyTorch version on the CPU."""
        # imported here: ops/stft_kernels builds its tables from this module
        from mqgan_tpu_torch.ops.stft_kernels import log_mel_tables

        self.cfg = cfg
        self.device = resolve_device(device)
        self._tables = log_mel_tables(cfg, self.device)

    def __call__(self, wav) -> torch.Tensor:
        from mqgan_tpu_torch.ops.stft_kernels import log_mel

        wav = torch.as_tensor(wav, dtype=torch.float32, device=self.device)
        squeeze = wav.ndim == 1
        if squeeze:
            wav = wav[None]
        out = log_mel(wav.contiguous(), self._tables)
        return out[0] if squeeze else out

    def frames_for(self, num_samples: int) -> int:
        return num_frames(num_samples, self.cfg.hop_length)
