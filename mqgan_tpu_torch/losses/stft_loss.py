"""Multi-resolution STFT loss for vocoder training (counterpart of
``mqgan_tpu/losses/stft_loss.py``).

L = mean over resolutions of [spectral convergence + log-magnitude L1], on
fp32 magnitudes of ``signal/stft.py`` ``stft`` (``torch.stft``, cuFFT on
the card; the JAX package uses ``jnp.fft`` there, not a kernel). At an
exact zero of |STFT| the gradient is 0 in both frameworks.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from mqgan_tpu_torch.signal.stft import stft

DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (512, 128, 512),
    (1024, 256, 1024),
    (2048, 512, 2048),
)


def _stft_mag(x: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    return stft(x.float(), n_fft, hop, win).abs()


def spectral_convergence(mag_pred: torch.Tensor, mag_true: torch.Tensor) -> torch.Tensor:
    num = torch.sqrt(torch.sum(torch.square(mag_true - mag_pred)))
    den = torch.sqrt(torch.sum(torch.square(mag_true))) + 1e-7
    return num / den


def log_magnitude_l1(mag_pred: torch.Tensor, mag_true: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(torch.log(mag_true + 1e-7)
                                - torch.log(mag_pred + 1e-7)))


def multi_resolution_stft_loss(
        wav_pred: torch.Tensor, wav_true: torch.Tensor,
        resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS
) -> torch.Tensor:
    """(B, T_samples) prediction and target -> the fp32 scalar loss."""
    total = torch.zeros((), dtype=torch.float32, device=wav_pred.device)
    for n_fft, hop, win in resolutions:
        mp = _stft_mag(wav_pred, n_fft, hop, win)
        mt = _stft_mag(wav_true, n_fft, hop, win)
        total = total + spectral_convergence(mp, mt) + log_magnitude_l1(mp, mt)
    return total / len(resolutions)
