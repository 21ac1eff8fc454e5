"""STFT / iSTFT with torch.stft / torch.istft semantics (counterpart of
``mqgan_tpu/signal/stft.py``).

center=True with reflect padding of n_fft//2 on both sides, a periodic Hann
window of win_length (zero-padded to n_fft, centred, when shorter), one-sided
FFT, no normalisation. ``istft`` overlap-adds the windowed frames, divides by
the squared-window envelope, trims n_fft//2 from each side and returns
(B, 1, samples), as the reference's ``TorchSTFT.inverse`` does.

``stft`` and ``istft`` call ``torch.stft`` / ``torch.istft`` (cuFFT on the
card), as the JAX package computes them through XLA's FFT: neither is a
kernel of the repository. ``torch.istft`` checks the window envelope on the
host (a device-to-host read per call), so the training path uses
``istft_ola``: the JAX package's own overlap-add (irfft, window,
overlap-add, divide by the squared-window envelope, which is built once per
shape), differentiable and free of host reads; its output equals
``istft``'s. The log-mel front end does not go through here;
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


_WINDOWS: dict = {}


def _padded_window(win_length: int, n_fft: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """The Hann window zero-padded to n_fft, built once per (shape, dtype,
    device) and shared: a copy from the host to the card on every call
    would synchronise the host with the card. Callers must not write to
    it."""
    key = (win_length, n_fft, dtype, str(torch.device("cpu" if device is None
                                                      else device)))
    w = _WINDOWS.get(key)
    if w is None:
        w = hann_window(win_length, dtype, device)
        if win_length < n_fft:
            left = (n_fft - win_length) // 2
            w = F.pad(w, (left, n_fft - win_length - left))
        _WINDOWS[key] = w
    return w


def num_frames(num_samples: int, hop_length: int) -> int:
    """Frames of a centred STFT of num_samples samples."""
    return num_samples // hop_length + 1


def frame_count(num_samples: int, n_fft: int, hop_length: int) -> int:
    """Frames that ``frame_signal`` yields, as the JAX package's
    ``frame_signal`` does: (num_samples + 2 (n_fft // 2) - n_fft) // hop + 1.
    That is ``num_frames`` for an even n_fft and, for an odd one, one frame
    fewer where hop divides num_samples."""
    return (num_samples + 2 * (n_fft // 2) - n_fft) // hop_length + 1


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(B, T_samples) -> (B, frames, n_fft) windowless frames (a strided
    view of the reflect-padded signal)."""
    pad = n_fft // 2
    x = F.pad(x, (pad, pad), mode="reflect")
    return x.unfold(-1, n_fft, hop_length)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides, as ``np.pad`` /
    ``jnp.pad`` (mode "reflect") do, also where pad >= the length (the
    reflection repeats with period 2 (T - 1)); torch's own reflect padding
    takes pad < T only and is used there."""
    t = x.shape[-1]
    if pad < t:
        return F.pad(x, (pad, pad), mode="reflect")
    period = 2 * (t - 1)
    idx = torch.arange(-pad, t + pad, device=x.device).remainder(period)
    return x.index_select(-1, torch.where(idx >= t, period - idx, idx))


def stft(x: torch.Tensor, n_fft: int = 2048, hop_length: int = 512,
         win_length: int = 2048) -> torch.Tensor:
    """(B, T) real signal -> (B, n_fft//2+1, frames) complex64 (torch.stft's
    frequency-major layout); centred with ``reflect_pad``, so a signal
    shorter than n_fft//2 + 1 samples is framed as the JAX package frames
    it."""
    x = reflect_pad(x.float(), n_fft // 2)
    return torch.stft(x, n_fft, hop_length, win_length,
                      window=_padded_window(win_length, win_length, device=x.device),
                      center=False, return_complex=True)


def stft_mag_phase(x, n_fft=2048, hop_length=512, win_length=2048):
    """(|stft|, angle(stft)), the reference ``TorchSTFT.transform``."""
    s = stft(x, n_fft, hop_length, win_length)
    return s.abs(), s.angle()


def istft(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int = 2048,
          hop_length: int = 512, win_length: int = 2048) -> torch.Tensor:
    """(B, F, frames) magnitude and phase -> (B, 1, samples)."""
    spec = torch.polar(magnitude.float(), phase.float())
    wav = torch.istft(spec, n_fft, hop_length, win_length,
                      window=_padded_window(win_length, win_length,
                                            device=spec.device),
                      center=True)
    return wav[:, None, :]


_ENVELOPES: dict = {}


def _envelope(n_fft: int, hop_length: int, win_length: int, n: int,
              device) -> torch.Tensor:
    """1 / max(env, 1e-11) of n frames, trimmed by n_fft//2 at each end
    (the squared-window overlap-add; cached per shape and device)."""
    key = (n_fft, hop_length, win_length, n, str(device))
    inv = _ENVELOPES.get(key)
    if inv is None:
        w2 = _padded_window(win_length, n_fft, device=device) ** 2
        env = _overlap_add(w2.expand(1, n, n_fft), hop_length)[0]
        pad = n_fft // 2
        inv = 1.0 / env[pad: env.shape[0] - pad].clamp_min(1e-11)
        _ENVELOPES[key] = inv
    return inv


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, N, n_fft) frames -> (B, n_fft + hop * (N - 1)) sums."""
    b, n, n_fft = frames.shape
    out_len = n_fft + hop_length * (n - 1)
    return F.fold(frames.transpose(1, 2), output_size=(1, out_len),
                  kernel_size=(1, n_fft), stride=(1, hop_length)).reshape(b, out_len)


def istft_ola(magnitude: torch.Tensor, phase: torch.Tensor, n_fft: int = 2048,
              hop_length: int = 512, win_length: int = 2048) -> torch.Tensor:
    """``istft`` as the JAX package computes it (``mqgan_tpu/signal/stft.py``
    ``istft``): (B, F, frames) -> (B, samples) without the channel axis,
    differentiable, with no host read. Frames where the envelope is below
    1e-11 divide by 1e-11, as in JAX, where ``torch.istft`` raises."""
    spec = torch.polar(magnitude.float(), phase.float())
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)
    w = _padded_window(win_length, n_fft, device=frames.device)
    sig = _overlap_add(frames * w, hop_length)
    pad = n_fft // 2
    sig = sig[:, pad: sig.shape[1] - pad]
    return sig * _envelope(n_fft, hop_length, win_length, frames.shape[1],
                           frames.device)


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
