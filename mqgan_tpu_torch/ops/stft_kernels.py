"""Fused DFT -> |.| -> mel -> log front end (counterpart of
``mqgan_tpu/ops/stft_kernels.py``).

    re  = frames @ cos,  im = frames @ sin     (window folded into the tables)
    out = log(max(sqrt(re^2 + im^2) @ fbank, 1e-5))

``log_mel`` launches the CUDA kernel (``csrc/log_mel.cu``) on a CUDA tensor
and takes the plain PyTorch version ``log_mel_plain`` only for a CPU tensor.
There is no separate front-end class as in the JAX package
(``PallasMelFrontend``): the kernel computes exactly the function of
``signal/mel.py`` ``MelFrontend``, which runs it on the card.

The tables are not padded to lane multiples as the TPU kernel's are: the
kernel handles F = n_fft//2 + 1 with bounds checks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from mqgan_tpu_torch.core.config import SpectrogramConfig
from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL, mel_filterbank
from mqgan_tpu_torch.signal.stft import _padded_window, frame_signal, num_frames

TILE_K = 16  # the kernel's DFT stage depth: n_fft must be a multiple
MAX_MELS = 256  # the kernel's (64, n_mels) fp32 accumulator in shared memory
PLAIN_CHUNK = 8192  # frames per matmul in the plain version


def dft_mel_tables(cfg: SpectrogramConfig):
    """(cos, sin, fbank) fp32 CPU tensors: cos/sin (n_fft, F) with the
    window folded in, built in float64 and then cast; fbank (F, n_mels)."""
    n_fft = cfg.filter_length
    n = np.arange(n_fft)[:, None]
    k = np.arange(cfg.n_freqs)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    win = _padded_window(cfg.win_length, n_fft).numpy()[:, None]
    cos = (np.cos(ang) * win).astype(np.float32)
    sin = (np.sin(ang) * win).astype(np.float32)
    return (torch.from_numpy(cos), torch.from_numpy(sin),
            torch.from_numpy(mel_filterbank(cfg)))


def log_mel_plain(wav: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  fbank: torch.Tensor, hop: int) -> torch.Tensor:
    """wav (B, samples) fp32 -> (B, samples // hop + 1, n_mels) log-mel:
    the tables as fp32 matmuls over the frames, PLAIN_CHUNK frames at a
    time."""
    n_fft = cos.shape[0]
    frames = frame_signal(wav.float(), n_fft, hop)  # (B, T, n_fft)
    b, t, _ = frames.shape
    flat = frames.reshape(b * t, n_fft)
    out = torch.empty((b * t, fbank.shape[1]), dtype=torch.float32,
                      device=wav.device)
    for i in range(0, b * t, PLAIN_CHUNK):
        chunk = flat[i:i + PLAIN_CHUNK]
        re, im = chunk @ cos, chunk @ sin
        mel = torch.sqrt(re * re + im * im) @ fbank
        out[i:i + PLAIN_CHUNK] = torch.log(torch.clamp(mel, min=LOG_CLIP_VAL))
    return out.reshape(b, t, -1)


def log_mel(wav: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
            fbank: torch.Tensor, hop: int) -> torch.Tensor:
    """wav (B, samples) fp32 -> (B, samples // hop + 1, n_mels) fp32."""
    if wav.device.type == "cpu":
        return log_mel_plain(wav, cos, sin, fbank, hop)
    if wav.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {wav.device}")
    n_fft, n_freq = cos.shape
    n_mels = fbank.shape[1]
    dev = wav.device
    if wav.ndim != 2:
        raise ValueError(f"log_mel: wav must be (B, samples), got {tuple(wav.shape)}")
    _cuda.check(wav, "wav", dtype=torch.float32)
    _cuda.check(cos, "cos", dtype=torch.float32, device=dev)
    _cuda.check(sin, "sin", dtype=torch.float32, shape=(n_fft, n_freq), device=dev)
    _cuda.check(fbank, "fbank", dtype=torch.float32, shape=(n_freq, n_mels),
                device=dev)
    if n_fft % TILE_K or n_freq != n_fft // 2 + 1:
        raise ValueError(f"log_mel: n_fft {n_fft} must be a multiple of "
                         f"{TILE_K} and the tables (n_fft, n_fft//2 + 1)")
    if not 0 < n_mels <= MAX_MELS or hop <= 0:
        raise ValueError(f"log_mel: n_mels {n_mels} (1..{MAX_MELS}) or hop "
                         f"{hop} out of range")
    b, samples = wav.shape
    frames = num_frames(samples, hop)
    out = torch.empty((b, frames, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    pad = n_fft // 2
    wav_pad = F.pad(wav, (pad, pad), mode="reflect")
    if wav_pad.numel() >= 2 ** 31:
        raise ValueError("log_mel: the padded batch must hold < 2**31 samples")
    pt = _cuda.ptr
    _cuda.launch("mqgan_log_mel", dev, pt(wav_pad), pt(cos), pt(sin),
                 pt(fbank), pt(out), b, frames, wav_pad.shape[1], hop, n_fft,
                 n_freq, n_mels)
    _cuda.COUNTERS.add("log_mel")
    return out
