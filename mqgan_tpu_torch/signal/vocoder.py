"""Vocoder feature-extractor wrapper, the reference's ``ISTFTNetFE``
(counterpart of ``mqgan_tpu/signal/vocoder.py``).

Wraps an iSTFTNet-style generator (mel (B, n_mels, T) -> (spec, phase),
each (B, F, T')) together with an inverse STFT:

  forward: wav = istft(gen(mel))       (B, 1, samples)
  infer:   int16 PCM via x 32768

The generator is any callable; a ``torch.nn.Module`` gets its input on the
device of its parameters.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mqgan_tpu_torch.signal.stft import TorchSTFT

MAX_WAV_VALUE = 32768.0  # the reference's int16 scale


class ISTFTNetFE:
    def __init__(self, gen: Callable | None, stft: TorchSTFT | None):
        self.gen = gen
        self.stft = stft
        self.sampling_rate = None

    def _generate(self, mel):
        mel = torch.as_tensor(mel, dtype=torch.float32)
        if isinstance(self.gen, torch.nn.Module):
            mel = mel.to(next(self.gen.parameters()).device)
        with torch.no_grad():
            return self.gen(mel)

    def __call__(self, mel) -> torch.Tensor:
        spec, phase = self._generate(mel)
        return self.stft.inverse(spec, phase)  # (B, 1, samples)

    forward = __call__

    def infer(self, mel) -> np.ndarray:
        """mel -> int16 PCM."""
        wav = self(mel).cpu().numpy().squeeze()
        return (wav * MAX_WAV_VALUE).astype(np.int16)

    def infer_cpuistft(self, mel) -> np.ndarray:
        """mel -> int16 PCM with the inverse STFT on the host CPU: the
        generator runs where its weights are, spec and phase come back to
        the host and the overlap-add runs there (the caller asks for the
        CPU; this is not a fallback)."""
        spec, phase = self._generate(mel)
        wav = self.stft.inverse(spec.cpu(), phase.cpu()).numpy().squeeze()
        return (wav * MAX_WAV_VALUE).astype(np.int16)

    def export_ts(self, out_dir: str, sampling_rate: int, mel_channels: int = 160,
                  example_frames: int = 600):
        raise NotImplementedError(
            "the vocoder artifact is a JAX StableHLO program; exporting and "
            "loading belong to the export slice, ROADMAP.md Queue 1 item 4")

    @classmethod
    def load_ts(cls, in_dir: str) -> "ISTFTNetFE":
        raise NotImplementedError(
            "the vocoder artifact is a JAX StableHLO program; exporting and "
            "loading belong to the export slice, ROADMAP.md Queue 1 item 4")
