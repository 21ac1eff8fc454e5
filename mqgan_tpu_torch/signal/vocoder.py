"""Vocoder feature-extractor wrapper, the reference's ``ISTFTNetFE``
(counterpart of ``mqgan_tpu/signal/vocoder.py``).

Wraps an iSTFTNet-style generator (mel (B, n_mels, T) -> (spec, phase),
each (B, F, T')) together with an inverse STFT:

  forward: wav = istft(gen(mel))       (B, 1, samples)
  infer:   int16 PCM via x 32768
  export_ts / load_ts: the port's artifact, ``config.json`` (the JAX
      artifact's keys, plus the generator's hyperparameters under
      "generator") and the generator's fp32 ``weights.pt``

The generator is any callable; a ``torch.nn.Module`` gets its input on the
device of its parameters. The artifact vocodes any batch and length, as the
JAX artifact's symbolic (b, t) does; a JAX artifact (``istft_gen.shlo``, a
StableHLO program) cannot run in PyTorch and ``load_ts`` refuses it.
"""

from __future__ import annotations

from typing import Callable

import json
import os

import numpy as np
import torch

from mqgan_tpu_torch.signal.stft import TorchSTFT

MAX_WAV_VALUE = 32768.0  # the reference's int16 scale
CONFIG_NAME = "config.json"
WEIGHTS_NAME = "weights.pt"
JAX_PROGRAM_NAME = "istft_gen.shlo"


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
        """Write the artifact of this wrapper's ``ISTFTNetGenerator``.
        example_frames is kept for the reference API: the artifact vocodes
        any length."""
        del example_frames
        config = getattr(self.gen, "config", None)
        if config is None:
            raise TypeError("export_ts needs an ISTFTNetGenerator as gen, got "
                            f"{type(self.gen).__name__}")
        os.makedirs(out_dir, exist_ok=True)
        torch.save({k: v.detach().float().cpu()
                    for k, v in self.gen.state_dict().items()},
                   os.path.join(out_dir, WEIGHTS_NAME))
        cfg = {
            "gen_istft_n_fft": self.stft.filter_length,
            "gen_istft_hop_size": self.stft.hop_length,
            "gen_istft_win_length": self.stft.win_length,
            "sampling_rate": sampling_rate,
            "mel_channels": mel_channels,
            "generator": config(),
            "weights": WEIGHTS_NAME,
        }
        with open(os.path.join(out_dir, CONFIG_NAME), "w") as f:
            json.dump(cfg, f, indent=2)
        return out_dir

    @classmethod
    def load_ts(cls, in_dir: str, device=None) -> "ISTFTNetFE":
        """The wrapper of an ``export_ts`` directory, its generator on
        ``device`` (None: CUDA, raises without a card; "cpu" runs there)."""
        from mqgan_tpu_torch.core.device import resolve_device
        from mqgan_tpu_torch.models.istft_vocoder import ISTFTNetGenerator

        with open(os.path.join(in_dir, CONFIG_NAME)) as f:
            cfg = json.load(f)
        if "generator" not in cfg:
            program = os.path.join(in_dir, JAX_PROGRAM_NAME)
            raise ValueError(
                f"{in_dir} is not an artifact of this package: its config has "
                f"no generator hyperparameters"
                + (f" and {program} is a JAX StableHLO program, which PyTorch "
                   f"cannot run; export the vocoder with this package "
                   f"(train/vocoder_trainer.py --export_dir)"
                   if os.path.exists(program) else ""))
        kw = dict(cfg["generator"])
        dtype = kw.pop("dtype", None)
        gen = ISTFTNetGenerator(**kw, dtype=None if dtype is None
                                else getattr(torch, dtype))
        gen.load_state_dict(torch.load(
            os.path.join(in_dir, cfg.get("weights", WEIGHTS_NAME)),
            map_location="cpu", weights_only=True))
        stft = TorchSTFT(
            filter_length=cfg["gen_istft_n_fft"],
            hop_length=cfg["gen_istft_hop_size"],
            win_length=cfg.get("gen_istft_win_length", cfg["gen_istft_n_fft"]))
        fe = cls(gen=gen.to(resolve_device(device)).eval(), stft=stft)
        fe.sampling_rate = cfg["sampling_rate"]
        return fe
