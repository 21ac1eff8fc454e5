"""Vocoder feature-extractor wrapper, the reference's ``ISTFTNetFE``
(counterpart of ``mqgan_tpu/signal/vocoder.py``).

Wraps an iSTFTNet-style generator (mel (B, n_mels, T) -> (spec, phase),
each (B, F, T')) together with an inverse STFT:

  forward: wav = istft(gen(mel))       (B, 1, samples)
  infer:   int16 PCM via x 32768
  export_ts / load_ts: the port's artifact: ``config.json`` (the JAX
      artifact's keys, plus the generator's hyperparameters under
      "generator", ``program`` and ``platforms``), the generator's fp32
      ``weights.pt`` and ``<platform>/istft_gen.pt2``, a ``torch.export``
      program of the generator (weight norm folded) with a symbolic batch b
      and frame count t, as the JAX artifact's StableHLO has: it vocodes
      any batch and any length of 1 frame or more. ``cpu`` always, and
      ``cuda`` when the generator is on a card (traced there; the CPU's
      copy moved, its weights folded on the CPU)

The generator is any callable; a ``torch.nn.Module`` gets its input on the
device of its parameters. ``load_ts`` serves the program (``program``; the
rebuilt generator stays as ``gen``, for its hyperparameters) with the
inverse STFT as before. A JAX artifact (``istft_gen.shlo``, a StableHLO
program) cannot run in PyTorch, and ``load_ts`` refuses it, and an export
of weights without a program, which it asks to re-export.
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
PROGRAM_NAME = "istft_gen.pt2"
MIN_FRAMES = 1  # the program's least t: every conv pads SAME with zeros


class ISTFTNetFE:
    def __init__(self, gen: Callable | None, stft: TorchSTFT | None):
        self.gen = gen
        self.stft = stft
        self.sampling_rate = None
        self.program = None  # load_ts: the artifact's program, which serves

    def _generate(self, mel):
        mel = torch.as_tensor(mel, dtype=torch.float32)
        if isinstance(self.gen, torch.nn.Module):
            mel = mel.to(next(self.gen.parameters()).device)
        with torch.no_grad():
            return (self.gen if self.program is None else self.program)(mel)

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
        """Write the artifact of this wrapper's ``ISTFTNetGenerator`` (module
        docstring), traced on the generator's device. example_frames is
        kept for the reference API: the program takes any length."""
        import copy

        from torch.export import Dim

        from mqgan_tpu_torch.deploy.export import (MAX_ROWS, TRACE_ROWS,
                                                   export_platforms, module_tensors,
                                                   save_program, traced)
        from mqgan_tpu_torch.nn.conv import fold_weight_norm_

        del example_frames
        config = getattr(self.gen, "config", None)
        if config is None:
            raise TypeError("export_ts needs an ISTFTNetGenerator as gen, got "
                            f"{type(self.gen).__name__}")
        device = next(self.gen.parameters()).device
        platforms = export_platforms(device)
        for platform in platforms:
            os.makedirs(os.path.join(out_dir, platform), exist_ok=True)
        torch.save({k: v.detach().float().cpu()
                    for k, v in self.gen.state_dict().items()},
                   os.path.join(out_dir, WEIGHTS_NAME))
        def example():
            mel = torch.zeros((TRACE_ROWS, self.gen.n_mels, 7), device=device)
            return (mel,), ({0: Dim("b", min=1, max=MAX_ROWS),
                             2: Dim("t", min=MIN_FRAMES)},)

        program = traced(fold_weight_norm_(copy.deepcopy(self.gen)),
                         ("istft_gen", str(device), json.dumps(config(), sort_keys=True)),
                         example)
        # the CPU's copy holds the weights folded there
        save_program(program, out_dir, device.type, PROGRAM_NAME,
                     None if device.type == "cpu" else module_tensors(
                         fold_weight_norm_(copy.deepcopy(self.gen).cpu())))
        cfg = {
            "gen_istft_n_fft": self.stft.filter_length,
            "gen_istft_hop_size": self.stft.hop_length,
            "gen_istft_win_length": self.stft.win_length,
            "sampling_rate": sampling_rate,
            "mel_channels": mel_channels,
            "generator": config(),
            "weights": WEIGHTS_NAME,
            "program": PROGRAM_NAME,
            "platforms": platforms,
        }
        with open(os.path.join(out_dir, CONFIG_NAME), "w") as f:
            json.dump(cfg, f, indent=2)
        return out_dir

    @classmethod
    def load_ts(cls, in_dir: str, device=None) -> "ISTFTNetFE":
        """The wrapper of an ``export_ts`` directory, serving its program of
        ``device``'s platform (None: CUDA, raises without a card; "cpu"
        runs there)."""
        from mqgan_tpu_torch.core.device import resolve_device
        from mqgan_tpu_torch.deploy.runtime import load_program, program_path
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
        if "program" not in cfg:
            raise ValueError(f"{in_dir} is a vocoder export of weights without "
                             f"a program; re-export it with this package "
                             f"(ISTFTNetFE.export_ts)")
        device = resolve_device(device)
        if device.type not in cfg["platforms"]:
            raise RuntimeError(f"{in_dir} holds no {device.type} program (platforms "
                               f"{cfg['platforms']}): export it on a "
                               f"{device.type} device")
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
        fe = cls(gen=gen.to(device).eval(), stft=stft)
        fe.program = load_program(program_path(in_dir, device.type, cfg["program"]),
                                  device).module()
        fe.sampling_rate = cfg["sampling_rate"]
        return fe
