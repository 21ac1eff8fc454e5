"""Configuration (a copy of ``mqgan_tpu/core/config.py``: same fields, same
defaults).

``GeneratorConfig`` is the flagship hifispeech generator
(``configs/model_config_hifispeech.yaml``); ``SpectrogramConfig``,
``IOConfig`` and ``SpecConfig`` are the spec-config schema
(``configs/spec_config_*.yaml``). ``TrainConfig`` is the model part of the
model-config schema: ``model.mel_channels`` and ``model.generator``; the
other sections (data, discriminators, training, logging) belong to the
GAN-training slice and are ignored when read. Training-only
generator fields (dropout rates, remat, chunk sizes) are kept so a config
round-trips, and are ignored by the inference-only port. PyYAML is imported
only inside the ``from_yaml`` methods: nothing else reads YAML, so a machine
without it can still build every config in code or read one from JSON
(``load_model_config``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping


def _tuple(x) -> tuple:
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(_tuple(v) if isinstance(v, (list, tuple)) else v for v in x)
    return (x,)


@dataclass(frozen=True)
class SpectrogramConfig:
    """The spec-config ``spectrogram`` section."""

    sampling_rate: int = 44100
    filter_length: int = 2048  # n_fft
    hop_length: int = 512
    win_length: int = 2048
    n_mel_channels: int = 128
    mel_fmin: float = 0.0
    mel_fmax: float = 22050.0
    target_amplitude: float = 0.95

    @property
    def n_freqs(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class IOConfig:
    input_folder: str = "data/input_audio"
    output_folder: str = "data/spectrograms"
    audio_extensions: tuple = (
        ".wav", ".mp3", ".flac", ".aac", ".ogg", ".m4a", ".wma",
        ".aif", ".aiff", ".opus", ".amr",
    )


@dataclass(frozen=True)
class SpecConfig:
    io: IOConfig = field(default_factory=IOConfig)
    spectrogram: SpectrogramConfig = field(default_factory=SpectrogramConfig)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "SpecConfig":
        io_d = dict(d.get("io", {}))
        if "audio_extensions" in io_d:
            io_d["audio_extensions"] = _tuple(io_d["audio_extensions"])
        spec_d = dict(d.get("spectrogram", {}))
        return SpecConfig(io=IOConfig(**io_d), spectrogram=SpectrogramConfig(**spec_d))

    @staticmethod
    def from_yaml(path: str) -> "SpecConfig":
        import yaml

        with open(path) as f:
            return SpecConfig.from_dict(yaml.safe_load(f))

    def validate(self) -> None:
        """Required-key check (the reference converter's)."""
        s = self.spectrogram
        if s.filter_length <= 0 or s.hop_length <= 0 or s.win_length <= 0:
            raise ValueError("filter_length/hop_length/win_length must be positive")
        if s.win_length > s.filter_length:
            raise ValueError("win_length must be <= filter_length")
        if s.n_mel_channels <= 0:
            raise ValueError("n_mel_channels must be positive")
        if not self.io.audio_extensions:
            raise ValueError("audio_extensions must be non-empty")


@dataclass(frozen=True)
class GeneratorConfig:
    channels: tuple = (512, 512, 512, 768)
    kernel_sizes: tuple = (3, 3, 5, 7)
    dropout: float = 0.1
    fsq_levels: tuple = (8, 5, 5, 5)
    fsq_noise_dropout: float = 0.0
    refiner_base_channels: int = 64
    refiner_depth: int = 3
    refiner_hidden_proj_divisor: int = 8
    remat: bool = False
    remat_refiner: bool = False
    fast_dropout: bool = False
    mixer_chunk_t: int = 32

    @property
    def codebook_size(self) -> int:
        size = 1
        for level in self.fsq_levels:
            size *= level
        return size


@dataclass(frozen=True)
class ModelConfig:
    mel_channels: int = 128
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)


@dataclass(frozen=True)
class TrainConfig:
    """The model part of the model-config schema (``configs/model_config_*.yaml``)."""

    model: ModelConfig = field(default_factory=ModelConfig)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "TrainConfig":
        model_d = dict(d.get("model", {}))
        gen_d = dict(model_d.get("generator", {}))
        for k in ("channels", "kernel_sizes", "fsq_levels"):
            if k in gen_d:
                gen_d[k] = _tuple(gen_d[k])
        names = {f.name for f in dataclasses.fields(GeneratorConfig)}
        unknown = sorted(set(gen_d) - names)
        if unknown:
            raise ValueError(f"config: unknown model.generator key(s) {unknown}")
        return TrainConfig(
            model=ModelConfig(mel_channels=int(model_d.get("mel_channels", 128)),
                              generator=GeneratorConfig(**gen_d)))

    @staticmethod
    def from_yaml(path: str) -> "TrainConfig":
        import yaml

        with open(path) as f:
            return TrainConfig.from_dict(yaml.safe_load(f))


def load_model_config(path: str) -> TrainConfig:
    """A model config from ``.json`` (the stdlib) or YAML (PyYAML)."""
    if path.endswith(".json"):
        with open(path) as f:
            return TrainConfig.from_dict(json.load(f))
    return TrainConfig.from_yaml(path)
