"""Configuration (a copy of ``mqgan_tpu/core/config.py``: same fields, same
defaults).

``GeneratorConfig`` is the flagship hifispeech generator
(``configs/model_config_hifispeech.yaml``); ``SpectrogramConfig``,
``IOConfig`` and ``SpecConfig`` are the spec-config schema
(``configs/spec_config_*.yaml``). ``TrainConfig`` is the whole model-config
schema: data, model (generator and both discriminators), training (with its
loss weights) and logging. One JAX field is not here: ``rng_impl`` (a JAX
PRNG choice); like any unknown key of its section it is ignored with a
warning. ``logging.async_save`` writes checkpoints in the background
(``utils/checkpoint.py`` ``CheckpointWriter``, for orbax's). PyYAML
is imported only inside the ``from_yaml`` methods: nothing else reads YAML,
so a machine without it can still build every config in code or read one
from JSON (``load_model_config``).
"""

from __future__ import annotations

import dataclasses
import json
import warnings
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
class PatchDiscriminatorConfig:
    hidden_channels: tuple = (256, 256, 384, 512, 512)
    kernel_sizes: tuple = (5, 5, 5, 3, 3, 3)
    strides: tuple = ((1, 2), (2, 2), (2, 2), (2, 1), (2, 1), (2, 1))


@dataclass(frozen=True)
class MultiBinDiscriminatorConfig:
    hidden_channels: tuple = (128, 128, 256, 256, 384)
    kernel_sizes: tuple = (7, 5, 3, 3, 3, 3)
    n_bins: int = 8
    n_no_strides: int = 2


@dataclass(frozen=True)
class ModelConfig:
    mel_channels: int = 128
    generator: GeneratorConfig = field(default_factory=GeneratorConfig)
    discriminator_patch: PatchDiscriminatorConfig = field(
        default_factory=PatchDiscriminatorConfig)
    discriminator_multibin: MultiBinDiscriminatorConfig = field(
        default_factory=MultiBinDiscriminatorConfig)


@dataclass(frozen=True)
class LossWeights:
    fm_lambda: float = 0.25
    Gloss_lambda: float = 15.0
    # read by no code, as in the reference trainer, whose effective
    # weights are recon_lambda_pre / recon_lambda_post
    recon_lambda: float = 15.0
    recon_lambda_pre: float = 1.0
    recon_lambda_post: float = 2.0


@dataclass(frozen=True)
class TrainingConfig:
    num_epochs: int = 1000
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    lr_d_factor: float = 1.15
    d_beta1: float = 0.5
    d_beta2: float = 0.999
    warmup_steps: int = 1000
    discriminator_train_start_epoch: int = 8
    loss_weights: LossWeights = field(default_factory=LossWeights)
    use_fm_loss: bool = False
    clip_grad_norm: float = 1.0
    seed: int = 42
    no_cuda: bool = False  # accepted so that the reference's configs load
    pretrained: str | None = None


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = "data/real"
    output_dir: str = "training_output"
    validation_split: float = 0.02
    # int or tuple of ints; a tuple gives one crop length per batch, drawn
    crop_len: Any = (256, 192, 128)
    batch_size: int = 16
    num_workers: int = 0


@dataclass(frozen=True)
class WandbConfig:
    entity: str | None = None
    project: str = "MQGAN"


@dataclass(frozen=True)
class LoggingConfig:
    eval_interval: int = 2
    save_interval: int = 2
    # write checkpoints on a background thread (the CLI's --async_checkpoint)
    async_save: bool = False
    num_plot_examples: int = 10
    # warn when the logged codebook_usage stays below the floor for this
    # many consecutive metric logs (floor <= 0 turns the check off)
    codebook_usage_floor: float = 0.02
    codebook_collapse_patience: int = 5
    wandb: WandbConfig = field(default_factory=WandbConfig)


def _known(section: str, d_in: Mapping[str, Any], cls) -> dict:
    """The keys of ``d_in`` that are fields of ``cls``, warning on the rest
    (a typo such as ``epochs:`` must not fall back to a default unseen)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d_in) - names)
    if unknown:
        warnings.warn(f"config: ignoring unknown key(s) {unknown} in "
                      f"'{section}' (known: {sorted(names)})", stacklevel=3)
    return {k: v for k, v in d_in.items() if k in names}


@dataclass(frozen=True)
class TrainConfig:
    """The model-config schema (``configs/model_config_*.yaml``)."""

    project_name: str = "MQGAN"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    @property
    def crop_lens(self) -> tuple:
        cl = self.data.crop_len
        if isinstance(cl, (list, tuple)):
            return tuple(int(c) for c in cl)
        return (int(cl),)

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "TrainConfig":
        data_d = dict(d.get("data", {}))
        if "crop_len" in data_d:
            cl = data_d["crop_len"]
            data_d["crop_len"] = (_tuple(cl) if isinstance(cl, (list, tuple))
                                  else int(cl))
        model_d = dict(d.get("model", {}))
        gen_d = dict(model_d.get("generator", {}))
        for k in ("channels", "kernel_sizes", "fsq_levels"):
            if k in gen_d:
                gen_d[k] = _tuple(gen_d[k])
        names = {f.name for f in dataclasses.fields(GeneratorConfig)}
        unknown = sorted(set(gen_d) - names)
        if unknown:
            raise ValueError(f"config: unknown model.generator key(s) {unknown}")
        patch_d = dict(model_d.get("discriminator_patch", {}))
        for k in ("hidden_channels", "kernel_sizes", "strides"):
            if k in patch_d:
                patch_d[k] = _tuple(patch_d[k])
        mb_d = dict(model_d.get("discriminator_multibin", {}))
        for k in ("hidden_channels", "kernel_sizes"):
            if k in mb_d:
                mb_d[k] = _tuple(mb_d[k])
        train_d = dict(d.get("training", {}))
        lw_d = dict(train_d.pop("loss_weights", {}))
        log_d = dict(d.get("logging", {}))
        wandb_d = {k: v for k, v in dict(log_d.pop("wandb", {})).items()
                   if k in ("entity", "project")}
        return TrainConfig(
            project_name=d.get("project_name", "MQGAN"),
            data=DataConfig(**_known("data", data_d, DataConfig)),
            model=ModelConfig(
                mel_channels=int(model_d.get("mel_channels", 128)),
                generator=GeneratorConfig(**gen_d),
                discriminator_patch=PatchDiscriminatorConfig(**patch_d),
                discriminator_multibin=MultiBinDiscriminatorConfig(**mb_d)),
            training=TrainingConfig(
                **_known("training", train_d, TrainingConfig),
                loss_weights=LossWeights(
                    **_known("training.loss_weights", lw_d, LossWeights))),
            logging=LoggingConfig(**_known("logging", log_d, LoggingConfig),
                                  wandb=WandbConfig(**wandb_d)),
        )

    @staticmethod
    def from_yaml(path: str) -> "TrainConfig":
        import yaml

        with open(path) as f:
            return TrainConfig.from_dict(yaml.safe_load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_model_config(path: str) -> TrainConfig:
    """A model config from ``.json`` (the stdlib) or YAML (PyYAML)."""
    if path.endswith(".json"):
        with open(path) as f:
            return TrainConfig.from_dict(json.load(f))
    return TrainConfig.from_yaml(path)
