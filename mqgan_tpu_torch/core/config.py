"""Generator configuration (a copy of ``mqgan_tpu/core/config.py``
``GeneratorConfig``: same fields, same defaults — the flagship hifispeech
generator, ``configs/model_config_hifispeech.yaml``).

Only the generator section is carried over; nothing on the serving path
reads YAML. Training-only fields (dropout rates, remat, chunk sizes) are
kept so a config round-trips, and are ignored by the inference-only port.
"""

from __future__ import annotations

from dataclasses import dataclass


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
