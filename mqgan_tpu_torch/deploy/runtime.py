"""Codec runtimes (counterpart of ``mqgan_tpu/deploy/runtime.py``).

``CodecRuntime`` serves a port ``PreEncoder`` in process with the interface
the servers, streaming and re-encode use: ``buckets``, ``bucket_for``,
``encode``, ``decode``, ``reencode``, ``mel_channels``, ``codebook_size``,
and the model's overlap-chunking halos (``halos``, ``decoder_halos``,
``encoder_halo``, ``halo_align``; core/chunking.py).
Each call pads its batch's time axis up to the nearest bucket (zero mel
frames, or token 0), builds the pad mask from the clip lengths, runs the
model and trims the result back. ``reencode`` keeps the tokens on the device
between encode and decode. Sequences longer than the largest bucket are
rejected: the caller chunks them (deploy/reencode.py).

``ExportedPreEncoder`` is the runtime of an exported artifact
(deploy/export.py): the model rebuilt from its manifest and weights, plus
the manifest's ``fsq_levels`` and BOS/EOS ids.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from mqgan_tpu_torch.core.buckets import BucketPolicy
from mqgan_tpu_torch.core import chunking
from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.models.preencoder import PreEncoder

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.pt"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

UNPORTED_PARALLEL = ("{} serving is not ported yet: ROADMAP.md Queue 1 item 8 "
                     "(parallelism on torch.distributed)")


class CodecRuntime:
    def __init__(self, model: PreEncoder, buckets=(128, 256, 512, 1024),
                 device=None):
        """model: a PreEncoder with its parameters loaded. device: None
        means CUDA (raises without a card); pass "cpu" explicitly to run the
        plain versions on the CPU."""
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._policy = BucketPolicy(tuple(buckets))
        self.buckets = list(self._policy.buckets)

    @property
    def mel_channels(self) -> int:
        return self.model.mel_channels

    @property
    def codebook_size(self) -> int:
        return self.model.codebook_size

    @property
    def halos(self) -> tuple:
        """(left, right) overlap-chunking halo of the encode+decode
        pipeline."""
        return chunking.generator_halos(self.model.kernel_sizes,
                                        self.model.refiner_depth)

    @property
    def decoder_halos(self) -> tuple:
        """(left, right) halo of the token -> mel decode side alone
        (StreamingDecoder)."""
        return chunking.decoder_halos(self.model.kernel_sizes,
                                      self.model.refiner_depth)

    @property
    def encoder_halo(self) -> int:
        """Symmetric per-side halo of the mel -> token encode side alone
        (StreamingEncoder)."""
        return chunking.encoder_halo(self.model.kernel_sizes)

    @property
    def halo_align(self) -> int:
        """Chunk windows start on multiples of this (the refiner's pooling
        grid, 2**refiner_depth)."""
        return chunking.halo_align(self.model.refiner_depth)

    @property
    def n_devices(self) -> int:
        """Devices a batch is spread over: one (no data parallelism yet)."""
        return 1

    def bucket_for(self, t: int) -> int:
        return self._policy.bucket_for(t)

    def _prepare(self, arr: np.ndarray, lengths, pad_value=0):
        b, t = arr.shape[0], arr.shape[1]
        if t > self.buckets[-1]:
            raise ValueError(
                f"sequence length {t} exceeds the largest bucket "
                f"{self.buckets[-1]}; chunk the input")
        lengths = (np.full((b,), t, np.int32) if lengths is None
                   else np.asarray(lengths, np.int32))
        tb = self.bucket_for(t)
        if tb != t:
            pad = np.full((b, tb - t) + arr.shape[2:], pad_value, arr.dtype)
            arr = np.concatenate([arr, pad], axis=1)
        pad_mask = np.arange(tb)[None, :] >= lengths[:, None]
        return (torch.from_numpy(arr).to(self.device),
                torch.from_numpy(pad_mask).to(self.device), t)

    def encode(self, spec, lengths=None) -> np.ndarray:
        """(B, T, mel) float -> (B, T) int32 FSQ indices."""
        x, pad_mask, t = self._prepare(np.asarray(spec, np.float32), lengths)
        return self.model.encode(x, pad_mask)[:, :t].cpu().numpy()

    def decode(self, indices, lengths=None) -> np.ndarray:
        """(B, T) int -> (B, T, mel) float32 refined mel."""
        idx, pad_mask, t = self._prepare(np.asarray(indices, np.int32), lengths)
        out = self.model.decode(idx, pad_mask)[:, :t]
        return out.float().cpu().numpy()

    def reencode(self, spec, lengths=None):
        """(B, T, mel) -> (tokens (B, T), refined mel (B, T, mel))."""
        x, pad_mask, t = self._prepare(np.asarray(spec, np.float32), lengths)
        idx = self.model.encode(x, pad_mask)
        out = self.model.decode(idx, pad_mask)
        return idx[:, :t].cpu().numpy(), out[:, :t].float().cpu().numpy()


def read_manifest(path: str) -> dict:
    """The manifest of an artifact directory, or the manifest file itself."""
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    with open(path) as f:
        return json.load(f)


def manifest_config(manifest: dict) -> TrainConfig:
    """The model config an artifact was exported from."""
    return TrainConfig.from_dict({"model": {
        "mel_channels": manifest["mel_channels"],
        "generator": manifest["generator"]}})


class ExportedPreEncoder(CodecRuntime):
    """The runtime of an artifact directory written by deploy/export.py."""

    def __init__(self, model_dir: str, device=None,
                 data_parallel: bool = False):
        """device: None means CUDA (raises without a card); "cpu" runs the
        plain versions. data_parallel is not ported (raises)."""
        if data_parallel:
            raise NotImplementedError(UNPORTED_PARALLEL.format("data_parallel"))
        device = resolve_device(device)
        self.model_dir = model_dir
        self.manifest = read_manifest(model_dir)
        cfg = manifest_config(self.manifest)
        model = PreEncoder.from_config(
            cfg.model.mel_channels, cfg.model.generator,
            dtype=DTYPES[self.manifest.get("dtype", "float32")],
            poly_mixers=self.manifest.get("poly_mixers", False))
        weights = os.path.join(model_dir, self.manifest.get("weights",
                                                            WEIGHTS_NAME))
        model.load_state_dict(torch.load(weights, map_location="cpu",
                                         weights_only=True))
        super().__init__(model, buckets=self.manifest["buckets"], device=device)

    @property
    def fsq_levels(self) -> list:
        return list(self.manifest["fsq_levels"])

    @property
    def bos_token_id(self) -> int:
        return int(self.manifest["bos_token_id"])

    @property
    def eos_token_id(self) -> int:
        return int(self.manifest["eos_token_id"])
