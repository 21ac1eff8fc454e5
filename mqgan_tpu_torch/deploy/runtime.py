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

Data parallelism (``devices``, or ``ExportedPreEncoder(data_parallel=True)``
over every visible card): each distinct device holds a copy of the model
(parallel/mesh.py); a batch is repeat-padded to a multiple of the device
count and split into equal row slices, every slice's inputs are staged on
its device, the slices are dispatched one after another without a host
synchronisation between them (so the cards compute at once), and the
results are gathered and trimmed to the caller's rows.
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
from mqgan_tpu_torch.parallel.mesh import (local_devices, replicate,
                                           repeat_pad_rows, split_rows)

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "weights.pt"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class CodecRuntime:
    def __init__(self, model: PreEncoder, buckets=(128, 256, 512, 1024),
                 device=None, devices=None):
        """model: a PreEncoder with its parameters loaded. device: None
        means CUDA (raises without a card); pass "cpu" explicitly to run the
        plain versions on the CPU. devices: data parallelism over this list
        (a device may repeat; the first is ``device``); None is ``device``
        alone."""
        if devices is not None:
            devices = local_devices(devices)
            device = devices[0]
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._devices = devices or [self.device]
        self._replicas = replicate(self.model, self._devices)
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
        """Devices a batch is split over (1 without data parallelism)."""
        return len(self._devices)

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
        return arr, pad_mask, t

    def _run(self, fn, arr: np.ndarray, pad_mask: np.ndarray) -> tuple:
        """fn(model, x, pad_mask) -> a tuple of device tensors, over the
        devices' row slices; the outputs as numpy, the caller's rows."""
        n = len(self._devices)
        parts = ([(arr, pad_mask)] if n == 1 else
                 split_rows(repeat_pad_rows((arr, pad_mask), n), n))
        staged = [(d, [torch.from_numpy(np.ascontiguousarray(a)).to(d)
                       for a in part]) for d, part in zip(self._devices, parts)]
        pending = [fn(self._replicas[d], *ins) for d, ins in staged]
        b = arr.shape[0]
        return tuple(np.concatenate([p[j].cpu().numpy() for p in pending])[:b]
                     for j in range(len(pending[0])))

    def encode(self, spec, lengths=None) -> np.ndarray:
        """(B, T, mel) float -> (B, T) int32 FSQ indices."""
        x, pad_mask, t = self._prepare(np.asarray(spec, np.float32), lengths)
        return self._run(lambda m, x_, p_: (m.encode(x_, p_)[:, :t],),
                         x, pad_mask)[0]

    def decode(self, indices, lengths=None) -> np.ndarray:
        """(B, T) int -> (B, T, mel) float32 refined mel."""
        idx, pad_mask, t = self._prepare(np.asarray(indices, np.int32), lengths)
        return self._run(lambda m, i_, p_: (m.decode(i_, p_)[:, :t].float(),),
                         idx, pad_mask)[0]

    def reencode(self, spec, lengths=None):
        """(B, T, mel) -> (tokens (B, T), refined mel (B, T, mel))."""
        x, pad_mask, t = self._prepare(np.asarray(spec, np.float32), lengths)

        def run(m, x_, p_):
            idx = m.encode(x_, p_)
            return idx[:, :t], m.decode(idx, p_)[:, :t].float()

        return self._run(run, x, pad_mask)


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
                 data_parallel: bool = False, devices=None):
        """device: None means CUDA (raises without a card); "cpu" runs the
        plain versions. data_parallel: split each batch over ``devices``
        (a list, which may repeat a device), by default every visible card;
        with one card it is the single-device path."""
        if devices is not None and not data_parallel:
            raise ValueError("devices is the data_parallel device list")
        device = resolve_device(device)
        if data_parallel and devices is None:
            devices = local_devices() if device.type == "cuda" else [device]
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
        super().__init__(model, buckets=self.manifest["buckets"], device=device,
                         devices=devices)

    @property
    def fsq_levels(self) -> list:
        return list(self.manifest["fsq_levels"])

    @property
    def bos_token_id(self) -> int:
        return int(self.manifest["bos_token_id"])

    @property
    def eos_token_id(self) -> int:
        return int(self.manifest["eos_token_id"])
