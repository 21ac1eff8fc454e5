"""In-process codec runtime over a port ``PreEncoder`` (the interface of
``mqgan_tpu/deploy/reencode.py`` ``CheckpointReencoder``): ``buckets``,
``bucket_for``, ``encode``, ``decode``, ``reencode``, ``mel_channels``,
``codebook_size``.

Each call pads its batch's time axis up to the nearest bucket (zero mel
frames, or token 0), builds the pad mask from the clip lengths, runs the
model and trims the result back. ``reencode`` keeps the tokens on the device
between encode and decode. Sequences longer than the largest bucket are
rejected: the caller chunks them.
"""

from __future__ import annotations

import numpy as np
import torch

from mqgan_tpu_torch.core.buckets import BucketPolicy
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.models.preencoder import PreEncoder


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
