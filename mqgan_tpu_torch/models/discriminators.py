"""Spectrogram discriminators (counterpart of
``mqgan_tpu/models/discriminators.py``).

* ``MelSpectrogramPatchDiscriminator2D``: a 2-D PatchGAN over (freq, time):
  a ladder of spectrally normalized convs with per-layer (stride_f,
  stride_t), LeakyReLU 0.2 after every conv, masked squeeze-excitation
  before the last conv, the pad mask max-pooled (ceil mode) alongside the
  strides and padded patches zeroed. Returns (logits, valid mask[,
  features]); the features skip layers 0, 1 and the last.
* ``MultiBinDiscriminator``: the mel axis split into ``n_bins`` equal bands,
  one patch discriminator per band with (3, k) kernels and time-only strides
  ((1, 1) for the first ``n_no_strides`` layers, then (1, 2)).

Images are NCHW (B, C, F, T) inside; what the discriminators return is in
the JAX package's layout: logits and features (B, F', T', C), masks
(B, F', T'), True = valid for the patch mask.

Spectral norm is the port's own (``SNConv2d``), flax's ``SpectralNorm``:
one power-iteration step from the stored ``u`` on every call, on the kernel
matricized (kh * kw * in, out) as flax does; ``u`` and ``v`` carry no
gradient, sigma = v W u^T does; ``u`` and ``sigma`` (buffers) are written
back only when the call passes ``update_stats=True`` (once per
discriminator update in the train step). ``torch.nn.utils.spectral_norm``
updates ``u`` on every training-mode forward and keeps its own ``v``, so it
is not used.

Under sequence-parallel training (``seq``, ``parallel/seqtrain.py``) x
holds this rank's frames of a crop whose rows have the global ``lengths``:
each conv exchanges its time halos and keeps the output frames whose
anchor (the first input frame at its stride) is the rank's, the SE block's
statistics reduce over the seq group, and every mask is the one-pass
mask's frames, pooled from the global lengths (so a ceil-mode tail that
straddles two ranks is the full pass's). The power iteration reads the
weights only, so it is the same on every rank.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mqgan_tpu_torch.core.config import (MultiBinDiscriminatorConfig,
                                         PatchDiscriminatorConfig)
from mqgan_tpu_torch.core.masking import sequence_mask
from mqgan_tpu_torch.nn.se import ChannelSELayerMasked

_EPS = 1e-12  # flax SpectralNorm's epsilon


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + _EPS)


def maxpool2d_ceil_bool(mask: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """(B, H, W) bool -> ceil-mode max pool with kernel = stride: a tail
    window takes the max over its partial extent."""
    return F.max_pool2d(mask[:, None].float(), (sh, sw), (sh, sw),
                        ceil_mode=True)[:, 0] > 0


class SNConv2d(nn.Module):
    """Conv2d whose kernel is divided by its spectral norm, flax style.
    Parameters ``weight`` (O, I, kh, kw) and ``bias``; buffers ``u``
    (1, O) and ``sigma`` ()."""

    def __init__(self, in_channels: int, out_channels: int, kernel, stride,
                 padding):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty((out_channels, in_channels)
                                               + tuple(kernel)))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer("u", torch.ones(1, out_channels))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        w = self.weight.float()
        mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # flax's order
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ mat.t())
            u0 = _l2_normalize(v0 @ mat)
        sigma = (v0 @ mat @ u0.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    @torch.no_grad()
    def update_stats(self) -> None:
        """Write back one power-iteration step, as a call with
        ``update_stats=True`` does, without a forward."""
        self.normalized_weight(update_stats=True)

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                seq=None) -> torch.Tensor:
        """x (B, C, F, T); ``seq``: T is this rank's shard of time."""
        w = self.normalized_weight(update_stats).to(x.dtype)
        b = self.bias.to(x.dtype)
        if seq is None:
            return F.conv2d(x, w, b, self.stride, self.padding)
        y, _ = seq.conv(x, 3, w.shape[3], lambda xw: F.conv2d(
            xw, w, b, self.stride, (self.padding[0], 0)), stride=self.stride[1],
            pad=(self.padding[1], self.padding[1]))
        return y


def _pair(k) -> tuple:
    return tuple(k) if isinstance(k, (tuple, list)) else (k, k)


class MelSpectrogramPatchDiscriminator2D(nn.Module):
    def __init__(self, mel_channels: int, hidden_channels=(64, 128, 256, 512),
                 kernel_sizes=(7, 5, 5, 3, 3), strides=(2, 2),
                 dtype: torch.dtype | None = None):
        super().__init__()
        ks = list(kernel_sizes)
        if len(ks) != len(hidden_channels) + 1:
            raise ValueError("kernel_sizes needs one entry more than "
                             "hidden_channels")
        if isinstance(strides, int):
            layer_strides = [(1, strides)] * len(ks)
        elif len(strides) == 2 and all(isinstance(v, int) for v in strides):
            layer_strides = [tuple(strides)] * len(ks)
        else:
            if len(strides) != len(ks):
                raise ValueError("stride list must match kernel_sizes")
            layer_strides = [tuple(v) for v in strides]
        self.mel_channels = mel_channels
        self.dtype = dtype
        layers, c_in = [], 1
        outs = list(hidden_channels) + [1]
        for i, (out_ch, k) in enumerate(zip(outs, ks)):
            k1, k2 = _pair(k)
            stride = layer_strides[i] if i < len(ks) - 1 else (1, 1)
            layers.append(SNConv2d(c_in, out_ch, (k1, k2), stride,
                                   ((k1 - 1) // 2, (k2 - 1) // 2)))
            c_in = out_ch
        self.convs = nn.ModuleList(layers)
        self.se_block = ChannelSELayerMasked(hidden_channels[-1],
                                             reduction_ratio=8)

    @classmethod
    def from_config(cls, mel_channels: int, cfg: PatchDiscriminatorConfig,
                    dtype=None):
        return cls(mel_channels, tuple(cfg.hidden_channels),
                   tuple(cfg.kernel_sizes), tuple(cfg.strides), dtype)

    @property
    def ret_features_map(self) -> List[bool]:
        m = [True] * len(self.convs)
        m[0] = m[1] = m[-1] = False
        return m

    def spectral_convs(self):
        return list(self.convs)

    def pad_masks(self, lengths: torch.Tensor, t: int) -> List[torch.Tensor]:
        """The pad masks (B, F', T') of the input and after each conv, True
        = padded: a function of the lengths alone, so that a data-parallel
        step counts the valid patches of the global batch from its
        lengths."""
        mask = sequence_mask(t, lengths)[:, None, :].expand(
            lengths.shape[0], self.mel_channels, t)
        masks = [mask]
        for conv in self.convs:
            sh, sw = conv.stride
            if sh > 1 or sw > 1:
                mask = maxpool2d_ceil_bool(mask, sh, sw)
            masks.append(mask)
        return masks

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                return_features: bool = False, update_stats: bool = False,
                seq=None):
        """x (B, T, F), lengths (B,) -> logits (B, F', T', 1), valid mask
        (B, F', T') [, features: [(map (B, F', T', C), pad mask)]].
        ``seq``: x and every output hold this rank's frames of each level."""
        b, t, f = x.shape
        if f != self.mel_channels:
            raise ValueError(f"expected {self.mel_channels} mels, got {f}")
        shards = [seq] * (len(self.convs) + 1)
        if seq is None:
            masks = self.pad_masks(lengths, t)
        else:
            for i, conv in enumerate(self.convs):
                k, st, p = conv.weight.shape[3], conv.stride[1], conv.padding[1]
                shards[i + 1] = shards[i].window(k, st, (p, p))[0]
            masks = [sh.take(m, 2) for sh, m in
                     zip(shards, self.pad_masks(lengths, seq.total))]
        out = x.transpose(1, 2)[:, None]
        if self.dtype is not None:
            out = out.to(self.dtype)
        features = []
        ret_map = self.ret_features_map
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            if i == last:
                out = self.se_block(out, masks[i], shards[i])
            out = F.leaky_relu(conv(out, update_stats, shards[i]), 0.2)
            pad_mask = masks[i + 1]
            out = out.masked_fill(pad_mask[:, None], 0.0)
            if return_features and ret_map[i]:
                features.append((out.permute(0, 2, 3, 1), pad_mask))
        logits = out.permute(0, 2, 3, 1)
        if return_features:
            return logits, ~pad_mask, features
        return logits, ~pad_mask


class MultiBinDiscriminator(nn.Module):
    def __init__(self, mel_channels: int, n_bins: int = 4,
                 hidden_channels=(64, 128, 256, 512),
                 kernel_sizes=(7, 5, 5, 3, 3), n_no_strides: int = 2,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if mel_channels % n_bins:
            raise ValueError(f"{mel_channels} mels do not split into "
                             f"{n_bins} bins")
        self.n_bins = n_bins
        self.bin_size = mel_channels // n_bins
        strides = tuple((1, 1) if i < n_no_strides else (1, 2)
                        for i in range(len(kernel_sizes)))
        ksizes = tuple((3, k) for k in kernel_sizes)
        self.discriminators = nn.ModuleList(
            MelSpectrogramPatchDiscriminator2D(
                self.bin_size, tuple(hidden_channels), ksizes, strides, dtype)
            for _ in range(n_bins))

    @classmethod
    def from_config(cls, mel_channels: int, cfg: MultiBinDiscriminatorConfig,
                    dtype=None):
        return cls(mel_channels, cfg.n_bins, tuple(cfg.hidden_channels),
                   tuple(cfg.kernel_sizes), cfg.n_no_strides, dtype)

    def spectral_convs(self):
        return [c for d in self.discriminators for c in d.convs]

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                return_features: bool = False, update_stats: bool = False,
                seq=None) -> Tuple[list, ...]:
        """x (B, T, F) -> per bin: logits, masks [, features] (lists)."""
        outs, masks, feats = [], [], []
        for i, disc in enumerate(self.discriminators):
            sub = x[..., i * self.bin_size:(i + 1) * self.bin_size]
            res = disc(sub, lengths, return_features, update_stats, seq)
            outs.append(res[0])
            masks.append(res[1])
            if return_features:
                feats.append(res[2])
        if return_features:
            return outs, masks, feats
        return outs, masks
