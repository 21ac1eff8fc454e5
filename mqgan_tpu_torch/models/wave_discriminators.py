"""Waveform discriminators for adversarial vocoder training (counterpart of
``mqgan_tpu/models/wave_discriminators.py``): HiFi-GAN's multi-period and
multi-scale discriminators, as the JAX package builds them.

* ``MultiPeriodDiscriminator``: the waveform reshaped into (T/p, p) images
  per period p, through (k, 1) conv ladders with stride (3, 1).
* ``MultiScaleDiscriminator``: 1-D conv ladders (grouped, strided, 41 taps)
  on the raw waveform and on 2x / 4x means of sample pairs.

Every discriminator returns (logits, feature maps). Activations are
channels-first here (MPD (B, C, T/p, p), MSD (B, C, T)) where JAX's are
channels-last; the losses are means, the same in either layout. Where the
JAX package departs from HiFi-GAN's published code, this module follows the
JAX package: MSD downsamples by the mean of sample pairs after trimming to an
even length (not ``AvgPool1d(4, 2, 2)``); a group count that does not divide
the input channels falls back to 1; MPD right-pads by reflection without
repeating the edge sample; MPD's ``conv_pen`` has stride 1 and ``conv_post``
is (3, 1).

Submodule names mirror the JAX tree (``period_{p}``, ``scale_{i}``,
``conv_{i}``, ``conv_pen``, ``conv_post``), so ``utils/params.py``
``state_dict_from_jax`` carries an ``init(...)["params"]`` tree one to one.
``dtype`` is the compute dtype of the convs (None: fp32); the losses are
fp32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mqgan_tpu_torch.nn.conv import WNConv1d, WNConv2d

LRELU_SLOPE = 0.1


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, channels=(32, 128, 512, 1024),
                 kernel_size: int = 5, stride: int = 3,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.period = period
        self.dtype = dtype
        k = kernel_size
        pad = (((k - 1) // 2, (k - 1) // 2), (0, 0))
        self.n_convs = len(channels)
        c_in = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv_{i}", WNConv2d(c_in, ch, (k, 1), stride=(stride, 1),
                                                  padding=pad))
            c_in = ch
        self.conv_pen = WNConv2d(c_in, 1024, (k, 1), padding=pad)
        self.conv_post = WNConv2d(1024, 1, (3, 1), padding=((1, 1), (0, 0)))

    def forward(self, wav: torch.Tensor):
        """wav (B, T) -> (logits (B, 1, H', p), feature maps)."""
        b, t = wav.shape
        p = self.period
        pad = (-t) % p
        if pad:
            # reflection without the edge sample, as F.pad(..., "reflect")
            wav = torch.cat([wav, wav[:, t - pad - 1: t - 1].flip(1)], dim=1)
        x = wav.reshape(b, 1, -1, p)
        x = x.to(self.dtype) if self.dtype is not None else x.float()
        fmaps: List[torch.Tensor] = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = F.leaky_relu(self.conv_pen(x), LRELU_SLOPE)
        fmaps.append(x)
        logits = self.conv_post(x)
        fmaps.append(logits)
        return logits, fmaps


class ScaleDiscriminator(nn.Module):
    def __init__(self, channels=(128, 128, 256, 512, 1024, 1024),
                 kernel_sizes=(15, 41, 41, 41, 41, 5), strides=(1, 2, 2, 4, 4, 1),
                 groups=(1, 4, 16, 16, 16, 1), dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.n_convs = len(channels)
        c_in = 1
        for i, (ch, k, s, g) in enumerate(zip(channels, kernel_sizes, strides, groups)):
            self.add_module(f"conv_{i}", WNConv1d(
                c_in, ch, k, stride=s, groups=g if c_in % g == 0 else 1,
                padding=((k - 1) // 2, (k - 1) // 2)))
            c_in = ch
        self.conv_post = WNConv1d(c_in, 1, 3, padding=(1, 1))

    def forward(self, wav: torch.Tensor):
        """wav (B, T) -> (logits (B, 1, T'), feature maps)."""
        x = wav[:, None, :]
        x = x.to(self.dtype) if self.dtype is not None else x.float()
        fmaps: List[torch.Tensor] = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}").conv_nct(x), LRELU_SLOPE)
            fmaps.append(x)
        logits = self.conv_post.conv_nct(x)
        fmaps.append(logits)
        return logits, fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods=(2, 3, 5, 7, 11), dtype: torch.dtype | None = None):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(p, dtype=dtype))

    def forward(self, wav: torch.Tensor):
        outs, fmaps = [], []
        for p in self.periods:
            o, f = getattr(self, f"period_{p}")(wav)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, n_scales: int = 3, dtype: torch.dtype | None = None):
        super().__init__()
        self.n_scales = n_scales
        for i in range(n_scales):
            self.add_module(f"scale_{i}", ScaleDiscriminator(dtype=dtype))

    def forward(self, wav: torch.Tensor):
        outs, fmaps = [], []
        x = wav
        for i in range(self.n_scales):
            if i > 0:
                b, t = x.shape
                x = x[:, : (t // 2) * 2].reshape(b, t // 2, 2).mean(-1)
            o, f = getattr(self, f"scale_{i}")(x)
            outs.append(o)
            fmaps.append(f)
        return outs, fmaps


def adversarial_g_loss(fake_logit_lists: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    """LSGAN generator loss summed over all sub-discriminators."""
    total = 0.0
    for outs in fake_logit_lists:
        for o in outs:
            total = total + torch.mean(torch.square(o.float() - 1.0))
    return total


def adversarial_d_loss(real_logit_lists, fake_logit_lists) -> torch.Tensor:
    total = 0.0
    for reals, fakes in zip(real_logit_lists, fake_logit_lists):
        for r, f in zip(reals, fakes):
            total = total + torch.mean(torch.square(r.float() - 1.0))
            total = total + torch.mean(torch.square(f.float()))
    return total


def feature_matching_loss(real_fmap_lists, fake_fmap_lists) -> torch.Tensor:
    """Mean L1 between real (detached) and fake feature maps over every
    sub-discriminator and layer."""
    total = 0.0
    n = 0
    for rf_layers, ff_layers in zip(real_fmap_lists, fake_fmap_lists):
        for r, f in zip(rf_layers, ff_layers):
            total = total + torch.mean(torch.abs(r.detach().float() - f.float()))
            n += 1
    return total / max(n, 1)
