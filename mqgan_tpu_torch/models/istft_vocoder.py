"""iSTFTNet-style neural vocoder generator, inference side (counterpart of
``mqgan_tpu/models/istft_vocoder.py``).

A HiFi-GAN upsampler with multi-receptive-field (MRF) residual blocks that
upsamples only to hop/istft_hop resolution and emits (magnitude, phase) for
a small inverse STFT. Contract, as ``signal/vocoder.py`` ``ISTFTNetFE``
expects it: mel (B, n_mels, T) -> (spec, phase), each
(B, istft_n_fft//2+1, T * prod(upsample_rates)); channels-last inside.

Samples per mel frame = prod(upsample_rates) * istft_hop = the mel hop.

Submodule names mirror the JAX parameter tree (``conv_pre``, ``up_{i}``,
``mrf_{i}/conv_k{k}_d{d}`` and ``..._post``, ``conv_post``), so
``utils/params.py`` ``state_dict_from_jax`` maps an
``ISTFTNetGenerator.init(...)["params"]`` tree one to one. ``dtype`` is the
compute dtype of the convolutions; the heads are always fp32. The forward
is differentiable (``train/vocoder_trainer.py`` trains it); inference
through ``ISTFTNetFE`` runs without gradients.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mqgan_tpu_torch.nn.conv import WNConv1d
from mqgan_tpu_torch.signal.stft import TorchSTFT
from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE

LRELU_SLOPE = 0.1


class MRFBlock(nn.Module):
    """HiFi-GAN multi-receptive-field residual block: parallel dilated conv
    stacks with LeakyReLU, averaged."""

    def __init__(self, channels: int, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        self.dilations = tuple(dilations)
        for k in self.kernel_sizes:
            for d in self.dilations:
                self.add_module(f"conv_k{k}_d{d}",
                                WNConv1d(channels, channels, k, dilation=d))
                self.add_module(f"conv_k{k}_d{d}_post",
                                WNConv1d(channels, channels, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for k in self.kernel_sizes:
            h = x
            for d in self.dilations:
                y = F.leaky_relu(h, LRELU_SLOPE)
                y = getattr(self, f"conv_k{k}_d{d}")(y)
                y = F.leaky_relu(y, LRELU_SLOPE)
                y = getattr(self, f"conv_k{k}_d{d}_post")(y)
                h = h + y
            acc = h if acc is None else acc + h
        return acc / len(self.kernel_sizes)


class ISTFTNetGenerator(nn.Module):
    def __init__(self, n_mels: int = 128, upsample_rates=(8, 8),
                 upsample_kernel_sizes=(17, 17),
                 upsample_initial_channel: int = 512, istft_n_fft: int = 16,
                 resblock_kernel_sizes=(3, 7, 11), resblock_dilations=(1, 3, 5),
                 dtype: torch.dtype | None = None):
        """dtype: compute dtype of the convolutions (None = fp32)."""
        super().__init__()
        self.n_mels = n_mels
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.upsample_initial_channel = upsample_initial_channel
        self.istft_n_fft = istft_n_fft
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(resblock_dilations)
        self.dtype = dtype
        ch = upsample_initial_channel
        self.conv_pre = WNConv1d(n_mels, ch, 7)
        for i, (r, k) in enumerate(zip(self.upsample_rates, upsample_kernel_sizes)):
            self.add_module(f"up_{i}", WNConv1d(ch, ch // 2, k))
            ch //= 2
            self.add_module(f"mrf_{i}", MRFBlock(ch, resblock_kernel_sizes,
                                                 resblock_dilations))
        self.conv_post = WNConv1d(ch, 2 * (istft_n_fft // 2 + 1), 7)

    @property
    def total_upsample(self) -> int:
        return math.prod(self.upsample_rates)

    def config(self) -> dict:
        """The constructor's hyperparameters (dtype as its name or None),
        which rebuild this generator: ``ISTFTNetGenerator(**config)`` after
        ``dtype`` is mapped back."""
        return {
            "n_mels": self.n_mels,
            "upsample_rates": list(self.upsample_rates),
            "upsample_kernel_sizes": list(self.upsample_kernel_sizes),
            "upsample_initial_channel": self.upsample_initial_channel,
            "istft_n_fft": self.istft_n_fft,
            "resblock_kernel_sizes": list(self.resblock_kernel_sizes),
            "resblock_dilations": list(self.resblock_dilations),
            "dtype": None if self.dtype is None else str(self.dtype).split(".")[-1],
        }

    def forward(self, mel: torch.Tensor):
        """mel (B, n_mels, T) -> (spec, phase) each (B, n_fft//2+1, T')."""
        x = mel.transpose(1, 2)  # channels-last (B, T, n_mels)
        x = x.to(self.dtype) if self.dtype is not None else x.float()
        x = self.conv_pre(x)
        for i, r in enumerate(self.upsample_rates):
            x = F.leaky_relu(x, LRELU_SLOPE)
            # nearest upsample + conv (the transposed conv's equivalent
            # without checkerboard artefacts)
            x = torch.repeat_interleave(x, r, dim=1)
            x = getattr(self, f"up_{i}")(x)
            x = getattr(self, f"mrf_{i}")(x)
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = self.conv_post(x).float()
        n_freq = self.istft_n_fft // 2 + 1
        # heads: magnitude through a clamped exp, phase through a sin-bounded
        # angle
        spec = torch.exp(torch.clamp(x[..., :n_freq], -11.0, 6.0))
        phase = math.pi * torch.sin(x[..., n_freq:])
        return spec.transpose(1, 2), phase.transpose(1, 2)


def build_vocoder_fe(gen: ISTFTNetGenerator, istft_hop: int):
    """Wire a generator (its weights already loaded) into the reference's
    ``ISTFTNetFE`` wrapper (``signal/vocoder.py``). The JAX version takes
    the params beside the module; here the module holds them."""
    stft = TorchSTFT(filter_length=gen.istft_n_fft, hop_length=istft_hop,
                     win_length=gen.istft_n_fft)
    return ISTFTNetFE(gen=gen.eval(), stft=stft)
