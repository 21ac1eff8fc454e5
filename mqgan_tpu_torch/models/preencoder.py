"""PreEncoder — FSQ-quantized convolutional mel autoencoder + UNet refiner
(counterpart of ``mqgan_tpu/models/preencoder.py``), inference side:

  encode: proj -> pre mixer -> non-causal ResidualBlock1D stack
          -> fused FSQ head (q_in_proj + bound + round + pack) -> int32 tokens
  decode: unpack -> q_out_proj -> causal ResidualBlock1D stack (reversed
          channels) -> post mixer -> out_proj = x_recon;
          x_post = x_recon + refiner(concat(x_recon, hidden_proj(decoder out)))

Channels-last (B, T, C) throughout; pad masks are (B, T) bool, True = pad.
Parameters are fp32; the compute dtype is ``dtype`` (fp32 or bf16), FSQ
math always fp32. Training (``deterministic=False``) is not in this port.
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.core.device import check_inference
from mqgan_tpu_torch.core.masking import sequence_mask
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.nn.conv import Dense
from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
from mqgan_tpu_torch.nn.unet import UNetRefiner
from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_head, fsq_head_constants
from mqgan_tpu_torch.quant.fsq import FSQSpec, indices_to_codes

POLY_MIXER_MODES = (False, "decode")


class PreEncoder(nn.Module):
    def __init__(self, mel_channels: int,
                 channels=(512, 512, 512, 768), kernel_sizes=(3, 3, 5, 7),
                 fsq_levels=(8, 5, 5, 5), refiner_base_channels: int = 128,
                 refiner_depth: int = 3, refiner_hidden_proj_divisor: int = 8,
                 poly_mixers: bool | str = False,
                 dtype: torch.dtype = torch.float32):
        """poly_mixers: False (both mixers exact) or "decode" (the post
        mixer evaluates its MLP as a Chebyshev interpolant; the tokens stay
        those of the exact path)."""
        super().__init__()
        if poly_mixers not in POLY_MIXER_MODES:
            raise ValueError(f"poly_mixers must be one of {POLY_MIXER_MODES}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be fp32 or bf16, got {dtype}")
        ch = tuple(channels)
        self.mel_channels = mel_channels
        self.dtype = dtype
        self.spec = FSQSpec(tuple(fsq_levels))
        self.proj = Dense(mel_channels, ch[0])
        self.pre = MelMixer2D(ch[0])
        self.encoder_blocks = nn.ModuleList(
            ResidualBlock1D(ch[i], ch[i + 1], kernel_sizes[i], causal=False)
            for i in range(len(ch) - 1))
        self.q_in_proj = Dense(ch[-1], self.spec.codebook_dim)
        self.q_out_proj = Dense(self.spec.codebook_dim, ch[-1])
        rev_ch, rev_ks = ch[::-1], tuple(kernel_sizes)[::-1]
        self.decoder_blocks = nn.ModuleList(
            ResidualBlock1D(rev_ch[i], rev_ch[i + 1], rev_ks[i], causal=True)
            for i in range(len(rev_ch) - 1))
        self.post = MelMixer2D(ch[0], poly_approx=poly_mixers == "decode")
        self.out_proj = Dense(ch[0], mel_channels)
        hidden = mel_channels // refiner_hidden_proj_divisor
        self.hidden_proj = Dense(ch[0], hidden)
        self.refiner = UNetRefiner(mel_channels + hidden, refiner_base_channels,
                                   refiner_depth, mel_channels)
        self.register_buffer(
            "fsq_consts", torch.from_numpy(fsq_head_constants(self.spec)),
            persistent=False)

    @classmethod
    def from_config(cls, mel_channels: int, cfg: GeneratorConfig,
                    dtype: torch.dtype = torch.float32,
                    poly_mixers: bool | str = False) -> "PreEncoder":
        return cls(mel_channels, channels=cfg.channels,
                   kernel_sizes=cfg.kernel_sizes, fsq_levels=cfg.fsq_levels,
                   refiner_base_channels=cfg.refiner_base_channels,
                   refiner_depth=cfg.refiner_depth,
                   refiner_hidden_proj_divisor=cfg.refiner_hidden_proj_divisor,
                   poly_mixers=poly_mixers, dtype=dtype)

    @property
    def codebook_size(self) -> int:
        return self.spec.codebook_size

    def _pad_mask(self, x, pad_mask):
        if pad_mask is None:
            return torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
        return pad_mask

    def _encode_trunk(self, x, pad_mask):
        h = self.pre(self.proj(x.to(self.dtype)), pad_mask)
        for block in self.encoder_blocks:
            h = block(h, pad_mask)
        return h

    def _fsq_head(self, h):
        w = self.q_in_proj.weight.float().t().contiguous()
        idx = fsq_encode_head(h.reshape(-1, h.shape[-1]), w,
                              self.q_in_proj.bias.float(), self.fsq_consts)
        return idx.reshape(h.shape[:2])

    def _decode_tokens(self, indices, pad_mask):
        codes = indices_to_codes(indices, self.spec).to(self.dtype)
        h = self.q_out_proj(codes)
        for block in self.decoder_blocks:
            h = block(h, pad_mask)
        x_recon = self.out_proj(self.post(h, pad_mask))
        hidden = self.hidden_proj(h)
        residual = self.refiner(torch.cat([x_recon, hidden], dim=-1), pad_mask)
        return x_recon, x_recon + residual

    @torch.no_grad()
    def encode(self, x: torch.Tensor,
               pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mel (B, T, mel) -> packed FSQ indices (B, T) int32."""
        pad_mask = self._pad_mask(x, pad_mask)
        return self._fsq_head(self._encode_trunk(x, pad_mask))

    @torch.no_grad()
    def decode(self, indices: torch.Tensor,
               pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        """indices (B, T) -> refined mel (B, T, mel) in the compute dtype."""
        return self._decode_tokens(indices, self._pad_mask(indices, pad_mask))[1]

    @torch.no_grad()
    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                deterministic: bool = True):
        """Returns (x_recon, x_post, indices), like the JAX ``__call__``."""
        check_inference(deterministic)
        pad_mask = sequence_mask(x.shape[1], lengths)
        indices = self.encode(x, pad_mask)
        x_recon, x_post = self._decode_tokens(indices, pad_mask)
        return x_recon, x_post, indices
