"""PreEncoder — FSQ-quantized convolutional mel autoencoder + UNet refiner
(counterpart of ``mqgan_tpu/models/preencoder.py``), inference side:

  encode: proj -> pre mixer -> non-causal ResidualBlock1D stack
          -> fused FSQ head (q_in_proj + bound + round + pack) -> int32 tokens
  decode: unpack -> q_out_proj -> causal ResidualBlock1D stack (reversed
          channels) -> post mixer -> out_proj = x_recon;
          x_post = x_recon + refiner(concat(x_recon, hidden_proj(decoder out)))

Channels-last (B, T, C) throughout; pad masks are (B, T) bool, True = pad.
Parameters are fp32; the compute dtype is ``dtype`` (fp32 or bf16), FSQ
math always fp32.

Training (``forward(..., deterministic=False)``) returns (x_recon, x_post,
indices) under autograd through the modules' training branches, as the JAX
package trains through its XLA path: ``q_in_proj`` in the compute dtype and
the ``FSQ`` module with straight-through rounding and noise dropout in
place of the fused head; the refiner's input detached, so that only the
refiner takes the GAN gradients. Dropout masks draw from ``generator``,
FSQ noise from ``fsq_generator`` (both on the activations' device; a
``None`` generator means no dropout).
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.core.masking import sequence_mask
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.nn.conv import Dense
from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
from mqgan_tpu_torch.nn.unet import UNetRefiner
from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_head, fsq_head_constants
from mqgan_tpu_torch.quant.fsq import FSQ, indices_to_codes

# False: both mixers exact; "decode": the post mixer through the Chebyshev
# interpolant; "encode": the pre mixer; True or "both": both mixers
POLY_MIXER_MODES = (False, True, "decode", "encode", "both")


class PreEncoder(nn.Module):
    def __init__(self, mel_channels: int,
                 channels=(512, 512, 512, 768), kernel_sizes=(3, 3, 5, 7),
                 fsq_levels=(8, 5, 5, 5), refiner_base_channels: int = 128,
                 refiner_depth: int = 3, refiner_hidden_proj_divisor: int = 8,
                 poly_mixers: bool | str = False, int8_refiner: bool = False,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.1,
                 fsq_noise_dropout: float = 0.0, remat: bool = False,
                 remat_refiner: bool = False, fast_dropout: bool = False,
                 mixer_chunk_t: int = 32):
        """poly_mixers: which mixers evaluate their MLP as a Chebyshev
        interpolant (``POLY_MIXER_MODES``). "decode" keeps the tokens those
        of the exact path; "encode", True and "both" put the pre mixer
        through it too, which can flip an FSQ code whose pre-round value
        sits on a rounding midpoint (each flip a whole code step of the
        decode). int8_refiner: the JAX package's int8 refiner convs are
        not ported; only False is accepted. The rest are training knobs:
        the blocks' dropout rate (the mixers' and the refiner's is 0.1),
        FSQ noise dropout, ``remat`` (the mixers' pointwise MLP in
        checkpointed chunks of ``mixer_chunk_t`` frames), ``remat_refiner``
        (the refiner's ConvBlocks recomputed) and ``fast_dropout`` (the
        mixers' moment-matched Gaussian)."""
        super().__init__()
        if poly_mixers not in POLY_MIXER_MODES:
            raise ValueError(f"poly_mixers must be one of {POLY_MIXER_MODES}")
        if int8_refiner:
            raise NotImplementedError(
                "int8_refiner=True (the refiner's int8 convs) is not ported "
                "to the H100: ROADMAP.md Queue 1 item 7")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be fp32 or bf16, got {dtype}")
        ch = tuple(channels)
        self.mel_channels = mel_channels
        self.kernel_sizes = tuple(kernel_sizes)
        self.refiner_depth = refiner_depth
        self.poly_mixers = poly_mixers
        self.int8_refiner = False
        self.dtype = dtype
        poly_pre = poly_mixers in (True, "encode", "both")
        poly_post = poly_mixers in (True, "decode", "both")
        self.quantizer = FSQ(tuple(fsq_levels), noise_dropout=fsq_noise_dropout)
        self.spec = self.quantizer.spec
        chunk = mixer_chunk_t if remat else None
        mixer_kw = dict(dropout=0.1, hidden_chunk_t=chunk,
                        fast_dropout=fast_dropout)
        self.proj = Dense(mel_channels, ch[0])
        self.pre = MelMixer2D(ch[0], poly_approx=poly_pre, **mixer_kw)
        self.encoder_blocks = nn.ModuleList(
            ResidualBlock1D(ch[i], ch[i + 1], kernel_sizes[i], causal=False,
                            dropout=dropout)
            for i in range(len(ch) - 1))
        self.q_in_proj = Dense(ch[-1], self.spec.codebook_dim)
        self.q_out_proj = Dense(self.spec.codebook_dim, ch[-1])
        rev_ch, rev_ks = ch[::-1], tuple(kernel_sizes)[::-1]
        self.decoder_blocks = nn.ModuleList(
            ResidualBlock1D(rev_ch[i], rev_ch[i + 1], rev_ks[i], causal=True,
                            dropout=dropout)
            for i in range(len(rev_ch) - 1))
        self.post = MelMixer2D(ch[0], poly_approx=poly_post, **mixer_kw)
        self.out_proj = Dense(ch[0], mel_channels)
        hidden = mel_channels // refiner_hidden_proj_divisor
        self.hidden_proj = Dense(ch[0], hidden)
        self.refiner = UNetRefiner(mel_channels + hidden, refiner_base_channels,
                                   refiner_depth, mel_channels, dropout=0.1,
                                   remat=remat_refiner)
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
                   poly_mixers=poly_mixers, dtype=dtype, dropout=cfg.dropout,
                   fsq_noise_dropout=cfg.fsq_noise_dropout, remat=cfg.remat,
                   remat_refiner=cfg.remat_refiner,
                   fast_dropout=cfg.fast_dropout,
                   mixer_chunk_t=cfg.mixer_chunk_t)

    @property
    def codebook_size(self) -> int:
        return self.spec.codebook_size

    @property
    def fsq_levels(self) -> tuple:
        return self.spec.levels

    @property
    def bos_token_id(self) -> int:
        return self.codebook_size + 1

    @property
    def eos_token_id(self) -> int:
        return self.codebook_size + 2

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
        return x_recon, x_recon + residual, h

    @torch.no_grad()
    def encode(self, x: torch.Tensor,
               pad_mask: torch.Tensor | None = None) -> torch.Tensor:
        """mel (B, T, mel) -> packed FSQ indices (B, T) int32."""
        pad_mask = self._pad_mask(x, pad_mask)
        return self._fsq_head(self._encode_trunk(x, pad_mask))

    @torch.no_grad()
    def decode(self, indices: torch.Tensor,
               pad_mask: torch.Tensor | None = None,
               return_hidden: bool = False, return_recon: bool = False):
        """indices (B, T) -> refined mel (B, T, mel) in the compute dtype.
        return_hidden: also the decoder trunk's output (B, T, channels[0]),
        as (x_post, hidden); else return_recon: also the pre-refiner
        x_recon, as (x_post, x_recon)."""
        x_recon, x_post, hidden = self._decode_tokens(
            indices, self._pad_mask(indices, pad_mask))
        if return_hidden:
            return x_post, hidden
        if return_recon:
            return x_post, x_recon
        return x_post

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                deterministic: bool = True,
                generator: torch.Generator | None = None,
                fsq_generator: torch.Generator | None = None):
        """Returns (x_recon, x_post, indices), like the JAX ``__call__``:
        the inference path (no grad, the kernels on a card) when
        ``deterministic``, else the training branch."""
        pad_mask = sequence_mask(x.shape[1], lengths)
        if deterministic:
            with torch.no_grad():
                indices = self.encode(x, pad_mask)
                x_recon, x_post, _ = self._decode_tokens(indices, pad_mask)
            return x_recon, x_post, indices
        h = self.pre(self.proj(x.to(self.dtype)), pad_mask, False, generator)
        for block in self.encoder_blocks:
            h = block(h, pad_mask, False, generator)
        codes, indices = self.quantizer(self.q_in_proj(h), training=True,
                                        generator=fsq_generator)
        h = self.q_out_proj(codes)
        for block in self.decoder_blocks:
            h = block(h, pad_mask, False, generator)
        x_recon = self.out_proj(self.post(h, pad_mask, False, generator))
        refiner_in = torch.cat([x_recon, self.hidden_proj(h)], dim=-1)
        residual = self.refiner(refiner_in.detach(), pad_mask, generator)
        return x_recon, x_recon + residual, indices
