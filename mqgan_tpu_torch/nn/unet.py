"""UNetRefiner, the additive-residual head over reconstructed mels
(counterpart of ``mqgan_tpu/nn/unet.py``, plain path).

Input (B, T, F) with F = mel + hidden-projection channels; T padded to a
multiple of 2**depth; a ladder of ConvBlocks (two 3x3 weight-norm convs +
APTx, residual when channels match), time-only average-pool downs, nearest
x2 ups with skip concat; a final 3x3 conv to one plane, cropped to T and
masked; a bias-free Linear reproj (F -> mel).

In training, each conv's APTx output goes through dropout (draws from
``generator``; None: no dropout), and with ``remat`` each ConvBlock is
recomputed in the backward (``torch.utils.checkpoint``) instead of keeping
its activations.

Internally the image is NCHW (B, planes, T, F) in channels-last memory
format; the convs go to cuDNN on the card, as the JAX package leaves them
to XLA. The JAX package's packed-W and int8 variants are TPU layout tricks
and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mqgan_tpu_torch.nn.activations import aptx
from mqgan_tpu_torch.nn.conv import Dense, WNConv2d
from mqgan_tpu_torch.nn.layers import checkpoint, dropout


def _mask4(x: torch.Tensor, m: torch.Tensor | None) -> torch.Tensor:
    """x (B, C, T, F), m (B, T) True = pad."""
    if m is None:
        return x
    return x.masked_fill(m[:, None, :, None], 0.0)


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.residual = c_in == c_out
        self.conv1 = WNConv2d(c_in, c_out, 3)
        self.conv2 = WNConv2d(c_out, c_out, 3)

    def forward(self, x, m=None, generator=None):
        x = _mask4(x, m)
        y = dropout(aptx(self.conv1(x)), self.dropout, generator)
        y = dropout(aptx(self.conv2(y)), self.dropout, generator)
        if self.residual:
            y = y + x
        return _mask4(y, m)


class UNetRefiner(nn.Module):
    def __init__(self, in_features: int, base_ch: int = 128, depth: int = 3,
                 out_features: int = 128, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        chs = [base_ch * 2 ** i for i in range(depth + 1)]
        self.pre = ConvBlock(1, chs[0], dropout)
        self.downs = nn.ModuleList(ConvBlock(chs[i], chs[i + 1], dropout)
                                   for i in range(depth))
        self.mid = ConvBlock(chs[-1], chs[-1], dropout)
        self.ups = nn.ModuleList(
            ConvBlock(chs[depth - i] + chs[depth - i - 1], chs[depth - i - 1],
                      dropout)
            for i in range(depth))
        self.post = WNConv2d(chs[0], 1, 3)
        self.reproj = Dense(in_features, out_features, bias=False)

    def _block(self, block, h, m, generator):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, generator, h, m)
        return block(h, m, generator)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, F) -> (B, T, out_features), in x's dtype."""
        original_len = x.shape[1]
        pad_len = (-original_len) % (1 << self.depth)
        img = F.pad(x[:, None], (0, 0, 0, pad_len))
        img = img.contiguous(memory_format=torch.channels_last)
        m = pad_mask
        if pad_mask is not None and pad_len:
            m = F.pad(pad_mask, (0, pad_len), value=True)

        h = self._block(self.pre, img, m, generator)
        skips = []
        for down in self.downs:
            skips.append(h)
            h = F.avg_pool2d(h, (2, 1))
            if m is not None:
                m = m[:, : (m.shape[1] // 2) * 2].reshape(
                    m.shape[0], -1, 2).any(dim=-1)
            h = self._block(down, h, m, generator)
        h = self._block(self.mid, h, m, generator)
        for up in self.ups:
            h = h.repeat_interleave(2, dim=2)
            if m is not None:
                m = m.repeat_interleave(2, dim=1)
            skip = skips.pop()
            dt = skip.shape[2] - h.shape[2]
            if dt > 0:  # center-crop the skip's T to match
                skip = skip[:, :, dt // 2: dt // 2 + h.shape[2]]
            h = self._block(up, torch.cat([h, skip], dim=1), m, generator)

        out = self.post(_mask4(h, m))[:, 0, :original_len]  # (B, T, F)
        if pad_mask is not None:
            out = out.masked_fill(pad_mask[..., None], 0.0)
        return self.reproj(out)
