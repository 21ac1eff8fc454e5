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
to XLA. The JAX package's packed-W variant of the ``pre`` level is a TPU
layout trick and is not ported.

``int8`` (``UNetRefiner(int8=True)``: the downs, the mid and the ups, not
``pre``, as in the JAX package) runs both convs of a ConvBlock through the
int8 conv (``ops/int8_conv.py``: the kernel on the card, its plain version
on the CPU) at inference only: a call with ``deterministic=False`` (a
training step) takes the bf16/fp32 convs, as the JAX ConvBlock does
(``int8 and deterministic``).

Under sequence-parallel training (``seq`` with the rows' global
``lengths``, ``parallel/seqtrain.py``) x holds this rank's frames: the
crop is padded to a multiple of 2**depth globally, the pad frames the last
rank's; each 3x3 conv exchanges its one-frame halos; a pool's pair or an
upsample's source frame may sit on the neighbour, and is fetched; every
level's mask is the one-pass mask's frames (built from the lengths).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mqgan_tpu_torch.nn.activations import aptx
from mqgan_tpu_torch.nn.conv import Dense, WNConv2d, cast
from mqgan_tpu_torch.nn.layers import checkpoint, dropout
from mqgan_tpu_torch.ops.int8_conv import int8_conv, quantize_weights


def _mask4(x: torch.Tensor, m: torch.Tensor | None) -> torch.Tensor:
    """x (B, C, T, F), m (B, T) True = pad."""
    if m is None:
        return x
    return x.masked_fill(m[:, None, :, None], 0.0)


def _int8_args(conv: WNConv2d, dtype: torch.dtype) -> tuple:
    """(wq, sw, bias) of a 3x3 conv: its folded kernel cast to the compute
    dtype, then quantized (ops/int8_conv.py)."""
    return (*quantize_weights(cast(conv.folded(), dtype)),
            cast(conv.bias, torch.float32))


class ConvBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, dropout: float = 0.1,
                 int8: bool = False):
        super().__init__()
        self.dropout = dropout
        self.int8 = int8
        self.residual = c_in == c_out
        self.conv1 = WNConv2d(c_in, c_out, 3)
        self.conv2 = WNConv2d(c_out, c_out, 3)

    def forward(self, x, m=None, generator=None, seq=None, deterministic=True):
        x = _mask4(x, m)
        if self.int8 and deterministic:
            dt = x.dtype
            y = aptx(int8_conv(x, *_int8_args(self.conv1, dt)))
            y = aptx(int8_conv(y, *_int8_args(self.conv2, dt)))
            if self.residual:
                y = y + x
            return _mask4(y, m)
        y = dropout(aptx(self.conv1(x, seq)), self.dropout, generator)
        y = dropout(aptx(self.conv2(y, seq)), self.dropout, generator)
        if self.residual:
            y = y + x
        return _mask4(y, m)


class UNetRefiner(nn.Module):
    def __init__(self, in_features: int, base_ch: int = 128, depth: int = 3,
                 out_features: int = 128, dropout: float = 0.1,
                 remat: bool = False, int8: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        self.int8 = int8
        chs = [base_ch * 2 ** i for i in range(depth + 1)]
        self.pre = ConvBlock(1, chs[0], dropout)
        self.downs = nn.ModuleList(ConvBlock(chs[i], chs[i + 1], dropout, int8)
                                   for i in range(depth))
        self.mid = ConvBlock(chs[-1], chs[-1], dropout, int8)
        self.ups = nn.ModuleList(
            ConvBlock(chs[depth - i] + chs[depth - i - 1], chs[depth - i - 1],
                      dropout, int8)
            for i in range(depth))
        self.post = WNConv2d(chs[0], 1, 3)
        self.reproj = Dense(in_features, out_features, bias=False)

    def _block(self, block, h, m, generator, seq=None, deterministic=False):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(lambda h_, m_, g_: block(h_, m_, g_, seq),
                              generator, h, m)
        return block(h, m, generator, seq, deterministic)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None, seq=None,
                lengths: torch.Tensor | None = None,
                deterministic: bool = True) -> torch.Tensor:
        """x (B, T, F) -> (B, T, out_features), in x's dtype. ``seq``: x
        holds this rank's frames of a crop whose rows have ``lengths``.
        ``deterministic=False`` (training) keeps the int8 blocks on the
        float convs."""
        if seq is not None:
            return self._seq_forward(x, pad_mask, generator, seq, lengths)
        original_len = x.shape[1]
        pad_len = (-original_len) % (1 << self.depth)
        img = F.pad(x[:, None], (0, 0, 0, pad_len))
        img = img.contiguous(memory_format=torch.channels_last)
        m = pad_mask
        if pad_mask is not None and pad_len:
            m = F.pad(pad_mask, (0, pad_len), value=True)

        det = deterministic
        h = self._block(self.pre, img, m, generator, None, det)
        skips = []
        for down in self.downs:
            skips.append(h)
            h = F.avg_pool2d(h, (2, 1))
            if m is not None:
                m = m[:, : (m.shape[1] // 2) * 2].reshape(
                    m.shape[0], -1, 2).any(dim=-1)
            h = self._block(down, h, m, generator, None, det)
        h = self._block(self.mid, h, m, generator, None, det)
        for up in self.ups:
            h = h.repeat_interleave(2, dim=2)
            if m is not None:
                m = m.repeat_interleave(2, dim=1)
            skip = skips.pop()
            dt = skip.shape[2] - h.shape[2]
            if dt > 0:  # center-crop the skip's T to match
                skip = skip[:, :, dt // 2: dt // 2 + h.shape[2]]
            h = self._block(up, torch.cat([h, skip], dim=1), m, generator,
                            None, det)

        out = self.post(_mask4(h, m))[:, 0, :original_len]  # (B, T, F)
        if pad_mask is not None:
            out = out.masked_fill(pad_mask[..., None], 0.0)
        return self.reproj(out)

    def _seq_forward(self, x, pad_mask, generator, seq, lengths):
        total = seq.total
        t_pad = -(-total // (1 << self.depth)) * (1 << self.depth)
        shard = seq.padded(t_pad)
        img = F.pad(x[:, None], (0, 0, 0, t_pad - total if seq.is_last else 0))
        img = img.contiguous(memory_format=torch.channels_last)
        # the one-pass masks of every level, in its order (pools down, then
        # repeats up), each cut to this rank's frames at that level
        m = F.pad(torch.arange(total, device=x.device)[None, :] >= lengths[:, None],
                  (0, t_pad - total), value=True)
        shards = [shard]
        masks = [m]
        for _ in range(self.depth):
            m = m.reshape(m.shape[0], -1, 2).any(dim=-1)
            masks.append(m)
            shards.append(shards[-1].window(2, 2)[0])

        h = self._block(self.pre, img, shard.take(masks[0], 1), generator, shard)
        skips = []
        for i, down in enumerate(self.downs):
            skips.append(h)
            h, _ = shards[i].conv(h, 2, 2, lambda w: F.avg_pool2d(w, (2, 1)), stride=2)
            h = self._block(down, h, shards[i + 1].take(masks[i + 1], 1),
                            generator, shards[i + 1])
        level = self.depth
        h = self._block(self.mid, h, shards[level].take(m, 1), generator, shards[level])
        for up in self.ups:
            h = shards[level].upsample2(h, 2, shards[level - 1])
            m = m.repeat_interleave(2, dim=1)
            level -= 1
            h = self._block(up, torch.cat([h, skips.pop()], dim=1),
                            shards[level].take(m, 1), generator, shards[level])
        out = self.post(_mask4(h, shards[0].take(m, 1)), shard)[:, 0, :seq.local]
        out = out.masked_fill(pad_mask[..., None], 0.0)
        return self.reproj(out)
