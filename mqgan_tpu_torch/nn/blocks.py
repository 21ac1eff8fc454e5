"""ResidualBlock1D, the generator's core block (counterpart of
``mqgan_tpu/nn/blocks.py``) with trainable APTx ("taptx") and dilation 1:

conv1 -> norm1 -> mask -> act -> conv2 -> norm2 -> [CBAM if non-causal]
-> + residual (1x1 projection if channels change) -> mask -> act -> dropout.

``norm``: "weight" (the generator's: weight-normed convs, identity norms),
"layer" or "instance" (plain convs with nn/norm.py's norms).

At inference (``deterministic=True``) a "weight" block runs as
``ops/block_kernels.py`` ``fused_residual_block``: the CUDA kernels for a
CUDA tensor, the plain PyTorch version for a CPU tensor. Training
(``deterministic=False``) and the other norms run the module-by-module
composition, as the JAX package sends only "weight" blocks to its kernel
and trains through its XLA path; dropout masks come from ``generator``
(None: no dropout).

``stats_mask`` / ``reduce`` (non-causal blocks, sequence parallelism):
the CBAM channel gate pools the frames ``stats_mask`` leaves and combines
the windows' statistics with ``reduce`` (nn/attention.py); on the kernel
path that is the split launch, with each row's stats frames taken as one
contiguous range.

``seq`` (training, ``parallel/seqtrain.py``): x holds this rank's frames
of a time-sharded crop; the convs over time exchange their halos and the
CBAM's statistics reduce over the seq group.
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.core.masking import apply_mask, lengths_from_mask
from mqgan_tpu_torch.nn.activations import APTx
from mqgan_tpu_torch.nn.attention import CBAM1D
from mqgan_tpu_torch.nn.conv import WNConv1d, cast
from mqgan_tpu_torch.nn.layers import dropout
from mqgan_tpu_torch.nn.norm import make_norm
from mqgan_tpu_torch.nn.pooling import Reduce
from mqgan_tpu_torch.ops.block_kernels import (BlockWeights, fused_residual_block,
                                               split_residual_block)


def stats_range(stats_mask: torch.Tensor) -> tuple:
    """(B, T) stats mask (True = left out) -> (lo, hi) int32 (B,): the
    first frame each row keeps and the end of its run (rows keep one
    contiguous run of frames)."""
    keep = ~stats_mask
    count = keep.sum(dim=1, dtype=torch.int32)
    lo = torch.where(count > 0, keep.int().argmax(dim=1).int(),
                     torch.zeros_like(count))
    return lo, lo + count


class ResidualBlock1D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, causal: bool = False,
                 dropout: float = 0.3, norm: str = "weight"):
        super().__init__()
        self.kernel_size = kernel_size
        self.dropout = dropout
        self.causal = causal
        self.norm = norm
        wn = norm == "weight"
        self.conv1 = WNConv1d(in_channels, out_channels, kernel_size,
                              causal=causal, weight_norm=wn)
        self.conv2 = WNConv1d(out_channels, out_channels, kernel_size,
                              causal=causal, weight_norm=wn)
        self.norm1 = make_norm(norm, out_channels)
        self.norm2 = make_norm(norm, out_channels)
        self.residual = (WNConv1d(in_channels, out_channels, 1,
                                  weight_norm=False)
                         if in_channels != out_channels else None)
        self.cbam = CBAM1D(out_channels) if not causal else None
        self.act = APTx(trainable=True)

    def kernel_weights(self, dtype: torch.dtype) -> BlockWeights:
        """Fold the parameters into the layouts the kernel reads."""

        def taps(conv):  # (O, I, K) -> (K, I, O)
            return cast(conv.folded().permute(2, 1, 0), dtype).contiguous()

        def f32(t):
            return cast(t, torch.float32).contiguous()

        extra = {}
        if self.residual is not None:
            extra.update(proj_w=cast(self.residual.weight[:, :, 0].t(), dtype)
                         .contiguous(),
                         proj_b=f32(self.residual.bias))
        if self.cbam is not None:
            cam = self.cbam.channel_attention
            extra.update(
                cw1=cast(cam.mlp_0.weight.t(), dtype).contiguous(),
                cb1=f32(cam.mlp_0.bias),
                cw2=cast(cam.mlp_2.weight.t(), dtype).contiguous(),
                cb2=f32(cam.mlp_2.bias),
                sam_w=f32(self.cbam.spatial_attention.conv.weight[0].t()))
        return BlockWeights(
            act=f32(torch.stack([self.act.beta, self.act.gamma])),
            w1=taps(self.conv1), b1=f32(self.conv1.bias),
            w2=taps(self.conv2), b2=f32(self.conv2.bias),
            **extra)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None,
                deterministic: bool = True,
                generator: torch.Generator | None = None,
                stats_mask: torch.Tensor | None = None,
                reduce: Reduce | None = None, seq=None) -> torch.Tensor:
        if seq is not None and (deterministic or self.norm == "instance"
                                or stats_mask is not None or reduce is not None):
            raise ValueError("sequence parallelism is a training branch of a "
                             "block without instance norm or window statistics")
        if pad_mask is None:
            pad_mask = torch.zeros(x.shape[:2], dtype=torch.bool,
                                   device=x.device)
        if self.causal and (stats_mask is not None or reduce is not None):
            raise NotImplementedError(
                "causal CAM has no sequence-parallel variant (causal blocks "
                "drop CBAM)")
        if not deterministic or self.norm != "weight":
            return self._module_forward(
                x, pad_mask, None if deterministic else generator, stats_mask,
                reduce, seq)
        x, lengths = x.contiguous(), lengths_from_mask(pad_mask)
        weights = self.kernel_weights(x.dtype)
        if stats_mask is None and reduce is None:
            return fused_residual_block(x, lengths, weights, causal=self.causal)
        lo, hi = stats_range(pad_mask if stats_mask is None else stats_mask)
        return split_residual_block(x, lengths, weights, lo, hi, reduce)

    def _module_forward(self, x, pad_mask, generator, stats_mask, reduce,
                        seq=None):
        residual = self.residual(x) if self.residual is not None else x
        out = self.norm1(self.conv1(x, seq)).to(x.dtype)
        out = self.act(apply_mask(out, pad_mask))
        out = self.norm2(self.conv2(out, seq)).to(x.dtype)
        if self.cbam is not None:
            out = self.cbam(out, pad_mask, stats_mask, reduce, seq)
        out = self.act(apply_mask(out + residual, pad_mask))
        return dropout(out, self.dropout, generator)
