"""ResidualBlock1D, the generator's core block (counterpart of
``mqgan_tpu/nn/blocks.py``), in its generator form: weight-normed convs
("weight" norm, identity norms), trainable APTx ("taptx"), dilation 1:

conv1 -> mask -> act -> conv2 -> [CBAM if non-causal] -> + residual
(1x1 projection if channels change) -> mask -> act.

Inference only. The whole block runs as ``ops/block_kernels.py``
``fused_residual_block``: the CUDA kernels for a CUDA tensor, the plain
PyTorch version for a CPU tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.core.device import check_inference
from mqgan_tpu_torch.core.masking import lengths_from_mask
from mqgan_tpu_torch.nn.activations import APTx
from mqgan_tpu_torch.nn.attention import CBAM1D
from mqgan_tpu_torch.nn.conv import WNConv1d
from mqgan_tpu_torch.ops.block_kernels import BlockWeights, fused_residual_block


class ResidualBlock1D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        self.conv1 = WNConv1d(in_channels, out_channels, kernel_size,
                              causal=causal)
        self.conv2 = WNConv1d(out_channels, out_channels, kernel_size,
                              causal=causal)
        self.residual = (WNConv1d(in_channels, out_channels, 1,
                                  weight_norm=False)
                         if in_channels != out_channels else None)
        self.cbam = CBAM1D(out_channels) if not causal else None
        self.act = APTx(trainable=True)

    def kernel_weights(self, dtype: torch.dtype) -> BlockWeights:
        """Fold the parameters into the layouts the kernel reads."""

        def taps(conv):  # (O, I, K) -> (K, I, O)
            return conv.folded().permute(2, 1, 0).to(dtype).contiguous()

        extra = {}
        if self.residual is not None:
            extra.update(proj_w=self.residual.weight[:, :, 0].t().to(dtype)
                         .contiguous(),
                         proj_b=self.residual.bias.float().contiguous())
        if self.cbam is not None:
            cam = self.cbam.channel_attention
            extra.update(
                cw1=cam.mlp_0.weight.t().to(dtype).contiguous(),
                cb1=cam.mlp_0.bias.float().contiguous(),
                cw2=cam.mlp_2.weight.t().to(dtype).contiguous(),
                cb2=cam.mlp_2.bias.float().contiguous(),
                sam_w=self.cbam.spatial_attention.conv.weight[0].t().float()
                .contiguous())
        return BlockWeights(
            act=torch.stack([self.act.beta, self.act.gamma]).float(),
            w1=taps(self.conv1), b1=self.conv1.bias.float().contiguous(),
            w2=taps(self.conv2), b2=self.conv2.bias.float().contiguous(),
            **extra)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None,
                deterministic: bool = True) -> torch.Tensor:
        check_inference(deterministic)
        if pad_mask is None:
            pad_mask = torch.zeros(x.shape[:2], dtype=torch.bool,
                                   device=x.device)
        return fused_residual_block(
            x.contiguous(), lengths_from_mask(pad_mask),
            self.kernel_weights(x.dtype), causal=self.causal)
