"""MelMixer2D, the generator's mixer block (counterpart of
``mqgan_tpu/nn/mixer2d.py``) in its generator form: depthwise, weight norm,
fixed APTx. The (T, C) feature plane is a one-plane image: 5x5 conv ->
mask -> pointwise expansion to ``features`` planes -> mask -> APTx -> 1x1
contraction back to one plane.

Inference only. The exact path runs as ``ops/mixer_kernels.py``
``fused_mel_mixer``; ``poly_approx`` evaluates the pointwise MLP as the
Chebyshev interpolant, ``ops/mixer_poly.py`` ``fused_poly_mixer``. Each
launches its CUDA kernel for a CUDA tensor and takes its plain version for a
CPU tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.core.device import check_inference
from mqgan_tpu_torch.core.masking import lengths_from_mask
from mqgan_tpu_torch.nn.conv import WNConv2d
from mqgan_tpu_torch.ops.mixer_kernels import MixerWeights, fused_mel_mixer
from mqgan_tpu_torch.ops.mixer_poly import fused_poly_mixer


class MelMixer2D(nn.Module):
    def __init__(self, features: int, kernel_size: int = 5,
                 poly_approx: bool = False):
        super().__init__()
        self.poly_approx = poly_approx
        self.dw = WNConv2d(1, 1, kernel_size)
        self.pw = WNConv2d(1, features, 1)
        self.conv_out = WNConv2d(features, 1, 1, weight_norm=False)

    def kernel_weights(self) -> MixerWeights:
        w1 = self.pw.folded().reshape(-1)
        b1 = self.pw.bias.float()
        w2 = self.conv_out.weight.float().reshape(-1)
        consts = torch.stack([self.dw.bias.float()[0],
                              self.conv_out.bias.float()[0],
                              0.5 * (w2 * w1).sum(), 0.5 * (w2 * b1).sum()])
        return MixerWeights(dwk=self.dw.folded()[0, 0].contiguous(),
                            consts=consts, w1=w1.contiguous(),
                            b1=b1.contiguous(), w2=w2.contiguous())

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor | None = None,
                deterministic: bool = True) -> torch.Tensor:
        """x (B, T, C) -> (B, T, C) in x's dtype."""
        check_inference(deterministic)
        if pad_mask is None:
            pad_mask = torch.zeros(x.shape[:2], dtype=torch.bool,
                                   device=x.device)
        mixer = fused_poly_mixer if self.poly_approx else fused_mel_mixer
        return mixer(x.contiguous(), lengths_from_mask(pad_mask),
                     self.kernel_weights())
