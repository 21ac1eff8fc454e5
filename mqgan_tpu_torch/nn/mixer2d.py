"""MelMixer2D, the generator's mixer block (counterpart of
``mqgan_tpu/nn/mixer2d.py``) in its generator form: depthwise, weight norm,
fixed APTx. The (T, C) feature plane is a one-plane image: 5x5 conv ->
mask -> pointwise expansion to ``features`` planes -> mask -> APTx -> 1x1
contraction back to one plane.

At inference the exact path runs as ``ops/mixer_kernels.py``
``fused_mel_mixer``; ``poly_approx`` evaluates the pointwise MLP as the
Chebyshev interpolant, ``ops/mixer_poly.py`` ``fused_poly_mixer``. Each
launches its CUDA kernel for a CUDA tensor and takes its plain version for a
CPU tensor.

Training (``deterministic=False``) runs the module-by-module composition
under autograd, as the JAX package trains through its XLA path: the
(B, T, C, features) hidden with Bernoulli dropout on it, or with
``fast_dropout`` the moment-matched Gaussian on the contraction
(``fast_dropout_contract``); with ``hidden_chunk_t`` the pointwise MLP runs
in checkpointed time chunks so that the hidden never exists whole (the
remat mode). Draws come from ``generator`` (None: no dropout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mqgan_tpu_torch.core.masking import lengths_from_mask
from mqgan_tpu_torch.nn.activations import aptx
from mqgan_tpu_torch.nn.conv import WNConv2d
from mqgan_tpu_torch.nn.layers import checkpoint, dropout
from mqgan_tpu_torch.ops.mixer_kernels import MixerWeights, fused_mel_mixer
from mqgan_tpu_torch.ops.mixer_poly import fused_poly_mixer


def fast_dropout_contract(h: torch.Tensor, w2: torch.Tensor,
                          generator: torch.Generator, keep_p: float
                          ) -> torch.Tensor:
    """Moment-matched Gaussian in place of dropout(h) @ w2: inverted
    Bernoulli dropout of h then the contraction has mean sum_f w2 h and
    variance (1-p)/p * sum_f w2^2 h^2 per output element, so draw one
    standard normal per OUTPUT element. Gradients flow through both
    moments."""
    mu = h @ w2
    var = (h * h).float() @ (w2 * w2).float()
    var = var * ((1.0 - keep_p) / keep_p)
    eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    # double-where safe sqrt: var is exactly 0 at padded or zero hiddens,
    # and d sqrt(0) = inf would make the backward inf * 0 = NaN
    pos = var > 0
    std = torch.sqrt(torch.where(pos, var, torch.ones_like(var)))
    noise = torch.where(pos, eps * std, torch.zeros_like(std))
    return mu + noise.to(mu.dtype)


class MelMixer2D(nn.Module):
    def __init__(self, features: int, kernel_size: int = 5,
                 poly_approx: bool = False, dropout: float = 0.1,
                 hidden_chunk_t: int | None = None,
                 fast_dropout: bool = False):
        super().__init__()
        self.poly_approx = poly_approx
        self.dropout = dropout
        self.hidden_chunk_t = hidden_chunk_t
        self.fast_dropout = fast_dropout
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
                deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x (B, T, C) -> (B, T, C) in x's dtype."""
        if pad_mask is None:
            pad_mask = torch.zeros(x.shape[:2], dtype=torch.bool,
                                   device=x.device)
        if not deterministic:
            return self._train_forward(x, pad_mask, generator)
        mixer = fused_poly_mixer if self.poly_approx else fused_mel_mixer
        return mixer(x.contiguous(), lengths_from_mask(pad_mask),
                     self.kernel_weights())

    def _pointwise(self, s, pm, w, generator):
        """The pointwise MLP of (B, t, C) depthwise outputs and their pad
        mask: expansion, mask, APTx, dropout, contraction."""
        w1, b1, w2, b2 = w
        h = s[..., None] * w1 + b1  # (B, t, C, features)
        h = aptx(h.masked_fill(pm[:, :, None, None], 0.0))
        if generator is not None and self.dropout > 0.0 and self.fast_dropout:
            return fast_dropout_contract(h, w2, generator, 1.0 - self.dropout) + b2
        return dropout(h, self.dropout, generator) @ w2 + b2

    def _train_forward(self, x, pad_mask, generator):
        cdt = x.dtype
        s = self.dw(x[:, None])[:, 0].masked_fill(pad_mask[..., None], 0.0)
        w = (self.pw.folded().reshape(-1).to(cdt), self.pw.bias.to(cdt),
             self.conv_out.weight.reshape(-1).to(cdt),
             self.conv_out.bias.to(cdt)[0])
        if self.hidden_chunk_t is None:
            return self._pointwise(s, pad_mask, w, generator)
        b, t, c = s.shape
        tc = min(self.hidden_chunk_t, t)
        pad_t = -(-t // tc) * tc - t
        s = F.pad(s, (0, 0, 0, pad_t))
        pm = F.pad(pad_mask, (0, pad_t), value=True)
        outs = [checkpoint(lambda sc, mc, gen: self._pointwise(sc, mc, w, gen),
                           generator, s[:, t0:t0 + tc], pm[:, t0:t0 + tc])
                for t0 in range(0, t + pad_t, tc)]
        return torch.cat(outs, dim=1)[:, :t]
