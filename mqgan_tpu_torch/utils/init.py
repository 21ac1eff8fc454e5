"""Seeded initialisation without JAX, after the JAX package's scheme (not
its bits): lecun-normal kernels (truncated normal, variance 1/fan_in),
weight-norm magnitudes g = ||v||, zero biases, APTx beta = 1, gamma = 0.5;
for the token LMs flax's embedding init (normal, variance 1/features);
LayerNorm and InstanceNorm scale 1, bias 0; for the discriminators'
spectrally normalized convs normal(0, 0.02) kernels, a standard-normal
``u`` and sigma = 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mqgan_tpu_torch.nn.norm import InstanceNorm1d

# flax's truncated-normal stddev correction for truncation at +-2 sigma
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    gen = torch.Generator().manual_seed(seed)
    named = dict(module.named_parameters())
    for name, p in named.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("v", "weight"):
            fan_in = max(1, p[0].numel())  # (O, I, *k): I * prod(k)
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(p.shape)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            p.copy_(w)
        elif leaf == "bias":
            p.zero_()
        elif leaf == "beta":
            p.fill_(1.0)
        elif leaf == "gamma":
            p.fill_(0.5)
    for name, p in named.items():
        if name.endswith(".g"):
            v = named[name[:-1] + "v"]
            p.copy_(v.flatten(1).norm(dim=1))
    for sub in module.modules():
        if isinstance(sub, nn.Embedding):
            w = torch.empty(sub.weight.shape)
            nn.init.normal_(w, 0.0, math.sqrt(1.0 / w.shape[1]), generator=gen)
            sub.weight.copy_(w)
        elif isinstance(sub, (nn.LayerNorm, InstanceNorm1d)):
            sub.weight.fill_(1.0)
            sub.bias.zero_()
        elif hasattr(sub, "u") and hasattr(sub, "sigma"):  # SNConv2d
            w = torch.empty(sub.weight.shape)
            nn.init.normal_(w, 0.0, 0.02, generator=gen)
            sub.weight.copy_(w)
            sub.u.copy_(torch.randn(sub.u.shape, generator=gen))
            sub.sigma.fill_(1.0)
    return module
