"""flax.linen layers that the token LMs use, with flax's numerics: parameters
stay fp32 and are cast to the compute dtype at use (flax ``dtype=``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Embed(nn.Embedding):
    """flax ``nn.Embed``: rows of the fp32 table, cast to ``dtype``."""

    def __init__(self, num_embeddings: int, features: int, dtype=None):
        super().__init__(num_embeddings, features)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        return out if self.dtype is None else out.to(self.dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: epsilon 1e-6, statistics and affine in fp32,
    the result in the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate). ``generator=None`` means deterministic (identity)."""
    if generator is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def checkpoint(fn, generator: torch.Generator | None, *args):
    """``torch.utils.checkpoint`` of ``fn(*args, generator)`` whose backward
    recompute draws the same random numbers as its forward. The stock
    checkpoint replays only the global RNGs, so the call runs on a copy of
    ``generator`` made from its state before the call, and ``generator``
    then moves on to where the forward left the copy."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    if generator is None:
        return _checkpoint(fn, *args, None, use_reentrant=False,
                           preserve_rng_state=False)
    start, end = generator.get_state(), {}

    def run(*a):
        gen = torch.Generator(device=generator.device)
        gen.set_state(start)
        out = fn(*a, gen)
        end["state"] = gen.get_state()
        return out

    out = _checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
    generator.set_state(end["state"])
    return out
