"""APTx — (alpha + tanh(beta*x)) * gamma * x (counterpart of
``mqgan_tpu/nn/activations.py``). beta/gamma are fp32 and cast to the
activation's dtype at use, as in the JAX package."""

from __future__ import annotations

import torch
from torch import nn


def aptx(x: torch.Tensor, alpha=1.0, beta=1.0, gamma=0.5) -> torch.Tensor:
    """Op-by-op in x's dtype, like ``jnp`` does for bf16 inputs."""
    if torch.is_tensor(beta) and beta.dtype != x.dtype:
        beta = beta.to(x.dtype)
    if torch.is_tensor(gamma) and gamma.dtype != x.dtype:
        gamma = gamma.to(x.dtype)
    return (alpha + torch.tanh(beta * x)) * gamma * x


class APTx(nn.Module):
    """Fixed (alpha=1, beta=1, gamma=0.5) or trainable ("taptx") APTx."""

    def __init__(self, trainable: bool = False, alpha: float = 1.0,
                 beta: float = 1.0, gamma: float = 0.5):
        super().__init__()
        self.alpha = alpha
        self.trainable = trainable
        if trainable:
            self.beta = nn.Parameter(torch.tensor(beta, dtype=torch.float32))
            self.gamma = nn.Parameter(torch.tensor(gamma, dtype=torch.float32))
        else:
            self.beta, self.gamma = beta, gamma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return aptx(x, self.alpha, self.beta, self.gamma)
