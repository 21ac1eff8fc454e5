"""Reconstruction and feature-matching losses (counterpart of
``mqgan_tpu/losses/recon.py``).

* ``masked_mel_loss``: Charbonnier or MSE per frequency group, so that
  every sub-band counts equally;
* ``masked_mae``: masked L1 between discriminator feature maps.

A ``count`` is the mask's valid count over the GLOBAL batch of a
data-parallel step (``parallel/dp.py``): frames for ``masked_mel_loss``,
unmasked positions of ``pad_mask`` for ``masked_mae``. Under
sequence-parallel training the tensors hold a rank's frames and the
lengths its local prefix of them (``SeqShard.local_lengths``).
"""

from __future__ import annotations

import math

import torch

from mqgan_tpu_torch.core.masking import sequence_mask


def masked_mel_loss(x: torch.Tensor, y: torch.Tensor, lengths: torch.Tensor, *,
                    loss_type: str = "charbonnier", group_size: int = 1,
                    eps: float = 1e-6, count=None) -> torch.Tensor:
    """x, y (B, T, C), lengths (B,) -> fp32 scalar."""
    if x.shape != y.shape:
        raise ValueError(f"shapes differ: {tuple(x.shape)} {tuple(y.shape)}")
    b, t, c = x.shape
    if c % group_size:
        raise ValueError("C (n_mels) must be divisible by group_size")
    pad = sequence_mask(t, lengths)
    diff = x.float() - y.float()
    if loss_type == "charbonnier":
        per_elem = torch.sqrt(torch.square(diff) + eps * eps)
    elif loss_type == "mse":
        per_elem = torch.square(diff)
    else:
        raise ValueError(loss_type)
    per_elem = per_elem.masked_fill(pad[..., None], 0.0)
    group_sum = per_elem.reshape(b, t, c // group_size, group_size).sum(
        dim=(0, 1, 3))
    valid_per_frame = ((~pad).sum() if count is None else count) * group_size
    return (group_sum / (valid_per_frame.float() + 1e-12)).mean()


def masked_mae(pred: torch.Tensor, target: torch.Tensor, pad_mask: torch.Tensor,
               eps: float = 1e-8, count=None) -> torch.Tensor:
    """Masked mean absolute error; pad_mask True = padded, broadcast over
    the trailing (channel) axes."""
    diff = torch.abs(pred.float() - target.float())
    m = pad_mask.reshape(tuple(pad_mask.shape)
                         + (1,) * (diff.ndim - pad_mask.ndim)).expand(diff.shape)
    diff = diff.masked_fill(m, 0.0)
    if count is None:
        valid = (~m).sum().float()
    else:  # count x the trailing axes (a rank may hold no frame of a map)
        valid = count * math.prod(diff.shape[pad_mask.ndim:])
    return diff.sum() / (valid + eps)
