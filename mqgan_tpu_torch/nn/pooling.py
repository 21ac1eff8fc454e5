"""Masked global pooling over time for (B, T, C) tensors (counterpart of
``mqgan_tpu/nn/pooling.py`` ``masked_max_pool`` / ``masked_avg_pool``).
The causal pools are not ported: the generator's CBAM is non-causal.

Under sequence parallelism (parallel/seqpar.py) each window of a clip pools
its own frames: ``partial_pool`` gives the window's fp32 sum, max and frame
count, ``reduce_pools`` combines the windows' partials with the caller's
``reduce(sum, max) -> (sum, max)`` (the counterpart of JAX's psum / pmax
over the mesh axis; the count rides as the sum's last column, as JAX psums
the (total, count) pair), and the mean is the reduced sum over the reduced
count, clamped to >= 1 only after the reduction (JAX ``masked_avg_pool``
with ``axis_name``). Sequence-parallel training (``seq_pools``) reduces the
same partials over a seq group with their gradients
(``parallel/seqtrain.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

Reduce = Callable[[torch.Tensor, torch.Tensor], tuple]

_NEG_INF = -1e30


def masked_max_pool(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, C), (B, T) -> (B, C): max over valid time steps."""
    return x.masked_fill(pad_mask[..., None], _NEG_INF).amax(dim=1)


def masked_avg_pool(x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """(B, T, C), (B, T) -> (B, C): mean over valid steps, count >= 1."""
    valid = (~pad_mask).to(x.dtype)[..., None]
    total = (x * valid).sum(dim=1)
    count = valid.sum(dim=1)
    return total / count.clamp_min(1.0)


def partial_pool(x: torch.Tensor, stats_mask: torch.Tensor) -> tuple:
    """(B, T, C), (B, T) -> fp32 (sum (B, C), max (B, C), count (B,)) over
    the frames that ``stats_mask`` leaves (True = excluded); the max of a
    row with no such frame is the -1e30 fill."""
    keep = (~stats_mask)[..., None]
    total = (x * keep.to(x.dtype)).float().sum(dim=1)
    mx = x.masked_fill(~keep, _NEG_INF).amax(dim=1).float()
    return total, mx, keep[..., 0].sum(dim=1).float()


def reduce_pools(total: torch.Tensor, mx: torch.Tensor, count: torch.Tensor,
                 reduce: Optional[Reduce]) -> tuple:
    """The windows' partial (sum, max, count) combined by ``reduce``: one
    call, with the count as the sum's last column. ``None`` is one window."""
    if reduce is None:
        return total, mx, count
    s, m = reduce(torch.cat([total, count[:, None]], dim=1), mx)
    return s[:, :-1], m, s[:, -1]


def pooled_mean(total: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The mean from a (reduced) sum and count, the count clamped to >= 1."""
    return total / count.clamp_min(1.0)[:, None]


def seq_pools(x: torch.Tensor, pad_mask: torch.Tensor, seq) -> tuple:
    """(masked max, masked mean) (B, C) in x's dtype over the valid frames
    of every rank of ``seq``'s group, x (B, T, C) this rank's frames: the
    fp32 sum and count summed over the group, the max taken over it, both
    with their gradients."""
    keep = (~pad_mask)[..., None]
    mx = seq.max(x.masked_fill(~keep, _NEG_INF), 1)
    return mx, seq_masked_mean(x, keep, 1, seq)


def seq_masked_mean(x: torch.Tensor, keep: torch.Tensor, dims, seq) -> torch.Tensor:
    """(B, C) in x's dtype: the mean of x (B, C, ...) over ``dims`` where
    ``keep`` (broadcast to x, size 1 on C) holds, over every rank of
    ``seq``'s group: the fp32 sum and count (the count as the sum's last
    column) summed over the group with their gradient, the count clamped
    to >= 1 after the reduction."""
    s = seq.sum(torch.cat([(x * keep.to(x.dtype)).float().sum(dim=dims),
                           keep.float().sum(dim=dims)], dim=1))
    return pooled_mean(s[:, :-1], s[:, -1]).to(x.dtype)
