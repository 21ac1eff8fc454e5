"""The reductions of a data-parallel train step on ``torch.distributed``.

The JAX package trains under GSPMD, and XLA inserts every cross-replica
reduction of its sharded step (``mqgan_tpu/parallel/mesh.py:1-15``): the
gradient psum, the LeCam EMA sync and the global reductions behind every
masked loss mean. In PyTorch each one is explicit, and this module holds
them. Each rank holds rows [rank * lb, (rank + 1) * lb) of every global
batch (``parallel/mesh.py`` ``batch_rows``).

A masked mean over the global batch is sum / count over all of its rows.
So each rank divides its partial sum by the GLOBAL count, which follows
from the global batch's lengths (``global_lengths``: one small reduction a
step), and the partial gradients are SUMMED (``all_reduce_grads_``). The
result is the one-process gradient however the valid rows fall on the
ranks. Averaging rank-local means, which is what DistributedDataParallel
computes, over-weights the rows of a rank whose rows are short (and a
short final batch's zero-length fill rows).

Under sequence parallelism (``parallel/seqtrain.py``) the world is a
data x seq grid, seq innermost (``parallel/mesh.py`` ``train_grid``): the
seq ranks of one data rank hold the same rows, each its frames of them.
The rule extends to the time axis: each rank's partial sums over its rows
AND frames are divided by the global counts, and gradients, loss metrics
and the code histogram are summed over the whole world. Only the global
lengths are gathered over the data ranks alone.

Only ``all_reduce`` and ``broadcast`` are used, so that gloo reduces CUDA
tensors too (ranks that share one card). Every function is the identity
in one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List

import torch
import torch.distributed as dist

from mqgan_tpu_torch.parallel.mesh import batch_rows, train_grid


def world() -> tuple:
    """(rank, world size) of this process's group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` on one flat buffer per (dtype, device) holding
    ``tensors``, then copy the results back into them."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_(tensors: Iterable[torch.Tensor], op=None) -> int:
    """Reduce ``tensors`` in place over the group (SUM unless ``op``),
    coalesced into one buffer per dtype and device; returns the bytes
    reduced (0 in one process)."""
    tensors = list(tensors)
    if world()[1] == 1 or not tensors:
        return 0
    op = dist.ReduceOp.SUM if op is None else op
    _coalesced(tensors, lambda flat: dist.all_reduce(flat, op=op))
    return sum(t.numel() * t.element_size() for t in tensors)


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s values."""
    tensors = list(tensors)
    if world()[1] == 1 or not tensors:
        return
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src))


def all_reduce_grads_(params: Iterable[torch.Tensor]) -> int:
    """Sum the parameters' ``.grad`` over the group in one coalesced
    reduction; a parameter without a gradient gets zeros first, so that
    every rank reduces the same buffer. Returns the bytes reduced."""
    params = list(params)
    if world()[1] == 1:
        return 0
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return all_reduce_([p.grad for p in params])


def global_lengths(lengths: torch.Tensor, n_seq: int = 1) -> torch.Tensor:
    """The global batch's lengths from each data rank's (lb,) rows: the
    first seq rank of every data rank fills its rows of a zero (lb *
    data ranks,) vector and one SUM reduction over the world completes it
    (in fp32, exact for any length below 2**24)."""
    rank, n = world()
    if n == 1:
        return lengths
    data, n_data, seq = train_grid(rank, n, n_seq)
    lb = lengths.shape[0]
    buf = torch.zeros((lb * n_data,), dtype=torch.float32, device=lengths.device)
    if seq == 0:
        buf[batch_rows(lb * n_data, data, n_data)] = lengths.float()
    all_reduce_([buf])
    return buf.to(lengths.dtype)


def any_flag(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is True on any (a MAX reduction;
    the caller's host reads the result)."""
    if world()[1] == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    all_reduce_([t], op=dist.ReduceOp.MAX)
    return bool(t.item() > 0)


def barrier(device) -> None:
    """Wait for every rank (an all-reduce of one element, so that gloo and
    NCCL wait alike on CPU and CUDA tensors)."""
    if world()[1] > 1:
        all_reduce_([torch.zeros((1,), device=device)])


@dataclass(frozen=True)
class DataParallel:
    """This process's place in a data-parallel train step, its rank, the
    world size and the seq ranks per data rank, and the step's reductions:
    loss denominators count the global batch, so that summed partial
    gradients and losses are the one-process step's."""

    rank: int = 0
    world: int = 1
    n_seq: int = 1

    @classmethod
    def current(cls) -> "DataParallel":
        return cls(*world())

    def count_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        """The lengths that a step's loss denominators count: the global
        batch's (``lengths`` are this rank's rows' own)."""
        return global_lengths(lengths, self.n_seq)

    def reduce_grads_(self, params) -> int:
        return all_reduce_grads_(params)

    def reduce_sums_(self, tensors) -> int:
        """Partial sums (the LeCam (sum, count) pairs, the code histogram)
        to global sums."""
        return all_reduce_(tensors)

    def reduce_metrics_(self, tensors) -> int:
        """Each rank's partial losses (its sums over the global counts) to
        the global losses."""
        return all_reduce_(tensors)
