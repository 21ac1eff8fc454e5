"""Devices for parallel serving and the rows of data-parallel training
(counterpart of ``mqgan_tpu/parallel/mesh.py`` and of
``mqgan_tpu/core/buckets.py`` ``repeat_pad_rows``).

JAX serves in parallel from one controller: a ``shard_map`` over the local
devices, or one compiled copy of an exported program per device. The port
keeps that shape with a plain list of ``torch.device`` and one model copy
per distinct device: CUDA launches to different cards from one host thread
run concurrently, since each launch returns before its kernels end. A list
may name a device more than once, so that one card (or the CPU, in the
tests) holds several windows or batch slices.

Training runs one process a rank on ``torch.distributed``
(``parallel/multihost.py``); ``batch_rows`` is each rank's share of a
global batch, the counterpart of ``batch_axes`` / ``train_array_sharding``
with the batch axis over the processes and no seq axis.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from mqgan_tpu_torch.core.device import resolve_device


def local_devices(devices=None) -> list:
    """``devices`` as ``torch.device``s (a "cuda" without an index becomes
    the current card), or every visible card when None (raises without
    one: pass ``["cpu", ...]`` explicitly to run on the CPU)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = []
    for d in devices:
        d = resolve_device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("need at least one device")
    return out


def batch_rows(global_batch: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``global_batch`` rows over
    ``world`` ranks: [rank * lb, (rank + 1) * lb), lb = global_batch /
    world, so that the ranks' rows concatenated in rank order are the
    global batch."""
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{world} ranks")
    lb = global_batch // world
    return slice(rank * lb, (rank + 1) * lb)


def replicate(model: torch.nn.Module, devices) -> dict:
    """{device: model} for each distinct device of ``devices``: the model
    itself on its own device, a copy elsewhere. Inference only reads the
    weights, so windows or slices on one device share its copy."""
    home = next(model.parameters()).device
    out = {}
    for d in devices:
        if d not in out:
            out[d] = model if d == home else copy.deepcopy(model).to(d)
    return out


def repeat_pad_rows(arrays, multiple: int) -> tuple:
    """Repeat-pad each array's leading (batch) axis up to a multiple of
    ``multiple`` by cycling its rows (the data-parallel batch convention:
    padded rows are real rows, computed normally and trimmed by the
    caller). The arrays unchanged when the batch already divides."""
    b = arrays[0].shape[0]
    if b == 0:
        raise ValueError("cannot repeat-pad an empty batch")
    b_pad = -(-b // multiple) * multiple
    if b_pad == b:
        return tuple(arrays)
    reps = [i % b for i in range(b_pad - b)]
    return tuple(np.concatenate([a, a[reps]], axis=0) for a in arrays)


def split_rows(arrays, n: int) -> list:
    """n tuples of equal row slices of ``arrays`` (whose batch divides by
    n): slice i holds rows [i * B/n, (i + 1) * B/n)."""
    b = arrays[0].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not divide over {n} devices")
    per = b // n
    return [tuple(a[i * per:(i + 1) * per] for a in arrays) for i in range(n)]
