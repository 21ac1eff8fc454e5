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
(``parallel/multihost.py``), the counterpart of ``train_array_sharding``:
the ranks form a data x seq grid, seq innermost (``train_grid``); the
seq ranks of one data rank hold the same rows (``batch_rows`` of the data
ranks) and each its range of their frames (``frame_range``), the time
axis sharded as the JAX ``seq`` mesh axis shards it
(``parallel/seqtrain.py``).
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


def train_grid(rank: int, world: int, n_seq: int = 1) -> tuple:
    """(data index, data ranks, seq index) of ``rank`` in the data x seq
    grid of ``world`` ranks, seq innermost: the ranks of data index d are
    d * n_seq .. (d + 1) * n_seq - 1."""
    if n_seq < 1 or world % n_seq:
        raise ValueError(f"{world} ranks do not form a grid with "
                         f"{n_seq} sequence-parallel ranks per data rank")
    return rank // n_seq, world // n_seq, rank % n_seq


def frame_range(t: int, seq_index: int, n_seq: int) -> slice:
    """Seq rank ``seq_index``'s frames of a crop of ``t`` frames (which
    ``n_seq`` divides): [s * t / n, (s + 1) * t / n)."""
    if t % n_seq:
        raise ValueError(f"crop of {t} frames does not divide over {n_seq} "
                         "sequence-parallel ranks")
    step = t // n_seq
    return slice(seq_index * step, (seq_index + 1) * step)


def check_seq_crops(crop_lens, n_seq: int) -> None:
    """Every crop bucket divides by the sequence-parallel factor (the JAX
    trainer's rule and message)."""
    bad = [t for t in crop_lens if t % n_seq]
    if n_seq > 1 and bad:
        raise ValueError(
            f"crop buckets {bad} do not divide by the sequence-parallel "
            f"factor {n_seq}; even time shards need crop_len multiples of {n_seq}")


def check_seq_hosts(hosts, n_seq: int) -> None:
    """Every seq group sits inside one host (``hosts``: each rank's host, in
    rank order), as the JAX trainer requires of its processes under
    --multihost: the halo exchanges ride intra-host links."""
    for d in range(len(hosts) // n_seq):
        owners = sorted(set(hosts[d * n_seq:(d + 1) * n_seq]))
        if len(owners) > 1:
            raise ValueError(
                f"seq-parallel group {d} (ranks {d * n_seq}..{(d + 1) * n_seq - 1}) "
                f"spans hosts {owners}: under --multihost each seq group must sit "
                f"inside one host (choose --seq_par dividing the ranks per host; "
                f"seq is the innermost axis of the rank grid)")


def train_devices(cards, n_seq: int) -> list:
    """The ranks' devices of a trainer that spawns its own: every card when
    ``n_seq`` divides their count (data = count / n_seq), else ``n_seq``
    ranks sharing the cards round robin when the count divides ``n_seq``."""
    cards = list(cards)
    if len(cards) % n_seq == 0:
        return cards
    if n_seq % len(cards) == 0:
        return [cards[i % len(cards)] for i in range(n_seq)]
    raise ValueError(f"--seq_par {n_seq} and {len(cards)} visible cards: one must "
                     "divide the other")


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
