"""Host-side input pipeline for .npy mel datasets (counterpart of
``mqgan_tpu/train/data.py``).

Recursive .npy discovery, a seeded train/eval split, one crop length per
batch drawn from the configured list, random crop or right zero-pad to it,
failed loads dropped. ``MelLoader``'s sampling plan is the JAX package's,
a pure function of (seed, epoch, batch, row), so both packages see the same
batches. ``DevicePrefetcher`` stages the next batch while the current step
runs: pinned host memory and a non-blocking copy onto the card.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np
import torch

from mqgan_tpu_torch.utils.npy import find_npy_files, load_npy

__all__ = ["find_npy_files", "split_train_eval", "Batch", "MelDataset",
           "collate", "MelLoader", "DevicePrefetcher"]


def split_train_eval(files: Sequence[str], validation_split: float, seed: int):
    """Seeded random split: (train files, eval files)."""
    files = list(files)
    perm = np.random.default_rng(seed).permutation(len(files))
    eval_size = int(validation_split * len(files))
    eval_idx = set(perm[:eval_size].tolist())
    train = [f for i, f in enumerate(files) if i not in eval_idx]
    return train, [files[i] for i in perm[:eval_size]]


@dataclass
class Batch:
    mel: np.ndarray  # (B, T_crop, C) float32
    lengths: np.ndarray  # (B,) int32
    filenames: List[str]


class MelDataset:
    """(T, C) float32 mels; ``load`` returns None for a broken file."""

    def __init__(self, files: Sequence[str]):
        self.files = list(files)

    def __len__(self):
        return len(self.files)

    def load(self, idx: int):
        path = self.files[idx]
        try:
            mel = load_npy(path, np.float32)
        except (OSError, ValueError) as e:
            print(f"[Load error] {path}: {e}")
            return None
        if mel.ndim != 2:
            print(f"[Shape error] {path}: shape={mel.shape}")
            return None
        return mel


def collate(items: List[tuple], crop_lens: Sequence[int],
            rng: random.Random) -> Batch | None:
    """One crop length per batch, drawn; every (mel, name) item random-
    cropped or right zero-padded to it."""
    items = [it for it in items if it is not None]
    if not items:
        return None
    tgt = int(rng.choice(list(crop_lens)))
    mel = np.zeros((len(items), tgt, items[0][0].shape[1]), np.float32)
    lengths = np.zeros((len(items),), np.int32)
    names = []
    for i, (m, name) in enumerate(items):
        full = m.shape[0]
        if full > tgt:
            start = rng.randint(0, full - tgt)
            mel[i] = m[start:start + tgt]
            lengths[i] = tgt
        else:
            mel[i, :full] = m
            lengths[i] = full
        names.append(name)
    return Batch(mel=mel, lengths=lengths, filenames=names)


class MelLoader:
    """Shuffling, threaded batch iterator whose plan (the shuffle order,
    each batch's crop length and each row's crop start) is a pure function
    of (seed, epoch, batch, row) over the file list, as the JAX loader's
    process-count-invariant plan is (the port runs one process: multi-host
    loading is ROADMAP.md Queue 1 item 8). A short final batch (and a row
    whose file fails to load) becomes zero-length all-zero rows: every loss
    is masked by ``lengths``, so they weigh nothing, with one batch shape."""

    def __init__(self, dataset: MelDataset, batch_size: int,
                 crop_lens: Sequence[int], seed: int = 42,
                 num_threads: int = 8, drop_last: bool = False,
                 mel_channels: int | None = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop_lens = tuple(crop_lens)
        self.seed = seed
        self.num_threads = num_threads
        self.drop_last = drop_last
        self.mel_channels = mel_channels

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_rng(self, epoch: int, b: int, row: int | None = None):
        key = [self.seed & 0xFFFFFFFF, epoch, b]
        if row is not None:
            key.append(row)
        return np.random.default_rng(key)

    def crop_for_batch(self, epoch: int, b: int) -> int:
        r = self._batch_rng(epoch, b)
        return int(self.crop_lens[int(r.integers(len(self.crop_lens)))])

    def epoch(self, epoch: int) -> Iterator[Batch]:
        order = list(range(len(self.dataset)))
        random.Random(self.seed + epoch).shuffle(order)
        n = len(order)
        bs = self.batch_size
        num_batches = n // bs if self.drop_last else -(-n // bs)

        def load(g: int):
            return self.dataset.load(order[g]) if g < n else None

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            for b in range(num_batches):
                tgt = self.crop_for_batch(epoch, b)
                gidxs = [b * bs + i for i in range(bs)]
                mels = list(pool.map(load, gidxs))
                c = self.mel_channels
                if c is None:
                    c = next((m.shape[1] for m in mels if m is not None), None)
                    if c is None:
                        continue  # the whole batch failed; channels unknown
                mel = np.zeros((bs, tgt, c), np.float32)
                lengths = np.zeros((bs,), np.int32)
                names = []
                for i, (g, m) in enumerate(zip(gidxs, mels)):
                    if m is None:
                        names.append("<pad>")
                        continue
                    full = m.shape[0]
                    if full > tgt:
                        start = int(self._batch_rng(epoch, b, g).integers(
                            0, full - tgt + 1))
                        mel[i] = m[start:start + tgt]
                        lengths[i] = tgt
                    else:
                        mel[i, :full] = m
                        lengths[i] = full
                    names.append(os.path.basename(self.dataset.files[order[g]]))
                yield Batch(mel=mel, lengths=lengths, filenames=names)


class DevicePrefetcher:
    """Stage host batches onto ``device`` one step ahead: a thread copies
    each batch into pinned memory and starts a non-blocking copy (on the
    CPU the tensors are the host arrays). Yields (mel, lengths, host Batch)."""

    def __init__(self, it: Iterator[Batch], device, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._it = it
        self._device = torch.device(device)
        self._done = object()
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self._device.type != "cuda":
            return t
        return t.pin_memory().to(self._device, non_blocking=True)

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    break
                self._q.put((self._put(batch.mel), self._put(batch.lengths), batch))
        except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._done:
                self._thread.join()
                if self._error is not None:
                    raise self._error
                return
            yield item

    def close(self) -> None:
        """Stop staging (a consumer that leaves the epoch early) and join
        the thread."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
        self._thread.join()
