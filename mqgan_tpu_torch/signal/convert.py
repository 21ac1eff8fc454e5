"""Batch wav -> log-mel conversion CLI (counterpart of
``mqgan_tpu/signal/convert.py``).

Walk the input tree, mirror its directories into the output folder, skip
files whose output already exists (resume), resample to the configured
rate, gate clips outside [1 s, 15 s], extract log-mels (``signal/mel.py``,
the hand-written kernel on the card) and save ``{name}_mel.npy`` as float32;
fan the files out over worker processes by static striping.

The front end runs on ``--device`` (default ``cuda``; it raises without a
card; pass ``cpu`` for the plain PyTorch version). Workers are started with
the ``spawn`` method: a forked child cannot use CUDA.

Usage: python -m mqgan_tpu_torch.signal.convert --config spec_config.yaml
       [--input_folder ...] [--output_folder ...] [--num_workers N]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
from typing import List, Tuple

import numpy as np

from mqgan_tpu_torch.core.config import SpecConfig
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.signal.audio import (UnsupportedFormatError, load_audio,
                                          resample, to_mono)

MIN_DURATION_S = 1.0  # the reference converter's gate
MAX_DURATION_S = 15.0


class MelExtractor:
    """Per-process wav -> log-mel pipeline (the front end is built at first
    use, in the process that uses it)."""

    def __init__(self, config: SpecConfig, device="cuda"):
        self.config = config
        self.device = device
        self._frontend = None

    @property
    def frontend(self):
        if self._frontend is None:
            from mqgan_tpu_torch.signal.mel import MelFrontend

            self._frontend = MelFrontend(self.config.spectrogram, device=self.device)
        return self._frontend

    def process_file(self, file_path: str, output_dir: str) -> bool:
        base = os.path.splitext(os.path.basename(file_path))[0]
        out_path = os.path.join(output_dir, f"{base}_mel.npy")
        if os.path.isfile(out_path):  # resume-skip
            return True
        target_sr = self.config.spectrogram.sampling_rate
        try:
            wav, sr = load_audio(file_path)
            if sr and sr != target_sr:
                wav = resample(wav, sr, target_sr)
            wav = to_mono(wav)
        except UnsupportedFormatError as e:
            print(f"Skipping {file_path}: {e}")
            return False
        except (OSError, ValueError) as e:  # one unreadable file must not stop the run
            print(f"Error reading {file_path}: {e}")
            return False

        duration = wav.shape[1] / target_sr
        if duration < MIN_DURATION_S or duration > MAX_DURATION_S:
            return False  # duration gate

        # errors of the front end and its kernel propagate
        mel = self.frontend(wav[0]).cpu().numpy()  # (frames, n_mels)
        np.save(out_path, mel.astype(np.float32))
        return True


def _run_shard(shard_id: int, tasks: List[Tuple[str, str]], config: SpecConfig,
               device: str):
    extractor = MelExtractor(config, device)
    n = len(tasks)
    for i, (file_path, output_dir) in enumerate(tasks):
        os.makedirs(output_dir, exist_ok=True)
        extractor.process_file(file_path, output_dir)
        if (i + 1) % 50 == 0:
            print(f"[shard {shard_id}] {i + 1}/{n}")


def shard_tasks(tasks: List, n: int) -> List[List]:
    """Static round-robin assignment of tasks to n worker shards (striping
    balances mixed file sizes and is order-independent per shard)."""
    return [tasks[i::n] for i in range(n)]


def collect_tasks(config: SpecConfig) -> List[Tuple[str, str]]:
    tasks = []
    in_dir = config.io.input_folder
    out_dir = config.io.output_folder
    exts = tuple(config.io.audio_extensions) + (".npy",)
    for root, _, files in os.walk(in_dir):
        rel = os.path.relpath(root, in_dir)
        out_sub = os.path.join(out_dir, rel)
        for fn in files:
            if fn.lower().endswith(exts):
                tasks.append((os.path.join(root, fn), out_sub))
    return tasks


def run(config: SpecConfig, num_workers: int | None = None, device: str = "cuda"):
    config.validate()
    device = str(resolve_device(device))  # no card for "cuda": raise here
    os.makedirs(config.io.output_folder, exist_ok=True)
    tasks = collect_tasks(config)
    print(f"{len(tasks)} audio files to convert")
    if not tasks:
        return

    num_workers = num_workers or multiprocessing.cpu_count()
    if num_workers <= 1 or len(tasks) < 4:
        _run_shard(0, tasks, config, device)
        return
    if device.startswith("cuda"):
        from mqgan_tpu_torch.ops import _cuda

        _cuda.build_library()  # once, before the workers would race to build it
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for i, shard in enumerate(shard_tasks(tasks, num_workers)):
        if not shard:
            continue
        p = ctx.Process(target=_run_shard, args=(i, shard, config, device))
        p.start()
        procs.append(p)
    for p in procs:
        p.join()
    failed = [p.exitcode for p in procs if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"convert workers exited with codes {failed}")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Convert audio files to log-mel spectrograms."
    )
    parser.add_argument("--config", type=str, default="spec_config.yaml")
    parser.add_argument("--input_folder", type=str, default=None)
    parser.add_argument("--output_folder", type=str, default=None)
    parser.add_argument("--num_workers", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="device of the mel front end: cuda (default; "
                             "the hand-written kernel, raises without a "
                             "card) or cpu (the plain PyTorch version)")
    args = parser.parse_args(argv)

    config = SpecConfig.from_yaml(args.config)
    io = config.io
    if args.input_folder:
        io = dataclasses.replace(io, input_folder=args.input_folder)
    if args.output_folder:
        io = dataclasses.replace(io, output_folder=args.output_folder)
    config = dataclasses.replace(config, io=io)

    run(config, num_workers=args.num_workers, device=args.device)


if __name__ == "__main__":
    main()
