"""Batch dataset re-encoding through the codec (counterpart of
``mqgan_tpu/deploy/reencode.py``).

Recursive .npy discovery, batching, pad-to-bucket, encode -> decode with
lengths, trim to the original length, save into a mirrored output tree;
optionally the tokens too (for LM training). Two sources:

  --model_dir   an exported artifact (deploy/export.py)
  --checkpoint  a generator checkpoint (utils/checkpoint.py's sources) with
                --config

Files longer than the largest bucket go through OVERLAPPING windows with
seam discard (core/chunking.py). A file that cannot be read (``OSError``,
or ``ValueError`` from a bad .npy or a wrong shape) is counted and logged,
and the rest go on; any other error — a kernel's, CUDA's, a failed write —
propagates. The CLI exits non-zero when any file failed.

CLI:  python -m mqgan_tpu_torch.deploy.reencode --input_dir MELS
      --output_dir OUT (--model_dir EXP | --checkpoint CKPT --config CFG)
      [--save_tokens --tokens_dir TOKS] [--batch_size 8] [--bf16]
      [--exact_mixers] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import queue
import threading

import numpy as np
import torch

from mqgan_tpu_torch.core.chunking import chunk_plan
from mqgan_tpu_torch.core.config import load_model_config
from mqgan_tpu_torch.deploy.runtime import UNPORTED_PARALLEL, CodecRuntime
from mqgan_tpu_torch.utils.npy import find_npy_files, load_npy


class CheckpointReencoder(CodecRuntime):
    """In-process encode/decode from a generator checkpoint (no export):
    a CodecRuntime over the model built from ``config_path`` (YAML or JSON)
    with the weights of ``checkpoint_path`` (a reference or port
    ``.pth``/``.pt``, or an ``.npz`` JAX tree). ``poly_mixers`` defaults to
    the exact mixers here; the CLI defaults to "decode"."""

    def __init__(self, config_path: str, checkpoint_path: str,
                 buckets=(128, 256, 512, 1024), dtype=torch.float32,
                 data_parallel: bool = False, seq_parallel: bool = False,
                 poly_mixers: bool | str = False, device=None):
        from mqgan_tpu_torch.utils.checkpoint import pretrained_generator

        for name, on in (("data_parallel", data_parallel),
                         ("seq_parallel", seq_parallel)):
            if on:
                raise NotImplementedError(UNPORTED_PARALLEL.format(name))
        cfg = load_model_config(config_path)
        model = pretrained_generator(checkpoint_path, cfg.model, dtype=dtype,
                                     poly_mixers=poly_mixers)
        super().__init__(model, buckets=buckets, device=device)


def _read_batches(files, batch_size, mel_channels, q, stop):
    """Loader thread: per batch, a list of (path, mel or None, error or
    None); then None. An unexpected error is passed on for the consumer to
    raise."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    try:
        for start in range(0, len(files), batch_size):
            batch = []
            for path in files[start:start + batch_size]:
                try:
                    mel = load_npy(path, np.float32)
                    if mel.ndim != 2 or mel.shape[1] != mel_channels or not len(mel):
                        raise ValueError(f"mel of shape {mel.shape}, expected "
                                         f"(T > 0, {mel_channels})")
                    batch.append((path, mel, None))
                except (OSError, ValueError) as e:
                    batch.append((path, None, e))
            if not put(batch):
                return
        put(None)
    except Exception as e:  # noqa: BLE001 — re-raised by the consumer
        put(e)


def reencode_spectrograms(
    codec,
    input_dir: str,
    output_dir: str,
    *,
    batch_size: int = 8,
    save_tokens: bool = False,
    tokens_dir: str | None = None,
) -> dict:
    """Walk input_dir, re-encode every .npy mel, mirror the tree into
    output_dir (and the int64 tokens into tokens_dir with save_tokens).
    Returns {'processed': n, 'failed': n, 'frames': frames written}.

    Files longer than the largest bucket run in overlapping windows whose
    kept frames carry the generator's receptive field (the codec's
    ``halos`` and ``halo_align``)."""
    files = find_npy_files(input_dir)
    print(f"Found {len(files)} spectrograms under {input_dir}")
    os.makedirs(output_dir, exist_ok=True)
    if save_tokens and tokens_dir:
        os.makedirs(tokens_dir, exist_ok=True)
    max_chunk = max(codec.buckets)
    halo_l, halo_r = codec.halos
    align = int(codec.halo_align)
    processed = failed = frames = 0

    # read-ahead: the next batch's files load while the device computes
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    loader = threading.Thread(
        target=_read_batches,
        args=(files, batch_size, codec.mel_channels, q, stop), daemon=True)
    loader.start()
    try:
        while (item := q.get()) is not None:
            if isinstance(item, Exception):
                raise item
            for path, _, err in item:
                if err is not None:
                    print(f"could not read {path}: {err}")
                    failed += 1
            batch = [(path, mel) for path, mel, err in item if err is None]
            if not batch:
                continue
            mels = [mel for _, mel in batch]
            t_total = max(m.shape[0] for m in mels)
            t_max = min(t_total, max_chunk)
            out_specs = [np.zeros((m.shape[0], codec.mel_channels), np.float32)
                         for m in mels]
            out_tokens = [np.zeros((m.shape[0],), np.int32) for m in mels]
            # strict=False shrinks the halos when the buckets are smaller
            # than the model's receptive field (best effort)
            for span in chunk_plan(t_total, t_max, halo_l, halo_r,
                                   align=align, strict=False):
                w = span.stop - span.start
                chunk = np.zeros((len(mels), w, codec.mel_channels), np.float32)
                lens = np.zeros((len(mels),), np.int32)
                for i, m in enumerate(mels):
                    n = min(max(m.shape[0] - span.start, 0), w)
                    if n > 0:
                        chunk[i, :n] = m[span.start:span.start + n]
                    lens[i] = n
                if (lens == 0).all():
                    continue
                tokens, recon = codec.reencode(chunk, np.maximum(lens, 1))
                for i, m in enumerate(mels):
                    lo, hi = span.keep_lo, min(span.keep_hi, m.shape[0])
                    if hi > lo:
                        ll, lh = lo - span.start, hi - span.start
                        out_specs[i][lo:hi] = recon[i, ll:lh]
                        out_tokens[i][lo:hi] = tokens[i, ll:lh]
            for (path, _), spec, toks in zip(batch, out_specs, out_tokens):
                rel = os.path.relpath(path, input_dir)
                dst = os.path.join(output_dir, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                np.save(dst, spec)
                if save_tokens and tokens_dir:
                    tdst = os.path.join(tokens_dir, rel)
                    os.makedirs(os.path.dirname(tdst), exist_ok=True)
                    np.save(tdst, toks.astype(np.int64))
                processed += 1
                frames += spec.shape[0]
    finally:
        stop.set()
        loader.join()

    print(f"Re-encoded {processed} files ({failed} failed) -> {output_dir}")
    return {"processed": processed, "failed": failed, "frames": frames}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Re-encode mel datasets through the codec.")
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--model_dir", help="exported artifact directory")
    p.add_argument("--checkpoint", help="generator checkpoint (needs --config)")
    p.add_argument("--config", help="model config, .yaml or .json (with --checkpoint)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--save_tokens", action="store_true")
    p.add_argument("--tokens_dir", default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute for the checkpoint source (an artifact "
                        "keeps its own dtype)")
    p.add_argument("--exact_mixers", action="store_true",
                   help="checkpoint source: the exact mixer MLPs instead of "
                        "the default poly_mixers='decode' post mixer (tokens "
                        "are the same either way)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.model_dir:
        from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

        codec = ExportedPreEncoder(args.model_dir, device=args.device)
    elif args.checkpoint and args.config:
        codec = CheckpointReencoder(
            args.config, args.checkpoint,
            dtype=torch.bfloat16 if args.bf16 else torch.float32,
            poly_mixers=False if args.exact_mixers else "decode",
            device=args.device)
    else:
        p.error("provide --model_dir, or --checkpoint with --config")

    result = reencode_spectrograms(
        codec, args.input_dir, args.output_dir, batch_size=args.batch_size,
        save_tokens=args.save_tokens, tokens_dir=args.tokens_dir)
    if result["failed"]:
        raise SystemExit(f"{result['failed']} file(s) could not be read")
    return result


if __name__ == "__main__":
    main()
