"""Token-LM trainer — genre-conditioned next-token prediction CLI
(counterpart of ``mqgan_tpu/train/lstm_trainer.py``).

*.npy int token chunks + fname_to_id.json genre map, BOS prepend, seeded
train/val split, AdamW + global-norm clipping with optax's rules, masked CE
(ignore pad), an in-graph NaN/Inf skip, perplexity, best-val-loss
checkpointing with the run args in best.json. The split and the per-epoch
shuffles use the same numpy generators as the JAX trainer, so both see the
batches in the same order. Checkpoints are this package's own (``torch.save``
of the state_dict).

Usage: python -m mqgan_tpu_torch.train.lstm_trainer --chunks_dir D
       --mapping_json M --vocab_size 1003 --num_genres N [--device cuda|cpu]
       [--arch transformer --flash_lm --bf16 ...]

``--flash_lm`` on a card runs the transformer's attention through the
hand-written flash kernels (``csrc/flash_attention.cu``). ``--pipe N
--pipe_micro M`` pipelines the LSTM stack (``parallel/pipeline.py``: one
layer a stage, N == --lstm_layers, a GPipe schedule of M microbatches;
equal values and gradients); stage i runs on visible card i mod count, so
one card holds every stage when there is one (``--device cpu``: the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.models.music_lstm import MusicLSTM, masked_ce_loss
from mqgan_tpu_torch.parallel.pipeline import music_lstm_pipelined_logits
from mqgan_tpu_torch.train.state import ClipAdamW
from mqgan_tpu_torch.utils.logging import MetricsLogger
from mqgan_tpu_torch.utils.npy import load_npy
from mqgan_tpu_torch.utils.params import state_dict_from_jax, unflatten_tree
from mqgan_tpu_torch.utils.torch_import import (import_music_lstm_params,
                                                strip_module_prefix)

LEN_BUCKETS = (64, 128, 256, 512, 1024, 2048)
PRETRAINED_SOURCES = ("pass a .pt state_dict written by this trainer, the "
                      "reference MusicLSTM's .pth/.pt (--arch lstm), or an "
                      ".npz of a flattened JAX param tree; orbax dirs need "
                      "JAX to read: convert them with "
                      "tools/jax_generator_to_npz.py")


class MusicChunkDataset:
    """Token chunks listed in a fname -> genre id mapping, BOS prepended."""

    def __init__(self, chunks_dir: str, mapping_json: str, bos_id=1, pad_id=0):
        self.chunks_dir = chunks_dir
        self.bos_id = bos_id
        self.pad_id = pad_id
        with open(mapping_json, encoding="utf-8") as f:
            fname2genre = json.load(f)
        self.items: List[Tuple[str, int]] = [
            (os.path.join(chunks_dir, fname), gid)
            for fname, gid in fname2genre.items()
            if os.path.isfile(os.path.join(chunks_dir, fname))
        ]
        if not self.items:
            raise RuntimeError(
                f"No matching .npy files in {chunks_dir} per {mapping_json}")
        print(f"Found {len(self.items)} valid chunk files.")

    def __len__(self):
        return len(self.items)

    def load(self, idx: int):
        path, genre_id = self.items[idx]
        seq = np.asarray(load_npy(path)).astype(np.int64)
        return np.concatenate([[self.bos_id], seq]), genre_id


def collate_music(seqs, genres, pad_id=0):
    """Pad to the smallest bucket covering the batch (the longest bucket
    truncates longer rows)."""
    lengths = np.array([len(s) for s in seqs], np.int32)
    need = int(lengths.max()) if len(lengths) else 1
    bucket = next((b for b in LEN_BUCKETS if b >= need), LEN_BUCKETS[-1])
    tokens = np.full((len(seqs), bucket), pad_id, np.int64)
    for i, s in enumerate(seqs):
        n = min(len(s), bucket)
        tokens[i, :n] = s[:n]
    lengths = np.minimum(lengths, bucket)
    return tokens, np.asarray(genres, np.int64), lengths


def batches(ds: MusicChunkDataset, idxs, batch_size, pad_id,
            rng: np.random.Generator | None):
    order = list(idxs)
    if rng is not None:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        chunk = order[start : start + batch_size]
        loaded = [ds.load(i) for i in chunk]
        seqs = [s for s, _ in loaded]
        genres = [g for _, g in loaded]
        if len(chunk) < batch_size:
            # a short final batch is filled with zero-length all-pad rows:
            # every target of a fill row is pad_id, so the masked CE gives
            # them zero weight and zero gradient
            deficit = batch_size - len(chunk)
            seqs += [np.zeros((0,), np.int64)] * deficit
            genres += [0] * deficit
        yield collate_music(seqs, genres, pad_id)


def make_lstm_step(model, tx: ClipAdamW, pad_id: int, train: bool,
                   pipe_devices=None, pipe_micro: int = 4):
    """One LM step for either arch. Train: ``step(opt_state, tokens, genres,
    lengths, generator) -> loss`` updates the model's parameters and
    ``opt_state`` in place (dropout from the CPU ``generator``). Eval:
    ``step(tokens, genres, lengths) -> (loss, n_valid)``. Tensors stay on
    the device; nothing synchronises with the host. ``pipe_devices``: the
    LSTM's stack pipelined over them (one layer each, ``pipe_micro``
    microbatches)."""

    def loss_fn(tokens, genres, lengths, generator):
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        if pipe_devices is not None:
            logits = music_lstm_pipelined_logits(
                model, inp, genres, pipe_devices, pipe_micro,
                deterministic=not train, generator=generator)
        else:
            logits = model(inp, genres, lengths - 1, deterministic=not train,
                           generator=generator)
        return masked_ce_loss(logits, tgt, pad_id)

    if not train:
        @torch.no_grad()
        def eval_step(tokens, genres, lengths):
            return loss_fn(tokens, genres, lengths, None)

        return eval_step

    params = [p for p in model.parameters()]

    def train_step(opt_state, tokens, genres, lengths, generator):
        loss, _ = loss_fn(tokens, genres, lengths, generator)
        grads = torch.autograd.grad(loss, params)
        # in-graph NaN/Inf skip (reference train_music_lstm_v2.py:295-299)
        tx.step_(params, grads, opt_state, torch.isfinite(loss))
        return loss.detach()

    return train_step


def pipe_stage_devices(n_stages: int, device: torch.device) -> list:
    """Stage i's device: visible card i mod count on CUDA (so one card
    holds every stage when there is one), the CPU on the CPU."""
    if device.type != "cuda":
        return [device] * n_stages
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_stages)]


def load_pretrained(model, path: str) -> None:
    """Warm start from a state_dict this trainer saved (``.pt``), from the
    reference MusicLSTM's checkpoint (its ``model_state_dict`` when it has
    one), or from an ``.npz`` of the JAX trainer's flattened params."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as flat:
            model.load_state_dict(state_dict_from_jax(unflatten_tree(flat), model))
        return
    if not path.endswith((".pt", ".pth")):
        raise SystemExit(f"--pretrained {path}: {PRETRAINED_SOURCES}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = strip_module_prefix(sd.get("model_state_dict", sd))
    if set(sd) != set(model.state_dict()):
        if not isinstance(model, MusicLSTM):
            raise SystemExit(f"--pretrained {path}: not a state_dict of this "
                             f"model; {PRETRAINED_SOURCES}")
        tree = import_music_lstm_params(sd, lstm_layers=model.lstm_layers)
        sd = state_dict_from_jax(tree, model)
    model.load_state_dict(sd)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a genre-conditioned token LM.")
    p.add_argument("--chunks_dir", default="musicmels")
    p.add_argument("--mapping_json", default="fname_to_id.json")
    p.add_argument("--val_split", type=float, default=0.1)
    p.add_argument("--vocab_size", type=int, required=True)
    p.add_argument("--num_genres", type=int, required=True)
    p.add_argument("--arch", choices=("lstm", "transformer"), default="lstm",
                   help="token-LM architecture: the reference-parity LSTM or "
                        "the causal transformer (same data/loss/checkpoint "
                        "path)")
    p.add_argument("--emb_dim", type=int, default=512)
    p.add_argument("--lstm_hid", type=int, default=1024)
    p.add_argument("--lstm_layers", type=int, default=2)
    p.add_argument("--n_layers", type=int, default=6,
                   help="transformer depth (--arch transformer)")
    p.add_argument("--n_heads", type=int, default=8,
                   help="transformer attention heads (--arch transformer)")
    p.add_argument("--mlp_ratio", type=int, default=4,
                   help="transformer MLP width ratio (--arch transformer)")
    p.add_argument("--flash_lm", action="store_true",
                   help="causal flash attention for the transformer "
                        "(--arch transformer): on a card the hand-written "
                        "CUDA kernels, O(L) attention memory")
    p.add_argument("--flash_blocks", type=int, nargs=2, default=None,
                   metavar=("Q", "K"),
                   help="recorded in the run args and not used: the CUDA "
                        "kernels' tiles are fixed at compile time")
    p.add_argument("--remat_lm", action="store_true",
                   help="per-block rematerialization (--arch transformer)")
    p.add_argument("--bos_id", type=int, default=1)
    p.add_argument("--pad_id", type=int, default=0)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--out_dir", default="logs/musiclstm-run1")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--pretrained", default=None,
                   help="warm-start weights: a .pt state_dict saved by this "
                        "trainer, the reference MusicLSTM's .pth (--arch "
                        "lstm), or an .npz of flattened JAX params "
                        "(tools/jax_generator_to_npz.py converts orbax dirs)")
    p.add_argument("--pipe", type=int, default=0, metavar="N",
                   help="pipeline parallelism of the LSTM stack: N stages "
                        "(== --lstm_layers), stage i on visible card i mod "
                        "count")
    p.add_argument("--pipe_micro", type=int, default=4, metavar="M",
                   help="microbatches of the --pipe schedule (divides "
                        "--batch_size)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    from mqgan_tpu_torch.models.token_lm import build_token_lm
    from mqgan_tpu_torch.utils.init import seeded_init_

    args = parse_args(argv)
    if args.pipe:
        if args.arch != "lstm":
            raise SystemExit("--pipe pipelines the LSTM stack: --arch "
                             "transformer is not pipelined (as in the JAX "
                             "trainer)")
        if args.pipe != args.lstm_layers:
            raise SystemExit(f"--pipe {args.pipe} must equal --lstm_layers "
                             f"{args.lstm_layers} (one layer a stage)")
        if args.batch_size % args.pipe_micro:
            raise SystemExit(f"--batch_size {args.batch_size} not divisible by "
                             f"--pipe_micro {args.pipe_micro}")
    device = resolve_device(args.device)
    if args.flash_blocks:
        print(f"--flash_blocks {args.flash_blocks} recorded, not used: the "
              f"CUDA flash kernels' tiles are fixed at compile time")

    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricsLogger(args.out_dir, run_name="lstm")

    ds = MusicChunkDataset(args.chunks_dir, args.mapping_json,
                           bos_id=args.bos_id, pad_id=args.pad_id)
    rng_np = np.random.default_rng(args.seed)
    perm = rng_np.permutation(len(ds))
    val_size = max(1, int(args.val_split * len(ds)))
    val_idx, train_idx = perm[:val_size].tolist(), perm[val_size:].tolist()
    print(f"Split: {len(train_idx)} train / {len(val_idx)} val")

    # both archs train with dropout 0.1 (reference train_music_lstm_v2.py:158)
    model = build_token_lm(vars(args), dropout=0.1,
                           dtype=torch.bfloat16 if args.bf16 else None)
    seeded_init_(model, args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Total trainable parameters: {n_params / 1e6:.2f} M")
    if args.pretrained:
        load_pretrained(model, args.pretrained)
        print(f"Warm-started from {args.pretrained}")
    model.to(device)

    tx = ClipAdamW(args.lr, args.max_grad_norm)
    opt_state = tx.init(model.parameters())
    pipe_devices = None
    if args.pipe:
        pipe_devices = pipe_stage_devices(args.pipe, device)
        print(f"pipeline parallel: {args.pipe} stages x {args.pipe_micro} "
              f"microbatches on {[str(d) for d in pipe_devices]}"
              + (" (stages share a device)"
                 if len(set(pipe_devices)) < len(pipe_devices) else ""))
    train_step = make_lstm_step(model, tx, args.pad_id, train=True,
                                pipe_devices=pipe_devices,
                                pipe_micro=args.pipe_micro)
    eval_step = make_lstm_step(model, tx, args.pad_id, train=False,
                               pipe_devices=pipe_devices,
                               pipe_micro=args.pipe_micro)
    gen = torch.Generator().manual_seed(args.seed + 1)

    def on_device(batch):
        return [torch.from_numpy(np.asarray(x)).to(device) for x in batch]

    best_val = float("inf")
    global_step = 0
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        n_batches = 0
        for batch in batches(ds, train_idx, args.batch_size, args.pad_id,
                             np.random.default_rng(args.seed + epoch)):
            loss = train_step(opt_state, *on_device(batch), gen)
            global_step += 1
            n_batches += 1
            if n_batches % args.log_every == 0 or n_batches == 1:
                logger.log({"train/loss_step": float(loss), "epoch": epoch,
                            "steps_per_sec": n_batches / (time.time() - t0)},
                           step=global_step)

        val_losses, val_ns = [], []
        for batch in batches(ds, val_idx, args.batch_size, args.pad_id, None):
            loss, n = eval_step(*on_device(batch))
            if np.isfinite(float(loss)):
                val_losses.append(float(loss) * float(n))
                val_ns.append(float(n))
        avg_val = (sum(val_losses) / max(sum(val_ns), 1.0)) if val_ns else 0.0
        val_ppl = math.exp(avg_val) if avg_val < 700 else float("inf")
        print(f"Epoch {epoch}: val loss {avg_val:.4f}, ppl {val_ppl:.2f}")
        logger.log({"val/loss": avg_val, "val/perplexity": val_ppl,
                    "epoch": epoch}, step=global_step)

        if avg_val < best_val:
            best_val = avg_val
            path = os.path.join(
                args.out_dir, f"model_epoch_{epoch}_valloss_{avg_val:.4f}.pt")
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                       path)
            with open(os.path.join(args.out_dir, "best.json"), "w") as f:
                json.dump({"epoch": epoch, "val_loss": avg_val, "path": path,
                           "args": vars(args)}, f, indent=2)
            print(f"  New best validation loss. Saved model to {path}")

    logger.close()
    print("Training finished.")


if __name__ == "__main__":
    main()
