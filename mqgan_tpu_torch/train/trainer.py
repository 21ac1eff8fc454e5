"""The codec GAN trainer: host loop and CLI (counterpart of
``mqgan_tpu/train/trainer.py``).

Per epoch: the loader's batches (staged onto the card one step ahead), one
train step each (``train/step.py``: warmup epochs before
``discriminator_train_start_epoch`` run no discriminator), metrics every 10
steps to ``{output_dir}/train_metrics.jsonl``, the train-image triptychs;
every ``eval_interval`` epochs the eval set (full-length clips through the
inference path, chunked into overlapping windows of at most 512 frames),
every ``save_interval`` epochs a checkpoint of the whole state. A run
resumes from the newest checkpoint in its output dir; SIGTERM or SIGINT
finishes the current step, checkpoints and exits.

CLI:  python -m mqgan_tpu_torch.train.trainer --config model.yaml
      [--device cuda|cpu] [--fp32] [--pretrained CKPT] [--output_dir DIR]
      [--no_wandb] [--ema DECAY] [--keep_best] [--grad_accum N] [--remat]
      [--remat_refiner] [--exact_dropout] [--profile N] [--watch N]

The trainer runs on CUDA unless ``--device cpu`` is given; without a card
CUDA is an error. JAX's ``--compile_cache``, ``--rng_impl`` and
``--async_checkpoint`` are not accepted (XLA compile, JAX PRNG and orbax
knobs); ``--multihost`` and ``--seq_par`` > 1 raise (ROADMAP.md Queue 1
item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time
from typing import Dict

import numpy as np
import torch

from mqgan_tpu_torch.core.buckets import BucketPolicy
from mqgan_tpu_torch.core.chunking import chunk_plan, generator_halos, halo_align
from mqgan_tpu_torch.core.config import TrainConfig, load_model_config
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.train.data import (DevicePrefetcher, MelDataset, MelLoader,
                                        find_npy_files, split_train_eval)
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models, make_eval_step, make_train_step
from mqgan_tpu_torch.utils import checkpoint as ckpt_utils
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.logging import MetricsLogger, tree_stats

# the eval windows: the JAX trainer's first six inference buckets
EVAL_BUCKETS = (64, 128, 192, 256, 384, 512)
PROFILE_START = 2  # steps skipped (first-call and warm-up) before profiling


class Trainer:
    def __init__(self, config: TrainConfig, *, device="cuda",
                 use_wandb: bool = True, dtype=torch.bfloat16, profile_steps: int = 0,
                 watch_interval: int = 0, grad_accum: int = 1,
                 keep_best: bool = False, ema_decay: float = 0.0):
        if not 0.0 <= ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
        if grad_accum > 1 and config.data.batch_size % grad_accum:
            raise ValueError(f"batch_size {config.data.batch_size} not "
                             f"divisible by grad_accum {grad_accum}")
        self.config = config
        self.device = resolve_device(device)
        self.dtype = dtype
        self.ema_decay = float(ema_decay)
        self.keep_best = keep_best
        self._best_eval = float("inf")
        self.grad_accum = int(grad_accum)
        self.profile_steps = profile_steps
        self._profiler = None
        self.watch_interval = watch_interval
        self.start_epoch = 1
        # set by SIGTERM/SIGINT: the epoch stops at the next step boundary
        # and train() checkpoints before it returns
        self._stop_requested = False
        self._collapse_streak = 0
        self._collapse_warned = False
        self._steps: Dict[bool, callable] = {}
        self._eval_step = make_eval_step()
        self._setup_data()
        self._setup_state()
        log_cfg = config.logging
        self.logger = MetricsLogger(
            config.data.output_dir,
            wandb_project=log_cfg.wandb.project if use_wandb else None,
            wandb_entity=log_cfg.wandb.entity, config=config.to_dict())

    def _setup_data(self):
        cfg = self.config
        files = find_npy_files(cfg.data.data_dir)
        if not files:
            raise ValueError(f"No .npy files found in {cfg.data.data_dir}")
        train_files, eval_files = split_train_eval(
            files, cfg.data.validation_split, cfg.training.seed)
        print(f"Dataset: {len(files)} files -> {len(train_files)} train / "
              f"{len(eval_files)} eval")
        self.train_loader = MelLoader(
            MelDataset(train_files), batch_size=cfg.data.batch_size,
            crop_lens=cfg.crop_lens, seed=cfg.training.seed,
            mel_channels=cfg.model.mel_channels)
        self.eval_dataset = MelDataset(eval_files)

    def _setup_state(self):
        cfg = self.config
        seed = cfg.training.seed
        gen, patch, mb = build_models(cfg, self.dtype)
        for i, model in enumerate((gen, patch, mb)):
            seeded_init_(model, seed + i)
        self.state = create_train_state(
            gen.to(self.device), patch.to(self.device), mb.to(self.device),
            cfg.training, self.device, ema=self.ema_decay > 0)
        latest = ckpt_utils.latest_checkpoint(cfg.data.output_dir)
        if latest is not None:
            path, epoch = latest
            print(f"Resuming from {path} (epoch {epoch})")
            ckpt_utils.restore_checkpoint(path, self.state)
            self.start_epoch = epoch + 1
        elif cfg.training.pretrained:
            path = cfg.training.pretrained
            print(f"Warm-starting generator from {path}")
            self.state.gen.load_state_dict(
                ckpt_utils.load_pretrained_generator(path, cfg.model))
            if self.state.gen_ema is not None:
                self.state.gen_ema.load_state_dict(self.state.gen.state_dict())
            discs = ckpt_utils.load_pretrained_discriminators(path, cfg.model)
            if discs is not None:
                print(f"Warm-starting both discriminators from {path}")
                self.state.patch.load_state_dict(discs[0])
                self.state.multibin.load_state_dict(discs[1])

    def _step_fn(self, train_d: bool):
        if train_d not in self._steps:
            self._steps[train_d] = make_train_step(
                self.config, train_d=train_d, dtype=self.dtype,
                grad_accum=self.grad_accum, ema_decay=self.ema_decay,
                log_grad_norms=bool(self.watch_interval))
        return self._steps[train_d]

    def _eval_gen(self):
        """The weights that eval, plots and --keep_best use: the EMA's when
        on, else the live generator's."""
        return self.state.gen_ema if self.state.gen_ema is not None else self.state.gen

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.config
        step_fn = self._step_fn(epoch >= cfg.training.discriminator_train_start_epoch)
        it = DevicePrefetcher(self.train_loader.epoch(epoch), self.device)
        last: Dict[str, float] = {}
        n, frames, last_batch = 0, 0, None
        t0 = time.time()
        try:
            for mel, lengths, host_batch in it:
                if self.profile_steps and epoch == self.start_epoch:
                    self._maybe_profile(n)
                metrics = step_fn(self.state, mel, lengths)
                n += 1
                frames += mel.shape[0] * mel.shape[1]
                last_batch = host_batch
                if self.watch_interval and n % self.watch_interval == 0:
                    watch = tree_stats(self.state.gen.named_parameters(),
                                       prefix="param/gen")
                    watch.update({k: float(v) for k, v in metrics.items()
                                  if k.startswith("grad_norm")})
                    self.logger.log(watch, step=self.state.step)
                if n % 10 == 0 or n == 1:
                    last = {k: float(v) for k, v in metrics.items()}
                    bad = [k for k, v in last.items() if not np.isfinite(v)]
                    if bad:
                        print(f"WARNING: non-finite metrics at step "
                              f"{self.state.step}: {bad}")
                    self._check_codebook_health(last, self.state.step)
                    last["frames_per_sec"] = frames / max(time.time() - t0, 1e-9)
                    last["epoch"] = epoch
                    self.logger.log(last, step=self.state.step)
                if self._stop_requested:
                    break
        finally:
            it.close()
        if self._profiler is not None:
            self._maybe_profile(PROFILE_START + self.profile_steps)
        self._log_train_images(epoch, last_batch)
        return last

    def _check_codebook_health(self, metrics: Dict[str, float], step: int):
        """Warn once per episode when codebook_usage stays below the floor
        for ``codebook_collapse_patience`` consecutive metric logs: the
        quantizer can collapse to a near-constant code while recon keeps
        improving."""
        log_cfg = self.config.logging
        usage = metrics.get("codebook_usage")
        if log_cfg.codebook_usage_floor <= 0 or usage is None or not np.isfinite(usage):
            return
        if usage >= log_cfg.codebook_usage_floor:
            self._collapse_streak, self._collapse_warned = 0, False
            return
        self._collapse_streak += 1
        if (self._collapse_streak >= log_cfg.codebook_collapse_patience
                and not self._collapse_warned):
            self._collapse_warned = True
            print(f"WARNING: codebook collapse at step {step}: codebook_usage "
                  f"{usage:.4f} has stayed below {log_cfg.codebook_usage_floor} "
                  f"for {self._collapse_streak} consecutive logs (perplexity "
                  f"{metrics.get('codebook_perplexity', float('nan')):.1f}). "
                  "Recon loss will keep improving while the quantizer "
                  "degenerates to a near-constant code. Mitigation: set "
                  "generator.fsq_noise_dropout: 0.5 in the model config.")

    def _maybe_profile(self, n: int):
        """torch.profiler over steps [PROFILE_START, PROFILE_START +
        profile_steps) of the first epoch; the trace goes to
        {output_dir}/profile."""
        if self._profiler is None and n == PROFILE_START:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()
            print("profiling started")
        elif self._profiler is not None and n >= PROFILE_START + self.profile_steps:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.__exit__(None, None, None)
            out = os.path.join(self.config.data.output_dir, "profile")
            os.makedirs(out, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(out, "trace.json"))
            self._profiler = None
            print(f"profiling stopped -> {out}/trace.json")

    def _save_plot(self, tag: str, image_tag: str, mel, pre, post, length):
        """Best-effort: a missing matplotlib or a plotting error is logged
        and training goes on."""
        from mqgan_tpu_torch.utils.plotting import save_triptych

        try:
            png = save_triptych(self.config.data.output_dir, tag, mel, pre, post,
                                length=length)
        except Exception as e:  # noqa: BLE001 - plots never stop training
            print(f"plotting failed: {e}")
            return False
        self.logger.log_image(image_tag, png, step=self.state.step)
        return True

    def _log_train_images(self, epoch: int, batch):
        """Original / pre / post triptychs of the last train batch's rows,
        through the live generator."""
        if batch is None or self.config.logging.num_plot_examples <= 0:
            return
        mel = torch.from_numpy(batch.mel).to(self.device)
        lengths = torch.from_numpy(batch.lengths).to(self.device)
        pre, post, _, _ = self._eval_step(self.state.gen, mel, lengths)
        pre_h, post_h = pre.float().cpu().numpy(), post.float().cpu().numpy()
        rows = [i for i in range(mel.shape[0]) if batch.lengths[i] > 0]
        for slot, i in enumerate(rows[:self.config.logging.num_plot_examples], 1):
            if not self._save_plot(f"epoch_{epoch:03d}_train_{slot}",
                                   f"train_spectrograms/example_{slot}",
                                   batch.mel[i], pre_h[i], post_h[i],
                                   int(batch.lengths[i])):
                break

    def _eval_clip(self, mel: np.ndarray, gen=None):
        """A full-length (T, C) clip through the inference path in
        overlapping windows of at most the largest eval bucket, each with
        the generator's receptive field as halo (core/chunking.py), padded
        to its bucket; returns (pre, post, metrics)."""
        gen = self._eval_gen() if gen is None else gen
        policy = BucketPolicy(EVAL_BUCKETS)
        gcfg = self.config.model.generator
        halo_l, halo_r = generator_halos(tuple(gcfg.kernel_sizes), gcfg.refiner_depth)
        pre_full = np.zeros(mel.shape, np.float32)
        post_full = np.zeros(mel.shape, np.float32)
        for span in chunk_plan(mel.shape[0], policy.buckets[-1], halo_l, halo_r,
                               align=halo_align(gcfg.refiner_depth), strict=False):
            seg = mel[span.start:span.stop]
            batch = np.zeros((1, policy.bucket_for(len(seg)), mel.shape[1]),
                             np.float32)
            batch[0, :len(seg)] = seg
            pre, post, _, _ = self._eval_step(
                gen, torch.from_numpy(batch).to(self.device),
                torch.tensor([len(seg)], dtype=torch.int32, device=self.device))
            lo, hi = span.local_lo, span.local_hi
            pre_full[span.keep_lo:span.keep_hi] = pre[0, lo:hi].float().cpu().numpy()
            post_full[span.keep_lo:span.keep_hi] = post[0, lo:hi].float().cpu().numpy()
        mel32 = mel.astype(np.float32)
        return pre_full, post_full, {
            "eval_recon_pre_mse": float(np.mean((pre_full - mel32) ** 2)),
            "eval_recon_post_mse": float(np.mean((post_full - mel32) ** 2)),
        }

    def evaluate(self, epoch: int, num_examples: int | None = None):
        """Eval metrics over (a sample of) the eval set, and triptychs of
        the first ``num_plot_examples`` clips."""
        cfg = self.config
        if num_examples is not None:
            n_plot = n = min(num_examples, len(self.eval_dataset))
        else:
            n_plot = cfg.logging.num_plot_examples
            n = min(max(n_plot, 16), len(self.eval_dataset))
        rng = np.random.default_rng(epoch)
        idxs = rng.choice(len(self.eval_dataset), size=n, replace=False) if n else []
        metrics_acc = []
        gen = self._eval_gen()
        for i, idx in enumerate(idxs):
            mel = self.eval_dataset.load(int(idx))
            if mel is None:
                continue
            pre, post, m = self._eval_clip(mel, gen)
            metrics_acc.append(m)
            if i < n_plot:
                self._save_plot(f"epoch_{epoch:03d}_eval_{i + 1}",
                                f"eval_spectrograms/example_{i + 1}",
                                mel, pre, post, mel.shape[0])
        if not metrics_acc:
            return {}
        avg = {k: float(np.mean([m[k] for m in metrics_acc])) for k in metrics_acc[0]}
        avg["epoch"] = epoch
        self.logger.log(avg, step=self.state.step)
        return avg

    def _maybe_save_best(self, epoch: int, ev: Dict[str, float]):
        """With --keep_best, snapshot the eval generator to
        ``output_dir/generator_best.pt`` when eval recon (post) improves;
        ``generator_best.json`` keeps the running best across resumes."""
        score = ev.get("eval_recon_post_mse") if ev else None
        if not self.keep_best or score is None:
            return
        meta_path = os.path.join(self.config.data.output_dir, "generator_best.json")
        if self._best_eval == float("inf") and os.path.exists(meta_path):
            with open(meta_path) as f:
                self._best_eval = float(json.load(f)["eval_recon_post_mse"])
        if score >= self._best_eval:
            return
        self._best_eval = score
        path = ckpt_utils.save_generator_only(
            self.config.data.output_dir, self._eval_gen().state_dict(),
            name="generator_best")
        with open(meta_path, "w") as f:
            json.dump({"epoch": epoch, "eval_recon_post_mse": score}, f)
        print(f"New best eval recon {score:.6f} (epoch {epoch}) -> {path}")

    def save(self, epoch: int):
        path = ckpt_utils.save_checkpoint(self.config.data.output_dir, self.state,
                                          epoch, self.config.to_dict())
        print(f"Checkpoint saved to {path}")

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT -> finish the current step, checkpoint, exit; a
        second signal raises KeyboardInterrupt. Returns the previous
        handlers, or None off the main thread (signals cannot be set)."""

        def request_stop(signum, frame):
            if self._stop_requested:
                raise KeyboardInterrupt
            self._stop_requested = True
            print(f"signal {signum}: finishing the current step, then "
                  "checkpointing and exiting (signal again to force-quit)")

        prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev[sig] = signal.signal(sig, request_stop)
            except ValueError:
                return None
        return prev

    def train(self):
        cfg = self.config
        prev = self._install_signal_handlers()
        try:
            for epoch in range(self.start_epoch, cfg.training.num_epochs + 1):
                last = self.train_epoch(epoch)
                print(f"Epoch {epoch}: {last}")
                if self._stop_requested:
                    # tagged with the interrupted epoch: a resume starts at
                    # epoch + 1 and skips the tail of this one
                    self.save(epoch)
                    print(f"Stopped by signal after epoch {epoch} (possibly "
                          "partial); checkpoint written.")
                    break
                if epoch % cfg.logging.eval_interval == 0 and len(self.eval_dataset):
                    self._maybe_save_best(epoch, self.evaluate(epoch))
                if epoch % cfg.logging.save_interval == 0:
                    self.save(epoch)
        finally:
            for sig, handler in (prev or {}).items():
                signal.signal(sig, handler)
        print("Training finished.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the codec GAN (PyTorch port).")
    p.add_argument("--config", default="config.yaml",
                   help="model config: YAML (needs PyYAML) or .json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    p.add_argument("--pretrained", default=None,
                   help="warm-start the generator (and both discriminators "
                        "when the .pth holds them): any source of "
                        "utils/checkpoint.py load_pretrained_generator")
    p.add_argument("--output_dir", default=None)
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--fp32", action="store_true", help="fp32 compute (default bf16)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="torch.profiler trace of N steps of the first epoch "
                        "into {output_dir}/profile")
    p.add_argument("--watch", type=int, default=0, metavar="N",
                   help="every N steps, log gradient norms per component and "
                        "parameter distribution summaries")
    p.add_argument("--remat", action="store_true",
                   help="the mixers' pointwise MLP in checkpointed time "
                        "chunks: the (B, T, mels, channels[0]) hiddens never "
                        "exist whole")
    p.add_argument("--remat_refiner", action="store_true",
                   help="also recompute the refiner's ConvBlocks in the backward")
    p.add_argument("--fast_dropout", action="store_true",
                   help="no-op kept for older invocations: moment-matched "
                        "Gaussian mixer dropout is the default; an error with "
                        "--exact_dropout")
    p.add_argument("--exact_dropout", action="store_true",
                   help="Bernoulli dropout on the mixer hiddens (the "
                        "reference's) instead of the default moment-matched "
                        "Gaussian")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="keep an EMA of the generator (e.g. 0.999); eval, "
                        "plots and --keep_best use it. 0 = off")
    p.add_argument("--keep_best", action="store_true",
                   help="snapshot the generator to output_dir/generator_best.pt "
                        "whenever eval recon (post) improves")
    p.add_argument("--grad_accum", type=int, default=1, metavar="N",
                   help="each batch as N microbatches with one optimizer "
                        "update (the memory knob)")
    p.add_argument("--multihost", action="store_true",
                   help="not ported (ROADMAP.md Queue 1 item 8)")
    p.add_argument("--seq_par", type=int, default=1, metavar="N",
                   help="not ported beyond 1 (ROADMAP.md Queue 1 item 8)")
    return p, p.parse_args(argv)


def main(argv=None):
    parser, args = parse_args(argv)
    if args.fast_dropout and args.exact_dropout:
        parser.error("--fast_dropout and --exact_dropout request opposite "
                     "mixer-dropout semantics; drop one (--fast_dropout is a "
                     "no-op: fast dropout is the default)")
    if args.multihost or args.seq_par > 1:
        raise SystemExit("--multihost and --seq_par > 1: multi-device training "
                         "is not ported yet (ROADMAP.md Queue 1 item 8)")
    device = resolve_device(args.device)
    config = load_model_config(args.config)
    training, data, gen = config.training, config.data, config.model.generator
    if args.pretrained:
        training = dataclasses.replace(training, pretrained=args.pretrained)
    if args.output_dir:
        data = dataclasses.replace(data, output_dir=args.output_dir)
    gen = dataclasses.replace(
        gen, remat=gen.remat or args.remat,
        remat_refiner=gen.remat_refiner or args.remat_refiner,
        fast_dropout=gen.fast_dropout or not args.exact_dropout)
    config = dataclasses.replace(
        config, training=training, data=data,
        model=dataclasses.replace(config.model, generator=gen))
    trainer = Trainer(config, device=device, use_wandb=not args.no_wandb,
                      dtype=torch.float32 if args.fp32 else torch.bfloat16,
                      profile_steps=args.profile, watch_interval=args.watch,
                      grad_accum=args.grad_accum, keep_best=args.keep_best,
                      ema_decay=args.ema)
    try:
        trainer.train()
    finally:
        trainer.logger.close()
    return trainer


if __name__ == "__main__":
    main()
