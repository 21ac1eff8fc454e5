"""The codec GAN trainer: host loop and CLI (counterpart of
``mqgan_tpu/train/trainer.py``).

Per epoch: the loader's batches (staged onto the card one step ahead), one
train step each (``train/step.py``: warmup epochs before
``discriminator_train_start_epoch`` run no discriminator), metrics every 10
steps to ``{output_dir}/train_metrics.jsonl``, the train-image triptychs;
every ``eval_interval`` epochs the eval set (full-length clips through the
inference path: with more than one device, one exact sequence-parallel
call whose windows fit the largest eval bucket, else overlapping windows
of at most 512 frames), every ``save_interval`` epochs a checkpoint of the
whole state (with ``--async_checkpoint`` written in the background from a
host copy, ``utils/checkpoint.py`` ``CheckpointWriter``: a save waits for
the one before, and the writer is drained on the stop and before
``train`` returns). A run resumes from the newest checkpoint in its output
dir; SIGTERM or SIGINT finishes the current step, checkpoints and exits.

CLI:  python -m mqgan_tpu_torch.train.trainer --config model.yaml
      [--device cuda|cpu] [--fp32] [--pretrained CKPT] [--output_dir DIR]
      [--no_wandb] [--ema DECAY] [--keep_best] [--grad_accum N] [--remat]
      [--remat_refiner] [--exact_dropout] [--profile N] [--watch N]
      [--async_checkpoint] [--seq_par N] [--multihost [--coordinator HOST:PORT
      --num_processes N --process_id I]]

The trainer runs on CUDA unless ``--device cpu`` is given; without a card
CUDA is an error. Data parallelism follows JAX's "every local device": with
more than one visible card and no ``--multihost`` it starts one rank per
card itself (NCCL, ``spawn_ranks``: a signal to that process reaches the
ranks as a request to stop, and it waits for their checkpoint). ``--multihost``
joins a group instead: from ``--coordinator --num_processes --process_id``,
or from a launcher's environment (``torchrun --nproc_per_node N -m
mqgan_tpu_torch.train.trainer --multihost``). ``batch_size`` is global; each
rank trains on its rows of every batch and the step's reductions make it
the one-process step (``train/step.py``, ``parallel/dp.py``). Only rank 0
writes metrics, plots and checkpoints and runs the eval, on its own card,
while the others wait; a signal on any rank stops every rank at the next
step that logs (or the epoch's end), as one decision.

``--seq_par N`` splits each crop's time axis over N ranks
(``parallel/seqtrain.py``): the ranks form a data x seq grid, seq
innermost, and the N seq ranks of a data rank load the same rows and keep
their frames of them; the step is the one-process step on the whole crop
(``train/step.py``). Every crop length must divide by N, and under
``--multihost`` every seq group must sit inside one host (the JAX
trainer's rules). Without ``--multihost`` the trainer spawns the grid
itself: a rank per card when N divides the visible cards, else N ranks
sharing the cards (gloo); with ``--device cpu``, N CPU ranks. Rank 0
evaluates on its own card alone, as a data-parallel run does.
JAX's ``--compile_cache`` and ``--rng_impl`` are not accepted (XLA compile
and JAX PRNG knobs).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
from typing import Dict

import numpy as np
import torch

from mqgan_tpu_torch.core.buckets import BucketPolicy
from mqgan_tpu_torch.core.chunking import chunk_plan, generator_halos, halo_align
from mqgan_tpu_torch.core.config import TrainConfig, load_model_config
from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.parallel import multihost
from mqgan_tpu_torch.parallel.dp import DataParallel, any_flag, barrier, world
from mqgan_tpu_torch.parallel.mesh import (check_seq_crops, check_seq_hosts,
                                           local_devices, train_devices, train_grid)
from mqgan_tpu_torch.parallel.seqpar import plan_seq_reencode, seq_parallel_reencode
from mqgan_tpu_torch.parallel.seqtrain import SeqGroup
from mqgan_tpu_torch.train.data import (DevicePrefetcher, MelDataset, MelLoader,
                                        find_npy_files, split_train_eval)
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models, make_eval_step, make_train_step
from mqgan_tpu_torch.utils import checkpoint as ckpt_utils
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.logging import MetricsLogger, NullLogger, tree_stats

# the eval windows: the JAX trainer's first six inference buckets
EVAL_BUCKETS = (64, 128, 192, 256, 384, 512)
PROFILE_START = 2  # steps skipped (first-call and warm-up) before profiling


class Trainer:
    def __init__(self, config: TrainConfig, *, device="cuda",
                 use_wandb: bool = True, dtype=torch.bfloat16, profile_steps: int = 0,
                 watch_interval: int = 0, grad_accum: int = 1,
                 keep_best: bool = False, ema_decay: float = 0.0,
                 seq_par: int = 1):
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
        # data x seq parallelism: this process's rank in its group, its
        # place in the grid (one process: no reductions, self.dp and
        # self.seq None)
        self.rank, self.world = world()
        self.seq_par = int(seq_par)
        if self.seq_par > 1:
            check_seq_crops(config.crop_lens, self.seq_par)
            if self.world == 1:
                raise ValueError(f"--seq_par {self.seq_par} needs a group of "
                                 f"ranks; this process has none")
        self.data_rank, self.n_data, self.seq_index = train_grid(
            self.rank, self.world, self.seq_par)
        self.dp = (DataParallel(self.rank, self.world, self.seq_par)
                   if self.world > 1 else None)
        self.seq = None
        if self.seq_par > 1:
            check_seq_hosts(multihost.host_names(self.device), self.seq_par)
            self.seq = SeqGroup.create(self.rank, self.world, self.seq_par,
                                       multihost.group_timeout_s())
        self.is_primary = self.rank == 0
        # set by SIGTERM/SIGINT: the epoch stops at the next step boundary
        # (with ranks, the next one where they agree) and train()
        # checkpoints before it returns. _signalled: this process had a
        # signal (a second one force-quits); with ranks, _stop_requested
        # may also be the group's decision
        self._stop_requested = self._signalled = False
        # the background checkpoint writer (None: saves write in place); it
        # is drained before train() returns, so no write of this trainer is
        # pending when a later one in the process reads latest_checkpoint
        self._writer = (ckpt_utils.CheckpointWriter()
                        if config.logging.async_save else None)
        self._collapse_streak = 0
        self._collapse_warned = False
        self._steps: Dict[bool, callable] = {}
        self._eval_step = make_eval_step()
        # the exact eval's devices: None is every visible card (the CPU
        # alone for a CPU run); a list (which may repeat a device) overrides;
        # with ranks, rank 0's own device (the other cards train), so the
        # eval does not depend on --seq_par
        self.eval_devices = [self.device] if self.dp is not None else None
        self._setup_data()
        self._setup_state()
        log_cfg = config.logging
        self.logger = NullLogger()
        if self.is_primary:
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
        if self.dp is not None:
            if cfg.data.batch_size % (self.n_data * self.grad_accum):
                raise ValueError(f"batch_size {cfg.data.batch_size} does not "
                                 f"divide over {self.n_data} data ranks x "
                                 f"grad_accum {self.grad_accum}")
            print(f"data parallel: rank {self.rank} of {self.world} (data rank "
                  f"{self.data_rank} of {self.n_data}, seq rank {self.seq_index} "
                  f"of {self.seq_par}), local batch "
                  f"{cfg.data.batch_size // self.n_data}")
        # every rank keeps the whole file list and builds the same global
        # plan; it loads its data rank's rows of each batch (and keeps its
        # frames of them)
        self.train_loader = MelLoader(
            MelDataset(train_files), batch_size=cfg.data.batch_size,
            crop_lens=cfg.crop_lens, seed=cfg.training.seed,
            mel_channels=cfg.model.mel_channels, process_index=self.data_rank,
            process_count=self.n_data, seq_index=self.seq_index,
            seq_count=self.seq_par)
        self.eval_dataset = MelDataset(eval_files)

    def _setup_state(self):
        cfg = self.config
        seed = cfg.training.seed
        gen, patch, mb = build_models(cfg, self.dtype)
        for i, model in enumerate((gen, patch, mb)):
            seeded_init_(model, seed + i)
        self.state = create_train_state(
            gen.to(self.device), patch.to(self.device), mb.to(self.device),
            cfg.training, self.device, ema=self.ema_decay > 0, rank=self.rank)
        self.state.replicate_()
        # every rank reads the same checkpoint or warm start
        latest = ckpt_utils.latest_checkpoint(cfg.data.output_dir)
        if latest is not None:
            path, epoch = latest
            print(f"Resuming from {path} (epoch {epoch})")
            ckpt_utils.restore_checkpoint(path, self.state)
            self.state.fork_streams(self.rank)
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
                log_grad_norms=bool(self.watch_interval), dp=self.dp, seq=self.seq)
        return self._steps[train_d]

    def _agree_stop(self) -> bool:
        """Whether to stop here: in one process the signal flag; with ranks
        one collective decision (any rank's signal stops every rank at the
        same step; a MAX reduction)."""
        if self.dp is not None:
            self._stop_requested = any_flag(self._stop_requested, self.device)
        return self._stop_requested

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
                if self.profile_steps and epoch == self.start_epoch and self.is_primary:
                    self._maybe_profile(n)
                metrics = step_fn(self.state, mel, lengths)
                n += 1
                # the global batch's frames: every rank's rows and frames
                # have this shape
                frames += mel.shape[0] * mel.shape[1] * self.world
                last_batch = host_batch
                if (self.watch_interval and n % self.watch_interval == 0
                        and self.is_primary):
                    watch = tree_stats(self.state.gen.named_parameters(),
                                       prefix="param/gen")
                    watch.update({k: float(v) for k, v in metrics.items()
                                  if k.startswith("grad_norm")})
                    self.logger.log(watch, step=self.state.step)
                logged = n % 10 == 0 or n == 1
                if logged:
                    last = {k: float(v) for k, v in metrics.items()}
                    bad = [k for k, v in last.items() if not np.isfinite(v)]
                    if bad:
                        print(f"WARNING: non-finite metrics at step "
                              f"{self.state.step}: {bad}")
                    self._check_codebook_health(last, self.state.step)
                    last["frames_per_sec"] = frames / max(time.time() - t0, 1e-9)
                    last["epoch"] = epoch
                    self.logger.log(last, step=self.state.step)
                # with ranks, decide only where the metrics read above has
                # synchronised the host already: no new sync inside a step
                if (self.dp is None or logged) and self._agree_stop():
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
        through the live generator (rank 0's rows, on rank 0; under
        --seq_par its frames of them, the crop's first)."""
        if (batch is None or self.config.logging.num_plot_examples <= 0
                or not self.is_primary):
            return
        mel = torch.from_numpy(batch.mel).to(self.device)
        held = np.minimum(batch.lengths, batch.mel.shape[1])
        lengths = torch.from_numpy(held).to(self.device)
        pre, post, _, _ = self._eval_step(self.state.gen, mel, lengths)
        pre_h, post_h = pre.float().cpu().numpy(), post.float().cpu().numpy()
        rows = [i for i in range(mel.shape[0]) if held[i] > 0]
        for slot, i in enumerate(rows[:self.config.logging.num_plot_examples], 1):
            if not self._save_plot(f"epoch_{epoch:03d}_train_{slot}",
                                   f"train_spectrograms/example_{slot}",
                                   batch.mel[i], pre_h[i], post_h[i],
                                   int(held[i])):
                break

    def _eval_clip(self, mel: np.ndarray, gen=None):
        """A full-length (T, C) clip through the inference path; returns
        (pre, post, metrics). With more than one eval device, one exact
        sequence-parallel call when its windows fit the largest eval
        bucket (``_eval_clip_seq_parallel``); else overlapping windows of
        at most that bucket, each with the generator's receptive field as
        halo (core/chunking.py), padded to its bucket."""
        gen = self._eval_gen() if gen is None else gen
        policy = BucketPolicy(EVAL_BUCKETS)
        exact = self._eval_clip_seq_parallel(mel, gen, policy.buckets[-1])
        if exact is not None:
            return exact
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

    def _eval_clip_seq_parallel(self, mel: np.ndarray, gen, max_t: int):
        """One exact full-length eval call with the clip's time axis in
        windows over the eval devices (parallel/seqpar.py: the encoder's
        CBAM statistics reduced over the windows); None with one device, or
        when a window would exceed ``max_t`` (the chunked eval then bounds
        memory). The length is padded (masked) to a 256-frame grid."""
        devices = self.eval_devices
        if devices is None:
            devices = local_devices() if self.device.type == "cuda" else [self.device]
        if len(devices) <= 1:
            return None
        gcfg = self.config.model.generator
        t = mel.shape[0]
        t_pad = -(-max(t, 1) // 256) * 256
        plan = plan_seq_reencode(t_pad, len(devices), tuple(gcfg.kernel_sizes),
                                 gcfg.refiner_depth)
        if plan.window > max_t:
            return None
        batch = np.zeros((1, t_pad, mel.shape[1]), np.float32)
        batch[0, :t] = mel
        _, pre, post = seq_parallel_reencode(
            gen, torch.from_numpy(batch).to(self.device),
            torch.tensor([t]), devices, return_recon=True)
        pre = pre[0, :t].float().cpu().numpy()
        post = post[0, :t].float().cpu().numpy()
        mel32 = mel.astype(np.float32)
        return pre, post, {
            "eval_recon_pre_mse": float(np.mean((pre - mel32) ** 2)),
            "eval_recon_post_mse": float(np.mean((post - mel32) ** 2)),
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
                                          epoch, self.config.to_dict(), self._writer)
        print(f"Checkpoint {'queued (async)' if self._writer else 'saved'} to {path}")

    def drain_saves(self):
        """Block until a background save is on disk; raise if it failed."""
        if self._writer is not None:
            self._writer.wait()

    def _install_signal_handlers(self):
        """SIGTERM/SIGINT -> finish the current step, checkpoint, exit; a
        second signal raises KeyboardInterrupt. SIGUSR1 (what the spawning
        parent of ``launch`` sends when it is signalled) stops alike and
        never force-quits. Returns the previous handlers, or None off the
        main thread (signals cannot be set)."""

        def request_stop(signum, frame):
            if self._signalled:
                raise KeyboardInterrupt
            self._signalled = self._stop_requested = True
            print(f"signal {signum}: finishing the current step, then "
                  "checkpointing and exiting (signal again to force-quit)")

        def parent_stop(signum, frame):
            if not self._stop_requested:
                print(f"signal {signum} from the launching process: finishing "
                      "the current step, then checkpointing and exiting")
            self._stop_requested = True

        prev = {}
        for sig, handler in ((signal.SIGTERM, request_stop),
                             (signal.SIGINT, request_stop),
                             (signal.SIGUSR1, parent_stop)):
            try:
                prev[sig] = signal.signal(sig, handler)
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
                if self._agree_stop():
                    # tagged with the interrupted epoch: a resume starts at
                    # epoch + 1 and skips the tail of this one
                    self.save(epoch)
                    self.drain_saves()
                    print(f"Stopped by signal after epoch {epoch} (possibly "
                          "partial); checkpoint written.")
                    break
                if epoch % cfg.logging.eval_interval == 0 and len(self.eval_dataset):
                    # rank 0 alone, on its own device; the others wait
                    if self.is_primary:
                        self._maybe_save_best(epoch, self.evaluate(epoch))
                    barrier(self.device)
                if epoch % cfg.logging.save_interval == 0:
                    self.save(epoch)
        finally:
            for sig, handler in (prev or {}).items():
                signal.signal(sig, handler)
            self.drain_saves()
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
                   help="join a data-parallel process group (torch.distributed): "
                        "from --coordinator/--num_processes/--process_id, or "
                        "from a launcher's RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT (torchrun); batch_size is global. Without "
                        "it, more than one visible card starts a rank per card")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address for --multihost")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--async_checkpoint", action="store_true",
                   help="write checkpoints on a background thread: the train "
                        "loop goes on after a host copy of the state instead "
                        "of waiting for the disk (drained on stop and exit)")
    p.add_argument("--seq_par", type=int, default=1, metavar="N",
                   help="sequence (context) parallelism: split each crop's "
                        "time axis over N ranks (crop_len values must divide "
                        "by N); with --multihost, each seq group inside one "
                        "host")
    return p, p.parse_args(argv)


def _rank_main(rank: int, world_size: int, device, argv) -> None:
    """One rank of the trainer's own spawn (``launch``)."""
    main(list(argv) + ["--multihost", "--device", str(device)])


def spawn_ranks(devices, argv) -> None:
    """The CLI ``argv`` as one rank a device of ``devices`` from this
    process (``launch``, no time limit): the default over several cards
    or with ``--seq_par``. A signal to this process reaches the ranks as a
    request to stop, and it returns once they have checkpointed and
    exited."""
    print(f"parallel training over {len(devices)} devices: one rank each")
    multihost.launch(_rank_main, devices, (list(argv),), timeout_s=None)


def main(argv=None):
    parser, args = parse_args(argv)
    if args.fast_dropout and args.exact_dropout:
        parser.error("--fast_dropout and --exact_dropout request opposite "
                     "mixer-dropout semantics; drop one (--fast_dropout is a "
                     "no-op: fast dropout is the default)")
    if args.seq_par < 1:
        parser.error("--seq_par must be >= 1")
    device = resolve_device(args.device)
    config = load_model_config(args.config)
    check_seq_crops(config.crop_lens, args.seq_par)
    if not args.multihost:
        devices = None
        if device.type == "cuda" and device.index is None and (
                torch.cuda.device_count() > 1 or args.seq_par > 1):
            # JAX's default: parallel over every local device
            devices = train_devices(local_devices(), args.seq_par)
        elif args.seq_par > 1:
            devices = [device] * args.seq_par
        if devices is not None and len(devices) > 1:
            spawn_ranks(devices, argv if argv is not None else sys.argv[1:])
            return None
    created = False
    if args.multihost:
        created = multihost.initialize(args.coordinator, args.num_processes,
                                       args.process_id, device=device)
        device = multihost.rank_device(device, world()[0])
    training, data, gen = config.training, config.data, config.model.generator
    logging_cfg = config.logging
    if args.async_checkpoint:
        logging_cfg = dataclasses.replace(logging_cfg, async_save=True)
    if args.pretrained:
        training = dataclasses.replace(training, pretrained=args.pretrained)
    if args.output_dir:
        data = dataclasses.replace(data, output_dir=args.output_dir)
    gen = dataclasses.replace(
        gen, remat=gen.remat or args.remat,
        remat_refiner=gen.remat_refiner or args.remat_refiner,
        fast_dropout=gen.fast_dropout or not args.exact_dropout)
    config = dataclasses.replace(
        config, training=training, data=data, logging=logging_cfg,
        model=dataclasses.replace(config.model, generator=gen))
    try:
        trainer = Trainer(config, device=device, use_wandb=not args.no_wandb,
                          dtype=torch.float32 if args.fp32 else torch.bfloat16,
                          profile_steps=args.profile, watch_interval=args.watch,
                          grad_accum=args.grad_accum, keep_best=args.keep_best,
                          ema_decay=args.ema, seq_par=args.seq_par)
        try:
            trainer.train()
        finally:
            trainer.logger.close()
    finally:
        if created:
            multihost.shutdown()
    return trainer


if __name__ == "__main__":
    main()
