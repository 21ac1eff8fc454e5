"""The GAN train step and the eval step (counterpart of
``mqgan_tpu/train/step.py``).

One step follows the reference schedule:

  1. the generator forward runs ONCE, its graph kept (dropout on);
  2. with ``train_d``: the discriminator update on (real, detached fake),
     real and fake rows batched in one forward per discriminator; that
     forward writes the spectral norms' power-iteration stats;
  3. the generator update: reconstruction losses, the adversarial loss
     against the UPDATED discriminators and optionally feature matching;
     the gradient goes back through the graph of step 1.

Warmup epochs (``train_d=False``) run no discriminator at all. The steps
are ordinary PyTorch under autograd through the modules' training branches
(the JAX package trains through XLA, not its kernels); ``make_eval_step``
runs the inference path, so on a card it launches the kernels.

Reference quirks kept, as the JAX package keeps them:
* the multi-bin D and G losses use bin 0's masks for every bin;
* the multi-bin feature-matching loss divides the running sum by the
  number of feature maps inside the per-bin loop (compounding);
* the recon weights are recon_lambda_pre = 1.0 / recon_lambda_post = 2.0
  (``recon_lambda`` is read by nothing).

``grad_accum = N`` runs each batch as N microbatches (rows striped over
them, so that a short final batch's fill rows spread evenly) with one
optimizer update per phase; the LeCam EMA chain is rebuilt from logit sums
over ALL microbatches before any D gradient is taken, so that it equals
the one-pass step's. It costs one extra generator forward and one extra
discriminator forward per step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
from torch.profiler import record_function

from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.losses.gan import (discriminator_loss,
                                        discriminator_loss_fixed_ema,
                                        generator_loss, masked_sum_count,
                                        update_ema_from_means)
from mqgan_tpu_torch.losses.recon import masked_mae, masked_mel_loss
from mqgan_tpu_torch.models.discriminators import (
    MelSpectrogramPatchDiscriminator2D, MultiBinDiscriminator)
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.train.state import TrainState
from mqgan_tpu_torch.utils.logging import component

Metrics = Dict[str, torch.Tensor | float]


def build_models(cfg: TrainConfig, dtype: torch.dtype | None = None):
    """(generator, patch D, multi-bin D) on the CPU, parameters fp32, the
    compute dtype ``dtype`` (None: fp32)."""
    mels = cfg.model.mel_channels
    gen = PreEncoder.from_config(mels, cfg.model.generator,
                                 dtype=dtype or torch.float32)
    patch = MelSpectrogramPatchDiscriminator2D.from_config(
        mels, cfg.model.discriminator_patch, dtype)
    mb = MultiBinDiscriminator.from_config(
        mels, cfg.model.discriminator_multibin, dtype)
    return gen, patch, mb


def codebook_metrics(usage: torch.Tensor) -> Metrics:
    """From a batch's code histogram: the share of the codebook it used and
    the perplexity of its code distribution (== the codebook size when
    uniform, -> 1 on collapse)."""
    p = usage.float() / usage.sum().clamp_min(1)
    ent = -torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)).sum()
    return {"codebook_usage": (usage > 0).float().mean(),
            "codebook_perplexity": torch.exp(ent)}


def make_train_step(cfg: TrainConfig, *, train_d: bool,
                    dtype: torch.dtype | None = None, grad_accum: int = 1,
                    ema_decay: float = 0.0, log_grad_norms: bool = False
                    ) -> Callable[[TrainState, torch.Tensor, torch.Tensor], Metrics]:
    """A step for one phase: ``step(state, mel, lengths)`` updates
    ``state`` in place and returns its metrics (device scalars, read by the
    caller when it logs). mel (B, T, mels) fp32 on the state's device,
    lengths (B,) int. ``log_grad_norms`` adds the gradients' global norms
    before clipping (G, D, and G per component); ``ema_decay`` > 0 updates
    ``state.gen_ema`` after each G update."""
    w = cfg.training.loss_weights
    use_fm = bool(cfg.training.use_fm_loss) and train_d
    n_bins = cfg.model.discriminator_multibin.n_bins
    n_calls = 1 + n_bins  # D loss calls per step: patch, then each bin
    mels = cfg.model.mel_channels
    group = 16 if mels % 16 == 0 else math.gcd(mels, 16)
    cb = cfg.model.generator.codebook_size
    lr, warmup = cfg.training.lr, cfg.training.warmup_steps

    def recon(x, y, lengths):
        return (masked_mel_loss(x, y, lengths, loss_type="mse")
                + 0.25 * masked_mel_loss(x, y, lengths, loss_type="mse",
                                         group_size=group))

    def d_forward(state, both, lengths2, b, update_stats):
        """Per D loss call (real logits, fake logits, real mask, fake mask)
        in the reference's order [patch, bin 0..n-1], every bin with bin
        0's masks."""
        logits, mask = state.patch(both, lengths2, False, update_stats)
        calls = [(logits[:b], logits[b:], mask[:b], mask[b:])]
        l2, m2 = state.multibin(both, lengths2, False, update_stats)
        for i in range(n_bins):
            calls.append((l2[i][:b], l2[i][b:], m2[0][:b], m2[0][b:]))
        return calls

    def g_total_loss(state, r_pre, r_post, mel_t, mel_c, lengths):
        """The G loss terms against the (already updated) discriminators;
        mel_t is the fp32 target, mel_c the compute-dtype input that
        feature matching runs through the discriminators as 'real'."""
        zero = torch.zeros((), device=mel_t.device)
        loss_recon_pre = recon(r_pre, mel_t, lengths)
        loss_recon_post = recon(r_post, mel_t, lengths)
        loss_gan = loss_fm = zero
        if train_d:
            b = r_post.shape[0]
            if use_fm:
                lengths2 = torch.cat([lengths, lengths])
                both_g = torch.cat([r_post, mel_c])
                gl, gm, gf = state.patch(both_g, lengths2, True)
                g_logits, g_mask = gl[:b], gm[:b]
                pairs = [(f[b:].detach(), m[b:], f[:b]) for f, m in gf]
                l2g, m2g, f2g = state.multibin(both_g, lengths2, True)
                g_l2 = [t[:b] for t in l2g]
                g_m2 = [t[:b] for t in m2g]
                pairs2 = [[(f[b:].detach(), m[b:], f[:b]) for f, m in fs]
                          for fs in f2g]
            else:
                g_logits, g_mask = state.patch(r_post, lengths)
                g_l2, g_m2 = state.multibin(r_post, lengths)
            loss_gan_mbd = zero
            for i in range(n_bins):
                loss_gan_mbd = loss_gan_mbd + generator_loss(g_l2[i], g_m2[0])
            loss_gan = 0.5 * (generator_loss(g_logits, g_mask)
                              + loss_gan_mbd / n_bins)
            if use_fm:
                loss_fm_d1 = zero
                for rf, rmask, ff in pairs:
                    loss_fm_d1 = loss_fm_d1 + masked_mae(ff, rf, rmask)
                if pairs:
                    loss_fm_d1 = loss_fm_d1 / len(pairs)
                loss_fm_mbd = zero
                for fs in pairs2:
                    for rf, rmask, ff in fs:
                        loss_fm_mbd = loss_fm_mbd + masked_mae(ff, rf, rmask)
                    if fs:  # reference quirk: compounding division
                        loss_fm_mbd = loss_fm_mbd / len(fs)
                if pairs2:
                    loss_fm_mbd = loss_fm_mbd / len(pairs2)
                loss_fm = 0.5 * (loss_fm_d1 + loss_fm_mbd)
        total = (loss_recon_pre * w.recon_lambda_pre
                 + loss_recon_post * w.recon_lambda_post
                 + loss_gan * (w.Gloss_lambda if train_d else 0.0)
                 + loss_fm * (w.fm_lambda if use_fm else 0.0))
        return total, {"loss_g_total": total.detach(),
                       "loss_recon_pre": loss_recon_pre.detach(),
                       "loss_recon_post": loss_recon_post.detach(),
                       "loss_gan": loss_gan.detach(),
                       "loss_fm": loss_fm.detach()}

    def gen_forward(state, mel_c, lengths):
        return state.gen(mel_c, lengths, deterministic=False,
                         generator=state.dropout_rng,
                         fsq_generator=state.fsq_rng)

    def usage_of(indices):
        return torch.bincount(indices.reshape(-1).long(), minlength=cb)

    def finish(state, metrics, g_norm, usage):
        """After the G update: gradient-norm and learning-rate metrics, the
        EMA, the step count and the codebook metrics."""
        if log_grad_norms:
            metrics["grad_norm/gen"] = g_norm
            comps: Dict[str, list] = {}
            for name, p in state.gen.named_parameters():
                if p.grad is not None:
                    comps.setdefault(component(name), []).append(p.grad)
            for comp, grads in comps.items():
                metrics[f"grad_norm/gen/{comp}"] = torch.linalg.vector_norm(
                    torch.stack(torch._foreach_norm(grads)))
        metrics["learning_rate"] = lr * min((state.step + 1.0) / warmup, 1.0)
        if ema_decay > 0.0:
            with torch.no_grad():
                ema = list(state.gen_ema.parameters())
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, list(state.gen.parameters()),
                                    alpha=1.0 - ema_decay)
        state.step += 1
        metrics.update(codebook_metrics(usage))
        return metrics

    def step(state: TrainState, mel: torch.Tensor, lengths: torch.Tensor
             ) -> Metrics:
        # the record_function ranges name the step's parts in a profile
        mel_c = mel.to(dtype) if dtype is not None else mel
        with record_function("gan/g_forward"):
            r_pre, r_post, indices = gen_forward(state, mel_c, lengths)
        metrics: Metrics = {}
        if train_d:
            with record_function("gan/d_forward"):
                b = mel.shape[0]
                both = torch.cat([mel_c, r_post.detach()])
                calls = d_forward(state, both, torch.cat([lengths, lengths]), b,
                                  update_stats=True)
                loss_d1, lecam = discriminator_loss(*calls[0], state=state.lecam)
                loss_mbd = torch.zeros((), device=mel.device)
                for i in range(n_bins):
                    li, lecam = discriminator_loss(*calls[1 + i], state=lecam)
                    loss_mbd = loss_mbd + li
                loss_d = loss_d1 + loss_mbd / n_bins
            with record_function("gan/d_backward"):
                state.disc_opt.zero_grad()
                loss_d.backward(inputs=state.disc_opt.params)
            with record_function("gan/d_optimizer"):
                d_norm = state.disc_opt.step()
            state.lecam = lecam
            metrics["loss_d"] = loss_d.detach()
            if log_grad_norms:
                metrics["grad_norm/disc"] = d_norm
        else:
            metrics["loss_d"] = torch.zeros((), device=mel.device)
        with record_function("gan/g_loss"):
            total, g_metrics = g_total_loss(state, r_pre, r_post, mel, mel_c,
                                            lengths)
        with record_function("gan/g_backward"):
            state.gen_opt.zero_grad()
            total.backward(inputs=state.gen_opt.params)
        with record_function("gan/g_optimizer"):
            g_norm = state.gen_opt.step()
            metrics.update(g_metrics)
            return finish(state, metrics, g_norm, usage_of(indices))

    def step_accum(state: TrainState, mel: torch.Tensor, lengths: torch.Tensor
                   ) -> Metrics:
        n = grad_accum
        big_b = mel.shape[0]
        if big_b % n:
            raise ValueError(f"batch {big_b} not divisible by grad_accum {n}")
        b = big_b // n
        stripe = torch.arange(big_b, device=mel.device).reshape(b, n).t().reshape(-1)
        mel, lengths = mel[stripe], lengths[stripe]
        mel_c_full = mel.to(dtype) if dtype is not None else mel
        zero = torch.zeros((), device=mel.device)

        def micro(arr, i):
            return arr[i * b:(i + 1) * b]

        gens = [g for g in (state.dropout_rng, state.fsq_rng) if g is not None]
        starts = []  # each microbatch's generator states, replayed by pass 3
        metrics: Metrics = {}
        if train_d:
            # pass 1, forward only: the fakes, and the per-call logit
            # (sum, count) pairs of the whole batch for the LeCam chain
            sums = torch.zeros((n_calls, 4), device=mel.device)
            fakes = []
            with torch.no_grad():
                for i in range(n):
                    starts.append([g.get_state() for g in gens])
                    _, post, _ = gen_forward(state, micro(mel_c_full, i),
                                             micro(lengths, i))
                    len_i = micro(lengths, i)
                    calls = d_forward(state, torch.cat([micro(mel_c_full, i), post]),
                                      torch.cat([len_i, len_i]), b, False)
                    rows = []
                    for r_l, f_l, r_m, f_m in calls:
                        sr, cr = masked_sum_count(r_l, r_m)
                        sf, cf = masked_sum_count(f_l, f_m)
                        rows.append(torch.stack([sr, cr, sf, cf]))
                    sums += torch.stack(rows)
                    fakes.append(post)
            chain, s = [], state.lecam
            for c in range(n_calls):
                s = update_ema_from_means(s, sums[c, 0] / sums[c, 1].clamp_min(1.0),
                                          sums[c, 2] / sums[c, 3].clamp_min(1.0))
                chain.append(s)
            # pass 2: D gradients summed over microbatches, then averaged
            state.disc_opt.zero_grad()
            loss_sum = zero
            for i in range(n):
                len_i = micro(lengths, i)
                calls = d_forward(state, torch.cat([micro(mel_c_full, i), fakes[i]]),
                                  torch.cat([len_i, len_i]), b, False)
                loss_mbd = zero
                for j in range(n_bins):
                    loss_mbd = loss_mbd + discriminator_loss_fixed_ema(
                        *calls[1 + j], ema_state=chain[1 + j])
                loss_i = (discriminator_loss_fixed_ema(*calls[0], ema_state=chain[0])
                          + loss_mbd / n_bins)
                loss_i.backward(inputs=state.disc_opt.params)
                loss_sum = loss_sum + loss_i.detach()
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in state.disc_opt.params
                                     if p.grad is not None], n)
            # the power iteration depends only on the (old) weights and u:
            # the one update the one-pass step's D forward writes
            for conv in state.patch.spectral_convs() + state.multibin.spectral_convs():
                conv.update_stats()
            d_norm = state.disc_opt.step()
            state.lecam = s
            metrics["loss_d"] = loss_sum / n
            if log_grad_norms:
                metrics["grad_norm/disc"] = d_norm
        else:
            metrics["loss_d"] = zero
        # pass 3: G gradients against the UPDATED discriminators; each
        # microbatch replays pass 1's draws, so its outputs are the fakes
        # the D update saw
        state.gen_opt.zero_grad()
        sums_g: Dict[str, torch.Tensor] = {}
        usage = torch.zeros((cb,), dtype=torch.long, device=mel.device)
        for i in range(n):
            if starts:
                for g, st in zip(gens, starts[i]):
                    g.set_state(st)
            r_pre, r_post, idx = gen_forward(state, micro(mel_c_full, i),
                                             micro(lengths, i))
            total, g_metrics = g_total_loss(state, r_pre, r_post, micro(mel, i),
                                            micro(mel_c_full, i), micro(lengths, i))
            total.backward(inputs=state.gen_opt.params)
            for k, v in g_metrics.items():
                sums_g[k] = sums_g.get(k, zero) + v
            usage += usage_of(idx)
        with torch.no_grad():
            torch._foreach_div_([p.grad for p in state.gen_opt.params
                                     if p.grad is not None], n)
        g_norm = state.gen_opt.step()
        metrics.update({k: v / n for k, v in sums_g.items()})
        return finish(state, metrics, g_norm, usage)

    return step_accum if grad_accum > 1 else step


def make_eval_step():
    """``eval_step(gen, mel, lengths)`` -> (recon_pre, recon_post, indices,
    metrics): the inference path, no gradient."""

    def eval_step(gen: PreEncoder, mel: torch.Tensor, lengths: torch.Tensor):
        with torch.no_grad():
            recon_pre, recon_post, indices = gen(mel, lengths, deterministic=True)
            metrics = {
                "eval_recon_pre_mse": masked_mel_loss(recon_pre, mel, lengths,
                                                      loss_type="mse"),
                "eval_recon_post_mse": masked_mel_loss(recon_post, mel, lengths,
                                                       loss_type="mse"),
            }
        return recon_pre, recon_post, indices, metrics

    return eval_step
