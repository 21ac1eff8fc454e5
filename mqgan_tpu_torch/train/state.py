"""Training state and optimizers of the codec GAN (counterpart of
``mqgan_tpu/train/state.py``).

``TrainState`` holds what a train step changes: the generator, both
discriminators (their spectral-norm ``u``/``sigma`` are module buffers),
both optimizer states, the LeCam state, the step count, the two random
generators (dropout masks, FSQ noise; on the training device) and, with
EMA on, a moving-average copy of the generator. ``state_dict`` /
``load_state_dict`` round-trip all of it, the generators' states included,
so that a resumed run continues their streams.

Optimizers, as the JAX package builds them with optax: clip by global norm,
then Adam with no weight decay; G with the linear warmup
lr * min((count + 1) / warmup_steps, 1) and betas (beta1, beta2), D with
lr * lr_d_factor and betas (d_beta1, d_beta2), one optimizer over both
discriminators.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List

import torch
from torch import nn

from mqgan_tpu_torch.core.config import TrainingConfig
from mqgan_tpu_torch.losses.gan import LeCamState


def warmup_schedule(lr: float, warmup_steps: int) -> Callable[[int], float]:
    """lr * min((count + 1) / warmup_steps, 1), count = updates so far."""
    return lambda count: lr * min((count + 1.0) / float(warmup_steps), 1.0)


class ClipAdam:
    """clip_by_global_norm(max_norm) then Adam (eps 1e-8, no weight decay),
    optax's arithmetic, as ``torch._foreach`` updates whose only device
    scalar (the global norm) never reaches the host."""

    def __init__(self, params, lr: Callable[[int], float], b1: float,
                 b2: float, max_norm: float, eps: float = 1e-8):
        self.params: List[nn.Parameter] = list(params)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.max_norm, self.eps = max_norm, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in self.params]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the parameters' ``.grad``; returns the global
        norm of the gradients before clipping (a device scalar)."""
        grads = self.grads()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.max_norm
        one = torch.ones_like(norm)
        g = torch._foreach_div(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * self.max_norm))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        lr = self.lr(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.mu, denom, value=-lr / bc1)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, d: dict) -> None:
        self.count = int(d["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            if len(d[key]) != len(dst):
                raise ValueError(f"optimizer state: {len(d[key])} {key} "
                                 f"tensors for {len(dst)} parameters")
            for t, v in zip(dst, d[key]):
                t.copy_(v)


def make_optimizers(cfg: TrainingConfig, gen_params, disc_params):
    gen_opt = ClipAdam(gen_params, warmup_schedule(cfg.lr, cfg.warmup_steps),
                       cfg.beta1, cfg.beta2, cfg.clip_grad_norm)
    disc_lr = cfg.lr * cfg.lr_d_factor
    disc_opt = ClipAdam(disc_params, lambda count: disc_lr, cfg.d_beta1,
                        cfg.d_beta2, cfg.clip_grad_norm)
    return gen_opt, disc_opt


@dataclass
class TrainState:
    gen: nn.Module
    patch: nn.Module
    multibin: nn.Module
    gen_opt: ClipAdam
    disc_opt: ClipAdam
    lecam: LeCamState
    # None: no dropout / no FSQ noise draws (the parity tests' inert mode)
    dropout_rng: torch.Generator | None
    fsq_rng: torch.Generator | None
    step: int = 0
    gen_ema: nn.Module | None = None

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "gen": self.gen.state_dict(),
            "patch": self.patch.state_dict(),
            "multibin": self.multibin.state_dict(),
            "gen_opt": self.gen_opt.state_dict(),
            "disc_opt": self.disc_opt.state_dict(),
            "lecam": dict(self.lecam._asdict()),
            "rng": {"dropout": _rng_state(self.dropout_rng),
                    "fsq_noise": _rng_state(self.fsq_rng)},
            "gen_ema": (None if self.gen_ema is None
                        else self.gen_ema.state_dict()),
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore in place; a checkpoint without an EMA seeds the EMA (when
        on) from the restored generator, one with an EMA restores it only
        when EMA is on."""
        self.step = int(d["step"])
        self.gen.load_state_dict(d["gen"])
        self.patch.load_state_dict(d["patch"])
        self.multibin.load_state_dict(d["multibin"])
        self.gen_opt.load_state_dict(d["gen_opt"])
        self.disc_opt.load_state_dict(d["disc_opt"])
        dev = self.lecam.ema_real.device
        self.lecam = LeCamState(**{k: v.to(dev) for k, v in d["lecam"].items()})
        for gen, st in ((self.dropout_rng, d["rng"]["dropout"]),
                        (self.fsq_rng, d["rng"]["fsq_noise"])):
            if gen is not None and st is not None:
                gen.set_state(st)
        if self.gen_ema is not None:
            self.gen_ema.load_state_dict(d["gen_ema"] if d["gen_ema"] is not None
                                         else d["gen"])


def _rng_state(gen: torch.Generator | None):
    return None if gen is None else gen.get_state()


def create_train_state(gen: nn.Module, patch: nn.Module, multibin: nn.Module,
                       cfg: TrainingConfig, device, ema: bool = False
                       ) -> TrainState:
    """The initial state around freshly built models (already on
    ``device``); the generators are seeded from ``cfg.seed``."""
    gen_opt, disc_opt = make_optimizers(
        cfg, gen.parameters(),
        list(patch.parameters()) + list(multibin.parameters()))
    dropout_rng = torch.Generator(device=device).manual_seed(cfg.seed)
    fsq_rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    gen_ema = None
    if ema:
        gen_ema = copy.deepcopy(gen)
        gen_ema.requires_grad_(False)
    return TrainState(gen, patch, multibin, gen_opt, disc_opt,
                      LeCamState.create(device), dropout_rng, fsq_rng,
                      gen_ema=gen_ema)
