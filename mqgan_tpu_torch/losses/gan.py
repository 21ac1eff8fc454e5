"""LSGAN loss with LeCam regularization (counterpart of
``mqgan_tpu/losses/gan.py``): pure functions and an explicit ``LeCamState``.

Least-squares GAN with masked MSE to the real/fake labels; LeCam keeps EMAs
(decay 0.99) of the discriminator's mean outputs and adds hinge-squared
distances to them to the discriminator loss. The state is a value the train
step passes in and gets back; its tensors stay on the device, so no update
waits for the host.

Masks in this file: True = VALID (the discriminators' patch masks).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LeCamState(NamedTuple):
    ema_real: torch.Tensor  # fp32 scalar
    ema_fake: torch.Tensor  # fp32 scalar
    initialized: torch.Tensor  # bool scalar

    @staticmethod
    def create(device=None) -> "LeCamState":
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return LeCamState(zero, zero.clone(),
                          torch.zeros((), dtype=torch.bool, device=device))


def _broadcast_mask(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return m.reshape(tuple(m.shape) + (1,) * (x.ndim - m.ndim))


def _masked_mse(pred, target, valid_mask=None):
    """Masked mean squared error; 0 when no element is valid."""
    err = torch.square(pred.float() - target.float())
    if valid_mask is None:
        return err.mean()
    m = valid_mask.float()
    valid = m.sum() * (err.numel() / m.numel() if m.numel() != err.numel() else 1.0)
    total = (err * _broadcast_mask(m, err)).sum()
    return torch.where(valid > 0, total / valid.clamp_min(1e-12),
                       torch.zeros((), device=err.device))


def masked_sum_count(x, valid_mask=None):
    """(sum, count) with ``_masked_mean(x, m) == sum / max(count, 1)``:
    per-microbatch pairs add up to the masked mean of the whole batch."""
    x = x.float()
    if valid_mask is None:
        return x.sum(), torch.tensor(float(x.numel()), device=x.device)
    m = valid_mask.float()
    scale = x.numel() / m.numel() if m.numel() != x.numel() else 1.0
    return (x * _broadcast_mask(m, x)).sum(), m.sum() * scale


def _masked_mean(x, valid_mask=None):
    s, c = masked_sum_count(x, valid_mask)
    return s / c.clamp_min(1.0)


def update_ema_from_means(state: LeCamState, real_mean, fake_mean,
                          decay: float = 0.99) -> LeCamState:
    """The first update copies the means, later ones decay toward them."""
    real_mean, fake_mean = real_mean.detach(), fake_mean.detach()
    new_real = torch.where(state.initialized,
                           state.ema_real * decay + (1 - decay) * real_mean,
                           real_mean)
    new_fake = torch.where(state.initialized,
                           state.ema_fake * decay + (1 - decay) * fake_mean,
                           fake_mean)
    return LeCamState(new_real, new_fake, torch.ones_like(state.initialized))


def update_ema(state: LeCamState, real_out, fake_out, real_mask=None,
               fake_mask=None, decay: float = 0.99) -> LeCamState:
    return update_ema_from_means(state, _masked_mean(real_out, real_mask),
                                 _masked_mean(fake_out, fake_mask), decay)


def lecam_loss(state: LeCamState, real_out, fake_out, real_mask=None,
               fake_mask=None):
    """Hinge-squared distances to the (updated) EMAs."""
    ema_r, ema_f = state.ema_real.detach(), state.ema_fake.detach()
    term_r = _masked_mean(torch.square(torch.clamp_min(
        real_out.float() - ema_f, 0.0)), real_mask)
    term_f = _masked_mean(torch.square(torch.clamp_min(
        ema_r - fake_out.float(), 0.0)), fake_mask)
    return term_r + term_f


def discriminator_loss_fixed_ema(real_output, fake_output, real_mask=None,
                                 fake_mask=None, *, ema_state: LeCamState,
                                 real_label: float = 1.0,
                                 fake_label: float = 0.0,
                                 use_lecam: bool = True):
    """The LSGAN + LeCam loss with an already-updated LeCam state (gradient
    accumulation passes one built from the whole batch)."""
    real_loss = _masked_mse(real_output, torch.full_like(real_output, real_label),
                            real_mask)
    fake_loss = _masked_mse(fake_output, torch.full_like(fake_output, fake_label),
                            fake_mask)
    loss = 0.5 * (real_loss + fake_loss)
    if use_lecam:
        loss = loss + lecam_loss(ema_state, real_output, fake_output,
                                 real_mask, fake_mask)
    return loss


def discriminator_loss(real_output, fake_output, real_mask=None,
                       fake_mask=None, *, state: LeCamState,
                       real_label: float = 1.0, fake_label: float = 0.0,
                       decay: float = 0.99, use_lecam: bool = True):
    """(loss, new state): the EMAs update before the penalty uses them."""
    if use_lecam:
        state = update_ema(state, real_output, fake_output, real_mask,
                           fake_mask, decay)
    loss = discriminator_loss_fixed_ema(
        real_output, fake_output, real_mask, fake_mask, ema_state=state,
        real_label=real_label, fake_label=fake_label, use_lecam=use_lecam)
    return loss, state


def generator_loss(fake_output, fake_mask=None, real_label: float = 1.0):
    return _masked_mse(fake_output, torch.full_like(fake_output, real_label),
                       fake_mask)
