"""Every function of the port's ``losses/gan.py`` and ``losses/recon.py``
against the JAX package's on the same inputs, within 1e-6 (the LeCam state
updates included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.losses import gan as jgan
from mqgan_tpu.losses import recon as jrecon
from mqgan_tpu_torch.losses import gan as tgan
from mqgan_tpu_torch.losses import recon as trecon
from tests.test_torch_gan_step import one_torch_thread  # noqa: F401 - autouse

TOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=TOL, rtol=TOL)


def _logits(seed, all_invalid=False):
    rng = np.random.default_rng(seed)
    real = rng.standard_normal((3, 4, 6, 1)).astype(np.float32)
    fake = rng.standard_normal((3, 4, 6, 1)).astype(np.float32)
    rmask = rng.random((3, 4, 6)) > 0.3
    fmask = rng.random((3, 4, 6)) > 0.4
    if all_invalid:
        rmask[:] = False
    return real, fake, rmask, fmask


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays]


def _states():
    j = jgan.LeCamState(jnp.float32(0.3), jnp.float32(-0.2), jnp.bool_(True))
    t = tgan.LeCamState(torch.tensor(0.3), torch.tensor(-0.2), torch.tensor(True))
    return [(jgan.LeCamState.create(), tgan.LeCamState.create()), (j, t)]


def _state_close(ts, js):
    _close(ts.ema_real, js.ema_real)
    _close(ts.ema_fake, js.ema_fake)
    assert bool(ts.initialized) == bool(js.initialized)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("all_invalid", [False, True])
def test_masked_mse_mean_and_sum_count(masked, all_invalid):
    real, _, rmask, _ = _logits(0, all_invalid)
    m = rmask if masked else None
    target = np.full_like(real, 0.7)
    _close(tgan._masked_mse(*_t(real, target, m)), jgan._masked_mse(*_j(real, target, m)))
    _close(tgan._masked_mean(*_t(real, m)), jgan._masked_mean(*_j(real, m)))
    for a, b in zip(tgan.masked_sum_count(*_t(real, m)),
                    jgan.masked_sum_count(*_j(real, m))):
        _close(a, b)


@pytest.mark.parametrize("start", [0, 1], ids=["fresh", "initialized"])
def test_lecam_updates_and_loss(start):
    real, fake, rmask, fmask = _logits(1)
    js, ts = _states()[start]
    _state_close(tgan.update_ema_from_means(ts, torch.tensor(0.5), torch.tensor(-1.5)),
                 jgan.update_ema_from_means(js, jnp.float32(0.5), jnp.float32(-1.5)))
    jnew = jgan.update_ema(js, *_j(real, fake, rmask, fmask))
    tnew = tgan.update_ema(ts, *_t(real, fake, rmask, fmask))
    _state_close(tnew, jnew)
    _close(tgan.lecam_loss(tnew, *_t(real, fake, rmask, fmask)),
           jgan.lecam_loss(jnew, *_j(real, fake, rmask, fmask)))


@pytest.mark.parametrize("use_lecam", [True, False])
@pytest.mark.parametrize("start", [0, 1], ids=["fresh", "initialized"])
def test_discriminator_losses(use_lecam, start):
    real, fake, rmask, fmask = _logits(2)
    js, ts = _states()[start]
    jl, jst = jgan.discriminator_loss(*_j(real, fake, rmask, fmask), state=js,
                                      use_lecam=use_lecam)
    tl, tst = tgan.discriminator_loss(*_t(real, fake, rmask, fmask), state=ts,
                                      use_lecam=use_lecam)
    _close(tl, jl)
    _state_close(tst, jst)
    _close(tgan.discriminator_loss_fixed_ema(*_t(real, fake, rmask, fmask),
                                             ema_state=ts, use_lecam=use_lecam),
           jgan.discriminator_loss_fixed_ema(*_j(real, fake, rmask, fmask),
                                             ema_state=js, use_lecam=use_lecam))


@pytest.mark.parametrize("masked", [True, False])
def test_generator_loss(masked):
    _, fake, _, fmask = _logits(3)
    m = fmask if masked else None
    _close(tgan.generator_loss(*_t(fake, m)), jgan.generator_loss(*_j(fake, m)))


@pytest.mark.parametrize("loss_type", ["charbonnier", "mse"])
@pytest.mark.parametrize("group_size", [1, 4, 16])
def test_masked_mel_loss(loss_type, group_size):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20, 16)).astype(np.float32)
    y = rng.standard_normal((3, 20, 16)).astype(np.float32)
    lengths = np.array([20, 13, 0], np.int32)
    kw = dict(loss_type=loss_type, group_size=group_size)
    _close(trecon.masked_mel_loss(*_t(x, y, lengths), **kw),
           jrecon.masked_mel_loss(*_j(x, y, lengths), **kw))


@pytest.mark.parametrize("mask_ndim", [3, 4])
def test_masked_mae(mask_ndim):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    b = rng.standard_normal((2, 4, 6, 5)).astype(np.float32)
    m = rng.random((2, 4, 6) if mask_ndim == 3 else (2, 4, 6, 5)) > 0.5
    _close(trecon.masked_mae(*_t(a, b, m)), jrecon.masked_mae(*_j(a, b, m)))


def test_losses_carry_gradients_to_their_inputs():
    """The G-side losses differentiate through the logits and features, the
    LeCam EMAs do not."""
    real, fake, rmask, fmask = _logits(6)
    f = torch.from_numpy(fake).requires_grad_()
    _, ts = _states()[1]
    loss, st = tgan.discriminator_loss(torch.from_numpy(real), f,
                                       torch.from_numpy(rmask),
                                       torch.from_numpy(fmask), state=ts)
    assert not st.ema_fake.requires_grad
    (loss + tgan.generator_loss(f, torch.from_numpy(fmask))).backward()
    assert f.grad is not None and float(f.grad.abs().sum()) > 0
