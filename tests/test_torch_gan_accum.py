"""The port's ``grad_accum = 2`` step equals its one-pass step, as
tests/test_train_step.py's ``test_grad_accum_matches_plain`` and
``test_grad_accum_fill_rows_match_plain`` pin it in JAX: pad-free batches,
and a batch whose last rows are the loader's zero-length fill rows (rows
are striped over microbatches). Dropout inert (rates 0, no generator)."""

import copy

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import TrainConfig
from mqgan_tpu_torch.train.state import create_train_state
from mqgan_tpu_torch.train.step import build_models, make_train_step
from mqgan_tpu_torch.utils.init import seeded_init_
from tests.test_torch_gan_step import (  # noqa: F401 - the fixture
    MEL, T, one_torch_thread, tiny_config_dict)


def _states(cfg):
    gen, patch, mb = build_models(cfg)
    for i, m in enumerate((gen, patch, mb)):
        seeded_init_(m, i)
    states = []
    for _ in range(2):
        g, p, m = (copy.deepcopy(x) for x in (gen, patch, mb))
        s = create_train_state(g, p, m, cfg.training, torch.device("cpu"))
        s.dropout_rng = s.fsq_rng = None
        states.append(s)
    return states


def _compare(a, b):
    for name, mod_a, mod_b in (("gen", a.gen, b.gen), ("patch", a.patch, b.patch),
                               ("multibin", a.multibin, b.multibin)):
        for k, v in mod_a.state_dict().items():
            np.testing.assert_allclose(mod_b.state_dict()[k].numpy(), v.numpy(),
                                       rtol=5e-4, atol=1e-5, err_msg=f"{name} {k}")
    for opt_a, opt_b in ((a.gen_opt, b.gen_opt), (a.disc_opt, b.disc_opt)):
        assert opt_a.count == opt_b.count
        for x, y in zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu):
            np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=5e-4, atol=1e-5)
    for f in ("ema_real", "ema_fake"):
        np.testing.assert_allclose(float(getattr(b.lecam, f)),
                                   float(getattr(a.lecam, f)), rtol=5e-4, atol=1e-5)


@pytest.mark.parametrize("train_d,use_fm,fill", [
    (True, True, False), (False, False, False), (True, False, True)],
    ids=["gan_fm", "warmup", "fill_rows"])
def test_grad_accum_matches_one_pass(train_d, use_fm, fill):
    cfg = TrainConfig.from_dict(tiny_config_dict(use_fm=use_fm))
    big_b = 8
    rng = np.random.default_rng(7)
    mel = rng.standard_normal((big_b, T, MEL)).astype(np.float32)
    lengths = np.full((big_b,), T, np.int32)
    if fill:  # the last 4 rows: zero-length fill, as the loader builds them
        mel[4:] = 0.0
        lengths[4:] = 0
    mel, lengths = torch.from_numpy(mel), torch.from_numpy(lengths)
    plain_state, accum_state = _states(cfg)
    plain = make_train_step(cfg, train_d=train_d)
    accum = make_train_step(cfg, train_d=train_d, grad_accum=2)
    for _ in range(2):  # the second step takes the LeCam decay branch
        m_plain = plain(plain_state, mel, lengths)
        m_accum = accum(accum_state, mel, lengths)
    for key, v in m_plain.items():
        np.testing.assert_allclose(float(m_accum[key]), float(v), rtol=5e-4,
                                   atol=1e-5, err_msg=key)
    _compare(plain_state, accum_state)
    assert accum_state.step == plain_state.step == 2


def test_grad_accum_rejects_an_indivisible_batch():
    cfg = TrainConfig.from_dict(tiny_config_dict())
    state, _ = _states(cfg)
    step = make_train_step(cfg, train_d=True, grad_accum=3)
    with pytest.raises(ValueError, match="not divisible"):
        step(state, torch.zeros(4, T, MEL), torch.full((4,), T))
