"""The port's training branches (``deterministic=False``) on the CPU: with
dropout inert they equal the inference path (the plain versions) within
1e-5; fast dropout's moments match Bernoulli dropout's (tests/
test_fast_dropout.py's tolerances); the remat modes give the gradients of
the plain run, also with dropout drawing, because the checkpoint's
recompute replays the generator."""

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.core.config import GeneratorConfig
from mqgan_tpu_torch.core.masking import sequence_mask
from mqgan_tpu_torch.models.preencoder import PreEncoder
from mqgan_tpu_torch.nn import mixer2d, unet
from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
from mqgan_tpu_torch.utils.init import seeded_init_
from tests.test_torch_gan_step import one_torch_thread  # noqa: F401 - autouse

TOL = 1e-5
MELS, T = 16, 30
LENGTHS = (30, 23, 9)
CFG = GeneratorConfig(channels=(16, 24), kernel_sizes=(3,), dropout=0.1,
                      refiner_base_channels=4, refiner_depth=2, mixer_chunk_t=8)


def _model(**kw):
    model = PreEncoder.from_config(MELS, GeneratorConfig(**{**CFG.__dict__, **kw}))
    return seeded_init_(model, 0)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((len(LENGTHS), T, MELS)).astype(np.float32))
    return x, torch.tensor(LENGTHS, dtype=torch.int32)


def _no_checkpoint(fn, generator, *args):
    return fn(*args, generator)


def test_training_branch_equals_inference_path():
    model = _model()
    x, lengths = _inputs()
    want = model(x, lengths)
    got = model(x, lengths, deterministic=False)
    assert torch.equal(got[2], want[2])  # tokens
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_block_training_branch_equals_kernel_path(causal):
    blk = seeded_init_(ResidualBlock1D(16, 24, 5, causal=causal), 1)
    x, lengths = _inputs(1)
    mask = sequence_mask(T, lengths)
    with torch.no_grad():
        want = blk(x, mask)
    got = blk(x, mask, deterministic=False)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("chunk", [None, 7])
def test_mixer_training_branch_equals_kernel_path(chunk):
    mix = seeded_init_(MelMixer2D(32, hidden_chunk_t=chunk), 2)
    x, lengths = _inputs(2)
    mask = sequence_mask(T, lengths)
    with torch.no_grad():
        want = mix(x, mask)
    got = mix(x, mask, deterministic=False)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=TOL, rtol=TOL)


def _sample(mix, x, n, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return np.stack([mix(x, None, False, gen).numpy() for _ in range(n)])


def test_fast_dropout_moments_match_bernoulli():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, 4)).astype(np.float32))
    exact = seeded_init_(MelMixer2D(64, dropout=0.3), 3)
    fast = MelMixer2D(64, dropout=0.3, fast_dropout=True)
    fast.load_state_dict(exact.state_dict())
    n = 400
    se, sf = _sample(exact, x, n, 1), _sample(fast, x, n, 2)
    with torch.no_grad():
        det = exact(x, None, False).numpy()
    tol = 6 * np.abs(se).std() / np.sqrt(n)
    np.testing.assert_allclose(se.mean(0), det, atol=tol)
    np.testing.assert_allclose(sf.mean(0), det, atol=tol)
    std_e, std_f = se.std(0), sf.std(0)
    keep = std_e > 0.05 * std_e.max()
    ratio = std_f[keep] / std_e[keep]
    assert 0.75 < ratio.mean() < 1.25, ratio.mean()


def test_fast_dropout_padded_rows_give_finite_gradients():
    """var is exactly 0 at padded frames: the double-where sqrt keeps the
    backward finite."""
    mix = seeded_init_(MelMixer2D(16, fast_dropout=True, hidden_chunk_t=8), 4)
    x, lengths = _inputs(4)
    out = mix(x, sequence_mask(T, lengths), False, torch.Generator().manual_seed(0))
    out.square().sum().backward()
    for name, p in mix.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name


def _grads(model, x, lengths, seed):
    model.zero_grad(set_to_none=True)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    pre, post, _ = model(x, lengths, deterministic=False, generator=gen)
    (pre.square().mean() + post.square().mean()).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("fast", [False, True])
def test_remat_gradients_equal_the_plain_run(fast, monkeypatch):
    """remat (the mixers' chunked, checkpointed MLP) and remat_refiner (the
    refiner's checkpointed ConvBlocks): with dropout inert their gradients
    are the plain run's; with dropout drawing they are those of the same
    chunked run without checkpoints, so the recompute redrew the forward's
    masks."""
    x, lengths = _inputs(5)
    plain = _model(fast_dropout=fast)
    remat = _model(fast_dropout=fast, remat=True, remat_refiner=True)
    want = _grads(plain, x, lengths, None)
    got = _grads(remat, x, lengths, None)
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)
    drawn = _grads(remat, x, lengths, 7)
    monkeypatch.setattr(mixer2d, "checkpoint", _no_checkpoint)
    monkeypatch.setattr(unet, "checkpoint", _no_checkpoint)
    eager = _grads(remat, x, lengths, 7)
    for name, g in eager.items():
        np.testing.assert_allclose(drawn[name].numpy(), g.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)
    assert any(not torch.allclose(drawn[n], want[n]) for n in want)
