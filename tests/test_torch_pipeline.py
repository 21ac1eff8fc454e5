"""The pipelined LSTM stack (``parallel/pipeline.py``) on ``["cpu"] * 4``:
logits, gradients, the LM trainer's train step and a generic stage chain
against the serial port stack (1e-6), and logits and gradients against the
JAX package's ``music_lstm_pipelined_logits`` on a 4-device pipe mesh of
the conftest's virtual devices (tests/test_pipeline.py's shapes; 1e-5);
bf16 at 2e-2; the dropout after the stack: the serial model's draws, and
its mean."""

import numpy as np
import pytest
import torch

from mqgan_tpu_torch.models.music_lstm import MusicLSTM, masked_ce_loss
from mqgan_tpu_torch.parallel.pipeline import (music_lstm_pipelined_logits,
                                               pipeline_map)
from mqgan_tpu_torch.train.lstm_trainer import make_lstm_step
from mqgan_tpu_torch.train.state import ClipAdamW
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_gan_step import one_torch_thread  # noqa: F401 - the fixture

VOCAB, GENRES, EMB, HID, LAYERS = 50, 3, 16, 32, 4
B, L = 8, 12
CPUS = ["cpu"] * LAYERS


@pytest.fixture(scope="module")
def setup():
    """tests/test_pipeline.py's model, inputs and pipe mesh; the port's
    model on the same weights."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mqgan_tpu.models.music_lstm import MusicLSTM as JaxLSTM

    rng = np.random.default_rng(0)
    tokens = rng.integers(1, VOCAB, (B, L)).astype(np.int32)
    tokens[0, 9:] = 0
    tokens[3, 6:] = 0
    genres = rng.integers(0, GENRES, (B,)).astype(np.int32)
    jmodel = JaxLSTM(vocab_size=VOCAB, num_genres=GENRES, emb_dim=EMB,
                     lstm_hid=HID, lstm_layers=LAYERS)
    variables = jmodel.init(jax.random.key(0), jnp.asarray(tokens), jnp.asarray(genres))
    mesh = Mesh(np.array(jax.devices()[:LAYERS]), ("pipe",))
    return tokens, genres, variables, mesh


def port_model(variables, dtype=None, dropout=0.0):
    import jax

    model = MusicLSTM(VOCAB, GENRES, emb_dim=EMB, lstm_hid=HID, lstm_layers=LAYERS,
                      dropout=dropout, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(jax.device_get(variables["params"]),
                                              model))
    return model


def _targets(tokens):
    t = torch.roll(tokens, -1, dims=1)
    t[:, -1] = 0
    return t


def test_pipelined_logits_and_grads_equal_the_serial_stack(setup):
    tokens, genres, variables, _ = setup
    tok, gen = torch.from_numpy(tokens).long(), torch.from_numpy(genres).long()
    model = port_model(variables)
    grads = []
    outs = []
    for piped in (False, True):
        model.zero_grad()
        logits = (music_lstm_pipelined_logits(model, tok, gen, CPUS, 4) if piped
                  else model(tok, gen))
        masked_ce_loss(logits, _targets(tok))[0].backward()
        outs.append(logits.detach())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-6, rtol=1e-6)
    for n, g in grads[0].items():
        np.testing.assert_allclose(grads[1][n].numpy(), g.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=n)


def test_pipelined_logits_and_grads_equal_jax_pipelined(setup):
    import jax
    import jax.numpy as jnp

    from mqgan_tpu.models.music_lstm import masked_ce_loss as jax_ce
    from mqgan_tpu.parallel.pipeline import music_lstm_pipelined_logits as jax_piped

    tokens, genres, variables, mesh = setup
    jt, jg = jnp.asarray(tokens), jnp.asarray(genres)
    targets = jnp.roll(jt, -1, axis=1).at[:, -1].set(0)

    def loss(v):
        return jax_ce(jax_piped(v, jt, jg, mesh, n_micro=4, n_layers=LAYERS), targets)[0]

    want_logits = np.asarray(jax.jit(lambda v: jax_piped(
        v, jt, jg, mesh, n_micro=4, n_layers=LAYERS))(variables))
    want_grads = state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss))(variables))["params"],
                                     port_model(variables))
    model = port_model(variables)
    tok, gen = torch.from_numpy(tokens).long(), torch.from_numpy(genres).long()
    logits = music_lstm_pipelined_logits(model, tok, gen, CPUS, 4)
    masked_ce_loss(logits, _targets(tok))[0].backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-5, rtol=1e-5)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=n)


def test_pipelined_bf16(setup):
    """bf16 runs the pipeline in the module's dtype: equal to the serial
    bf16 stack, and within 2e-2 (rel-L2) of the JAX bf16 pipeline."""
    import jax
    import jax.numpy as jnp

    from mqgan_tpu.parallel.pipeline import music_lstm_pipelined_logits as jax_piped

    tokens, genres, variables, mesh = setup
    model = port_model(variables, dtype=torch.bfloat16)
    tok, gen = torch.from_numpy(tokens).long(), torch.from_numpy(genres).long()
    with torch.no_grad():
        piped = music_lstm_pipelined_logits(model, tok, gen, CPUS, 4)
        serial = model(tok, gen)
    assert piped.dtype == torch.bfloat16
    assert torch.equal(piped, serial)
    want = np.asarray(jax_piped(variables, jnp.asarray(tokens), jnp.asarray(genres), mesh,
                                n_micro=4, n_layers=LAYERS, dtype=jnp.bfloat16),
                      np.float32)
    got = piped.float().numpy()
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_pipelined_dropout(setup):
    """The dropout after the stack draws as the serial model's does (the
    same CPU generator gives the same logits), and keeps the mean: 64
    draws at rate 0.5 average to the deterministic logits (tests/
    test_pipeline.py's tolerance)."""
    tokens, genres, variables, _ = setup
    model = port_model(variables, dropout=0.5)
    tok, gen = torch.from_numpy(tokens).long(), torch.from_numpy(genres).long()
    with torch.no_grad():
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        piped = music_lstm_pipelined_logits(model, tok, gen, CPUS, 4, False, g1)
        serial = model(tok, gen, deterministic=False, generator=g2)
        assert torch.equal(piped, serial)
        det = music_lstm_pipelined_logits(model, tok, gen, CPUS, 4)
        g = torch.Generator().manual_seed(7)
        avg = torch.stack([music_lstm_pipelined_logits(model, tok, gen, CPUS, 4,
                                                       False, g)
                           for _ in range(64)]).mean(0)
    np.testing.assert_allclose(avg.numpy(), det.numpy(), atol=0.25)


def test_pipelined_train_step_equals_serial(setup):
    """The LM trainer's own step (``make_lstm_step``) with the stack
    pipelined: two AdamW updates equal the serial step's."""
    tokens, genres, variables, _ = setup
    tok, gen = torch.from_numpy(tokens).long(), torch.from_numpy(genres).long()
    lengths = (tok != 0).sum(1)
    runs = []
    for pipe in (None, CPUS):
        model = port_model(variables)
        tx = ClipAdamW(1e-3, 1.0)
        opt = tx.init(model.parameters())
        step = make_lstm_step(model, tx, 0, train=True, pipe_devices=pipe, pipe_micro=4)
        losses = [float(step(opt, tok, gen, lengths, torch.Generator().manual_seed(1)))
                  for _ in range(2)]
        runs.append((losses, {n: p.detach().clone() for n, p in model.named_parameters()}))
    np.testing.assert_allclose(runs[1][0], runs[0][0], atol=1e-6, rtol=1e-6)
    for n, p in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][n].numpy(), p.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("n_micro", [4, 8, 7])
def test_pipeline_map_generic_stage_chain(n_micro):
    """Distinct affine stages in order, M == S, M > S and M odd, against
    the serial loop (tests/test_pipeline.py's chain)."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((LAYERS, 6, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((LAYERS, 6)).astype(np.float32))

    def stage(params, x):
        return torch.tanh(x @ params["w"] + params["b"])

    xs = torch.from_numpy(rng.standard_normal((n_micro, 3, 6)).astype(np.float32))
    got = pipeline_map(stage, [{"w": w[i], "b": b[i]} for i in range(LAYERS)], xs, CPUS)
    want = xs
    for i in range(LAYERS):
        want = stage({"w": w[i], "b": b[i]}, want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="stages for"):
        pipeline_map(stage, [{"w": w[0], "b": b[0]}], xs, CPUS)
