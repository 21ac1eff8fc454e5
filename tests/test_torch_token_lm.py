"""PyTorch port: the token LMs (MusicTransformer's training path, MusicLSTM,
masked CE) against the JAX package on bridged weights, on the CPU; the
flash route, remat and dropout within the port."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.models.music_lstm import MusicLSTM as JaxLSTM
from mqgan_tpu.models.music_lstm import masked_ce_loss as jax_masked_ce
from mqgan_tpu.models.token_transformer import MusicTransformer as JaxTransformer
from mqgan_tpu_torch.models.music_lstm import MusicLSTM, masked_ce_loss
from mqgan_tpu_torch.models.token_lm import arch_config, build_token_lm, lm_arch
from mqgan_tpu_torch.models.token_transformer import MusicTransformer
from mqgan_tpu_torch.nn.layers import dropout
from mqgan_tpu_torch.utils.init import seeded_init_
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_bridge import to_numpy_tree

# fp32 on the CPU: the same functions summed in other orders
LOGIT_TOL, GRAD_TOL = 1e-5, 1e-4
BF16_REL = 2e-2
VOCAB, GENRES = 40, 3
TF = dict(vocab_size=VOCAB, num_genres=GENRES, emb_dim=32, n_layers=2,
          n_heads=4, mlp_ratio=4)
LSTM = dict(vocab_size=VOCAB, num_genres=GENRES, emb_dim=32, lstm_hid=48,
            lstm_layers=2)


def _batch(rng, t, b=3):
    """Right-padded tokens (row 1 half pad, row 2 one token), genres,
    next-token targets with the same pads."""
    tokens = rng.integers(1, VOCAB, (b, t)).astype(np.int64)
    tokens[1, max(1, t // 2):] = 0
    tokens[2, 1:] = 0
    targets = rng.integers(1, VOCAB, (b, t)).astype(np.int64)
    targets[tokens == 0] = 0
    return tokens, rng.integers(0, GENRES, (b,)).astype(np.int64), targets


def _perturb(tree, rng, scale=0.1):
    """Random offsets on the leaves flax initialises to constants (biases,
    LayerNorm scales)."""
    return {k: (_perturb(v, rng, scale) if isinstance(v, dict) else
                (v + scale * rng.standard_normal(v.shape)).astype(np.float32)
                if k in ("bias", "scale") else v)
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _init_tree(jmodel):
    """The model's init tree (it does not depend on the sequence length)."""
    tokens = jnp.ones((1, 4), jnp.int32)
    return to_numpy_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(0), tokens,
                                              jnp.zeros((1,), jnp.int32)))


def _jax_tree(jmodel, rng):
    return _perturb(_init_tree(jmodel), rng)


def _jax_logits_and_grads(jmodel, tree, tokens, genres, targets):
    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens), jnp.asarray(genres))
        return jax_masked_ce(logits, jnp.asarray(targets))[0], logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    return np.asarray(logits.astype(jnp.float32)), to_numpy_tree(grads)


def _port_logits_and_grads(model, tokens, genres, targets, **kw):
    model.zero_grad()
    logits = model(torch.from_numpy(tokens), torch.from_numpy(genres), **kw)
    loss, _ = masked_ce_loss(logits, torch.from_numpy(targets))
    loss.backward()
    return logits.detach().float(), {k: p.grad.clone() for k, p in model.named_parameters()}


def _port(cls, tree, **kw):
    model = cls(**kw)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return model


@pytest.mark.parametrize("t", [1, 7, 37, 130])
def test_transformer_logits_and_grads_match_jax_fp32(rng, t):
    tokens, genres, targets = _batch(rng, t)
    jmodel = JaxTransformer(**TF, dropout=0.0, flash=False)
    tree = _jax_tree(jmodel, rng)
    want_logits, jgrads = _jax_logits_and_grads(jmodel, tree, tokens, genres, targets)
    model = _port(MusicTransformer, tree, **TF, dropout=0.0, flash=True)
    logits, grads = _port_logits_and_grads(model, tokens, genres, targets)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    want = state_dict_from_jax(jgrads, model)
    assert set(want) == set(grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_transformer_flash_at_head_size_96_matches_jax_fp32(rng):
    """Head size 96 (emb 96, one head; 768 / 8 heads is the same D), which
    the CUDA kernels take by zero-filling 96-column tiles: one layer of the
    port's flash route (its plain versions on the CPU) against JAX's
    attention on the CPU (its XLA path: the TPU kernel does not run
    there), loss, logits and gradients."""
    tf = dict(TF, emb_dim=96, n_heads=1, n_layers=1)
    tokens, genres, targets = _batch(rng, 37)
    jmodel = JaxTransformer(**tf, dropout=0.0, flash=False)
    tree = _jax_tree(jmodel, rng)
    want_logits, jgrads = _jax_logits_and_grads(jmodel, tree, tokens, genres, targets)
    model = _port(MusicTransformer, tree, **tf, dropout=0.0, flash=True)
    assert model.blocks[0].attn.features // model.blocks[0].attn.n_heads == 96
    logits, grads = _port_logits_and_grads(model, tokens, genres, targets)
    loss, _ = masked_ce_loss(logits, torch.from_numpy(targets))
    want_loss = jax_masked_ce(jnp.asarray(want_logits), jnp.asarray(targets))[0]
    np.testing.assert_allclose(float(loss), float(want_loss), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    want = state_dict_from_jax(jgrads, model)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("emb", [384, 512])
def test_transformer_flash_at_chunked_head_sizes_matches_jax_fp32(rng, emb):
    """Head sizes 384 and 512 (emb 384 or 512, one head), the multiples of
    128 past 256 that JAX's TPU kernel takes and the CUDA kernels run by
    128-column chunks: one layer of the port's flash route (its plain
    versions on the CPU) against JAX's attention on the CPU, loss, logits
    and gradients, as at head size 96."""
    tf = dict(TF, emb_dim=emb, n_heads=1, n_layers=1)
    tokens, genres, targets = _batch(rng, 37)
    jmodel = JaxTransformer(**tf, dropout=0.0, flash=False)
    tree = _jax_tree(jmodel, rng)
    want_logits, jgrads = _jax_logits_and_grads(jmodel, tree, tokens, genres, targets)
    model = _port(MusicTransformer, tree, **tf, dropout=0.0, flash=True)
    assert model.blocks[0].attn.features // model.blocks[0].attn.n_heads == emb
    logits, grads = _port_logits_and_grads(model, tokens, genres, targets)
    loss, _ = masked_ce_loss(logits, torch.from_numpy(targets))
    want_loss = jax_masked_ce(jnp.asarray(want_logits), jnp.asarray(targets))[0]
    np.testing.assert_allclose(float(loss), float(want_loss), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    want = state_dict_from_jax(jgrads, model)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_transformer_bf16_matches_jax_bf16(rng):
    tokens, genres, targets = _batch(rng, 37)
    jmodel = JaxTransformer(**TF, dropout=0.0, dtype=jnp.bfloat16)
    tree = _jax_tree(jmodel, rng)
    want_logits, jgrads = _jax_logits_and_grads(jmodel, tree, tokens, genres, targets)
    model = _port(MusicTransformer, tree, **TF, dropout=0.0, flash=True,
                  dtype=torch.bfloat16)
    logits, grads = _port_logits_and_grads(model, tokens, genres, targets)
    assert _rel(logits, want_logits) <= BF16_REL
    want = state_dict_from_jax(jgrads, model)
    flat = np.concatenate([grads[k].numpy().ravel() for k in sorted(grads)])
    flat_want = np.concatenate([want[k].numpy().ravel() for k in sorted(grads)])
    assert _rel(flat, flat_want) <= BF16_REL


def test_flash_route_and_remat_equal_the_naive_route(rng):
    tokens, genres, targets = _batch(rng, 37)
    model = seeded_init_(MusicTransformer(**TF, dropout=0.0), 3)
    state = model.state_dict()
    logits, grads = _port_logits_and_grads(model, tokens, genres, targets)
    for kw in (dict(flash=True), dict(remat=True), dict(flash=True, remat=True)):
        other = MusicTransformer(**TF, dropout=0.0, **kw)
        other.load_state_dict(state)
        got_logits, got = _port_logits_and_grads(other, tokens, genres, targets)
        torch.testing.assert_close(got_logits, logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for name in grads:
            torch.testing.assert_close(got[name], grads[name], atol=GRAD_TOL,
                                       rtol=GRAD_TOL, msg=f"{kw} {name}")


def test_dropout_rate_scale_and_remat_replay(rng):
    x = torch.ones(400_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    dropped = float((y == 0).float().mean())
    # binomial: sd sqrt(0.09 / 4e5) = 4.7e-4, so 0.1 +- 0.003 is > 6 sd
    assert abs(dropped - 0.1) < 3e-3, dropped
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert torch.equal(dropout(x, 0.1, None), x)

    tokens, genres, targets = _batch(rng, 37)
    model = seeded_init_(MusicTransformer(**TF, dropout=0.1), 4)
    remat = MusicTransformer(**TF, dropout=0.1, remat=True)
    remat.load_state_dict(model.state_dict())
    runs = []
    for m, seed in ((model, 7), (model, 7), (remat, 7), (model, 8)):
        runs.append(_port_logits_and_grads(
            m, tokens, genres, targets, deterministic=False,
            generator=torch.Generator().manual_seed(seed)))
    det, _ = _port_logits_and_grads(model, tokens, genres, targets)
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], det)
    assert not torch.equal(runs[0][0], runs[3][0])
    # a rematerialised block replays its dropout masks
    torch.testing.assert_close(runs[2][0], runs[0][0], atol=0, rtol=0)
    for name in runs[0][1]:
        torch.testing.assert_close(runs[2][1][name], runs[0][1][name],
                                   atol=1e-6, rtol=1e-6)


def test_lstm_logits_and_grads_match_jax(rng):
    tokens, genres, targets = _batch(rng, 37)
    jmodel = JaxLSTM(**LSTM, dropout=0.0)
    tree = _jax_tree(jmodel, rng)
    want_logits, jgrads = _jax_logits_and_grads(jmodel, tree, tokens, genres, targets)
    model = _port(MusicLSTM, tree, **LSTM, dropout=0.0)
    assert "lstm_0.if.weight" in model.state_dict()
    logits, grads = _port_logits_and_grads(model, tokens, genres, targets)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    want = state_dict_from_jax(jgrads, model)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


def test_masked_ce_matches_jax_with_all_pad_rows(rng):
    logits = rng.standard_normal((3, 11, VOCAB)).astype(np.float32) * 3
    targets = rng.integers(0, VOCAB, (3, 11))
    targets[1] = 0  # an all-pad row
    for tgt in (targets, np.zeros_like(targets)):  # and an all-pad batch
        want = jax_masked_ce(jnp.asarray(logits), jnp.asarray(tgt))
        got = masked_ce_loss(torch.from_numpy(logits), torch.from_numpy(tgt))
        np.testing.assert_allclose(float(got[0]), float(want[0]), atol=1e-6, rtol=1e-6)
        assert float(got[1]) == float(want[1])
    assert float(masked_ce_loss(torch.from_numpy(logits), torch.zeros((3, 11),
                                dtype=torch.int64))[0]) == 0.0


def test_bridge_is_strict_for_lm_trees(rng):
    tree = _jax_tree(JaxTransformer(**TF, dropout=0.0, flash=False), rng)
    model = MusicTransformer(**TF)
    missing = {k: v for k, v in tree.items() if k != "ln_f"}
    with pytest.raises(KeyError, match="ln_f"):
        state_dict_from_jax(missing, model)
    extra = dict(tree, block_9=tree["block_0"])
    with pytest.raises(KeyError, match="blocks.9"):
        state_dict_from_jax(extra, model)


def test_seeded_init_follows_flax_lm_initialisers():
    model = seeded_init_(MusicTransformer(**dict(TF, emb_dim=64, vocab_size=1003)), 0)
    with torch.no_grad():
        # flax: Embed normal(variance 1/features), Dense lecun-normal
        # (variance 1/fan_in), LayerNorm scale 1 and bias 0, zero biases
        assert float(model.tok_emb.weight.std()) == pytest.approx(64 ** -0.5, rel=0.03)
        assert float(model.blocks[0].fc1.weight.std()) == pytest.approx(64 ** -0.5, rel=0.03)
        assert float(model.blocks[0].fc2.weight.std()) == pytest.approx(256 ** -0.5, rel=0.03)
        assert float(model.blocks[0].fc1.weight.abs().max()) <= 2 * 64 ** -0.5 / 0.8796
    assert torch.equal(model.ln_f.weight, torch.ones(64))
    assert torch.equal(model.blocks[1].ln2.bias, torch.zeros(64))
    assert torch.equal(model.proj.bias, torch.zeros(1003))


def test_registry_builds_both_archs_and_strips_training_knobs():
    args = dict(TF, arch="transformer", pad_id=0, flash_lm=True, remat_lm=True,
                flash_blocks=[128, 128])
    train = build_token_lm(args, dropout=0.1)
    serve = build_token_lm(args, for_inference=True)
    assert train.flash and train.remat and train.dropout == 0.1
    assert not serve.flash and not serve.remat and serve.dropout == 0.0
    assert lm_arch(train) == "transformer"
    again = build_token_lm(arch_config(train))
    assert again.state_dict().keys() == train.state_dict().keys()
    lstm = build_token_lm(dict(LSTM, pad_id=0))
    assert lm_arch(lstm) == "lstm" and arch_config(lstm)["lstm_hid"] == 48
    with pytest.raises(ValueError, match="unknown token-LM arch"):
        build_token_lm(dict(arch="gru"))
