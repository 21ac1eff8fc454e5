"""PyTorch port: the token LMs' decode path against the JAX package on
bridged weights, fp32 on the CPU: the transformer's prefill (with and
without per-row last positions), step and step_rows over the KV cache, the
bf16 cache, and the LSTM's one-step cell."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.models import lm_sampling as jax_sampling
from mqgan_tpu.models.music_lstm import MusicLSTM as JaxLSTM
from mqgan_tpu.models.token_transformer import MusicTransformer as JaxTransformer
from mqgan_tpu.models.token_transformer import init_cache as jax_init_cache
from mqgan_tpu_torch.models.music_lstm import MusicLSTM
from mqgan_tpu_torch.models.token_transformer import MusicTransformer, init_cache
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_token_lm import LSTM, TF, _jax_tree

# fp32 on the CPU: the same functions summed in other orders
LOGIT_TOL = 1e-5
BF16_REL = 2e-2
B, T, EXTRA = 3, 6, 5  # prefix length, decode steps after it


def _close(got, want, tol=LOGIT_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def transformer():
    jm = JaxTransformer(**TF, dropout=0.0)
    tree = _jax_tree(jm, np.random.default_rng(7))
    model = MusicTransformer(**TF, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return jm, tree, model.eval()


def _inputs(seed):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, TF["vocab_size"], (B, T)).astype(np.int32)
    genres = rng.integers(0, TF["num_genres"], (B,)).astype(np.int32)
    steps = rng.integers(1, TF["vocab_size"], (EXTRA, B)).astype(np.int32)
    return prefix, genres, steps


def _jax_apply(jm, tree, method, *args):
    return jm.apply({"params": tree}, *args, method=method)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


@pytest.mark.parametrize("kv", ["fp32", "bf16"])
def test_prefill_and_step_match_jax(transformer, kv):
    """prefill at the last position, then ``step`` at shared positions; the
    bf16 cache against JAX's bf16 cache (rel-L2), fp32 within 1e-5."""
    jm, tree, model = transformer
    prefix, genres, steps = _inputs(0)
    jdt, tdt = ((jnp.float32, torch.float32) if kv == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    jc = jax_init_cache(jm, B, T + EXTRA, jdt)
    tc = init_cache(model, B, T + EXTRA, tdt)
    jl, jc = _jax_apply(jm, tree, JaxTransformer.prefill, jnp.asarray(prefix),
                        jnp.asarray(genres), jc)
    tl, tc = model.prefill(_t(prefix), _t(genres), tc)
    pairs = [(tl, jl)]
    for i in range(EXTRA):
        jl, jc = _jax_apply(jm, tree, JaxTransformer.step, jnp.asarray(steps[i]),
                            jnp.asarray(genres), jc, T + i)
        tl, tc = model.step(_t(steps[i]), _t(genres), tc, T + i)
        pairs.append((tl, jl))
    for got, want in pairs:
        got, want = got.detach().numpy(), np.asarray(want, np.float32)
        if kv == "fp32":
            _close(got, want)
        else:
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= BF16_REL, rel
    if kv == "fp32":  # the cache holds JAX's rotated keys and values
        _close(tc[0]["k"].numpy(), jc[0]["k"])
        _close(tc[-1]["v"].numpy(), jc[-1]["v"])


def test_prefill_last_idx_and_step_rows_match_jax(transformer):
    """Per-row prefix ends (right-padded rows) and per-row decode
    positions, as the served sampler drives them."""
    jm, tree, model = transformer
    prefix, genres, steps = _inputs(1)
    last = np.asarray([T - 1, 2, 0], np.int32)
    jc = jax_init_cache(jm, B, T + EXTRA)
    tc = init_cache(model, B, T + EXTRA)
    jl, jc = _jax_apply(jm, tree, JaxTransformer.prefill, jnp.asarray(prefix),
                        jnp.asarray(genres), jc, jnp.asarray(last))
    tl, tc = model.prefill(_t(prefix), _t(genres), tc, _t(last))
    _close(tl.numpy(), jl)
    for i in range(EXTRA):
        idx = last + 1 + i
        jl, jc = _jax_apply(jm, tree, JaxTransformer.step_rows,
                            jnp.asarray(steps[i]), jnp.asarray(genres), jc,
                            jnp.asarray(idx))
        tl, tc = model.step_rows(_t(steps[i]), _t(genres), tc, _t(idx))
        _close(tl.numpy(), jl)


def test_step_rows_equals_step_at_shared_positions(transformer):
    _, _, model = transformer
    prefix, genres, steps = _inputs(2)
    ca, cb = init_cache(model, B, T + EXTRA), init_cache(model, B, T + EXTRA)
    model.prefill(_t(prefix), _t(genres), ca)
    model.prefill(_t(prefix), _t(genres), cb)
    for i in range(EXTRA):
        la, _ = model.step(_t(steps[i]), _t(genres), ca, T + i)
        lb, _ = model.step_rows(_t(steps[i]), _t(genres), cb,
                                torch.full((B,), T + i))
        assert torch.equal(la, lb)
    assert all(torch.equal(x["k"], y["k"]) and torch.equal(x["v"], y["v"])
               for x, y in zip(ca, cb))


def test_prefill_and_steps_match_the_batch_forward(transformer):
    """Decoding a sequence token by token gives the training forward's
    logits at every position."""
    _, _, model = transformer
    prefix, genres, steps = _inputs(3)
    full = np.concatenate([prefix, steps.T], axis=1)
    want = model(_t(full), _t(genres)).detach()
    cache = init_cache(model, B, T + EXTRA)
    got, _ = model.prefill(_t(prefix), _t(genres), cache)
    _close(got.numpy(), want[:, T - 1].numpy())
    for i in range(EXTRA - 1):
        got, _ = model.step(_t(steps[i]), _t(genres), cache, T + i)
        _close(got.numpy(), want[:, T + i].numpy())


def test_lstm_step_matches_jax_step_logits():
    jm = JaxLSTM(**LSTM, dropout=0.0)
    tree = _jax_tree(jm, np.random.default_rng(11))
    model = MusicLSTM(**LSTM, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(tree, model))
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, LSTM["vocab_size"], (4, B)).astype(np.int32)
    tokens[1, 0] = 0  # a pad token embeds to zero
    genres = rng.integers(0, LSTM["num_genres"], (B,)).astype(np.int32)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jvec = jnp.take(jtree["genre_emb"]["embedding"], jnp.asarray(genres), axis=0)
    cell = jax_sampling._cell(jm)
    jcar = [cell.initialize_carry(jax.random.key(0), (B, LSTM["emb_dim"]))
            for _ in range(LSTM["lstm_layers"])]
    tcar = model.zero_carries(B)
    tvec = model.genre_vectors(_t(genres))
    for tok in tokens:
        jcar, jl = jax_sampling._step_logits(jm, jtree, jcar, jnp.asarray(tok),
                                             jvec)
        tcar, tl = model.step(tcar, _t(tok), tvec)
        _close(tl.numpy(), jl)
    for (tc, th), (jc, jh) in zip(tcar, jcar):
        _close(tc.numpy(), jc)
        _close(th.numpy(), jh)
