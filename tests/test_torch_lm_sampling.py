"""PyTorch port: the token-LM samplers (``models/lm_sampling.py``) against
the JAX package on bridged weights, fp32 on the CPU, and the port's own
per-row key chain.

JAX's threefry streams cannot be reproduced, so sampled tokens are held to
JAX's only where no noise matters (``top_k = 1``); elsewhere the port is held
to its own contract: per-row seeds reproduce, a batched row equals the same
row alone, mixed prompt lengths equal solo runs, the vocab mask restricts
support, and the key chain's draws follow the categorical distribution.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mqgan_tpu.models import lm_sampling as jls
from mqgan_tpu.models.music_lstm import MusicLSTM as JaxLSTM
from mqgan_tpu.models.token_transformer import MusicTransformer as JaxTransformer
from mqgan_tpu_torch.models import lm_sampling as tls
from mqgan_tpu_torch.models.music_lstm import MusicLSTM
from mqgan_tpu_torch.models.token_lm import served_sampler
from mqgan_tpu_torch.models.token_transformer import MusicTransformer
from mqgan_tpu_torch.utils.params import state_dict_from_jax
from tests.test_torch_token_lm import LSTM, TF, _jax_tree

LOGIT_TOL = 1e-5
VOCAB = TF["vocab_size"]
L, P = 10, 5  # generated tokens, prompt bucket


@pytest.fixture(scope="module", params=["lstm", "transformer"])
def arch(request):
    """(name, JAX model, JAX params, port model) on bridged weights."""
    if request.param == "lstm":
        jm, cls, cfg, seed = JaxLSTM(**LSTM, dropout=0.0), MusicLSTM, LSTM, 21
    else:
        jm, cls, cfg, seed = (JaxTransformer(**TF, dropout=0.0), MusicTransformer,
                              TF, 22)
    tree = _jax_tree(jm, np.random.default_rng(seed))
    model = cls(**cfg, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(tree, model))
    return request.param, jm, jax.tree_util.tree_map(jnp.asarray, tree), model.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _prompts(rng, lens):
    prompt = rng.integers(2, VOCAB, (len(lens), P)).astype(np.int32)
    for i, n in enumerate(lens):
        prompt[i, n:] = 0  # the pad region is arbitrary
    return prompt


def _port_served(model, genres, seeds, prompt, lens, *, temperature=1.0,
                 top_k=0, top_p=0.0, mask=None, max_len=L, **kw):
    mask = torch.ones(VOCAB, dtype=torch.bool) if mask is None else mask
    return served_sampler(model)(
        model, _t(genres), _t(seeds), _t(prompt), _t(lens), temperature, top_k,
        top_p, mask, max_len=max_len, bos_id=1, **kw).numpy()


@functools.lru_cache(maxsize=None)
def _jax_served_fn(arch_name, jm, max_len):
    fn = (jls.generate_tokens_transformer_served if arch_name == "transformer"
          else jls.generate_tokens_served)
    return jax.jit(functools.partial(fn, jm, max_len=max_len, bos_id=1))


# -- the filter -------------------------------------------------------------

@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 1.0])
@pytest.mark.parametrize("top_k", [0, 1, 5, VOCAB])
def test_filter_logits_traced_exact(top_k, top_p):
    """Bit for bit JAX's filter (values and -inf pattern) over temperatures
    and vocab masks."""
    rng = np.random.default_rng(top_k * 10 + int(top_p * 10))
    logits = (rng.standard_normal((6, VOCAB)) * 3.0).astype(np.float32)
    masks = [np.ones(VOCAB, bool), rng.random(VOCAB) < 0.6]
    masks[1][:2] = False
    for temperature in (0.7, 1.0, 1.9):
        for mask in masks:
            want = np.asarray(jls.filter_logits_traced(
                jnp.asarray(logits), jnp.float32(temperature), jnp.int32(top_k),
                jnp.float32(top_p), jnp.asarray(mask)))
            got = tls.filter_logits_traced(
                torch.from_numpy(logits), torch.tensor(temperature),
                torch.tensor(top_k), torch.tensor(top_p, dtype=torch.float32),
                torch.from_numpy(mask)).numpy()
            np.testing.assert_array_equal(got, want)


# -- scoring and stepwise logits -----------------------------------------

def test_score_tokens_matches_jax(arch):
    _, jm, params, model = arch
    rng = np.random.default_rng(31)
    tokens = rng.integers(1, VOCAB, (3, 9)).astype(np.int32)
    tokens[1, 6:] = 0
    genres = np.asarray([0, 2, 1], np.int32)
    jn, jv = jls.score_tokens(jm, params, jnp.asarray(tokens), jnp.asarray(genres))
    tn, tv = tls.score_tokens(model, _t(tokens), _t(genres))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_greedy_next_logits_match_jax_and_the_forward():
    jm = JaxLSTM(**LSTM, dropout=0.0)
    tree = _jax_tree(jm, np.random.default_rng(32))
    model = MusicLSTM(**LSTM, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(tree, model))
    rng = np.random.default_rng(33)
    tokens = rng.integers(1, VOCAB, (2, 7)).astype(np.int32)
    genres = np.asarray([1, 0], np.int32)
    want = np.asarray(jls.greedy_next_logits(
        jm, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
        jnp.asarray(genres)))
    got = tls.greedy_next_logits(model, _t(tokens), _t(genres)).numpy()
    assert np.abs(got - want).max() <= LOGIT_TOL * max(1.0, np.abs(want).max())
    with torch.no_grad():
        fwd = model(_t(tokens), _t(genres)).numpy()
    assert np.abs(got - fwd).max() <= LOGIT_TOL * max(1.0, np.abs(fwd).max())


# -- greedy tokens against JAX ---------------------------------------------

@pytest.mark.parametrize("lens", [(0, 0, 0, 0), (0, 5, 1, 3)])
def test_served_greedy_tokens_match_jax(arch, lens):
    """top_k = 1: the served samplers of both archs give JAX's tokens,
    unconditional and with mixed prompt lengths."""
    name, jm, params, model = arch
    rng = np.random.default_rng(sum(lens) + 40)
    prompt = _prompts(rng, lens)
    genres = np.asarray([0, 1, 2, 1], np.int32)
    seeds = np.asarray([5, 6, 7, 8], np.int32)
    mask = np.ones(VOCAB, bool)
    mask[[0, 1]] = False
    want = np.asarray(_jax_served_fn(name, jm, L)(
        params, jnp.asarray(genres), jnp.asarray(seeds), jnp.asarray(prompt),
        jnp.asarray(np.asarray(lens, np.int32)), jnp.float32(0.8), jnp.int32(1),
        jnp.float32(0.0), jnp.asarray(mask)))
    got = _port_served(model, genres, seeds, prompt, lens, temperature=0.8,
                       top_k=1, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got, want)


def test_static_greedy_tokens_match_jax(arch):
    """The static samplers at top_k = 1 with a prompt and forbidden ids."""
    name, jm, params, model = arch
    rng = np.random.default_rng(41)
    prompt = rng.integers(2, VOCAB, (3, 4)).astype(np.int32)
    genres = np.asarray([2, 0, 1], np.int32)
    jfn, tfn = ((jls.generate_tokens_transformer, tls.generate_tokens_transformer)
                if name == "transformer"
                else (jls.generate_tokens, tls.generate_tokens))
    kw = dict(temperature=1.0, top_k=1, prompt=prompt, forbidden_tokens=(0, 1, 7))
    want = np.asarray(jfn(jm, params, jnp.asarray(genres), jax.random.key(0), L,
                          **dict(kw, prompt=jnp.asarray(prompt))))
    got = tfn(model, _t(genres), 0, L, **dict(kw, prompt=_t(prompt))).numpy()
    np.testing.assert_array_equal(got, want)


# -- the port's own sampling contract -----------------------------------

def test_seeds_reproduce_and_differ(arch):
    _, _, _, model = arch
    genres, lens = np.zeros(4, np.int32), np.zeros(4, np.int32)
    prompt = np.zeros((4, 1), np.int32)
    a = _port_served(model, genres, [1, 2, 3, 4], prompt, lens)
    b = _port_served(model, genres, [1, 2, 3, 4], prompt, lens)
    c = _port_served(model, genres, [9, 10, 11, 12], prompt, lens)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert len({tuple(r) for r in a}) > 1  # rows draw their own streams


def _check_batched_rows(name, model, extra):
    rng = np.random.default_rng(50)
    lens = np.asarray([3, 0, 5, 1], np.int32)
    prompt = _prompts(rng, lens)
    genres = np.asarray([2, 1, 0, 1], np.int32)
    seeds = np.asarray([100, 7, 2**31 + 5, 42], np.int64)
    knobs = dict(temperature=1.3, top_k=12, top_p=0.9)
    batch = _port_served(model, genres, seeds, prompt, lens, **knobs, **extra)
    static = (tls.generate_tokens_transformer if name == "transformer"
              else tls.generate_tokens)
    for i in range(4):
        solo = _port_served(model, genres[i:i + 1], seeds[i:i + 1],
                            prompt[i:i + 1], lens[i:i + 1], **knobs, **extra)
        np.testing.assert_array_equal(batch[i:i + 1], solo)
        p = _t(prompt[i:i + 1, :lens[i]]) if lens[i] else None
        alone = static(model, _t(genres[i:i + 1]), _t(seeds[i:i + 1]), L,
                       prompt=p, **knobs, **extra).numpy()
        np.testing.assert_array_equal(solo, alone)
    # rows among other neighbours at other positions: the same tokens
    perm = [2, 0, 3, 1]
    shuffled = _port_served(model, genres[perm], seeds[perm], prompt[perm],
                            lens[perm], **knobs, **extra)
    np.testing.assert_array_equal(shuffled, batch[perm])


def test_batched_rows_equal_solo_rows(arch):
    """Every row of a mixed-prompt batch (top-k and top-p on) equals the same
    request served alone, the static sampler at B = 1 with that seed and
    prompt, and itself among other neighbours."""
    name, _, _, model = arch
    _check_batched_rows(name, model, {})


def test_bf16_kv_cache_rows_equal_solo_rows():
    """The per-row contract within a bf16 KV cache."""
    model = MusicTransformer(**TF, dropout=0.0)
    model.load_state_dict(state_dict_from_jax(
        _jax_tree(JaxTransformer(**TF, dropout=0.0), np.random.default_rng(23)),
        model))
    _check_batched_rows("transformer", model.eval(), {"kv_dtype": torch.bfloat16})


def test_vocab_mask_restricts_support(arch):
    _, _, _, model = arch
    mask = torch.zeros(VOCAB, dtype=torch.bool)
    allowed = [3, 8, 17, 30]
    mask[allowed] = True
    out = _port_served(model, np.zeros(8, np.int32), np.arange(8),
                       np.zeros((8, 1), np.int32), np.zeros(8, np.int32),
                       temperature=3.0, mask=mask, max_len=16)
    assert set(np.unique(out)) <= set(allowed)
    assert len(set(np.unique(out))) == len(allowed)


def test_key_chain_uniforms_and_chi_square():
    """The uniforms are odd multiples of 2^-24 in (0, 1), one per (row,
    step, vocab id); Gumbel-argmax draws from fixed logits over 20,000
    (seed, step) pairs pass a chi-square test (7 degrees of freedom, 99.9%
    quantile 24.32)."""
    chain = tls.KeyChain(tls.row_seeds(0, 2000), 8)
    u = torch.cat([chain.uniforms(s) for s in range(10)])
    assert u.dtype == torch.float32
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    k = (u * 2.0 ** 24).double()
    assert torch.equal(k, torch.round(k)) and bool((k % 2 == 1).all())
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert len(torch.unique(u)) > 0.99 * u.numel()
    probs = torch.tensor([0.3, 0.2, 0.15, 0.1, 0.1, 0.08, 0.05, 0.02])
    logits = torch.log(probs)[None].expand(2000, 8)
    draws = torch.cat([chain.draw(logits, s) for s in range(10)])
    counts = torch.bincount(draws, minlength=8).double()
    expected = probs.double() * draws.numel()
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 24.32, chi2


def test_key_chain_masks_to_32_bits():
    """Seeds are taken mod 2^32 (the server hands negative int32 and
    uint32 seeds alike) and the hash never leaves [0, 2^32)."""
    a = tls.KeyChain(torch.tensor([-1, 2**32 - 1, 5]), 64)
    assert int(a.seed_keys.min()) >= 0 and int(a.seed_keys.max()) < 2**32
    assert int(a.seed_keys[0]) == int(a.seed_keys[1])
    u = a.uniforms(torch.tensor([0, 0, 2**40]))
    assert torch.equal(u[0], u[1])
    assert bool((u > 0).all()) and bool((u < 1).all())
