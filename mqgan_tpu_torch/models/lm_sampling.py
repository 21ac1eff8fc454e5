"""Autoregressive sampling from the token LMs (counterpart of
``mqgan_tpu/models/lm_sampling.py``): the LSTM's step-by-step sampler, the
transformer's prefill + KV-cache decode, their served twins with every
sampling control a tensor and per-row (seed, prompt length), the shared
temperature / top-k / top-p filter, and scoring.

Random draws. JAX's threefry key streams cannot be reproduced in PyTorch, so
the port has its own per-row key chain (``KeyChain``): the uniform of (row
seed, post-prompt step, vocab id) is a counter-based hash computed with
integer tensor ops on 32-bit lanes of int64 tensors, so it keeps no
generator state and gives the same bits on the CPU and on a card. A draw is
``argmax(logits + Gumbel(u))``, the way ``jax.random.categorical`` draws.
Row b's tokens depend only on its own seed, prompt and logits, so a row
served in a batch equals the same row served alone wherever the logits
agree: that is the continuous-batching invariant of ``deploy/http_lm.py``.
With ``top_k = 1`` no noise matters and the tokens are JAX's.

All functions run on the device of the tensors they are given, without
gradients.
"""

from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF
_SEED_SALT, _STEP_SALT, _VOCAB_SALT = 0x3C6EF372, 0xA54FF53A, 0x510E527F
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32): the constant is split in
    16-bit halves so that no product leaves the int64 range."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijection with full avalanche) on int64
    values in [0, 2^32); shifts of non-negative values extend no sign."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def row_seeds(seeds, batch: int, device=None) -> torch.Tensor:
    """(B,) int64 seeds in [0, 2^32): a tensor as given (masked to 32
    bits), or an int ``s`` meaning s, s + 1, ..., s + B - 1."""
    if isinstance(seeds, int):
        seeds = seeds + torch.arange(batch, device=device)
    return torch.as_tensor(seeds, device=device).long() & _MASK32


class KeyChain:
    """The per-row key chain: uniforms u(seed, step, vocab id) in (0, 1),
    odd multiples of 2^-24 (exact in fp32)."""

    def __init__(self, seeds: torch.Tensor, vocab_size: int):
        self.seed_keys = _mix32((seeds.long() & _MASK32) ^ _SEED_SALT)  # (B,)
        ids = torch.arange(vocab_size, device=seeds.device)
        self.vocab_keys = _mix32(_mul32(ids, _GOLDEN) ^ _VOCAB_SALT)  # (V,)

    def uniforms(self, steps) -> torch.Tensor:
        """steps: an int or (B,) post-prompt steps -> (B, V) fp32."""
        if isinstance(steps, int):
            steps = torch.full_like(self.seed_keys, steps)
        step_keys = _mix32(self.seed_keys
                           ^ _mix32((steps.long() & _MASK32) ^ _STEP_SALT))
        bits = _mix32(step_keys[:, None] ^ self.vocab_keys[None, :])
        return ((bits >> 9) * 2 + 1).float() * 2.0 ** -24

    def draw(self, logits: torch.Tensor, steps) -> torch.Tensor:
        """Row b's categorical draw from ``logits`` (B, V) at its step."""
        gumbel = -torch.log(-torch.log(self.uniforms(steps)))
        return torch.argmax(logits.float() + gumbel, dim=-1)


def sample_filtered(logits: torch.Tensor, chain: KeyChain, steps, *,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 0.0,
                    forbid: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature / forbid / top-k / top-p filtering and a categorical draw
    at ``steps`` of ``chain``, with static controls. top_k keeps the k
    highest logits; top_p (nucleus) keeps the smallest descending-prob prefix
    whose mass reaches p (0 or >= 1 disables); both compose (top_k first)."""
    logits = logits.float() / max(temperature, 1e-6)
    if forbid is not None:
        logits = logits.index_fill(1, forbid, float("-inf"))
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p and 0.0 < top_p < 1.0:
        # a token stays iff the mass before it is still < top_p, so the
        # top-1 token always stays
        desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(desc, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        kept = torch.where(before < top_p, desc, float("inf"))
        kth = kept.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return chain.draw(logits, steps)


def filter_logits_traced(logits: torch.Tensor, temperature: torch.Tensor,
                         top_k: torch.Tensor, top_p: torch.Tensor,
                         vocab_mask: torch.Tensor) -> torch.Tensor:
    """``sample_filtered``'s filter with every control a tensor and no
    draw: temperature () fp32 (> 0), top_k () int in [0, V] (0 disables),
    top_p () fp32 (0 or >= 1 disables), vocab_mask (V,) bool (True =
    sampleable). Disabled filters become -inf thresholds, not skipped
    branches, so one dispatch serves every setting."""
    b, v = logits.shape
    neg_inf = float("-inf")  # a scalar: no host-to-device copy per step
    logits = logits.float() / temperature
    logits = torch.where(vocab_mask[None, :], logits, neg_inf)
    # top-k: ascending sort, the threshold at rank V - k
    srt = torch.sort(logits, dim=-1).values
    rank = (v - torch.clamp(top_k, min=1)).long().reshape(1, 1).expand(b, 1)
    kth_k = torch.where(top_k > 0, srt.gather(-1, rank), neg_inf)
    logits = torch.where(logits < kth_k, neg_inf, logits)
    # nucleus, re-sorted after the top-k filter
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    kept = torch.where(before < top_p, desc, float("inf"))
    kth_p = kept.min(dim=-1, keepdim=True).values
    kth_p = torch.where((top_p > 0.0) & (top_p < 1.0), kth_p, neg_inf)
    return torch.where(logits < kth_p, neg_inf, logits)


def _controls(model, temperature, top_k, top_p, device):
    """The served samplers' controls as clamped 0-d tensors."""
    return (torch.clamp(torch.as_tensor(temperature, dtype=torch.float32,
                                        device=device), min=1e-6),
            torch.clamp(torch.as_tensor(top_k, device=device).long(), 0,
                        model.vocab_size),
            torch.as_tensor(top_p, dtype=torch.float32, device=device))


def _forbid(forbidden_tokens, device):
    ids = sorted(set(int(t) for t in forbidden_tokens))
    return torch.tensor(ids, device=device) if ids else None


@torch.no_grad()
def generate_tokens(model, genre_ids: torch.Tensor, seeds, max_len: int, *,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 0.0, bos_id: int = 1,
                    prompt: torch.Tensor | None = None,
                    forbidden_tokens: tuple = ()) -> torch.Tensor:
    """The LSTM sampler: (B, max_len) tokens after [BOS] + ``prompt`` (B, P).
    Row b draws its step-s token from the key chain at (seed_b, s);
    ``seeds`` as ``row_seeds`` takes them."""
    b = genre_ids.shape[0]
    dev = genre_ids.device
    weights = model.step_weights()
    genre_vec = model.genre_vectors(genre_ids)
    carries = model.zero_carries(b, dev)
    top_k = min(top_k, model.vocab_size) if top_k else 0
    token = torch.full((b,), bos_id, dtype=torch.long, device=dev)
    if prompt is not None:
        # teacher-force the prompt; its last token is the next input
        prompt = prompt.long()
        fed = torch.cat([token[:, None], prompt[:, :-1]], dim=1)
        for t in range(fed.shape[1]):
            carries, _ = model.step(carries, fed[:, t], genre_vec, weights)
        token = prompt[:, -1]
    chain = KeyChain(row_seeds(seeds, b, dev), model.vocab_size)
    forbid = _forbid(forbidden_tokens, dev)
    outs = []
    for s in range(max_len):
        carries, logits = model.step(carries, token, genre_vec, weights)
        token = sample_filtered(logits, chain, s, temperature=temperature,
                                top_k=top_k, top_p=top_p, forbid=forbid)
        outs.append(token)
    return torch.stack(outs, dim=1)


@torch.no_grad()
def generate_tokens_served(model, genre_ids: torch.Tensor, seeds: torch.Tensor,
                           prompt: torch.Tensor, prompt_lens: torch.Tensor,
                           temperature, top_k, top_p,
                           vocab_mask: torch.Tensor, *, max_len: int,
                           bos_id: int = 1) -> torch.Tensor:
    """``generate_tokens`` with tensor controls and per-row (seed, prompt
    length): prompt (B, P) with P >= 1 (the pad region is arbitrary),
    prompt_lens (B,) in [0, P] (0 = unconditional). The recurrence runs
    P + max_len steps; at step t row b draws with its key at post-prompt
    step clip(t - prompt_lens[b], 0, max_len - 1) and feeds prompt[t] back
    while t + 1 <= prompt_lens[b]. Row b equals ``generate_tokens`` at B = 1
    with seed seeds[b] and its own prompt. Returns the (B, max_len)
    continuation after each row's prompt."""
    b, p_bucket = prompt.shape
    dev = genre_ids.device
    temperature, top_k, top_p = _controls(model, temperature, top_k, top_p, dev)
    weights = model.step_weights()
    genre_vec = model.genre_vectors(genre_ids)
    carries = model.zero_carries(b, dev)
    chain = KeyChain(row_seeds(seeds, b, dev), model.vocab_size)
    prompt = prompt.long()
    prompt_lens = torch.clamp(prompt_lens.long(), 0, p_bucket)
    token = torch.full((b,), bos_id, dtype=torch.long, device=dev)
    outs = []
    for t in range(p_bucket + max_len):
        carries, logits = model.step(carries, token, genre_vec, weights)
        flt = filter_logits_traced(logits, temperature, top_k, top_p, vocab_mask)
        nxt = chain.draw(flt, torch.clamp(t - prompt_lens, 0, max_len - 1))
        token = torch.where(t + 1 <= prompt_lens, prompt[:, min(t, p_bucket - 1)],
                            nxt)
        outs.append(nxt)
    outs = torch.stack(outs, dim=1)  # (B, P + max_len)
    gather = prompt_lens[:, None] + torch.arange(max_len, device=dev)
    return outs.gather(1, gather)


def _kv_dtype(model, kv_dtype):
    return kv_dtype or model.dtype or torch.float32


@torch.no_grad()
def generate_tokens_transformer_served(model, genre_ids: torch.Tensor,
                                       seeds: torch.Tensor, prompt: torch.Tensor,
                                       prompt_lens: torch.Tensor, temperature,
                                       top_k, top_p, vocab_mask: torch.Tensor, *,
                                       max_len: int, bos_id: int = 1,
                                       kv_dtype: torch.dtype | None = None
                                       ) -> torch.Tensor:
    """The transformer twin of ``generate_tokens_served``, same signature
    and per-row contract. [BOS] + each row's prompt, right-padded to the P
    bucket, fills every layer's KV cache in one prefill; row b's logits are
    read at its last valid position (prompt_lens[b]); then max_len - 1
    ``step_rows`` calls extend the cache, row b writing and attending at
    its own position prompt_lens[b] + t, which overwrites the prefill's
    pad-region entries before any valid query can see them. ``kv_dtype``
    (default: the compute dtype, fp32 for inference rebuilds) stores the
    cache; bf16 halves its reads, scores and softmax stay fp32, and the
    per-row contract holds within one cache dtype."""
    from mqgan_tpu_torch.models.token_transformer import init_cache

    b, p_bucket = prompt.shape
    dev = genre_ids.device
    temperature, top_k, top_p = _controls(model, temperature, top_k, top_p, dev)
    chain = KeyChain(row_seeds(seeds, b, dev), model.vocab_size)
    prompt_lens = torch.clamp(prompt_lens.long(), 0, p_bucket)
    prefix = torch.cat([torch.full((b, 1), bos_id, dtype=torch.long, device=dev),
                        prompt.long()], dim=1)
    caches = init_cache(model, b, p_bucket + max_len, _kv_dtype(model, kv_dtype),
                        dev)
    logits, caches = model.prefill(prefix, genre_ids, caches, prompt_lens)

    def sample(logits, step):
        return chain.draw(filter_logits_traced(logits, temperature, top_k, top_p,
                                               vocab_mask), step)

    token = sample(logits, 0)
    outs = [token]
    for t in range(1, max_len):
        logits, caches = model.step_rows(token, genre_ids, caches, prompt_lens + t)
        token = sample(logits, t)
        outs.append(token)
    return torch.stack(outs, dim=1)


@torch.no_grad()
def generate_tokens_transformer(model, genre_ids: torch.Tensor, seeds,
                                max_len: int, *, temperature: float = 1.0,
                                top_k: int = 0, top_p: float = 0.0,
                                bos_id: int = 1,
                                prompt: torch.Tensor | None = None,
                                forbidden_tokens: tuple = (),
                                kv_dtype: torch.dtype | None = None
                                ) -> torch.Tensor:
    """``generate_tokens`` for the transformer: [BOS] + ``prompt`` is
    prefilled in one batched pass, then max_len tokens extend the KV cache a
    step at a time. Returns (B, max_len) tokens after BOS and prompt."""
    from mqgan_tpu_torch.models.token_transformer import init_cache

    b = genre_ids.shape[0]
    dev = genre_ids.device
    p_len = 0 if prompt is None else prompt.shape[1]
    top_k = min(top_k, model.vocab_size) if top_k else 0
    forbid = _forbid(forbidden_tokens, dev)
    chain = KeyChain(row_seeds(seeds, b, dev), model.vocab_size)
    prefix = torch.full((b, 1), bos_id, dtype=torch.long, device=dev)
    if prompt is not None:
        prefix = torch.cat([prefix, prompt.long()], dim=1)
    # the cache holds the prefix and every token fed back (the last sampled
    # token never is)
    caches = init_cache(model, b, p_len + max_len, _kv_dtype(model, kv_dtype), dev)
    logits, caches = model.prefill(prefix, genre_ids, caches)

    def sample(logits, step):
        return sample_filtered(logits, chain, step, temperature=temperature,
                               top_k=top_k, top_p=top_p, forbid=forbid)

    token = sample(logits, 0)
    outs = [token]
    for s in range(1, max_len):
        logits, caches = model.step(token, genre_ids, caches, p_len + s)
        token = sample(logits, s)
        outs.append(token)
    return torch.stack(outs, dim=1)


@torch.no_grad()
def score_tokens(model, tokens: torch.Tensor, genre_ids: torch.Tensor):
    """Per-row next-token NLL sums over a BOS-prepended batch: the trainer's
    loss (inputs tokens[:, :-1], targets tokens[:, 1:], pad targets
    excluded) reduced per row. Returns (nll_sum (B,), n_valid (B,)), fp32."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logp = torch.log_softmax(model(inp, genre_ids).float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None].long())[..., 0]
    valid = (tgt != model.pad_id).float()
    return (nll * valid).sum(dim=1), valid.sum(dim=1)


@torch.no_grad()
def greedy_next_logits(model, tokens: torch.Tensor, genre_ids: torch.Tensor):
    """The LSTM's stepwise logits (B, T, V) over a whole prefix: the
    sampler's recurrence, held against the batch forward by the tests."""
    b, t = tokens.shape
    weights = model.step_weights()
    genre_vec = model.genre_vectors(genre_ids)
    carries = model.zero_carries(b, tokens.device)
    outs = []
    for i in range(t):
        carries, logits = model.step(carries, tokens[:, i], genre_vec, weights)
        outs.append(logits)
    return torch.stack(outs, dim=1)
