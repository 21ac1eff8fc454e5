"""Autoregressive sampling from the token LMs (counterpart of
``mqgan_tpu/models/lm_sampling.py``): the LSTM's step-by-step sampler, the
transformer's prefill + KV-cache decode, their served twins with every
sampling control a tensor and per-row (seed, prompt length), the shared
temperature / top-k / top-p filter, and scoring.

The served samplers are loops over traceable pieces: ``transformer_prefill``
and ``transformer_step`` for the transformer, ``lstm_step`` for the LSTM.
In a traced piece every per-step value is a tensor (the step counter ``t``
a 0-d int64, the prompt column gathered by it; the LSTM's eager loop
passes its Python step and column, the same values with no more host work
a step than before). The transformer's pieces write
the KV caches in place; the LSTM's return the new carries, which the
sampler here rebinds and the traced program copies into its state inputs.
``deploy/export_lm.py`` traces the pieces with ``torch.export`` (the
transformer's through the model methods they call: embedding, one layer,
head) and its runtime replays the programs, eagerly or as CUDA graphs, with
the same operations in the same order as the loops here.

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

    @classmethod
    def of(cls, seed_keys: torch.Tensor, vocab_keys: torch.Tensor) -> "KeyChain":
        """The chain whose keys were made already: a traced piece takes
        them as inputs."""
        chain = cls.__new__(cls)
        chain.seed_keys, chain.vocab_keys = seed_keys, vocab_keys
        return chain

    def uniforms(self, steps) -> torch.Tensor:
        """steps: an int, a 0-d tensor or (B,) post-prompt steps -> (B, V)
        fp32."""
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


def served_controls(model, temperature, top_k, top_p, device=None):
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


def filtered_draw(chain: KeyChain, logits, steps, temperature, top_k, top_p,
                  vocab_mask):
    """The served samplers' draw: ``filter_logits_traced`` then the key
    chain's categorical draw at ``steps``."""
    return chain.draw(filter_logits_traced(logits, temperature, top_k, top_p,
                                           vocab_mask), steps)


def prompt_column(prompt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Column min(t, P - 1) of ``prompt`` (B, P), t a 0-d int64 tensor."""
    return prompt.index_select(1, torch.clamp(t, max=prompt.shape[1] - 1).reshape(1))[:, 0]


def lstm_step(model, weights, token, t, fed, prompt_lens, genre_vec,
              seed_keys, vocab_keys, temperature, top_k, top_p, vocab_mask,
              carries):
    """Step t (an int, or a 0-d int64 tensor in a traced program) of the
    served LSTM sampler: ``model.step`` on ``token`` (B,) from the (c, h)
    ``carries`` with ``weights`` (``model.step_weights()``) and
    ``genre_vec`` (``model.genre_vectors``), then row b's draw at
    post-prompt step max(t - prompt_lens[b], 0). Returns (the new
    carries, the draw, the next input): ``fed``, the prompt's column
    min(t, P - 1), while t + 1 <= prompt_lens[b], else the draw. A draw
    past a row's max_len steps is never returned by the sampler, so its
    step is not clipped above."""
    carries, logits = model.step(carries, token, genre_vec, weights)
    nxt = filtered_draw(KeyChain.of(seed_keys, vocab_keys), logits,
                        torch.clamp(t - prompt_lens, min=0), temperature, top_k,
                        top_p, vocab_mask)
    return carries, nxt, torch.where(t + 1 <= prompt_lens, fed, nxt)


@torch.no_grad()
def generate_tokens_served(model, genre_ids: torch.Tensor, seeds: torch.Tensor,
                           prompt: torch.Tensor, prompt_lens: torch.Tensor,
                           temperature, top_k, top_p,
                           vocab_mask: torch.Tensor, *, max_len: int,
                           bos_id: int = 1) -> torch.Tensor:
    """``generate_tokens`` with tensor controls and per-row (seed, prompt
    length): prompt (B, P) with P >= 1 (the pad region is arbitrary),
    prompt_lens (B,) in [0, P] (0 = unconditional). The recurrence runs
    P + max_len ``lstm_step`` calls; at step t row b draws with its key at
    post-prompt step t - prompt_lens[b] and feeds prompt[t] back while
    t + 1 <= prompt_lens[b]. Row b equals ``generate_tokens`` at B = 1
    with seed seeds[b] and its own prompt. Returns the (B, max_len)
    continuation after each row's prompt."""
    b, p_bucket = prompt.shape
    dev = genre_ids.device
    controls = served_controls(model, temperature, top_k, top_p, dev)
    weights = model.step_weights()
    genre_vec = model.genre_vectors(genre_ids)
    carries = model.zero_carries(b, dev)
    chain = KeyChain(row_seeds(seeds, b, dev), model.vocab_size)
    prompt = prompt.long()
    prompt_lens = torch.clamp(prompt_lens.long(), 0, p_bucket)
    token = torch.full((b,), bos_id, dtype=torch.long, device=dev)
    outs = []
    for t in range(p_bucket + max_len):
        carries, nxt, token = lstm_step(
            model, weights, token, t, prompt[:, min(t, p_bucket - 1)], prompt_lens,
            genre_vec, chain.seed_keys, chain.vocab_keys, *controls, vocab_mask,
            carries)
        outs.append(nxt)
    outs = torch.stack(outs, dim=1)  # (B, P + max_len)
    gather = prompt_lens[:, None] + torch.arange(max_len, device=dev)
    return outs.gather(1, gather)


def _kv_dtype(model, kv_dtype):
    return kv_dtype or model.dtype or torch.float32


def prefix_tokens(prompt: torch.Tensor, bos_id: int) -> torch.Tensor:
    """[BOS] + each row's prompt: (B, P) -> (B, P + 1) int64."""
    return torch.cat([torch.full((prompt.shape[0], 1), bos_id, dtype=torch.long,
                                 device=prompt.device), prompt.long()], dim=1)


def transformer_prefill(model, prompt, prompt_lens, genre_ids, seed_keys,
                        vocab_keys, temperature, top_k, top_p, vocab_mask,
                        caches, *, bos_id: int):
    """The served transformer's first piece: [BOS] + each row's prompt
    (B, P), right-padded to the P bucket, through every layer in one pass
    that writes positions [0, P] of ``caches`` in place; row b's logits at
    its last valid position prompt_lens[b], filtered and drawn at
    post-prompt step 0. Returns the first token (B,)."""
    logits, _ = model.prefill(prefix_tokens(prompt, bos_id), genre_ids, caches,
                              prompt_lens)
    return filtered_draw(KeyChain.of(seed_keys, vocab_keys), logits, 0,
                         temperature, top_k, top_p, vocab_mask)


def transformer_step(model, token, t, prompt_lens, genre_ids, seed_keys,
                     vocab_keys, temperature, top_k, top_p, vocab_mask, caches):
    """Decode step t >= 1 (0-d int64) of the served transformer: row b's
    ``token`` at position prompt_lens[b] + t through ``step_rows`` (its k/v
    written into ``caches`` in place), drawn at post-prompt step t. Returns
    the next token (B,)."""
    logits, _ = model.step_rows(token, genre_ids, caches, prompt_lens + t)
    return filtered_draw(KeyChain.of(seed_keys, vocab_keys), logits, t,
                         temperature, top_k, top_p, vocab_mask)


@torch.no_grad()
def generate_tokens_transformer_served(model, genre_ids: torch.Tensor,
                                       seeds: torch.Tensor, prompt: torch.Tensor,
                                       prompt_lens: torch.Tensor, temperature,
                                       top_k, top_p, vocab_mask: torch.Tensor, *,
                                       max_len: int, bos_id: int = 1,
                                       kv_dtype: torch.dtype | None = None
                                       ) -> torch.Tensor:
    """The transformer twin of ``generate_tokens_served``, same signature
    and per-row contract: one ``transformer_prefill`` fills every layer's
    KV cache, then max_len - 1 ``transformer_step`` calls extend it, row b
    writing and attending at its own position prompt_lens[b] + t, which
    overwrites the prefill's pad-region entries before any valid query can
    see them. ``kv_dtype`` (default: the compute dtype, fp32 for inference
    rebuilds) stores the cache; bf16 halves its reads, scores and softmax
    stay fp32, and the per-row contract holds within one cache dtype."""
    from mqgan_tpu_torch.models.token_transformer import init_cache

    b, p_bucket = prompt.shape
    dev = genre_ids.device
    controls = served_controls(model, temperature, top_k, top_p, dev)
    chain = KeyChain(row_seeds(seeds, b, dev), model.vocab_size)
    rows = (torch.clamp(prompt_lens.long(), 0, p_bucket), genre_ids,
            chain.seed_keys, chain.vocab_keys)
    caches = init_cache(model, b, p_bucket + max_len, _kv_dtype(model, kv_dtype),
                        dev)
    token = transformer_prefill(model, prompt, *rows, *controls, vocab_mask,
                                caches, bos_id=bos_id)
    outs = [token]
    t = torch.zeros((), dtype=torch.long, device=dev)
    for _ in range(1, max_len):
        t += 1
        token = transformer_step(model, token, t, *rows, *controls, vocab_mask,
                                 caches)
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


def masked_nll(logits: torch.Tensor, targets: torch.Tensor, pad_id: int):
    """(next-token NLL with pad targets zeroed, the valid mask), fp32, each
    of the targets' shape."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())[..., 0]
    valid = (targets != pad_id).float()
    return nll * valid, valid


@torch.no_grad()
def score_tokens(model, tokens: torch.Tensor, genre_ids: torch.Tensor):
    """Per-row next-token NLL sums over a BOS-prepended batch: the trainer's
    loss (inputs tokens[:, :-1], targets tokens[:, 1:], pad targets
    excluded) reduced per row. Returns (nll_sum (B,), n_valid (B,)), fp32."""
    nll, valid = masked_nll(model(tokens[:, :-1], genre_ids), tokens[:, 1:],
                            model.pad_id)
    return nll.sum(dim=1), valid.sum(dim=1)


def lstm_score_step(model, weights, token, target, genre_ids, carries):
    """One position of the LSTM's score through its decode step: ``token``
    (B,) in from the (c, h) ``carries``; returns (the new carries, and
    ``masked_nll`` of ``target`` (B,)). ``deploy/export_lm.py`` scores the
    LSTM with it (the training forward's loop over time would trace
    unrolled)."""
    carries, logits = model.step(carries, token, model.genre_vectors(genre_ids),
                                 weights)
    return carries, masked_nll(logits, target, model.pad_id)


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
