"""Genre-conditioned causal Transformer token LM (counterpart of
``mqgan_tpu/models/token_transformer.py``): the training forward, and the
decode path, ``prefill`` / ``step`` / ``step_rows`` over a KV cache.

Pre-LN blocks with RoPE on q/k (fp32 rotation, non-interleaved halves),
scores and softmax in fp32, everything else in the compute ``dtype`` (None =
fp32, or bf16) over fp32 parameters. ``flash=True`` routes attention through
``ops/flash_attention.py`` ``causal_attention`` (the hand-written Hopper
kernels on a card, their plain versions on the CPU); ``flash=False`` is the
naive path that materialises the (B, H, T, T) scores. ``remat=True`` wraps
each block in ``torch.utils.checkpoint``.

Submodule names mirror the JAX parameter tree (``tok_emb``, ``genre_emb``,
``block_{i}`` -> ``blocks.i``, ``attn.wq``, ``ln1``, ``fc1``, ``ln_f``,
``proj``), so ``utils/params.py`` bridges a ``MusicTransformer.init`` tree.

The KV cache (``init_cache``) is one preallocated ``{"k", "v"}`` pair of
(B, S, H, D) tensors per layer, fp32 or bf16, holding rotated keys and raw
values; it is cast up to the compute dtype after each read, so scores and
softmax stay fp32. Unlike JAX's functional updates, the decode methods write
the new positions into the cache tensors in place (``step_rows`` scatters
row b's k/v at (b, idx[b]) only) and return the same dicts: no cache is
copied per token. Decode attends through the plain masked attention, as the
JAX package does (its cost is the cache read, not the scores).

Dropout draws its masks from an explicit ``torch.Generator`` (CPU) passed to
``forward``: one seed per block is drawn from it, and each block seeds its
own generator on the activations' device, so a rematerialised block draws
the same masks again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mqgan_tpu_torch.nn.conv import Dense
from mqgan_tpu_torch.nn.layers import Embed, LayerNorm, dropout
from mqgan_tpu_torch.ops.flash_attention import causal_attention

Cache = dict  # {"k": (B, S, H, D), "v": (B, S, H, D)}


def rope_angles(positions: torch.Tensor, head_dim: int):
    """cos/sin tables for RoPE: positions (...,) -> (..., head_dim // 2)."""
    half = head_dim // 2
    # a fill, not a copy from the host: a host-to-device copy would wait
    # for the card at every decode step
    freqs = torch.pow(torch.full((), 10000.0, device=positions.device),
                      -torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate (x[..., :half], x[..., half:]) of x (B, T, H, D) by the
    (T, D // 2) angles shared by the batch, or by per-row (B, T, D // 2)
    angles, in fp32; returns x's dtype."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention with RoPE; scores and softmax fp32."""

    def __init__(self, features: int, n_heads: int, flash: bool = False):
        super().__init__()
        assert features % n_heads == 0
        assert (features // n_heads) % 2 == 0, "RoPE needs even head_dim"
        self.features, self.n_heads, self.flash = features, n_heads, flash
        self.wq = Dense(features, features)
        self.wk = Dense(features, features)
        self.wv = Dense(features, features)
        self.wo = Dense(features, features)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_heads, self.features // self.n_heads)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projected heads, q and k rotated to ``positions``: (T,) shared by
        the batch or (B, T) per row."""
        q = self._heads(self.wq(x))
        k = self._heads(self.wk(x))
        v = self._heads(self.wv(x))
        cos, sin = rope_angles(positions, q.shape[-1])
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

    @staticmethod
    def masked_attention(q, k, v, visible) -> torch.Tensor:
        """q (B, Tq, H, D), k/v (B, Tk, H, D), ``visible`` (Tq, Tk) shared or
        (B, Tq, Tk) per row -> (B, Tq, H, D); scores and softmax in fp32."""
        scale = q.shape[-1] ** -0.5
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        visible = visible[None, None] if visible.dim() == 2 else visible[:, None]
        scores = scores.masked_fill(~visible, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)

    def attend(self, q, k, v) -> torch.Tensor:
        """(B, T, H, D) q, k, v -> (B, T, H, D) causal attention."""
        if self.flash:
            return causal_attention(q, k, v, q.shape[-1] ** -0.5)
        t = q.shape[1]
        visible = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        return self.masked_attention(q, k, v, visible)

    def _out(self, out: torch.Tensor, dtype) -> torch.Tensor:
        b, t = out.shape[:2]
        return self.wo(out.reshape(b, t, self.features).to(dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        q, k, v = self._qkv(x, torch.arange(t, device=x.device))
        return self._out(self.attend(q, k, v), x.dtype)

    def prefill(self, x: torch.Tensor, cache: Cache):
        """Full causal pass over a (B, T) prefix that also writes the rotated
        k / raw v of positions [0, T) into the cache."""
        t = x.shape[1]
        q, k, v = self._qkv(x, torch.arange(t, device=x.device))
        visible = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        out = self.masked_attention(q, k, v, visible)
        # an index copy, not a slice assignment: a traced prefill then takes
        # any cache length >= t
        pos = torch.arange(t, device=x.device)
        cache["k"].index_copy_(1, pos, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, pos, v.to(cache["v"].dtype))
        return self._out(out, x.dtype), cache

    def _attend_cache(self, q, k, v, cache: Cache, visible):
        return self.masked_attention(q, cache["k"].to(k.dtype),
                                     cache["v"].to(v.dtype), visible)

    def step(self, x: torch.Tensor, cache: Cache, idx: int):
        """One decode step: x (B, 1, E) at absolute position ``idx``."""
        q, k, v = self._qkv(x, torch.arange(idx, idx + 1, device=x.device))
        cache["k"][:, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, idx] = v[:, 0].to(cache["v"].dtype)
        s = cache["k"].shape[1]
        visible = (torch.arange(s, device=x.device) <= idx)[None, :]
        return self._out(self._attend_cache(q, k, v, cache, visible), x.dtype), cache

    def step_rows(self, x: torch.Tensor, cache: Cache, idx: torch.Tensor):
        """One decode step with per-row absolute positions: x (B, 1, E), idx
        (B,) — row b's token sits at position idx[b], where it is rotated,
        written (in place, that row's slot only) and masked."""
        idx = idx.long()
        q, k, v = self._qkv(x, idx[:, None])
        rows = torch.arange(idx.shape[0], device=x.device)
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        s = cache["k"].shape[1]
        visible = torch.arange(s, device=x.device)[None, None, :] <= idx[:, None, None]
        return self._out(self._attend_cache(q, k, v, cache, visible), x.dtype), cache


class TransformerBlock(nn.Module):
    """Pre-LN block: x + drop(attn(ln1(x))); x + drop(mlp(ln2(x)))."""

    def __init__(self, features: int, n_heads: int, mlp_dim: int,
                 dropout_rate: float, flash: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.ln1 = LayerNorm(features)
        self.attn = CausalSelfAttention(features, n_heads, flash=flash)
        self.ln2 = LayerNorm(features)
        self.fc1 = Dense(features, mlp_dim)
        self.fc2 = Dense(mlp_dim, features)

    def forward(self, x: torch.Tensor, seed: int | None = None) -> torch.Tensor:
        """``seed=None``: deterministic; else the dropout masks' seed."""
        gen = (None if seed is None
               else torch.Generator(device=x.device).manual_seed(seed))
        x = x + dropout(self.attn(self.ln1(x)), self.dropout_rate, gen)
        return x + dropout(self._mlp(x), self.dropout_rate, gen)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))

    def prefill(self, x: torch.Tensor, cache: Cache):
        a, cache = self.attn.prefill(self.ln1(x), cache)
        x = x + a
        return x + self._mlp(x), cache

    def step(self, x: torch.Tensor, cache: Cache, idx: int):
        a, cache = self.attn.step(self.ln1(x), cache, idx)
        x = x + a
        return x + self._mlp(x), cache

    def step_rows(self, x: torch.Tensor, cache: Cache, idx: torch.Tensor):
        a, cache = self.attn.step_rows(self.ln1(x), cache, idx)
        x = x + a
        return x + self._mlp(x), cache


class MusicTransformer(nn.Module):
    """Same call signature and conditioning as ``MusicLSTM``."""

    def __init__(self, vocab_size: int, num_genres: int, emb_dim: int = 512,
                 n_layers: int = 6, n_heads: int = 8, mlp_ratio: int = 4,
                 pad_id: int = 0, dropout: float = 0.1, remat: bool = False,
                 flash: bool = False, dtype: torch.dtype | None = None):
        super().__init__()
        self.vocab_size, self.num_genres, self.emb_dim = vocab_size, num_genres, emb_dim
        self.n_layers, self.n_heads, self.mlp_ratio = n_layers, n_heads, mlp_ratio
        self.pad_id, self.dropout, self.remat, self.flash = pad_id, dropout, remat, flash
        self.dtype = dtype
        self.tok_emb = Embed(vocab_size, emb_dim, dtype)
        self.genre_emb = Embed(num_genres, emb_dim, dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(emb_dim, n_heads, mlp_ratio * emb_dim, dropout,
                             flash=flash)
            for _ in range(n_layers))
        self.ln_f = LayerNorm(emb_dim)
        self.proj = Dense(emb_dim, vocab_size)

    def embed(self, tokens: torch.Tensor, genre_ids: torch.Tensor):
        """Token embeddings (pad positions zeroed) plus the genre
        embedding: (B, T) -> (B, T, E)."""
        tok_e = self.tok_emb(tokens)
        # padding_idx semantics: pad positions contribute zero vectors
        tok_e = torch.where((tokens == self.pad_id)[..., None],
                            torch.zeros((), dtype=tok_e.dtype, device=tok_e.device),
                            tok_e)
        return tok_e + self.genre_emb(genre_ids)[:, None, :]

    def forward(self, tokens: torch.Tensor, genre_ids: torch.Tensor,
                lengths: torch.Tensor | None = None, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens (B, L), genre_ids (B,) -> logits (B, L, V) in the compute
        dtype. ``lengths`` is unused (the masked CE ignores pads); dropout
        runs when ``deterministic`` is False, from ``generator`` (CPU)."""
        del lengths
        x = self.embed(tokens, genre_ids)
        seeds = [None] * self.n_layers
        if not deterministic and self.dropout > 0.0:
            if generator is None:
                raise ValueError("deterministic=False needs a generator")
            seeds = torch.randint(0, 2**62, (self.n_layers,),
                                  generator=generator).tolist()
        for blk, seed in zip(self.blocks, seeds):
            if self.remat:
                x = checkpoint(blk, x, seed, use_reentrant=False)
            else:
                x = blk(x, seed)
        return self.head(x)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The final norm and the vocab projection: hiddens -> logits."""
        return self.proj(self.ln_f(h))

    @staticmethod
    def last_hidden(x: torch.Tensor, last_idx: torch.Tensor | None = None):
        """(B, E) hiddens of x (B, T, E) at the last position, or per row at
        ``last_idx`` (B,)."""
        if last_idx is None:
            return x[:, -1]
        return x[torch.arange(x.shape[0], device=x.device), last_idx.long()]

    # -- decode path ------------------------------------------------------

    def prefill(self, tokens: torch.Tensor, genre_ids: torch.Tensor,
                caches: list, last_idx: torch.Tensor | None = None):
        """Batched prefix pass filling every layer's KV cache at positions
        [0, T). Returns (logits (B, V), caches): at the last position, or per
        row at ``last_idx`` (B,) when given (row b's prefix ends at
        last_idx[b]; later positions are right-padding that the causal mask
        keeps from every valid query)."""
        x = self.embed(tokens, genre_ids)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.prefill(x, cache)
        return self.head(self.last_hidden(x, last_idx)), caches

    def step(self, token: torch.Tensor, genre_ids: torch.Tensor, caches: list,
             idx: int):
        """One decode step: token (B,) at absolute position ``idx``. Returns
        (logits (B, V), caches)."""
        x = self.embed(token[:, None], genre_ids)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.step(x, cache, idx)
        return self.head(x[:, 0]), caches

    def step_rows(self, token: torch.Tensor, genre_ids: torch.Tensor,
                  caches: list, idx: torch.Tensor):
        """``step`` with per-row absolute positions idx (B,): the
        mixed-prompt-length decode path. Equals ``step`` when every row
        shares its position."""
        x = self.embed(token[:, None], genre_ids)
        for blk, cache in zip(self.blocks, caches):
            x, _ = blk.step_rows(x, cache, idx)
        return self.head(x[:, 0]), caches


def init_cache(model: MusicTransformer, batch: int, max_total: int,
               dtype: torch.dtype = torch.float32, device=None) -> list:
    """Per-layer KV cache covering absolute positions [0, max_total)."""
    shape = (batch, max_total, model.n_heads, model.emb_dim // model.n_heads)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(model.n_layers)]
