"""Genre-conditioned causal Transformer token LM, training path (counterpart
of ``mqgan_tpu/models/token_transformer.py``: ``__call__`` and ``_embed``;
the decode methods and the KV cache belong to the LM serving slice).

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


def rope_angles(positions: torch.Tensor, head_dim: int):
    """cos/sin tables for RoPE: positions (...,) -> (..., head_dim // 2)."""
    half = head_dim // 2
    freqs = torch.pow(torch.tensor(10000.0, device=positions.device),
                      -torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate (x[..., :half], x[..., half:]) of x (B, T, H, D) by the
    (T, D // 2) angles, in fp32; returns x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
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

    def attend(self, q, k, v) -> torch.Tensor:
        """(B, T, H, D) q, k, v -> (B, T, H, D) causal attention."""
        scale = q.shape[-1] ** -0.5
        if self.flash:
            return causal_attention(q, k, v, scale)
        t = q.shape[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        visible = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~visible, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        q = self._heads(self.wq(x))
        k = self._heads(self.wk(x))
        v = self._heads(self.wv(x))
        cos, sin = rope_angles(torch.arange(t, device=x.device), q.shape[-1])
        out = self.attend(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
        return self.wo(out.reshape(b, t, self.features).to(x.dtype))


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
        h = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))
        return x + dropout(h, self.dropout_rate, gen)


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

    def _embed(self, tokens: torch.Tensor, genre_ids: torch.Tensor):
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
        x = self._embed(tokens, genre_ids)
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
        return self.proj(self.ln_f(x))
