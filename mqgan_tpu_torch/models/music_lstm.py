"""Genre-conditioned next-token LSTM and the masked cross-entropy (counterpart
of ``mqgan_tpu/models/music_lstm.py``).

Token embedding (pad positions zeroed) + genre embedding broadcast-added,
``lstm_layers`` LSTM layers with the input projection hoisted out of the
recurrence (one (B, L, E) @ (E, 4H) product for the whole sequence; the loop
over time keeps only h @ W_h), dropout, vocab projection. Right-padded
batches need no packing: padded steps are excluded from the loss.

Parameter names are the JAX tree's: ``lstm_{i}`` layers whose gate Denses
are ``ii/ig/if/io`` (input kernels, no bias) and ``hi/hg/hf/ho`` (hidden
kernels with the biases), gate order i, g, f, o, so ``utils/params.py``
bridges a ``MusicLSTM.init`` tree one to one.
"""

from __future__ import annotations

import torch
from torch import nn

from mqgan_tpu_torch.nn.conv import Dense
from mqgan_tpu_torch.nn.layers import Embed, dropout

GATES = ("i", "g", "f", "o")


class HoistedLSTMLayer(nn.Module):
    """One LSTM layer (flax LSTMCell equations):
        i = sigmoid(x W_ii + h W_hi + b_hi)    g = tanh(x W_ig + h W_hg + b_hg)
        f = sigmoid(x W_if + h W_hf + b_hf)    o = sigmoid(x W_io + h W_ho + b_ho)
        c' = f c + i g ;  h' = o tanh(c')
    computed in ``dtype`` (None: the input's)."""

    def __init__(self, in_features: int, features: int, dtype=None):
        super().__init__()
        self.features, self.dtype = features, dtype
        for g in GATES:  # "if" is a keyword: registered by name
            self.add_module(f"i{g}", Dense(in_features, features, bias=False))
        for g in GATES:
            self.add_module(f"h{g}", Dense(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, E) -> (B, L, H)
        cdt = self.dtype or x.dtype
        mods = self._modules
        w_in = torch.cat([mods[f"i{g}"].weight.t() for g in GATES], dim=1).to(cdt)
        w_hid = torch.cat([mods[f"h{g}"].weight.t() for g in GATES], dim=1).to(cdt)
        bias = torch.cat([mods[f"h{g}"].bias for g in GATES]).to(cdt)
        zx = x.to(cdt) @ w_in + bias  # (B, L, 4H), the whole sequence at once
        b = x.shape[0]
        c = torch.zeros((b, self.features), dtype=cdt, device=x.device)
        h = torch.zeros_like(c)
        ys = []
        for t in range(x.shape[1]):
            zi, zg, zf, zo = torch.addmm(zx[:, t], h, w_hid).chunk(4, dim=-1)
            c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
            h = torch.sigmoid(zo) * torch.tanh(c)
            ys.append(h)
        return torch.stack(ys, dim=1)


class MusicLSTM(nn.Module):
    def __init__(self, vocab_size: int, num_genres: int, emb_dim: int = 512,
                 lstm_hid: int = 1024, lstm_layers: int = 2, pad_id: int = 0,
                 dropout: float = 0.1, dtype: torch.dtype | None = None):
        super().__init__()
        self.vocab_size, self.num_genres, self.emb_dim = vocab_size, num_genres, emb_dim
        self.lstm_hid, self.lstm_layers, self.pad_id = lstm_hid, lstm_layers, pad_id
        self.dropout, self.dtype = dropout, dtype
        self.tok_emb = Embed(vocab_size, emb_dim, dtype)
        self.genre_emb = Embed(num_genres, emb_dim, dtype)
        for i in range(lstm_layers):
            self.add_module(f"lstm_{i}", HoistedLSTMLayer(
                emb_dim if i == 0 else lstm_hid, lstm_hid, dtype))
        self.proj = Dense(lstm_hid, vocab_size)

    def forward(self, tokens: torch.Tensor, genre_ids: torch.Tensor,
                lengths: torch.Tensor | None = None, deterministic: bool = True,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens (B, L), genre_ids (B,) -> logits (B, L, V); ``lengths`` is
        unused; dropout (before the projection) runs when ``deterministic``
        is False, from ``generator`` (CPU)."""
        del lengths
        tok_e = self.tok_emb(tokens)
        tok_e = torch.where((tokens == self.pad_id)[..., None],
                            torch.zeros((), dtype=tok_e.dtype, device=tok_e.device),
                            tok_e)
        x = tok_e + self.genre_emb(genre_ids)[:, None, :]
        for i in range(self.lstm_layers):
            x = self._modules[f"lstm_{i}"](x)
        gen = None
        if not deterministic and self.dropout > 0.0:
            if generator is None:
                raise ValueError("deterministic=False needs a generator")
            seed = int(torch.randint(0, 2**62, (1,), generator=generator))
            gen = torch.Generator(device=x.device).manual_seed(seed)
        return self.proj(dropout(x, self.dropout, gen))


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   pad_id: int = 0):
    """Cross-entropy in fp32 ignoring ``pad_id`` targets. Returns
    (mean over valid targets, number of valid targets), both 0-d fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    valid = (targets != pad_id).float()
    n = torch.clamp(valid.sum(), min=1.0)
    return (nll * valid).sum() / n, valid.sum()
