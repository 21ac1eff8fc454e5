"""Genre-conditioned next-token LSTM and the masked cross-entropy (counterpart
of ``mqgan_tpu/models/music_lstm.py``).

Token embedding (pad positions zeroed) + genre embedding broadcast-added,
``lstm_layers`` LSTM layers with the input projection hoisted out of the
recurrence (one (B, L, E) @ (E, 4H) product for the whole sequence; the loop
over time keeps only h @ W_h), dropout, vocab projection. Right-padded
batches need no packing: padded steps are excluded from the loss.

``MusicLSTM.step`` is one step of the recurrence for decoding (the
counterpart of ``mqgan_tpu/models/lm_sampling.py`` ``_step_logits``: flax's
``OptimizedLSTMCell`` on the same weights, zero initial carries).

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

    def gate_weights(self, cdt):
        """(W_in (E, 4H), W_hid (H, 4H), bias (4H,)) in gate order i, g, f, o."""
        mods = self._modules
        w_in = torch.cat([mods[f"i{g}"].weight.t() for g in GATES], dim=1).to(cdt)
        w_hid = torch.cat([mods[f"h{g}"].weight.t() for g in GATES], dim=1).to(cdt)
        bias = torch.cat([mods[f"h{g}"].bias for g in GATES]).to(cdt)
        return w_in, w_hid, bias

    @staticmethod
    def _cell(z: torch.Tensor, c: torch.Tensor):
        zi, zg, zf, zo = z.chunk(4, dim=-1)
        c = torch.sigmoid(zf) * c + torch.sigmoid(zi) * torch.tanh(zg)
        return c, torch.sigmoid(zo) * torch.tanh(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, E) -> (B, L, H)
        cdt = self.dtype or x.dtype
        return self.scan(x.to(cdt), self.gate_weights(torch.float32))

    @staticmethod
    def scan(x: torch.Tensor, weights) -> torch.Tensor:
        """The layer over a whole (B, L, E) sequence from zero carries, in
        x's dtype, with the fp32 ``weights`` = gate_weights(torch.float32):
        the input projection hoisted, the loop over time keeping h @ W_hid.
        The loop uses W_hid detached; its gradient is one product over the
        whole sequence (``_HiddenWeightGrad``)."""
        w_in, w_hid, bias = weights
        cdt = x.dtype
        zx = x @ w_in.to(cdt) + bias.to(cdt)  # (B, L, 4H), the whole sequence at once
        states: list = []
        if torch.is_grad_enabled() and w_hid.requires_grad:
            zx = _HiddenWeightGrad.apply(zx, w_hid, states)
        w_h = w_hid.detach().to(cdt)
        c = torch.zeros((x.shape[0], w_hid.shape[0]), dtype=cdt, device=x.device)
        h = torch.zeros_like(c)
        ys = []
        for t in range(x.shape[1]):
            c, h = HoistedLSTMLayer._cell(torch.addmm(zx[:, t], h, w_h), c)
            ys.append(h)
        ys = torch.stack(ys, dim=1)
        states.append((ys.detach(), ys._version))
        return ys

    @staticmethod
    def step(x: torch.Tensor, carry, weights):
        """One step: x (B, E), carry (c, h), ``weights`` = gate_weights(...)
        -> (carry, h)."""
        w_in, w_hid, bias = weights
        c, h = carry
        c, h = HoistedLSTMLayer._cell(x @ w_in + h @ w_hid + bias, c)
        return (c, h), h


class _HiddenWeightGrad(torch.autograd.Function):
    """The identity on a scan's hoisted input products zx (B, L, 4H) whose
    backward also gives W_hid its gradient. z_t = zx_t + h_{t-1} W_hid, so
    the gradient reaching zx is dZ = dL/dz for every step at once, and
    dL/dW_hid = sum_t h_{t-1}^T dz_t = H_prev^T dZ: ONE product over all
    B * L rows, which accumulates in fp32 on tensor cores and rounds once,
    in place of L products of K = B each summed into an (H, 4H) buffer in
    the compute dtype (in bf16 both slow and inexact). ``states`` is the
    list to which the scan appends its detached (B, L, H) outputs and
    their version, read here: they must not change in place before the
    backward."""

    @staticmethod
    def forward(ctx, zx, w_hid, states):
        ctx.states, ctx.w_dtype = states, w_hid.dtype
        return zx.view_as(zx)

    @staticmethod
    def backward(ctx, dz):
        ((ys, version),) = ctx.states
        if ys._version != version:
            raise RuntimeError("an LSTM scan's output was modified in place "
                               "before its backward")
        h_prev = torch.nn.functional.pad(ys[:, :-1], (0, 0, 1, 0))  # h_{-1} = 0
        dw = h_prev.flatten(0, 1).t() @ dz.flatten(0, 1).to(h_prev.dtype)
        return dz, dw.to(ctx.w_dtype), None


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
        x = self.embed(tokens, genre_ids)
        for i in range(self.lstm_layers):
            x = self._modules[f"lstm_{i}"](x)
        return self.head(x, deterministic, generator)

    def embed(self, tokens: torch.Tensor, genre_ids: torch.Tensor) -> torch.Tensor:
        """The stack's input: token embeddings (pad positions zeroed) plus
        the genre embedding."""
        tok_e = self.tok_emb(tokens)
        tok_e = torch.where((tokens == self.pad_id)[..., None],
                            torch.zeros((), dtype=tok_e.dtype, device=tok_e.device),
                            tok_e)
        return tok_e + self.genre_emb(genre_ids)[:, None, :]

    def head(self, x: torch.Tensor, deterministic: bool = True,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Dropout (unless ``deterministic``; a seed drawn from the CPU
        ``generator``) and the vocab projection of the stack's output."""
        gen = None
        if not deterministic and self.dropout > 0.0:
            if generator is None:
                raise ValueError("deterministic=False needs a generator")
            seed = int(torch.randint(0, 2**62, (1,), generator=generator))
            gen = torch.Generator(device=x.device).manual_seed(seed)
        return self.proj(dropout(x, self.dropout, gen))

    def zero_carries(self, batch: int, device=None) -> list:
        """The initial (c, h) of every layer: zeros, fp32."""
        z = torch.zeros((batch, self.lstm_hid), device=device)
        return [(z, z) for _ in range(self.lstm_layers)]

    def genre_vectors(self, genre_ids: torch.Tensor) -> torch.Tensor:
        """(B,) genre ids -> (B, E) fp32 genre embeddings."""
        return self.genre_emb.weight[genre_ids].float()

    def step_weights(self) -> tuple:
        """The fp32 weights ``step`` reads, gathered once per decode: each
        layer's (W_in, W_hid, bias) and the projection's (W (H, V), b), all
        contiguous (a traced step holds them as buffers)."""
        layers = [self._modules[f"lstm_{i}"].gate_weights(torch.float32)
                  for i in range(self.lstm_layers)]
        return layers, (self.proj.weight.t().float().contiguous(),
                        self.proj.bias.float())

    def step(self, carries: list, token: torch.Tensor, genre_vec: torch.Tensor,
             weights: tuple | None = None):
        """One decode step in fp32, whatever the compute dtype (the JAX
        sampler steps flax cells on the fp32 weights): token (B,) ->
        (carries, logits (B, V)). ``weights``: ``step_weights()``, made
        here when not given."""
        layers, (w_out, b_out) = weights or self.step_weights()
        x = self.tok_emb.weight[token].float()
        x = torch.where((token == self.pad_id)[:, None], torch.zeros_like(x), x)
        x = x + genre_vec
        new = []
        for carry, w in zip(carries, layers):
            carry, x = HoistedLSTMLayer.step(x, carry, w)
            new.append(carry)
        return new, x @ w_out + b_out


def masked_ce_loss(logits: torch.Tensor, targets: torch.Tensor,
                   pad_id: int = 0):
    """Cross-entropy in fp32 ignoring ``pad_id`` targets. Returns
    (mean over valid targets, number of valid targets), both 0-d fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    valid = (targets != pad_id).float()
    n = torch.clamp(valid.sum(), min=1.0)
    return (nll * valid).sum() / n, valid.sum()
