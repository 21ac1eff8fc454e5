"""The token-LM artifact and its runtime (counterpart of
``mqgan_tpu/deploy/export_lm.py``).

The JAX package serializes its served samplers to StableHLO per (prompt
bucket P, generation bucket L) pair and a scoring program per length
bucket. This package traces the served samplers' pieces
(``models/lm_sampling.py``) with ``torch.export``, each once, every size
that varies symbolic (batch ``b``, prompt bucket ``p``, cache length ``s``,
token length ``t``):

* transformer: ``prefill.pt2`` (b, p, s), ``step.pt2`` (b, s) and
  ``score.pt2`` (b, t >= 3: the score of a bucket below 3 is not exported);
* LSTM: ``step.pt2`` (b, p), run P + L times, and ``score_step.pt2`` (b),
  run t - 1 times: its training forward loops over time in Python, which a
  trace unrolls (~50,000 nodes at t = 2,048).

One set of programs thus serves every bucket pair. The manifest,
``lm_manifest.json``, keeps the JAX manifest's keys (``arch_config``,
``arch``, vocab, genres, ``pad_id``, ``bos_id``, the three bucket lists,
``kv_dtype`` and ``lm_args`` where given), names each pair's and each score
bucket's programs in ``files`` (``{"generate": {"P:L": {"prefill": ...,
"step": ...}}, "score": {"T": ...}}``) and their platforms in ``platforms``:
``cpu`` always, ``cuda`` for an export on a card, which traces there and
writes the programs moved to the CPU beside them (``deploy/export.py``
does the same). ``weights.pt`` keeps the model's fp32 state_dict. A program
holds the parameters it reads; the KV caches (LSTM carries) are inputs that
it writes in place (``index_copy_`` / ``index_put_`` / ``copy_`` on the
inputs; no whole cache is copied).

``ExportedMusicLM`` serves its platform's programs as the JAX runtime serves
its own: the smallest covering buckets, padding, per-row seeds and prompt
lengths, a causal trim; ``score`` pads with ``pad_id`` to its bucket. On the
CPU a dispatch calls the programs eagerly in the served samplers' loop. On
a card it replays CUDA graphs, a pair per (P, L, rows, device), rows
repeat-padded to a power of two: a start graph (the state reset and, for
the transformer, the prefill) and a step graph replayed L - 1 times (P + L
for the LSTM), captured at the shape's first dispatch from buffers the
graphs own. The step counter is a device tensor that the step graph
advances, so the loop makes no host synchronisation, and the tokens come
back in one copy. A device's caches (carries) are one buffer each, sized
for the largest (rows, cache length) met (``reserve`` sizes them ahead):
graphs of smaller shapes use their leading part, which is safe since a lock
runs one dispatch at a time; growing them drops the device's graphs, which
are captured again at their next use. A row's tokens equal the in-process
served sampler's at the same padded bucket and seed.

``load_lm_from_run`` reads a run dir of this package's trainer
(``train/lstm_trainer.py``).

CLI:  python -m mqgan_tpu_torch.deploy.export_lm --lm_run RUN --output EXP
      [--gen_buckets ...] [--prompt_buckets ...] [--score_buckets ...]
      [--kv_bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import threading
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch
from torch.export import Dim

from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.deploy.export import (MAX_ROWS, TRACE_ROWS, export_platforms,
                                           module_tensors, save_program, traced)
from mqgan_tpu_torch.deploy.runtime import (CAPTURE_LOCK, graph_rows, load_program,
                                            program_path)
from mqgan_tpu_torch.models import lm_sampling
from mqgan_tpu_torch.models.token_lm import build_token_lm
from mqgan_tpu_torch.parallel.mesh import repeat_pad_rows

LM_MANIFEST_NAME = "lm_manifest.json"
WEIGHTS_NAME = "weights.pt"
DEFAULT_GEN_BUCKETS = (128, 256, 512, 1024)
DEFAULT_PROMPT_BUCKETS = (1, 128)  # P=1 + prompt_len=0 serves unconditional
DEFAULT_SCORE_BUCKETS = (256, 1024)
KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
MAX_LEN = 1 << 20
# each arch's pieces: those a bucket pair runs, and the score's
PIECES = {"transformer": (("prefill", "step"), "score"),
          "lstm": (("step",), "score_step")}
# the inputs of a dispatch that the host gives (the rest is the programs'
# state: the caches or carries, the token fed, the step counter, the tokens)
HOST_INPUTS = ("prompt", "prompt_lens", "genre_ids", "seed_keys", "vocab_keys",
               "temperature", "top_k", "top_p", "vocab_mask")
_CONTROLS = ("temperature", "top_k", "top_p", "vocab_mask")


# --- the traced programs ---------------------------------------------------
#
# A transformer piece is three programs run in turn: its embedding, its
# layer (called once per layer with that layer's weights from weights.pt,
# ``torch.func.functional_call``) and its head; each calls the model's own
# methods, so that the programs run the served sampler's operations in its
# order. Tracing with symbolic sizes costs milliseconds a node, and a whole
# flagship step is ~860 nodes where a layer is ~125: one trace serves every
# layer. An LSTM piece is one program.

def _only(model, *names):
    """A shallow copy of ``model`` holding only its submodules ``names``
    (the tensors shared): a program holds the parameters it reads."""
    model = copy.copy(model)
    model._modules = {k: v for k, v in model._modules.items() if k in names}
    return model


def _dims():
    """The symbolic sizes: batch, cache length, a sequence of 2 or more (the
    prefix, the score's inputs) and the prompt bucket."""
    return (Dim("b", min=1, max=MAX_ROWS), Dim("s", min=2, max=MAX_LEN),
            Dim("t", min=2, max=MAX_LEN), Dim("p", min=1, max=MAX_LEN))


class _Program(torch.nn.Module):
    """A traced program's root. ``examples(cfg, kv_dtype, device)`` gives
    its example inputs (TRACE_ROWS rows) and their dynamic shapes."""

    def _ex(self, cfg, device):
        rows, v = TRACE_ROWS, cfg["vocab_size"]
        heads = cfg.get("n_heads", 1)
        dt = getattr(self, "dtype", None) or torch.float32

        def long(*shape):
            return torch.zeros(shape, dtype=torch.long, device=device)

        return SimpleNamespace(
            rows=rows, long=long,
            x=lambda t: torch.zeros((rows, t, cfg["emb_dim"]), dtype=dt,
                                    device=device),
            cache=lambda kv: torch.zeros((rows, 6, heads, cfg["emb_dim"] // heads),
                                         dtype=kv, device=device),
            controls=(torch.ones((), device=device), long(),
                      torch.zeros((), device=device),
                      torch.ones((v,), dtype=torch.bool, device=device)),
            vocab=long(v))


def _draw(seed_keys, vocab_keys, logits, steps, controls):
    chain = lm_sampling.KeyChain.of(seed_keys, vocab_keys)
    return lm_sampling.filtered_draw(chain, logits, steps, *controls)


class _PrefillEmbed(_Program):
    def __init__(self, model, bos_id):
        super().__init__()
        self.model, self.bos_id = _only(model, "tok_emb", "genre_emb"), int(bos_id)

    def forward(self, prompt, genre_ids):
        return self.model.embed(lm_sampling.prefix_tokens(prompt, self.bos_id),
                                genre_ids)

    def examples(self, cfg, kv, device):
        e, (b, _, _, p) = self._ex(cfg, device), _dims()
        return (e.long(e.rows, 3), e.long(e.rows)), ({0: b, 1: p}, {0: b})


class _PrefillBlock(_Program):
    def __init__(self, block, dtype):
        super().__init__()
        self.block, self.dtype = block, dtype

    def forward(self, x, k, v):
        return self.block.prefill(x, {"k": k, "v": v})[0]

    def examples(self, cfg, kv, device):
        e, (b, s, t, _) = self._ex(cfg, device), _dims()
        return ((e.x(4), e.cache(kv), e.cache(kv)),
                ({0: b, 1: t}, {0: b, 1: s}, {0: b, 1: s}))


class _PrefillHead(_Program):
    def __init__(self, model):
        super().__init__()
        self.model, self.dtype = _only(model, "ln_f", "proj"), model.dtype

    def forward(self, x, prompt_lens, seed_keys, vocab_keys, temperature, top_k,
                top_p, vocab_mask):
        logits = self.model.head(self.model.last_hidden(x, prompt_lens))
        return _draw(seed_keys, vocab_keys, logits, 0,
                     (temperature, top_k, top_p, vocab_mask))

    def examples(self, cfg, kv, device):
        e, (b, _, t, _) = self._ex(cfg, device), _dims()
        return ((e.x(4), e.long(e.rows), e.long(e.rows), e.vocab, *e.controls),
                ({0: b, 1: t}, {0: b}, {0: b}) + (None,) * 5)


class _StepEmbed(_Program):
    def __init__(self, model):
        super().__init__()
        self.model = _only(model, "tok_emb", "genre_emb")

    def forward(self, token, t, prompt_lens, genre_ids):
        """-> (the hidden (B, 1, E), each row's position prompt_lens + t)."""
        return self.model.embed(token[:, None], genre_ids), prompt_lens + t

    def examples(self, cfg, kv, device):
        e, (b, _, _, _) = self._ex(cfg, device), _dims()
        return ((e.long(e.rows), e.long(), e.long(e.rows), e.long(e.rows)),
                ({0: b}, None, {0: b}, {0: b}))


class _StepBlock(_Program):
    def __init__(self, block, dtype):
        super().__init__()
        self.block, self.dtype = block, dtype

    def forward(self, x, idx, k, v):
        return self.block.step_rows(x, {"k": k, "v": v}, idx)[0]

    def examples(self, cfg, kv, device):
        e, (b, s, _, _) = self._ex(cfg, device), _dims()
        return ((e.x(1), e.long(e.rows), e.cache(kv), e.cache(kv)),
                ({0: b}, {0: b}, {0: b, 1: s}, {0: b, 1: s}))


class _StepHead(_Program):
    def __init__(self, model):
        super().__init__()
        self.model, self.dtype = _only(model, "ln_f", "proj"), model.dtype

    def forward(self, x, t, seed_keys, vocab_keys, temperature, top_k, top_p,
                vocab_mask):
        return _draw(seed_keys, vocab_keys, self.model.head(x[:, 0]), t,
                     (temperature, top_k, top_p, vocab_mask))

    def examples(self, cfg, kv, device):
        e, (b, _, _, _) = self._ex(cfg, device), _dims()
        return ((e.x(1), e.long(), e.long(e.rows), e.vocab, *e.controls),
                ({0: b}, None, {0: b}) + (None,) * 5)


class _ScoreEmbed(_Program):
    def __init__(self, model):
        super().__init__()
        self.model = _only(model, "tok_emb", "genre_emb")

    def forward(self, tokens, genre_ids):
        return self.model.embed(tokens[:, :-1], genre_ids)

    def examples(self, cfg, kv, device):
        e, (b, _, t, _) = self._ex(cfg, device), _dims()
        return (e.long(e.rows, 5), e.long(e.rows)), ({0: b, 1: t + 1}, {0: b})


class _ScoreBlock(_Program):
    def __init__(self, block, dtype):
        super().__init__()
        self.block, self.dtype = block, dtype

    def forward(self, x):
        return self.block(x)

    def examples(self, cfg, kv, device):
        e, (b, _, t, _) = self._ex(cfg, device), _dims()
        return (e.x(4),), ({0: b, 1: t},)


class _ScoreHead(_Program):
    def __init__(self, model):
        super().__init__()
        self.model, self.dtype = _only(model, "ln_f", "proj"), model.dtype

    def forward(self, x, tokens):
        """-> per-row (nll_sum, n_valid), ``score_tokens``'s."""
        nll, valid = lm_sampling.masked_nll(self.model.head(x), tokens[:, 1:],
                                            self.model.pad_id)
        return nll.sum(dim=1), valid.sum(dim=1)

    def examples(self, cfg, kv, device):
        e, (b, _, t, _) = self._ex(cfg, device), _dims()
        return (e.x(4), e.long(e.rows, 5)), ({0: b, 1: t}, {0: b, 1: t + 1})


class _LSTMProgram(_Program):
    """An LSTM piece's root: the embeddings and the fp32 step weights
    (``MusicLSTM.step_weights``) as buffers; its layers stay out (their
    gate modules are named after keywords)."""

    def __init__(self, model):
        super().__init__()
        layers, (w_out, b_out) = model.step_weights()
        self.model = _only(model, "tok_emb", "genre_emb")
        for i, layer in enumerate(layers):
            for name, w in zip(("w_in", "w_hid", "bias"), layer):
                self.register_buffer(f"{name}_{i}", w.detach())
        self.register_buffer("w_out", w_out.detach())
        self.register_buffer("b_out", b_out.detach())
        self.n_layers = len(layers)

    def step_weights(self) -> tuple:
        return ([tuple(getattr(self, f"{n}_{i}") for n in ("w_in", "w_hid", "bias"))
                 for i in range(self.n_layers)], (self.w_out, self.b_out))

    def _state(self, cfg, device):
        shape = (TRACE_ROWS, cfg["lstm_hid"])
        return [torch.zeros(shape, device=device) for _ in range(2 * self.n_layers)]

    @staticmethod
    def _carries(state: list) -> list:
        return list(zip(state[::2], state[1::2]))

    @staticmethod
    def _write(state: list, carries: list) -> None:
        """The new (c, h) of every layer copied into the state inputs."""
        for x, new in zip(state, (x for pair in carries for x in pair)):
            x.copy_(new)


class _LSTMStep(_LSTMProgram):
    def forward(self, token, t, prompt, prompt_lens, genre_ids, seed_keys,
                vocab_keys, temperature, top_k, top_p, vocab_mask, state):
        carries, drawn, fed = lm_sampling.lstm_step(
            self.model, self.step_weights(), token, t,
            lm_sampling.prompt_column(prompt, t), prompt_lens,
            self.model.genre_vectors(genre_ids), seed_keys, vocab_keys, temperature,
            top_k, top_p, vocab_mask, self._carries(state))
        self._write(state, carries)
        return drawn, fed

    def examples(self, cfg, kv, device):
        e, (b, _, _, p) = self._ex(cfg, device), _dims()
        state = self._state(cfg, device)
        row = e.long  # a tensor per input: export binds aliased inputs as one
        return ((row(e.rows), e.long(), e.long(e.rows, 3), row(e.rows), row(e.rows),
                 row(e.rows), e.vocab, *e.controls, state),
                ({0: b}, None, {0: b, 1: p}, {0: b}, {0: b}, {0: b}) + (None,) * 5
                + ([{0: b}] * len(state),))


class _LSTMScoreStep(_LSTMProgram):
    def forward(self, token, target, genre_ids, state):
        carries, scored = lm_sampling.lstm_score_step(
            self.model, self.step_weights(), token, target, genre_ids,
            self._carries(state))
        self._write(state, carries)
        return scored

    def examples(self, cfg, kv, device):
        e, (b, _, _, _) = self._ex(cfg, device), _dims()
        state = self._state(cfg, device)
        return ((e.long(e.rows), e.long(e.rows), e.long(e.rows), state),
                ({0: b},) * 3 + ([{0: b}] * len(state),))


def programs(model, piece: str, bos_id: int = 1) -> list:
    """(file name, root) of each program of a piece, in the order a
    dispatch runs them (the layer's traced on layer 0)."""
    from mqgan_tpu_torch.models.token_lm import lm_arch

    if lm_arch(model) == "lstm":
        return [(f"{piece}.pt2", {"step": _LSTMStep,
                                  "score_step": _LSTMScoreStep}[piece](model))]
    embed = {"prefill": lambda: _PrefillEmbed(model, bos_id),
             "step": lambda: _StepEmbed(model), "score": lambda: _ScoreEmbed(model)}
    block = {"prefill": _PrefillBlock, "step": _StepBlock, "score": _ScoreBlock}[piece]
    head = {"prefill": _PrefillHead, "step": _StepHead, "score": _ScoreHead}[piece]
    return [(f"{piece}_embed.pt2", embed[piece]()),
            (f"{piece}_block.pt2", block(model.blocks[0], model.dtype)),
            (f"{piece}_head.pt2", head(model))]


def state_shapes(arch_cfg: dict, rows: int, cache_len: int, kv_dtype) -> list:
    """(shape, dtype) of each state tensor a dispatch's programs write: the
    transformer's k and v caches of every layer, (rows, cache_len, heads,
    head_dim) in ``kv_dtype``; the LSTM's c and h of every layer, (rows,
    hidden) fp32."""
    if arch_cfg["arch"] == "transformer":
        heads = arch_cfg["n_heads"]
        shape = (rows, cache_len, heads, arch_cfg["emb_dim"] // heads)
        return [(shape, kv_dtype)] * (2 * arch_cfg["n_layers"])
    return [((rows, arch_cfg["lstm_hid"]), torch.float32)] * (2 * arch_cfg["lstm_layers"])


def trace_program(root: _Program, arch_cfg: dict, kv_dtype=torch.float32):
    """``torch.export`` of ``root`` on its tensors' device, those tensors
    inside (``deploy/export.py`` ``traced``: a later export of the same
    architecture in the process reuses the trace)."""
    dev = next(iter(module_tensors(root).values())).device
    key = (type(root).__name__, str(dev), json.dumps(arch_cfg, sort_keys=True),
           kv_dtype if isinstance(root, (_PrefillBlock, _StepBlock)) else None,
           getattr(root, "bos_id", None))
    return traced(root, key, lambda: root.examples(arch_cfg, kv_dtype, dev))


def load_lm_from_run(lm_run: str, device=None):
    """(model, lm_args) from a run dir of this package's trainer
    (``train/lstm_trainer.py``: best.json and the ``.pt`` state_dict it
    names). ``args["arch"]`` picks the model through ``build_token_lm``
    with the training-only knobs dropped; the model is put on ``device``
    (None: CUDA) in eval mode."""
    with open(os.path.join(lm_run, "best.json")) as f:
        best = json.load(f)
    path = best["path"]
    if os.path.isdir(path) or not path.endswith(".pt"):
        raise ValueError(
            f"{path}: an orbax checkpoint of the JAX trainer; convert it with "
            f"tools/jax_generator_to_npz.py and warm-start "
            f"mqgan_tpu_torch.train.lstm_trainer --pretrained from the .npz")
    args = best["args"]
    model = build_token_lm(args, dropout=0.0, for_inference=True)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(resolve_device(device)).eval(), args


def export_music_lm(model, out_dir: str, *,
                    gen_buckets: Sequence[int] = DEFAULT_GEN_BUCKETS,
                    prompt_buckets: Sequence[int] = DEFAULT_PROMPT_BUCKETS,
                    score_buckets: Sequence[int] = DEFAULT_SCORE_BUCKETS,
                    bos_id: int = 1, lm_args: dict | None = None,
                    verify: bool = True, kv_dtype: str | None = None,
                    device=None) -> str:
    """Write the artifact of a token LM (either arch): the programs of the
    CPU and, when ``device`` (None: the model's own) is a card, of the
    card. ``kv_dtype`` (transformer only, "bfloat16" or "float32"): the
    KV-cache dtype of its generation programs, recorded in the manifest.
    ``verify`` reloads it on ``device`` and runs ``verify_lm_export``."""
    from mqgan_tpu_torch.models.token_lm import arch_config

    cfg = arch_config(model)
    if kv_dtype is not None:
        if cfg["arch"] != "transformer":
            raise ValueError("kv_dtype applies to the transformer arch only "
                             "(the LSTM carries no KV cache)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {sorted(KV_DTYPES)}")
    gen_buckets = sorted(int(t) for t in gen_buckets)
    score_buckets = sorted(int(t) for t in score_buckets)
    if cfg["arch"] == "transformer" and gen_buckets[0] < 2:
        raise ValueError(f"generation bucket {gen_buckets[0]} < 2: a transformer "
                         f"dispatch runs its step program at least once")
    if cfg["arch"] == "transformer" and score_buckets[0] < 3:
        raise ValueError(f"score bucket {score_buckets[0]} < 3: the transformer's "
                         f"score programs take rows of 3 tokens or more")
    device = (next(model.parameters()).device if device is None
              else resolve_device(device))
    os.makedirs(out_dir, exist_ok=True)
    on_device = copy.deepcopy(model).to(device).eval()
    pair, score = PIECES[cfg["arch"]]
    roots = {piece: programs(on_device, piece, bos_id) for piece in pair + (score,)}
    names = {piece: [name for name, _ in r] for piece, r in roots.items()}
    manifest = {
        "version": 2,  # per-row seeds and prompt lengths, as the JAX v2
        "arch_config": cfg,
        "arch": cfg["arch"],
        "vocab_size": model.vocab_size,
        "num_genres": model.num_genres,
        "pad_id": model.pad_id,
        "bos_id": int(bos_id),
        "gen_buckets": gen_buckets,
        "prompt_buckets": sorted(int(t) for t in prompt_buckets),
        "score_buckets": score_buckets,
        "platforms": export_platforms(device),
        "files": {"generate": {f"{p}:{l}": {piece: names[piece] for piece in pair}
                               for p in sorted(prompt_buckets)
                               for l in gen_buckets},
                  "score": {str(t): names[score] for t in score_buckets}},
        "weights": WEIGHTS_NAME,
    }
    if lm_args is not None:
        manifest["lm_args"] = dict(lm_args)
    if kv_dtype is not None:
        manifest["kv_dtype"] = kv_dtype
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, WEIGHTS_NAME))
    kv = KV_DTYPES[kv_dtype or "float32"]
    for platform in manifest["platforms"]:
        os.makedirs(os.path.join(out_dir, platform), exist_ok=True)
    for piece_roots in roots.values():
        for name, root in piece_roots:
            save_program(trace_program(root, cfg, kv), out_dir, device.type, name)
    with open(os.path.join(out_dir, LM_MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    if verify:
        verify_lm_export(out_dir, device)
    return out_dir


def verify_lm_export(out_dir: str, device=None) -> None:
    """Reload through the runtime (the programs of ``device``'s platform)
    and generate and score at request shapes that are not buckets,
    including a per-row batch of mixed prompt lengths; raises on any
    failure."""
    rt = ExportedMusicLM(out_dir, device=device)
    length = max(1, rt.gen_buckets[0] - rt.gen_buckets[0] // 4)
    genres = np.zeros((2,), np.int64)
    toks = rt.generate(genres, length, seed=7, temperature=0.9, top_k=8,
                       forbidden=(rt.pad_id, rt.bos_id))
    if toks.shape != (2, length):
        raise RuntimeError(f"LM export verification: tokens {toks.shape}")
    if toks.min() < 0 or toks.max() >= rt.vocab_size:
        raise RuntimeError("LM export verification: tokens out of range")
    if np.isin(toks, [rt.pad_id, rt.bos_id]).any():
        raise RuntimeError("LM export verification: a forbidden token sampled")
    if np.array_equal(toks[0], toks[1]):
        raise RuntimeError("LM export verification: rows of two seeds agree")
    p = rt.prompt_buckets[-1]
    if p > 1:
        prompts = [np.arange(2, 2 + min(3, p)), np.arange(2, 2 + min(p, 5))[::-1]]
        mixed = rt.generate_rows(genres, np.asarray([3, 4]), length,
                                 prompts=prompts, temperature=0.9, top_k=8,
                                 forbidden=(rt.pad_id, rt.bos_id))
        if mixed.shape != (2, length):
            raise RuntimeError(f"LM export verification: mixed prompts "
                               f"{mixed.shape}")
    body = np.concatenate([np.full((2, 1), rt.bos_id, np.int64),
                           toks[:, : rt.score_buckets[0] - 1]], axis=1)
    nll, n = rt.score(body, genres)
    if nll.shape != (2,) or not np.isfinite(nll).all():
        raise RuntimeError(f"LM export verification: score {nll}")
    if not (n == body.shape[1] - 1).all():
        raise RuntimeError(f"LM export verification: scored targets {n}")
    print(f"LM export verification OK (generate at L={length}, "
          f"score at T={body.shape[1]})")


class _DecodeGraphs:
    """The CUDA graphs of one (P, L, rows, device) shape: ``start`` and
    ``step`` captured from a dispatch ``d`` whose tensors they own (the
    state tensors views of the device's buffers), after a warm-up of both
    on a side stream, under ``CAPTURE_LOCK``; ``staged`` pinned host copies
    of the host inputs, so that filling them makes no host
    synchronisation."""

    def __init__(self, rt, d, inputs, pool):
        self.d = d
        self.staged = {k: torch.empty_like(v).pin_memory() for k, v in inputs.items()}
        self.fill(inputs)
        device = d.token.device
        with CAPTURE_LOCK, torch.cuda.device(device), torch.no_grad():
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):  # load, pick algorithms
                rt._start(d)
                rt._step(d)
            torch.cuda.current_stream(device).wait_stream(side)
            self.start, self.step = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            for graph, fn in ((self.start, rt._start), (self.step, rt._step)):
                with torch.cuda.graph(graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    fn(d)

    def fill(self, inputs) -> None:
        for name, x in inputs.items():
            self.staged[name].copy_(x)
            getattr(self.d, name).copy_(self.staged[name], non_blocking=True)


class ExportedMusicLM:
    """The serving runtime of an LM artifact directory: bucket choice,
    padding and trim around its programs (module docstring), on ``device``
    (None: CUDA, raises without a card; "cpu" runs the CPU programs)."""

    def __init__(self, model_dir: str, device=None):
        self.model_dir = model_dir
        with open(os.path.join(model_dir, LM_MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("version", 1) < 2:
            raise ValueError(f"{model_dir} is a v1 LM export (scalar seed and "
                             f"prompt length); re-export it")
        if "weights" not in self.manifest:
            raise ValueError(f"{model_dir} holds StableHLO programs of the JAX "
                             f"package, which PyTorch cannot run; export the "
                             f"LM with this package's deploy.export_lm")
        if "files" not in self.manifest:
            raise ValueError(f"{model_dir} is an LM export of weights without "
                             f"programs; re-export it with this package's "
                             f"deploy.export_lm")
        self.device = resolve_device(device)
        self.platform = self.device.type
        if self.platform not in self.manifest["platforms"]:
            raise RuntimeError(
                f"{model_dir} holds no {self.platform} programs (platforms "
                f"{self.manifest['platforms']}): export it on a "
                f"{self.platform} device")
        self.kv_dtype = KV_DTYPES[self.manifest.get("kv_dtype", "float32")]
        self.gen_buckets = sorted(self.manifest["gen_buckets"])
        self.prompt_buckets = sorted(self.manifest["prompt_buckets"])
        self.score_buckets = sorted(self.manifest["score_buckets"])
        self._programs: dict = {}  # file name -> the loaded program
        self._weights = None  # weights.pt on the device: the layers' weights
        self._pieces: dict = {}  # a piece's files -> (embed, layers, head)
        self._lock = threading.Lock()
        self.graphs: dict = {}  # (P, L, rows, device) -> _DecodeGraphs
        self._pools: dict = {}  # device -> the graphs' memory pool
        self._buffers: dict = {}  # device -> (rows, cache length, state buffers)

    @property
    def vocab_size(self) -> int:
        return int(self.manifest["vocab_size"])

    @property
    def num_genres(self) -> int:
        return int(self.manifest["num_genres"])

    @property
    def pad_id(self) -> int:
        return int(self.manifest["pad_id"])

    @property
    def bos_id(self) -> int:
        return int(self.manifest["bos_id"])

    @property
    def lm_args(self) -> dict | None:
        """The training run's args recorded at export, if any."""
        return self.manifest.get("lm_args")

    @property
    def arch(self) -> str:
        return self.manifest.get("arch", "lstm")

    @staticmethod
    def _bucket(buckets, n, what):
        for t in buckets:
            if n <= t:
                return t
        raise ValueError(f"{what} {n} exceeds the largest exported bucket "
                         f"{buckets[-1]}")

    def program(self, name: str):
        """The artifact's program file ``name`` of this platform, loaded on
        the runtime's device at its first use."""
        if name not in self._programs:
            self._programs[name] = load_program(
                program_path(self.model_dir, self.platform, name), self.device).module()
        return self._programs[name]

    def _pair(self, p: int, l: int) -> dict:
        return self.manifest["files"]["generate"][f"{p}:{l}"]

    # -- one dispatch: the samplers' loop over the programs -----------------

    def _cache_len(self, p: int, l: int) -> int:
        return p + l if self.arch == "transformer" else 1

    def _dispatch(self, rows: int, p: int, l: int, state: list | None = None):
        """The tensors of one dispatch on the runtime's device: the host
        inputs' buffers, the state (fresh zeros unless given), the token fed,
        the step counter ``t`` and the tokens ``out``."""
        dev = self.device

        def long(*shape):
            return torch.zeros(shape, dtype=torch.long, device=dev)

        if state is None:
            state = [torch.zeros(s, dtype=d, device=dev) for s, d in state_shapes(
                self.manifest["arch_config"], rows, self._cache_len(p, l),
                self.kv_dtype)]
        n_out = l if self.arch == "transformer" else p + l
        return SimpleNamespace(
            files=self._pair(p, l), n_steps=n_out - 1 if self.arch == "transformer"
            else n_out, prompt=long(rows, p), prompt_lens=long(rows),
            genre_ids=long(rows), seed_keys=long(rows), vocab_keys=long(self.vocab_size),
            temperature=torch.ones((), device=dev), top_k=long(),
            top_p=torch.zeros((), device=dev),
            vocab_mask=torch.ones((self.vocab_size,), dtype=torch.bool, device=dev),
            state=state, token=long(rows), t=long(), out=long(rows, n_out))

    def _layers(self, names: list) -> tuple:
        """(embedding, a callable per layer, head) of a transformer piece's
        files: the layer's program with each layer's weights."""
        if tuple(names) in self._pieces:
            return self._pieces[tuple(names)]
        embed, block, head = (self.program(n) for n in names)
        if self._weights is None:
            weights = torch.load(os.path.join(self.model_dir, self.manifest["weights"]),
                                 map_location="cpu", weights_only=True)
            self._weights = {k: v.to(self.device) for k, v in weights.items()}
        params = [k for k in block.state_dict() if k.startswith("block.")]

        def layer(i):
            own = {k: self._weights[f"blocks.{i}.{k.removeprefix('block.')}"]
                   for k in params}
            return lambda *args: torch.func.functional_call(block, own, args)

        layers = [layer(i) for i in range(self.manifest["arch_config"]["n_layers"])]
        self._pieces[tuple(names)] = embed, layers, head
        return embed, layers, head

    def _start(self, d) -> None:
        """Reset the state; the transformer's prefill draws token 0."""
        for x in d.state:
            x.zero_()
        d.t.zero_()
        if self.arch != "transformer":
            d.token.fill_(self.bos_id)
            return
        embed, blocks, head = self._layers(d.files["prefill"])
        x = embed(d.prompt, d.genre_ids)
        for block, k, v in zip(blocks, d.state[::2], d.state[1::2]):
            x = block(x, k, v)
        token = head(x, d.prompt_lens, d.seed_keys, d.vocab_keys,
                     *(getattr(d, k) for k in _CONTROLS))
        d.out.select(1, 0).copy_(token)
        d.token.copy_(token)

    def _step(self, d) -> None:
        """One step: the served samplers' loop body (models/lm_sampling.py)."""
        controls = tuple(getattr(d, k) for k in _CONTROLS)
        if self.arch == "transformer":
            embed, blocks, head = self._layers(d.files["step"])
            d.t.add_(1)
            x, idx = embed(d.token, d.t, d.prompt_lens, d.genre_ids)
            for block, k, v in zip(blocks, d.state[::2], d.state[1::2]):
                x = block(x, idx, k, v)
            token = head(x, d.t, d.seed_keys, d.vocab_keys, *controls)
            d.out.index_copy_(1, d.t.reshape(1), token[:, None])
        else:
            (step,) = d.files["step"]
            drawn, token = self.program(step)(
                d.token, d.t, d.prompt, d.prompt_lens, d.genre_ids, d.seed_keys,
                d.vocab_keys, *controls, d.state)
            d.out.index_copy_(1, d.t.reshape(1), drawn[:, None])
            d.t.add_(1)
        d.token.copy_(token)

    def _state_views(self, rows: int, cache_len: int) -> list:
        """The state of a graph of (rows, cache_len): the leading part of
        the device's buffers, grown (and its graphs dropped) when too
        small."""
        dev = self.device
        have_rows, have_len, flat = self._buffers.get(dev, (0, 0, None))
        if rows > have_rows or cache_len > have_len:
            have_rows, have_len = max(rows, have_rows), max(cache_len, have_len)
            # the graphs go, and their pool with them: a new pool is made
            self.graphs = {k: g for k, g in self.graphs.items() if k[3] != dev}
            self._pools.pop(dev, None)
            self._buffers.pop(dev, None)
            del flat
            flat = [torch.empty(int(np.prod(s)), dtype=d, device=dev)
                    for s, d in state_shapes(self.manifest["arch_config"], have_rows,
                                             have_len, self.kv_dtype)]
            self._buffers[dev] = (have_rows, have_len, flat)
        shapes = state_shapes(self.manifest["arch_config"], rows, cache_len,
                              self.kv_dtype)
        return [f[: int(np.prod(s))].view(s) for f, (s, _) in zip(flat, shapes)]

    def reserve(self, rows: int, p_bucket: int, l_bucket: int) -> None:
        """Size the card's state buffers for dispatches of up to ``rows``
        rows at the (P, L) bucket pair, so that warming smaller shapes
        first drops no graph (a no-op on the CPU)."""
        if self.device.type == "cuda":
            with self._lock:
                self._state_views(graph_rows(rows), self._cache_len(p_bucket, l_bucket))

    def state_bytes(self) -> int:
        """Bytes of the card's state buffers (the graphs' own pool aside)."""
        return sum(f.numel() * f.element_size()
                   for _, _, flat in self._buffers.values() for f in flat)

    def _replay(self, inputs: dict, p: int, l: int) -> torch.Tensor:
        rows = inputs["genre_ids"].shape[0]
        key = (p, l, rows, self.device)
        graphs = self.graphs.get(key)
        if graphs is None:
            state = self._state_views(rows, self._cache_len(p, l))
            if self.device not in self._pools:
                self._pools[self.device] = torch.cuda.graph_pool_handle()
            graphs = _DecodeGraphs(self, self._dispatch(rows, p, l, state), inputs,
                                   self._pools[self.device])
            self.graphs[key] = graphs
        else:
            graphs.fill(inputs)
        graphs.start.replay()
        for _ in range(graphs.d.n_steps):
            graphs.step.replay()
        return graphs.d.out.cpu()  # the dispatch's one synchronisation

    def _eager(self, inputs: dict, p: int, l: int) -> torch.Tensor:
        d = self._dispatch(inputs["genre_ids"].shape[0], p, l)
        for name, x in inputs.items():
            setattr(d, name, x.to(self.device))
        with torch.no_grad():
            self._start(d)
            for _ in range(d.n_steps):
                self._step(d)
        return d.out.cpu()

    def generate(self, genre_ids, length: int, *, seed, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 0.0, prompt=None,
                 forbidden: Sequence[int] = ()) -> np.ndarray:
        """(B, length) sampled tokens. Row b equals the in-process served
        sampler at the covering generation bucket with seed_b (a scalar
        seed gives seed + b), trimmed to ``length``. ``prompt``: (B, P)
        shared-length prompts, or None."""
        prompts = None if prompt is None else list(np.asarray(prompt))
        return self.generate_rows(genre_ids, seed, length, prompts=prompts,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, forbidden=forbidden)

    def generate_rows(self, genre_ids, seeds, length: int, *, prompts=None,
                      temperature: float = 1.0, top_k: int = 0,
                      top_p: float = 0.0, forbidden: Sequence[int] = ()
                      ) -> np.ndarray:
        """The continuous-batching primitive: per-row seeds (a scalar means
        seed + arange(B)) and per-row prompts (None or 1-D int arrays of
        mixed lengths) in one dispatch at the (P, L) bucket pair."""
        genre_ids = np.asarray(genre_ids, np.int64)
        b = genre_ids.shape[0]
        seeds = np.asarray(seeds, np.int64)
        if seeds.ndim == 0:
            seeds = seeds + np.arange(b)
        seeds = seeds & 0xFFFFFFFF
        if seeds.shape != (b,):
            raise ValueError(f"seeds shape {seeds.shape} != ({b},)")
        l_bucket = self._bucket(self.gen_buckets, length, "length")
        if prompts is None:
            prompts = [None] * b
        if len(prompts) != b:
            raise ValueError(f"{len(prompts)} prompts for {b} rows")
        p_lens = np.asarray([0 if p is None else len(p) for p in prompts], np.int64)
        p_bucket = self._bucket(self.prompt_buckets, max(1, int(p_lens.max())),
                                "prompt length")
        prompt_arr = np.zeros((b, p_bucket), np.int64)
        for i, p in enumerate(prompts):
            if p is not None:
                prompt_arr[i, : p_lens[i]] = np.asarray(p, np.int64)
        rows = (genre_ids, seeds, prompt_arr, p_lens)
        if self.device.type == "cuda":
            rows = repeat_pad_rows(rows, graph_rows(b))
        genre_t, seeds_t, prompt_t, lens_t = (torch.from_numpy(a) for a in rows)
        mask = torch.ones((self.vocab_size,), dtype=torch.bool)
        mask[[int(t) for t in forbidden]] = False
        chain = lm_sampling.KeyChain(seeds_t, self.vocab_size)
        inputs = dict(zip(HOST_INPUTS, (
            prompt_t, lens_t, genre_t, chain.seed_keys, chain.vocab_keys,
            *lm_sampling.served_controls(self, temperature, top_k, top_p), mask)))
        with self._lock:
            if self.device.type == "cuda":
                out = self._replay(inputs, p_bucket, l_bucket)
            else:
                out = self._eager(inputs, p_bucket, l_bucket)
        out = out[:b].numpy()
        if self.arch != "transformer":  # each row's continuation after its prompt
            out = np.take_along_axis(out, p_lens[:, None] + np.arange(l_bucket), axis=1)
        return out[:, :length].astype(np.int32)

    def score(self, tokens, genre_ids):
        """Per-row (nll_sum, n_valid) over BOS-prepended rows, right-padded
        with pad_id to the covering score bucket (pad targets carry no
        weight, so the padding changes nothing)."""
        tokens = np.asarray(tokens, np.int64)
        t_bucket = self._bucket(self.score_buckets, tokens.shape[1], "token length")
        if tokens.shape[1] < t_bucket:
            pad = np.full((tokens.shape[0], t_bucket - tokens.shape[1]),
                          self.pad_id, np.int64)
            tokens = np.concatenate([tokens, pad], axis=1)
        dev = self.device
        names = self.manifest["files"]["score"][str(t_bucket)]
        tokens_t = torch.from_numpy(tokens).to(dev)
        genres = torch.from_numpy(np.asarray(genre_ids, np.int64)).to(dev)
        with self._lock, torch.no_grad():
            if self.arch == "transformer":
                embed, blocks, head = self._layers(names)
                x = embed(tokens_t, genres)
                for block in blocks:
                    x = block(x)
                nll, n = head(x, tokens_t)
            else:  # position by position through the LSTM's decode step
                step = self.program(names[0])
                state = [torch.zeros(s, dtype=d, device=dev) for s, d in state_shapes(
                    self.manifest["arch_config"], tokens.shape[0], 1, self.kv_dtype)]
                cols = tokens_t.t().contiguous()
                parts = [step(cols[i], cols[i + 1], genres, state)
                         for i in range(t_bucket - 1)]
                nll = torch.stack([x for x, _ in parts], dim=1).sum(dim=1)
                n = torch.stack([v for _, v in parts], dim=1).sum(dim=1)
        return nll.cpu().numpy(), n.cpu().numpy()


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="Export a trained token LM as a deployable artifact "
                    "(manifest + weights.pt).")
    p.add_argument("--lm_run", required=True,
                   help="run dir of mqgan_tpu_torch.train.lstm_trainer "
                        "(best.json + the .pt it names)")
    p.add_argument("--output", required=True)
    p.add_argument("--gen_buckets", type=int, nargs="+",
                   default=list(DEFAULT_GEN_BUCKETS))
    p.add_argument("--prompt_buckets", type=int, nargs="+",
                   default=list(DEFAULT_PROMPT_BUCKETS))
    p.add_argument("--score_buckets", type=int, nargs="+",
                   default=list(DEFAULT_SCORE_BUCKETS))
    p.add_argument("--kv_bf16", action="store_true",
                   help="transformer: generate with a bf16 KV cache (halves "
                        "its reads; streams consistent within the dtype)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: where the export traces and is "
                        "verified (cuda adds the card's programs to the CPU's)")
    args = p.parse_args(argv)

    model, a = load_lm_from_run(args.lm_run, args.device)
    export_music_lm(model, args.output, gen_buckets=args.gen_buckets,
                    prompt_buckets=args.prompt_buckets,
                    score_buckets=args.score_buckets, bos_id=a["bos_id"],
                    lm_args=a, kv_dtype="bfloat16" if args.kv_bf16 else None,
                    device=args.device)
    print(f"exported LM to {args.output}")
    return args.output


if __name__ == "__main__":
    main()
