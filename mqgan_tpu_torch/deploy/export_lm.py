"""The token-LM artifact and its runtime (counterpart of
``mqgan_tpu/deploy/export_lm.py``).

The JAX package serializes its served samplers to StableHLO per (prompt
bucket P, generation bucket L) pair and a scoring program per length bucket.
This package writes the codec artifact's design (``deploy/export.py``): a
manifest, ``lm_manifest.json`` with the JAX manifest's keys (``arch_config``,
``arch``, vocab, genres, ``pad_id``, ``bos_id``, the three bucket lists,
``kv_dtype`` and ``lm_args`` where given), and the model's fp32 state_dict,
``weights.pt``. ``ExportedMusicLM`` rebuilds the model from ``arch_config``
(``models/token_lm.py`` ``build_token_lm``, inference knobs: no flash) and
serves it as the JAX runtime serves its programs: the smallest covering
buckets, padding, the per-row served sampler (``models/lm_sampling.py``) at
the padded bucket, and a causal trim; ``score`` pads with ``pad_id`` to its
bucket and calls ``score_tokens``. A row's tokens equal the in-process
sampler's at the same padded bucket and seed.

``load_lm_from_run`` reads a run dir of this package's trainer
(``train/lstm_trainer.py``).

CLI:  python -m mqgan_tpu_torch.deploy.export_lm --lm_run RUN --output EXP
      [--gen_buckets ...] [--prompt_buckets ...] [--score_buckets ...]
      [--kv_bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Sequence

import numpy as np
import torch

from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.models.token_lm import build_token_lm

LM_MANIFEST_NAME = "lm_manifest.json"
WEIGHTS_NAME = "weights.pt"
DEFAULT_GEN_BUCKETS = (128, 256, 512, 1024)
DEFAULT_PROMPT_BUCKETS = (1, 128)  # P=1 + prompt_len=0 serves unconditional
DEFAULT_SCORE_BUCKETS = (256, 1024)
KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    """Write the artifact of a token LM (either arch). ``kv_dtype``
    (transformer only, "bfloat16" or "float32"): the KV-cache dtype the
    runtime's generation uses, recorded in the manifest. ``verify`` reloads
    it on ``device`` (None: CUDA) and runs ``verify_lm_export``."""
    from mqgan_tpu_torch.models.token_lm import arch_config

    os.makedirs(out_dir, exist_ok=True)
    cfg = arch_config(model)
    manifest = {
        "version": 2,  # per-row seeds and prompt lengths, as the JAX v2
        "arch_config": cfg,
        "arch": cfg["arch"],
        "vocab_size": model.vocab_size,
        "num_genres": model.num_genres,
        "pad_id": model.pad_id,
        "bos_id": int(bos_id),
        "gen_buckets": sorted(int(t) for t in gen_buckets),
        "prompt_buckets": sorted(int(t) for t in prompt_buckets),
        "score_buckets": sorted(int(t) for t in score_buckets),
        "weights": WEIGHTS_NAME,
    }
    if lm_args is not None:
        manifest["lm_args"] = dict(lm_args)
    if kv_dtype is not None:
        if manifest["arch"] != "transformer":
            raise ValueError("kv_dtype applies to the transformer arch only "
                             "(the LSTM carries no KV cache)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {sorted(KV_DTYPES)}")
        manifest["kv_dtype"] = kv_dtype
    torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, WEIGHTS_NAME))
    with open(os.path.join(out_dir, LM_MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    if verify:
        verify_lm_export(out_dir, device)
    return out_dir


def verify_lm_export(out_dir: str, device=None) -> None:
    """Reload through the runtime and generate and score at request shapes
    that are not buckets, including a per-row batch of mixed prompt
    lengths; raises on any failure."""
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


class ExportedMusicLM:
    """The serving runtime of an LM artifact directory: bucket choice,
    padding and trim around the model's served sampler and scorer, on
    ``device`` (None: CUDA, raises without a card; "cpu" runs there)."""

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
        from mqgan_tpu_torch.models.token_lm import served_sampler

        self.device = resolve_device(device)
        model = build_token_lm(self.manifest["arch_config"], dropout=0.0,
                               for_inference=True)
        model.load_state_dict(torch.load(
            os.path.join(model_dir, self.manifest["weights"]),
            map_location="cpu", weights_only=True))
        self.model = model.to(self.device).eval()
        self._sampler = served_sampler(self.model)
        self._kv = ({"kv_dtype": KV_DTYPES[self.manifest["kv_dtype"]]}
                    if "kv_dtype" in self.manifest else {})
        self.gen_buckets = sorted(self.manifest["gen_buckets"])
        self.prompt_buckets = sorted(self.manifest["prompt_buckets"])
        self.score_buckets = sorted(self.manifest["score_buckets"])

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
        mask = torch.ones((self.vocab_size,), dtype=torch.bool)
        mask[[int(t) for t in forbidden]] = False
        dev = self.device
        out = self._sampler(
            self.model, torch.from_numpy(genre_ids).to(dev),
            torch.from_numpy(seeds).to(dev), torch.from_numpy(prompt_arr).to(dev),
            torch.from_numpy(p_lens).to(dev), temperature, top_k, top_p,
            mask.to(dev), max_len=l_bucket, bos_id=self.bos_id, **self._kv)
        return out[:, :length].cpu().numpy().astype(np.int32)

    def score(self, tokens, genre_ids):
        """Per-row (nll_sum, n_valid) over BOS-prepended rows, right-padded
        with pad_id to the covering score bucket (pad targets carry no
        weight, so the padding changes nothing)."""
        from mqgan_tpu_torch.models.lm_sampling import score_tokens

        tokens = np.asarray(tokens, np.int64)
        t_bucket = self._bucket(self.score_buckets, tokens.shape[1], "token length")
        if tokens.shape[1] < t_bucket:
            pad = np.full((tokens.shape[0], t_bucket - tokens.shape[1]),
                          self.pad_id, np.int64)
            tokens = np.concatenate([tokens, pad], axis=1)
        dev = self.device
        nll, n = score_tokens(self.model, torch.from_numpy(tokens).to(dev),
                              torch.from_numpy(np.asarray(genre_ids, np.int64)).to(dev))
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
                   help="cuda (default) or cpu: where the export is verified")
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
