"""Token-LM architecture registry (counterpart of
``mqgan_tpu/models/token_lm.py``): maps a trainer args dict (the one
``train/lstm_trainer.py`` writes into best.json) to a built model, so every
consumer agrees on how ``arch`` resolves."""

from __future__ import annotations

from typing import Any

ARCHS = ("lstm", "transformer")


def build_token_lm(args: dict, *, dropout: float = 0.0, dtype: Any = None,
                   for_inference: bool = False):
    """Build the token LM that ``args`` describes (``arch`` defaults to
    "lstm"). ``for_inference=True`` drops the training-only knobs
    (``flash_lm``, ``remat_lm``): they change how the training forward is
    computed, never its numerics."""
    arch = args.get("arch", "lstm")
    if arch == "transformer":
        from mqgan_tpu_torch.models.token_transformer import MusicTransformer

        return MusicTransformer(
            vocab_size=args["vocab_size"], num_genres=args["num_genres"],
            emb_dim=args["emb_dim"], n_layers=args["n_layers"],
            n_heads=args["n_heads"], mlp_ratio=args["mlp_ratio"],
            pad_id=args["pad_id"], dropout=dropout,
            remat=(not for_inference) and bool(args.get("remat_lm", False)),
            flash=(not for_inference) and bool(args.get("flash_lm", False)),
            dtype=dtype,
        )
    if arch == "lstm":
        from mqgan_tpu_torch.models.music_lstm import MusicLSTM

        return MusicLSTM(
            vocab_size=args["vocab_size"], num_genres=args["num_genres"],
            emb_dim=args["emb_dim"], lstm_hid=args["lstm_hid"],
            lstm_layers=args["lstm_layers"], pad_id=args["pad_id"],
            dropout=dropout, dtype=dtype,
        )
    raise ValueError(f"unknown token-LM arch {arch!r} (expected {ARCHS})")


def lm_arch(model) -> str:
    """The registry name of a built token-LM instance."""
    from mqgan_tpu_torch.models.music_lstm import MusicLSTM
    from mqgan_tpu_torch.models.token_transformer import MusicTransformer

    if isinstance(model, MusicTransformer):
        return "transformer"
    if isinstance(model, MusicLSTM):
        return "lstm"
    raise ValueError(f"not a token LM: {type(model).__name__}")


def arch_config(model) -> dict:
    """The arch-specific hyperparameters that rebuild the model with
    ``build_token_lm``."""
    base = {
        "arch": lm_arch(model),
        "vocab_size": model.vocab_size,
        "num_genres": model.num_genres,
        "emb_dim": model.emb_dim,
        "pad_id": model.pad_id,
    }
    if base["arch"] == "transformer":
        base.update(n_layers=model.n_layers, n_heads=model.n_heads,
                    mlp_ratio=model.mlp_ratio)
    else:
        base.update(lstm_hid=model.lstm_hid, lstm_layers=model.lstm_layers)
    return base
