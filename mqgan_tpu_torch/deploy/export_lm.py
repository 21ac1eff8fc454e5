"""Loading a trained token LM for serving (counterpart of
``mqgan_tpu/deploy/export_lm.py`` ``load_lm_from_run``).

The LM artifact of the JAX package (``export_music_lm``,
``ExportedMusicLM``, ``verify_lm_export`` and the export CLI) waits for the
port's artifact design, ROADMAP.md Queue 1 item 4.
"""

from __future__ import annotations

import json
import os

import torch

from mqgan_tpu_torch.core.device import resolve_device
from mqgan_tpu_torch.models.token_lm import build_token_lm


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
        raise NotImplementedError(
            f"{path}: orbax checkpoints of the JAX trainer are not read by "
            f"this package yet (ROADMAP.md Queue 1 item 3, checkpoint "
            f"import); serve a run of mqgan_tpu_torch.train.lstm_trainer")
    args = best["args"]
    model = build_token_lm(args, dropout=0.0, for_inference=True)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return model.to(resolve_device(device)).eval(), args
