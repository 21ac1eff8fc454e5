"""Metrics logging (counterpart of ``mqgan_tpu/utils/logging.py``
``MetricsLogger``): JSONL on disk is the record, wandb mirrors it when it is
importable and a project is given."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


class MetricsLogger:
    """Appends one JSON object per ``log`` call to
    ``{output_dir}/{run_name}_metrics.jsonl``, with ``_time`` (seconds since
    the logger opened) and ``_step``."""

    def __init__(self, output_dir: str, run_name: str = "train",
                 wandb_project: str | None = None, wandb_entity: str | None = None,
                 config: Mapping[str, Any] | None = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, f"{run_name}_metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                wandb.init(project=wandb_project, entity=wandb_entity,
                           config=dict(config or {}))
                self._wandb = wandb
            except Exception:  # wandb absent or offline: JSONL only
                self._wandb = None

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        rec = {k: (list(v) if isinstance(v, (list, tuple)) else _to_py(v))
               for k, v in metrics.items()}
        rec["_time"] = round(time.time() - self._t0, 3)
        if step is not None:
            rec["_step"] = int(step)
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def log_image(self, tag: str, path: str, step: int | None = None) -> None:
        """Mirror an on-disk PNG to wandb as an image; the PNG stays the
        record, and without a wandb run this does nothing."""
        if self._wandb is not None and path:
            try:
                self._wandb.log({tag: self._wandb.Image(path)}, step=step)
            except Exception as e:  # noqa: BLE001 - mirroring never stops training
                print(f"wandb image {tag} not logged: {e}")

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """The metrics sink of a data-parallel rank other than 0: only rank 0
    writes ``train_metrics.jsonl`` and mirrors to wandb."""

    def log(self, *args, **kwargs) -> None:
        pass

    def log_image(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def component(name: str) -> str:
    """A parameter's top-level component, named as in the JAX tree
    (``encoder_blocks.0.conv1.v`` -> ``encoder_blocks_0``)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].isdigit():
        return f"{parts[0]}_{parts[1]}"
    return parts[0]


def tree_stats(named_tensors, prefix: str = "param", bins: int = 16) -> dict:
    """Distribution summaries per top-level component of (name, tensor)
    pairs (``named_parameters()``; components as ``component`` names
    them): l2, mean, std, absmax
    and a ``bins``-bin histogram over mean +- 4 std, as
    ``{prefix}/{component}/{stat}``."""
    import numpy as np

    groups: dict = {}
    for name, t in named_tensors:
        groups.setdefault(component(name), []).append(
            t.detach().float().cpu().numpy().ravel())
    out: dict = {}
    for comp, leaves in groups.items():
        v = np.concatenate(leaves).astype(np.float64)
        mean, std = float(v.mean()), float(v.std())
        out[f"{prefix}/{comp}/l2"] = float(np.sqrt(np.sum(v * v)))
        out[f"{prefix}/{comp}/mean"] = mean
        out[f"{prefix}/{comp}/std"] = std
        out[f"{prefix}/{comp}/absmax"] = float(np.abs(v).max())
        lo, hi = mean - 4 * std, mean + 4 * std
        if hi <= lo:
            hi = lo + 1e-12
        out[f"{prefix}/{comp}/hist"] = np.histogram(v, bins=bins,
                                                    range=(lo, hi))[0].tolist()
    return out
