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

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
