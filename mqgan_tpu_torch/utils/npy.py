""".npy reading for the token-LM trainer (counterpart of
``mqgan_tpu/utils/npy.py`` ``load_npy`` with ``use_native=False``: the
trainer reads integer token chunks, which the native float loader does not
take)."""

from __future__ import annotations

import numpy as np


def load_npy(path: str) -> np.ndarray:
    """The array in ``path``, in its stored dtype."""
    return np.load(path)
