""".npy discovery and reading (counterparts of ``mqgan_tpu/train/data.py``
``find_npy_files`` and ``mqgan_tpu/utils/npy.py`` ``load_npy`` with
``use_native=False``): token chunks keep their stored dtype, mels are read
as float32."""

from __future__ import annotations

import os
from typing import List

import numpy as np


def find_npy_files(data_dir: str) -> List[str]:
    """Every ``.npy`` under data_dir, recursively, sorted."""
    if not os.path.isdir(data_dir):
        raise FileNotFoundError(f"Directory not found: {data_dir}")
    out = []
    for root, _, files in os.walk(data_dir):
        for fn in files:
            if fn.endswith(".npy"):
                out.append(os.path.join(root, fn))
    return sorted(out)


def load_npy(path: str, dtype=None) -> np.ndarray:
    """The array in ``path``, in its stored dtype, or cast to ``dtype``
    (``np.float32`` for mels). A file that is not an .npy raises ValueError,
    a missing one OSError."""
    arr = np.load(path, allow_pickle=False)
    return arr if dtype is None else arr.astype(dtype, copy=False)
