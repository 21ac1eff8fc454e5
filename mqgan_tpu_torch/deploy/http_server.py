"""HTTP helpers shared by the port's servers (a copy of the helpers of
``mqgan_tpu/deploy/http_server.py``: the error type and the .npy / .npz
bodies). The codec's HTTP service itself is not ported yet (ROADMAP.md
Queue 1 item 4)."""

from __future__ import annotations

import io

import numpy as np


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


def _npy_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    return buf.getvalue()


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()
