"""Audio file loading and resampling for the data-prep pipeline (a numpy /
scipy copy of ``mqgan_tpu/signal/audio.py``).

PCM and float WAV decode through ``scipy.io.wavfile``, raw ``.npy``
waveforms load as they are, and resampling is scipy's kaiser-windowed
polyphase filter (``resample_poly``). Other container formats raise
``UnsupportedFormatError`` rather than being skipped silently.
"""

from __future__ import annotations

import math
import os

import numpy as np

_WAV_EXTS = (".wav", ".wave")


class UnsupportedFormatError(RuntimeError):
    pass


def load_audio(path: str) -> tuple[np.ndarray, int]:
    """Returns (wav (channels, T) float32 in [-1, 1], sample_rate)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
        if arr.ndim == 1:
            arr = arr[None, :]
        return arr.astype(np.float32), 0  # 0 = unknown sr, caller must know
    if ext in _WAV_EXTS:
        from scipy.io import wavfile

        sr, data = wavfile.read(path)
        if data.ndim == 1:
            data = data[:, None]
        data = data.T  # (channels, T)
        if data.dtype == np.int16:
            wav = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            wav = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            wav = (data.astype(np.float32) - 128.0) / 128.0
        else:  # float32/float64
            wav = data.astype(np.float32)
        return wav, sr
    raise UnsupportedFormatError(
        f"cannot decode {ext!r} without an audio backend; convert to wav "
        f"first or provide raw .npy waveforms"
    )


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """(C, T) polyphase resample, kaiser window (beta=14.77, the
    'kaiser_best' family)."""
    if orig_sr == new_sr:
        return wav
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(new_sr))
    up, down = new_sr // g, orig_sr // g
    return resample_poly(wav, up, down, axis=-1,
                         window=("kaiser", 14.769656459379492)).astype(np.float32)


def to_mono(wav: np.ndarray) -> np.ndarray:
    """(C, T) -> (1, T); mean over channels."""
    if wav.shape[0] == 1:
        return wav
    return wav.mean(axis=0, keepdims=True)
