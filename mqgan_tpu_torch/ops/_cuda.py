"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``mqgan_tpu_torch/csrc/*.cu`` have a plain C interface. At
first use they are compiled for Hopper (``sm_90a``) by ``nvcc`` — one
process per source, all started together — and linked into one shared
library under ``build/kernels/`` at the repository root, named by a hash of
the sources and flags so that an edited source is rebuilt. The library is
loaded with ``ctypes``; every pointer and the stream are ``c_void_p``, every
C entry point returns ``cudaGetLastError()`` and its wrapper raises if that
is not 0.

Nothing is built or loaded when a module is imported (the CPU tests import
every module): the first launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fsq_head.cu", "residual_block.cu", "mel_mixer.cu", "log_mel.cu",
           "log_mel_dft.cu", "flash_attention.cu")
# no --use_fast_math: the FSQ head needs exact tanhf and the mixer its
# exact-grade z tanh z (it writes its ex2/rcp.approx instructions itself;
# tanh.approx's 2^-11 flips FSQ codes on the encode side), the log-mel
# kernels exact sqrtf and logf, the flash kernels expf/exp2f/logf at full
# accuracy
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float

# C entry points: name -> argtypes (all return int, cudaGetLastError())
_SIGNATURES = {
    # h, h_is_bf16, w, b, consts, idx, n, c, d, stream
    "mqgan_fsq_head": (_PTR, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT,
                       _PTR),
    # x, lengths, act, w1, b1, w2, b2, pw, pb, cw1, cb1, cw2, cb2, sam_w,
    # h, z, res, pooled, gate_c, sam_stats, out,
    # B, T, Cin, Cout, K, H, sam_k, causal, is_bf16, stream
    "mqgan_residual_block": (_PTR,) * 21 + (_INT,) * 9 + (_PTR,),
    # x, lengths, dwk, consts, w1, b1, w2, out, B, T, C, P, dw_k, is_bf16,
    # stream
    "mqgan_mel_mixer": (_PTR,) * 8 + (_INT,) * 6 + (_PTR,),
    # x, lengths, dwk, consts, w1, b1, w2, z, partials, stats,
    # g_nodes, coef, out, B, T, C, P, dw_k, degree, grid, is_bf16, stream
    "mqgan_mel_mixer_poly": (_PTR,) * 13 + (_INT,) * 8 + (_PTR,),
    # wav, window, twiddles, bands, weights, out, n_clips, frames_per_clip,
    # samples, hop, n_fft, n_mels, stream
    "mqgan_log_mel": (_PTR,) * 6 + (_INT,) * 6 + (_PTR,),
    # wav_pad, cos, sin, fbank, out, n_clips, frames_per_clip, row_stride,
    # hop, n_fft, n_freq, n_mels, stream
    "mqgan_log_mel_dft": (_PTR,) * 5 + (_INT,) * 7 + (_PTR,),
    # q, k, v, o, lse, B, T, H, D, is_bf16, scale, stream
    "mqgan_flash_fwd": (_PTR,) * 5 + (_INT,) * 5 + (_FLT, _PTR),
    # q, k, v, o, do, lse, delta, dq, B, T, H, D, is_bf16, scale, stream
    "mqgan_flash_bwd_dq": (_PTR,) * 8 + (_INT,) * 5 + (_FLT, _PTR),
    # q, k, v, do, lse, delta, dk, dv, B, T, H, D, is_bf16, scale, stream
    "mqgan_flash_bwd_dkv": (_PTR,) * 8 + (_INT,) * 5 + (_FLT, _PTR),
}


class KernelCounters:
    """Launch counts per kernel wrapper: each wrapper adds one where it
    launches its kernel, and nowhere else (the plain CPU path does not
    count)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}

    def add(self, name: str) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


COUNTERS = KernelCounters()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the kernels")
    return str(path)


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC_DIR.iterdir()):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_library() -> tuple[Path, float]:
    """Compile the sources (in parallel) and link one shared library.
    Returns (path, seconds spent building; 0.0 when already built)."""
    lib = BUILD_DIR / f"libmqgan_kernels-{_digest()}.so"
    if lib.exists():
        return lib, 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + ".o")
        log = open(BUILD_DIR / (Path(src).stem + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / src), "-o", str(obj)]
        procs.append((src, obj, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, _, log, proc in procs:
        if proc.wait() != 0:
            failed.append(src)
        log.close()
    if failed:
        logs = "\n".join((BUILD_DIR / (Path(s).stem + ".log")).read_text()
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    subprocess.run([nvcc, "-shared", "-o", str(tmp),
                    *(str(obj) for _, obj, _, _ in procs)],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def ptxas_report() -> str:
    """The register / shared-memory lines ``-Xptxas -v`` wrote at build."""
    lines = []
    for src in SOURCES:
        log = BUILD_DIR / (Path(src).stem + ".log")
        if log.exists():
            lines += [ln for ln in log.read_text().splitlines()
                      if "registers" in ln or "Compiling entry" in ln
                      or "spill" in ln]
    return "\n".join(lines)


class _Library:
    def __init__(self):
        self._lock = threading.Lock()
        self._cdll = None
        self.build_seconds = 0.0

    def load(self):
        with self._lock:
            if self._cdll is None:
                path, self.build_seconds = build_library()
                cdll = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(cdll, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                self._cdll = cdll
            return self._cdll


LIBRARY = _Library()


def launch(name: str, device: torch.device, *args) -> None:
    """Call one C entry point on ``device`` and PyTorch's current stream
    there; raise on a CUDA error."""
    fn = getattr(LIBRARY.load(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, *, dtype=None, shape=None,
          device=None) -> None:
    """Raise unless t is contiguous and has the dtype/shape/device given."""
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def cuda_dtype_flag(dtype: torch.dtype) -> int:
    """1 for bf16, 0 for fp32; other dtypes have no kernel."""
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise ValueError(f"no CUDA kernel for dtype {dtype} (bf16 or fp32 only)")
