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

Every kernel entry point is also a custom operator of one ``torch.library``
namespace, ``mqgan`` (``register_op``): its CUDA implementation launches the
kernel, its CPU implementation is the kernel's plain PyTorch version, and a
fake implementation gives the exact output shapes and dtypes without
building or loading anything, so that ``torch.export`` traces a model through
the kernels. The ops take fresh outputs and mutate nothing. ``load_ops()``
imports every module that registers one (a loaded program needs them all).

The ops' dispatch costs the host some 10-55 us a call on an H100's machine
(``chip_smoke.py`` phase 20a), so the eager entry points call the kernel
wrappers themselves (``dispatch``): an eager call on a real CUDA tensor
takes the wrapper, a traced one (``torch.export``, ``torch.compile``) the
op, which is what a traced program records and its CUDA graphs replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import importlib
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
           "log_mel_mixed.cu", "log_mel_bluestein.cu", "log_mel_dft.cu",
           "flash_attention.cu", "flash_attention_wide.cu", "flash_attention_any.cu",
           "flash_attention_any_wide.cu", "flash_attention_chunked.cu", "int8_conv.cu")
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
    # B, T, Cin, Cout, K, H, sam_k, causal, is_bf16, elements a copy, stream
    "mqgan_residual_block": (_PTR,) * 21 + (_INT,) * 10 + (_PTR,),
    # x, lengths, act, w1, b1, w2, b2, pw, pb, stats_lo, stats_hi, h, z,
    # res, partial, B, T, Cin, Cout, K, is_bf16, elements a copy, stream
    "mqgan_residual_block_begin": (_PTR,) * 15 + (_INT,) * 7 + (_PTR,),
    # z, residual, lengths, act, cw1, cb1, cw2, cb2, sam_w, pooled, counts,
    # gate_c, sam_stats, out, B, T, Cout, H, sam_k, is_bf16, stream
    "mqgan_residual_block_finish": (_PTR,) * 14 + (_INT,) * 6 + (_PTR,),
    # x, lengths, dwk, consts, w1, b1, w2, out, B, T, C, P, dw_k, is_bf16,
    # stream
    "mqgan_mel_mixer": (_PTR,) * 8 + (_INT,) * 6 + (_PTR,),
    # x, lengths, dwk, consts, w1, b1, w2, z, partials, stats,
    # g_nodes, coef, out, B, T, C, P, dw_k, degree, grid, is_bf16, stream
    "mqgan_mel_mixer_poly": (_PTR,) * 13 + (_INT,) * 8 + (_PTR,),
    # wav, window, twiddles, bands, weights, out, n_clips, frames_per_clip,
    # samples, hop, n_fft, n_mels, stream
    "mqgan_log_mel": (_PTR,) * 6 + (_INT,) * 6 + (_PTR,),
    # wav, window, plan, twiddles, bands, weights, out, n_clips,
    # frames_per_clip, samples, hop, n_fft, n_mels, n_passes, split_off,
    # frames per block, stream
    "mqgan_log_mel_mixed": (_PTR,) * 7 + (_INT,) * 9 + (_PTR,),
    # wav, premul, chirp, plan, twiddles, spectrum, split, bands, weights,
    # out, n_clips, frames_per_clip, samples, hop, n_fft, n_mels, length,
    # n_passes, frames per block, stream
    "mqgan_log_mel_bluestein": (_PTR,) * 10 + (_INT,) * 9 + (_PTR,),
    # wav_pad, cos, sin, fbank, out, n_clips, frames_per_clip, row_stride,
    # hop, n_fft, n_freq, n_mels, stream
    "mqgan_log_mel_dft": (_PTR,) * 5 + (_INT,) * 7 + (_PTR,),
    # q, k, v, o, lse, B, T, H, D, elements a copy, is_bf16, scale, stream
    "mqgan_flash_fwd": (_PTR,) * 5 + (_INT,) * 6 + (_FLT, _PTR),
    # q, k, v, o, do, lse, delta, dq, B, T, H, D, elements a copy, is_bf16,
    # scale, stream
    "mqgan_flash_bwd_dq": (_PTR,) * 8 + (_INT,) * 6 + (_FLT, _PTR),
    # q, k, v, do, lse, delta, dk, dv, B, T, H, D, elements a copy, is_bf16,
    # scale, stream
    "mqgan_flash_bwd_dkv": (_PTR,) * 8 + (_INT,) * 6 + (_FLT, _PTR),
    # x, wq, sw, bias, amax, xq, out, B, H, W, Cin, Cout, is_bf16,
    # accumulators, bn, bk, stages, box_w, box_h, smem_bytes, stream
    "mqgan_int8_conv": (_PTR,) * 7 + (_INT,) * 13 + (_PTR,),
}

NAMESPACE = "mqgan"
# the modules that register the namespace's ops
OP_MODULES = ("fsq_kernels", "block_kernels", "mixer_kernels", "mixer_poly",
              "stft_kernels", "flash_attention", "int8_conv")


class KernelCounters:
    """Launch counts per kernel wrapper: each wrapper adds one where it
    launches its kernel, and nowhere else (the plain CPU path does not
    count). A CUDA graph's capture launches nothing: under ``recording()``
    the capturing thread's adds go to the graph's own tally, which each
    replay adds with ``add_all``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._local = threading.local()

    def add(self, name: str) -> None:
        tally = getattr(self._local, "tally", None)
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + 1

    def add_all(self, counts: dict) -> None:
        with self._lock:
            for name, n in counts.items():
                self._counts[name] = self._counts.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self):
        """Within, this thread's adds go into the yielded dict instead."""
        previous = getattr(self._local, "tally", None)
        self._local.tally = tally = {}
        try:
            yield tally
        finally:
            self._local.tally = previous

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
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:  # the C entry launches on the current device
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def register_op(name: str, cpu, cuda, fake):
    """Define ``mqgan::<name>`` with ``cpu`` as its CPU implementation (its
    type annotations give the schema), ``cuda`` as its CUDA implementation
    and ``fake`` as its fake one; returns the op."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu, mutates_args=(),
                                 device_types="cpu")
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    return op


def tracing(t: torch.Tensor) -> bool:
    """Whether t is a tracer's tensor (torch.export's fake and functional
    tensors, or anything under torch.compile) rather than a real one."""
    return type(t) is not torch.Tensor or torch.compiler.is_compiling()


def dispatch(op, kernel, *args):
    """``op(*args)``, or its CUDA implementation ``kernel(*args)`` itself
    for an eager call whose first argument is a real CUDA tensor: the same
    launch without the op's dispatch."""
    t = args[0]
    if t.device.type == "cuda" and not tracing(t):
        return kernel(*args)
    return op(*args)


def load_ops() -> None:
    """Import every module that registers an op of the namespace."""
    for name in OP_MODULES:
        importlib.import_module(f"mqgan_tpu_torch.ops.{name}")


def check_device(name: str, t: torch.Tensor) -> None:
    """Raise unless t is on the CPU (the plain version) or a card."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


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
