"""Fused FSQ encode head: (N, C) latent -> packed int32 FSQ indices
(counterpart of ``mqgan_tpu/ops/fsq_kernels.py`` ``FSQEncodeHead``).

    z   = h @ W + b                        fp32 (h is cast up)
    q   = round_half_even(tanh(z + shift) * half_l - offset)
    idx = sum((q + half_width) * basis)    int32

The projection runs in fp32, as the JAX kernel does. In bf16 this differs
from the JAX package's XLA path, whose ``q_in_proj`` runs in bf16; the port
follows the kernel, so a bf16 port and a bf16 JAX model can disagree on
codes whose pre-round value sits near a rounding midpoint.

``fsq_encode_head`` is the op ``mqgan::fsq_head``: on a CUDA tensor its
CUDA implementation ``fsq_head_kernel`` launches the kernel
(``csrc/fsq_head.cu``), on a CPU tensor it is the plain PyTorch version
``fsq_encode_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from mqgan_tpu_torch.ops import _cuda
from mqgan_tpu_torch.quant.fsq import FSQSpec, bound_constants

MAX_D = 8  # the kernel keeps its accumulators per code dim in registers
# W in shared memory: C * 4 * ceil(d / 4) fp32 values (d padded to float4s)
MAX_SMEM_FLOATS = 40960


def fsq_head_constants(spec: FSQSpec) -> np.ndarray:
    """(5, d) fp32 rows: half_l, offset, shift, half_width, basis."""
    half_l, offset, shift = bound_constants(spec.levels)
    return np.stack([half_l, offset, shift, spec.half_width,
                     spec.basis.astype(np.float32)]).astype(np.float32)


def fsq_encode_plain(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     consts: torch.Tensor) -> torch.Tensor:
    """h (N, C) -> (N,) int32; w (C, d), b (d,), consts (5, d), all fp32."""
    z = h.float() @ w + b
    half_l, offset, shift, half_w, basis = consts
    q = torch.round(torch.tanh(z + shift) * half_l - offset)
    return ((q + half_w) * basis).sum(dim=-1).to(torch.int32)


def fsq_head_kernel(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    consts: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (the op's CUDA implementation)."""
    if h.device.type != "cuda":
        raise ValueError(f"fsq_encode_head: unsupported device {h.device}")
    n, c = h.shape
    d = w.shape[1]
    dev = h.device
    _cuda.check(h, "h")
    _cuda.check(w, "w", dtype=torch.float32, shape=(c, d), device=dev)
    _cuda.check(b, "b", dtype=torch.float32, shape=(d,), device=dev)
    _cuda.check(consts, "consts", dtype=torch.float32, shape=(5, d), device=dev)
    smem_floats = c * 4 * -(-d // 4)
    if not 1 <= d <= MAX_D or smem_floats > MAX_SMEM_FLOATS:
        raise ValueError(f"fsq_encode_head: d={d} (1..{MAX_D}) and W's "
                         f"{smem_floats} shared-memory floats (max "
                         f"{MAX_SMEM_FLOATS}) exceed the kernel")
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return idx
    pt = _cuda.ptr
    _cuda.launch("mqgan_fsq_head", dev, pt(h), _cuda.cuda_dtype_flag(h.dtype),
                 pt(w), pt(b), pt(consts), pt(idx), n, c, d)
    _cuda.COUNTERS.add("fsq_head")
    return idx


def _fsq_head_cpu(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  consts: torch.Tensor) -> torch.Tensor:
    return fsq_encode_plain(h, w, b, consts)


fsq_head_op = _cuda.register_op(
    "fsq_head", _fsq_head_cpu, fsq_head_kernel,
    lambda h, w, b, consts: h.new_empty((h.shape[0],), dtype=torch.int32))


def fsq_encode_head(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    consts: torch.Tensor) -> torch.Tensor:
    """h (N, C) in bf16 or fp32 -> (N,) int32 packed indices."""
    _cuda.check_device("fsq_encode_head", h)
    return _cuda.dispatch(fsq_head_op, fsq_head_kernel, h, w, b, consts)
