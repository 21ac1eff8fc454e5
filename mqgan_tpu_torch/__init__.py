"""mqgan_tpu_torch — the codec in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

Same module layout and names as ``mqgan_tpu`` (the JAX package, which stays
the reference): ``core/``, ``nn/``, ``ops/``, ``quant/``, ``models/``,
``deploy/``, ``utils/``. Public functions keep JAX's layouts: channels-last
(B, T, C) activations and (B, T) bool pad masks with True = padded.

This package imports ``torch`` and numpy only — never ``jax``, ``flax`` or
``mqgan_tpu``. Its entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version, on a CUDA tensor it launches its kernel or raises.
"""

__version__ = "0.1.0"
