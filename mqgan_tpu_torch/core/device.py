"""Device choice for the port's entry points: CUDA unless the caller asks
for the CPU. There is no silent fallback — a missing card is an error."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_inference(deterministic: bool) -> None:
    """The port is inference-only so far; training paths raise."""
    if not deterministic:
        raise NotImplementedError(
            "deterministic=False (dropout, FSQ noise, fast-dropout) belongs "
            "to the GAN training slice, ROADMAP.md Queue 1 item 6; this "
            "package runs inference only")
