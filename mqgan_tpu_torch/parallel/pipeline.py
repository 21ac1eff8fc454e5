"""Pipeline parallelism of the token LM's LSTM stack (counterpart of
``mqgan_tpu/parallel/pipeline.py``).

A GPipe schedule over a list of devices, which may repeat a card: S
stages, M microbatches, stage s runs microbatch m at tick t = s + m. JAX
runs the schedule as one ``lax.scan`` inside a ``shard_map``, activations
hopping stages through ``ppermute``, and every device computes every tick
(the bubble ticks on zeros, masked out of the result). Eager PyTorch
launches stage s at tick t only when 0 <= t - s < M: the same results
without the bubbles' work. Launches to different cards from one host
thread overlap, since each returns before its kernels end, and autograd
through the cross-device copies is the pipelined backward.

Stages must preserve shapes. The stack's layer 0 takes ``emb_dim``
features and the others ``lstm_hid``, so every stage's input rows are
zero-padded to D = max(emb_dim, lstm_hid): padded weight rows multiply
zero features, so the results are the unpadded ones, not an
approximation. Each stage runs ``HoistedLSTMLayer.scan``, the serial
layer's own math. The embeddings and the vocab head stay on the input's
device (JAX replicates them), and the model's only dropout sits after the
stack, outside the pipeline.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from mqgan_tpu_torch.models.music_lstm import HoistedLSTMLayer, MusicLSTM


def pipeline_map(stage_fn: Callable, stage_params: Sequence, xs: torch.Tensor,
                 devices: Sequence) -> torch.Tensor:
    """Run the microbatches ``xs`` (M, mb, ...) through S stages in order,
    pipelined: ``stage_fn(params, x) -> y`` (x's shape) is one stage,
    ``stage_params[s]`` its parameters (a dict of tensors), run on
    ``devices[s]``. Returns the last stage's (M, mb, ...) outputs on
    ``xs``'s device; differentiable."""
    devices = [torch.device(d) for d in devices]
    if len(stage_params) != len(devices):
        raise ValueError(f"{len(stage_params)} stages for {len(devices)} devices")
    n_stages, n_micro = len(devices), xs.shape[0]
    params = [{k: v.to(d) for k, v in p.items()}
              for p, d in zip(stage_params, devices)]
    acts = list(xs.unbind(0))  # microbatch m's newest activation
    for t in range(n_micro + n_stages - 1):
        for s in range(n_stages):
            m = t - s
            if 0 <= m < n_micro:
                acts[m] = stage_fn(params[s], acts[m].to(devices[s]))
    return torch.stack([a.to(xs.device) for a in acts])


def stack_lstm_stage_params(model: MusicLSTM) -> list:
    """Per stage (one LSTM layer each) ``{"w_in": (D, 4H), "w_hid": (H,
    4H), "bias": (4H,)}`` in fp32 (a stage computes in its input's dtype),
    D = max(emb_dim, lstm_hid), layer 0's input rows beyond emb_dim zero;
    taken from the model's parameters, so gradients reach them."""
    layers = [model._modules[f"lstm_{i}"].gate_weights(torch.float32)
              for i in range(model.lstm_layers)]
    d = max(w_in.shape[0] for w_in, _, _ in layers)
    return [{"w_in": F.pad(w_in, (0, 0, 0, d - w_in.shape[0])),
             "w_hid": w_hid, "bias": bias} for w_in, w_hid, bias in layers]


def _lstm_stage(params: dict, x: torch.Tensor) -> torch.Tensor:
    """One LSTM layer on a (mb, L, D) microbatch, its (mb, L, H) output
    zero-padded back to D features."""
    ys = HoistedLSTMLayer.scan(x, (params["w_in"], params["w_hid"], params["bias"]))
    return F.pad(ys, (0, x.shape[-1] - ys.shape[-1]))


def lstm_stack_pipelined(model: MusicLSTM, x_emb: torch.Tensor, devices: Sequence,
                         n_micro: int) -> torch.Tensor:
    """The model's LSTM stack on (B, L, emb_dim) inputs, one layer a device
    of ``devices`` (len == lstm_layers), B in ``n_micro`` microbatches;
    returns the last layer's (B, L, lstm_hid) states, in the dtype the
    serial layers compute in (the model's, else the input's)."""
    if len(devices) != model.lstm_layers:
        raise ValueError(f"{len(devices)} devices for {model.lstm_layers} layers "
                         "(one layer a stage)")
    b, length, e = x_emb.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    cdt = model.dtype or x_emb.dtype
    stages = stack_lstm_stage_params(model)
    d = stages[0]["w_in"].shape[0]
    x = F.pad(x_emb.to(cdt), (0, d - e))
    ys = pipeline_map(_lstm_stage, stages,
                      x.reshape(n_micro, b // n_micro, length, d), devices)
    return ys.reshape(b, length, d)[..., :model.lstm_hid]


def music_lstm_pipelined_logits(model: MusicLSTM, tokens: torch.Tensor,
                                genre_ids: torch.Tensor, devices: Sequence,
                                n_micro: int, deterministic: bool = True,
                                generator: torch.Generator | None = None
                                ) -> torch.Tensor:
    """``model(tokens, genre_ids, deterministic=..., generator=...)`` with
    the LSTM stack pipelined over ``devices``: equal values and gradients
    (the dropout after the stack draws as the serial model's does, from
    the same CPU ``generator``)."""
    h = lstm_stack_pipelined(model, model.embed(tokens, genre_ids), devices,
                             n_micro)
    return model.head(h, deterministic, generator)
