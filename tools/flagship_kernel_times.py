"""Time the port's kernels at the flagship shapes in several checkouts, in
turns, on one card: the A/B of a change to a kernel against its parent.

    python3 tools/flagship_kernel_times.py --root PARENT --root NEW [--pairs 1]
    python3 tools/flagship_kernel_times.py --wide     # this checkout's wide shapes

Each root is timed by a worker process of its own (``--worker ROOT``: its
``mqgan_tpu_torch`` on ``sys.path``, its kernels built under ROOT/build), in
the order root 1, root 2, root 2, root 1 for each pair, so that drift on the
card falls on both sides. A worker times, with the same code whatever the
root, on the seeded flagship generator (hifispeech, bf16) with TF32 off:

- ``residual_block``: the six trunk blocks at B=64 T=512, summed;
- ``mel_mixer``: the pre and post mixers at B=64 T=512, summed;
- ``fsq_head``: the projection at N = 64 * 512;
- ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``: the layer call B=8
  H=8 T=2047 D=64;
- ``int8_conv``: the int8 refiner's 14 convs at B=64 T=512, summed;

each as the median CUDA-event time of single calls (20 reps), per call in
bursts of 10 calls (10 reps) and the device's own time a call
(torch.profiler over 10 calls: where the host's launch costs as much as the
kernel, as the FSQ head's, bursts time the host), and a digest of its outputs on these seeded
inputs (equal digests: the roots' kernels give bit-identical results). The
result prints one JSON line per worker and a table of each root's median
and digest, with the card's name and power limit.

``--wide`` times, in this checkout alone, the shapes the kernels took only
from PR 21 on, at the flagship's B=64 T=512 and beside the nearest shape of
the earlier builds: the blocks of a generator at channels (100, 100, 100,
132) (4-element copies) and at (128, 128, 128, 128) (16-byte copies); the
exact mixer at P 2048 (one slice of weights) and 4096 (two); the FSQ head at
d 4, 10 and 16 (N = 64 * 512, C = 768); the int8 conv over the 14 convs of
refiners of base 24 (Cin off 16) and 32.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

BURST = 10


def _time(fn, reps: int, inner: int = 1) -> float:
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def _device_ms(fn, calls: int = BURST) -> float:
    """The device's own time a call (torch.profiler: the CUDA activity of
    ``calls`` calls, summed over every kernel, memset and copy they launch),
    which the host's speed does not move."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def _both(fn) -> tuple:
    """(single-call ms, ms a call in bursts, device ms a call, the first
    call's outputs)."""
    first = fn()
    return _time(fn, 20), _time(fn, 10, BURST), _device_ms(fn), first


def _digest(outputs, h) -> None:
    import torch

    for x in outputs if isinstance(outputs, (tuple, list)) else (outputs,):
        h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())


def worker(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.nn.unet import _int8_args
    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.block_kernels import fused_residual_block
    from mqgan_tpu_torch.ops.flash_attention import (flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq,
                                                     flash_attention_fwd)
    from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_head
    from mqgan_tpu_torch.ops.int8_conv import int8_conv_kernel
    from mqgan_tpu_torch.ops.mixer_kernels import fused_mel_mixer
    from mqgan_tpu_torch.utils.init import seeded_init_

    assert _cuda.__file__.startswith(os.path.abspath(root)), _cuda.__file__
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.LIBRARY.load()
    dev, dt = torch.device("cuda"), torch.bfloat16
    mels, b, t = 128, 64, 512
    model = seeded_init_(PreEncoder.from_config(mels, GeneratorConfig(), dtype=dt), 0)
    model = model.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(5)
    lens = torch.full((b,), t, dtype=torch.int32, device=dev)
    out = {"build_s": _cuda.LIBRARY.build_seconds}
    digests = {}

    def add(name, fn):
        single, burst, device, first = _both(fn)
        _digest(first, digests.setdefault(name, hashlib.sha1()))
        prev = out.get(name, (0.0, 0.0, 0.0))
        out[name] = (prev[0] + single, prev[1] + burst, prev[2] + device)

    blocks = list(model.encoder_blocks) + list(model.decoder_blocks)
    for blk in blocks:
        x = torch.randn((b, t, blk.conv1.v.shape[1]), generator=gen, device=dev).to(dt)
        wts = blk.kernel_weights(dt)
        add("residual_block", lambda: fused_residual_block(x, lens, wts, causal=blk.causal))
    c = model.proj.weight.shape[0]
    for mixer in (model.pre, model.post):
        x = torch.randn((b, t, c), generator=gen, device=dev).to(dt)
        wts = mixer.kernel_weights()
        add("mel_mixer", lambda: fused_mel_mixer(x, lens, wts))
    w = model.q_in_proj.weight.float().t().contiguous()
    bias = model.q_in_proj.bias.float()
    h = torch.randn((b * t, w.shape[0]), generator=gen, device=dev).to(dt)
    add("fsq_head", lambda: fsq_encode_head(h, w, bias, model.fsq_consts))

    q, k, v, do = (torch.randn((8, 2047, 8, 64), generator=gen, device=dev).to(dt)
                   for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, 0.125)
    _, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, 0.125)
    add("flash_fwd", lambda: flash_attention_fwd(q, k, v, 0.125))
    add("flash_bwd_dq", lambda: flash_attention_bwd_dq(q, k, v, o, lse, do, 0.125))
    add("flash_bwd_dkv", lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.125))
    del q, k, v, do, o

    ref = model.refiner
    width = mels + mels // GeneratorConfig().refiner_hidden_proj_divisor
    levels = [(blk, 2 ** (i + 1)) for i, blk in enumerate(ref.downs)]
    levels += [(ref.mid, 2 ** ref.depth)]
    levels += [(blk, 2 ** (ref.depth - 1 - i)) for i, blk in enumerate(ref.ups)]
    for blk, div in levels:
        for conv in (blk.conv1, blk.conv2):
            cin = conv.v.shape[1]
            x = torch.randn((b, cin, t // div, width), generator=gen, device=dev)
            x = x.to(dt).contiguous(memory_format=torch.channels_last)
            args = _int8_args(conv, dt)
            add("int8_conv", lambda: int8_conv_kernel(x, *args))
            del x
            torch.cuda.empty_cache()
    out["digest"] = {name: h.hexdigest()[:16] for name, h in digests.items()}
    return out


def wide_shapes() -> dict:
    """The ``--wide`` times: {shape: (single-call ms, ms in bursts)}."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
    from mqgan_tpu_torch.nn.unet import UNetRefiner, _int8_args
    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.block_kernels import fused_residual_block
    from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_head, fsq_head_constants
    from mqgan_tpu_torch.ops.int8_conv import int8_conv_kernel
    from mqgan_tpu_torch.ops.mixer_kernels import fused_mel_mixer
    from mqgan_tpu_torch.quant.fsq import FSQSpec
    from mqgan_tpu_torch.utils.init import seeded_init_

    torch.set_grad_enabled(False)
    _cuda.LIBRARY.load()
    dev, dt = torch.device("cuda"), torch.bfloat16
    mels, b, t = 128, 64, 512
    gen = torch.Generator(device=dev).manual_seed(7)
    lens = torch.full((b,), t, dtype=torch.int32, device=dev)
    out = {}

    def add(name, fn):
        single, burst, device, _ = _both(fn)
        prev = out.get(name, (0.0, 0.0, 0.0))
        out[name] = (prev[0] + single, prev[1] + burst, prev[2] + device)

    for channels in ((100, 100, 100, 132), (128, 128, 128, 128)):
        model = seeded_init_(PreEncoder(mels, channels=channels, kernel_sizes=(3, 3, 5),
                                        dtype=dt), 0).to(dev).eval()
        for blk in list(model.encoder_blocks) + list(model.decoder_blocks):
            x = torch.randn((b, t, blk.conv1.v.shape[1]), generator=gen, device=dev).to(dt)
            wts = blk.kernel_weights(dt)
            add(f"residual_block x6 channels {channels}",
                lambda: fused_residual_block(x, lens, wts, causal=blk.causal))
    for p in (2048, 4096):
        wts = seeded_init_(MelMixer2D(p), 0).to(dev).kernel_weights()
        x = torch.randn((b, t, mels), generator=gen, device=dev).to(dt)
        add(f"mel_mixer P={p} C={mels}", lambda: fused_mel_mixer(x, lens, wts))
    h = torch.randn((b * t, 768), generator=gen, device=dev).to(dt)
    for levels in ((8, 5, 5, 5), (5,) * 10, (2,) * 16):
        d = len(levels)
        w = torch.randn((768, d), generator=gen, device=dev) / 768 ** 0.5
        bias = torch.zeros((d,), device=dev)
        consts = torch.from_numpy(fsq_head_constants(FSQSpec(levels))).to(dev)
        add(f"fsq_head d={d} N={b * t} C=768", lambda: fsq_encode_head(h, w, bias, consts))
    width = mels + mels // 8
    for base in (24, 32):
        ref = UNetRefiner(width, base, 3, mels, int8=True).to(dev)
        levels = [(blk, 2 ** (i + 1)) for i, blk in enumerate(ref.downs)]
        levels += [(ref.mid, 2 ** ref.depth)]
        levels += [(blk, 2 ** (ref.depth - 1 - i)) for i, blk in enumerate(ref.ups)]
        for blk, div in levels:
            for conv in (blk.conv1, blk.conv2):
                x = torch.randn((b, conv.v.shape[1], t // div, width), generator=gen,
                                device=dev)
                x = x.to(dt).contiguous(memory_format=torch.channels_last)
                args = _int8_args(conv, dt)
                add(f"int8_conv x14 refiner base {base}", lambda: int8_conv_kernel(x, *args))
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", action="append", default=[])
    parser.add_argument("--pairs", type=int, default=1)
    parser.add_argument("--worker")
    parser.add_argument("--wide", action="store_true")
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return
    if args.wide:
        print(f"card: {card_line()}")
        for name, (single, burst, device) in wide_shapes().items():
            print(f"{name}: {single:.4f} ms single calls, {burst:.4f} ms in bursts of "
                  f"{BURST}, {device:.4f} ms of device time")
        print(f"card: {card_line()}")
        return
    if len(args.root) < 2:
        parser.error("give two or more --root")
    print(f"card: {card_line()}")
    order = []
    for _ in range(args.pairs):
        order += args.root + args.root[::-1]
    runs = {r: [] for r in args.root}
    for root in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", root],
                              capture_output=True, text=True, timeout=1800)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"worker for {root} failed")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[root].append(result)
        print(f"{root}: {json.dumps(result)}", flush=True)
    names = [k for k in runs[args.root[0]][0] if k not in ("build_s", "digest")]
    for name in names:
        med = {root: [float(np.median([r[name][i] for r in runs[root]])) for i in range(3)]
               for root in args.root}
        cells = [f"{root} {m[0]:.4f} (bursts {m[1]:.4f}, device {m[2]:.4f})"
                 for root, m in med.items()]
        base = med[args.root[0]]
        ratios = [f"bursts {med[root][1] / base[1]:.4f}, device {med[root][2] / base[2]:.4f}"
                  for root in args.root[1:]]
        same = len({r["digest"][name] for root in args.root for r in runs[root]}) == 1
        print(f"{name}: ms single (bursts of {BURST}, device a call): {'; '.join(cells)}; vs "
              f"{args.root[0]}: {'; '.join(ratios)}; outputs "
              f"{'bit-identical' if same else 'differ'} across the roots")
    print("build s: " + "; ".join(f"{root} {runs[root][0]['build_s']:.1f}"
                                   for root in args.root))
    print(f"card: {card_line()}")


if __name__ == "__main__":
    main()
