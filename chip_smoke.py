#!/usr/bin/env python3
"""Drive the PyTorch port's codec serving path, its audio path and its
token-LM training path on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card and exits non-zero,
printing no result, without one. Phases (any failure exits non-zero):

 1. check the card; print its name and power limit (nvidia-smi);
 2. build the hand-written CUDA kernels from mqgan_tpu_torch/csrc (nvcc,
    sm_90a) and print the build time and the ptxas register report;
 3. hold each kernel against its plain PyTorch version on the same inputs,
    at the flagship widths (all six residual-block configurations, both
    mel-mixers, the FSQ head), B=8, T=512, ragged lengths: fp32 with TF32
    off (max|k - p| <= 1e-4 * max(1, max|p|)) and bf16 (||k - p|| / ||p||
    <= 2e-2); FSQ indices may differ only where the plain pre-round value
    lies within 1e-4 of a rounding midpoint. The log-mel kernels in fp32
    (max|k - p| <= 1e-4 in the log domain), each case through the route its
    shape selects (one launch of that kernel): the FFT kernel on the
    hifispeech spec at B=8 x 261,632 samples with 1 s of leading silence in
    clip 0 (silent frames must be exactly log(1e-5) in both), at B=1 x
    100,003 samples, at B=3 x 1,025 samples (n_fft/2 + 1: both reflected
    edges in every frame), on the hifimusic spec (160 mels) at B=2, at
    n_fft 512 (16 kHz, 80 mels), and at n_fft 256, 1024 and 4096 (256 mels)
    where a radix-2 pass ends the FFT; the DFT kernel at n_fft 1200 (16 kHz, hop
    300, 80 mels, 0.25 s of leading silence) and at n_fft 1000 (hop 250, a
    last partial 16-sample stage). Then the whole fp32 round trip
    through the kernels against the same model on the CPU (plain versions);
 4. serve 12 concurrent clips of mixed lengths (100-512 frames) through
    CodecServer over the runtime (flagship GeneratorConfig defaults, 128
    mels, seeded weights, bf16, buckets 128/256/512) and check the results
    and that each batch launched 6 block, 1 FSQ-head and 2 mixer kernels;
 5. time encode -> decode at B=64, T=512, bf16, tokens kept on the card,
    distinct inputs per iteration: mel-frames/s for exact and poly-decode
    mixers; then profile one round trip of each (torch.profiler): device
    time by kernel group and the card's idle share;
 6. the convert CLI's library entry point on the card: 8 wavs written with
    stdlib wave (44.1 kHz 16-bit of 1.5-15 s, one at 22.05 kHz, one of
    0.5 s): 7 mel files of (samples // 512 + 1, 128), one log-mel launch
    per file, a rerun changes nothing, two spawned workers write the same
    files;
 7. the audio round trip at full width: 64 seeded clips of 261,632 samples
    (5.93 s at 44.1 kHz, 512 frames) -> MelFrontend (the log-mel kernel) ->
    the codec of phase 5 (exact mixers, tokens on the card) -> the flagship
    ISTFTNetGenerator (seeded, bf16, fp32 heads) -> istft -> (64, 1,
    262,136) waveform; 1 log-mel, 6 block, 1 FSQ-head and 2 mixer launches
    per trip; times of the front end (mel-frames/s) and of wav -> wav
    (audio-s/s), Griffin-Lim (32 iterations) on the 64 decoded mels, a
    profile of one trip, its split into front end, codec and vocoder (CUDA
    events) and each stage's kernel groups;
 8. time each kernel at its flagship shapes beside its plain version, its
    bound and, for the log-mel kernel, the torch.stft chain that computes
    the same function and the DFT kernel (the earlier design, now the route
    for other n_fft), and print one JSON line of them; the log-mel kernel
    is first held against its plain version in float64 at that batch (64
    clips; max|k - p64| <= 1e-4, or no more than the fp32 plain version's
    own error, since fp32 rounding reaches ~1e-4 in the log domain at
    near-silent single-bin mels), and its bound is the function's: an FFT
    per frame and the filterbank's nonzeros, not F x n_mels;
 9. the three flash-attention kernels (forward, dQ, dK/dV) against their
    plain versions, fp32 (max|k - p| <= 1e-4 * max(1, max|p|), TF32 off)
    and bf16 (rel-L2 <= 2e-2), at T 1, 17, 128, 129, 2047 and head sizes
    32, 64, 128 (B=2, H=4); at T=1 dq and dk are 0 by definition (one key)
    and take the absolute gate in both dtypes; then the backward run twice
    on the same inputs must give bit-identical dq, dk and dv (torch.equal),
    fp32 and bf16, T 129 and 2047, every head size: no kernel uses atomics;
10. the token-LM training slice at the flagship width (MusicTransformer
    vocab 1003, 10 genres, emb 512, 6 layers, 8 heads, mlp 4x): one fp32
    step on the card through the kernels against the same step on the CPU
    through the plain path (loss and every gradient); the trainer CLI
    (--arch transformer --flash_lm --bf16) for one epoch of 2047-token
    chunks with 6 launches of each kernel per train step (the slice's main
    path: counts reset just before, read just after); training tokens/s
    (B * (L - 1) per step, bf16, dropout 0.1) at B=8 L=2048 and B=4 L=4096
    through the kernels, the plain attention and the SDPA yardstick, with
    peak memory, and a torch.profiler split of one step; one --arch lstm
    step at flagship width;
11. time the flash kernels at the flagship layer call (B=8, H=8, T=2047,
    D=64, bf16) beside their plain versions, their bounds (the function's
    operations) and SDPA's forward and backward, after holding them against
    the plain versions there, and each kernel's rate on the products it
    does (2 forward, 3 dQ, 4 dK/dV) beside the charged bound; kernels and
    SDPA are timed in single calls (the kernels line) and in bursts of 10
    calls (printed beside); print the kernels JSON line (seven rows);
12. print {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEED = 0
MELS = 128
BUCKETS = (128, 256, 512)
CMP_B, CMP_T = 8, 512
CMP_LENGTHS = (512, 480, 300, 257, 128, 77, 5, 1)
CLIP_LENGTHS = (100, 117, 128, 140, 201, 256, 300, 384, 450, 500, 512, 333)
BENCH_B, BENCH_T = 64, 512
WARMUP, ITERS = 2, 5
# the audio batch of the same throughput shape: 511 hops of 512 samples
# give 512 frames per clip (5.93 s at 44.1 kHz)
AUDIO_B, AUDIO_SAMPLES, AUDIO_ITERS = 64, 261_632, 3
GL_ITERS = 32
# flash attention: kernel vs plain at these sequence lengths and head sizes
FLASH_TS = (1, 17, 128, 129, 2047)
FLASH_DS = (32, 64, 128)
# the JAX package calls JAX's library kernels (JAX 0.9.0,
# jax/experimental/pallas/ops/tpu/flash_attention.py) from _attend_flash
FLASH_REPLACES = {
    "flash_fwd": "mqgan_tpu/models/token_transformer.py:128 "
                 "(jax flash_attention.py:758 _flash_attention_impl)",
    "flash_bwd_dq": "mqgan_tpu/models/token_transformer.py:128 "
                    "(jax flash_attention.py:1456 _flash_attention_bwd_dq)",
    "flash_bwd_dkv": "mqgan_tpu/models/token_transformer.py:128 "
                     "(jax flash_attention.py:1121 _flash_attention_bwd_dkv)",
}
# the flagship token LM (benchmarks/bench_flash_sweep.py, the trainer's
# defaults), the trainer run's chunk count, and the training shapes timed
LM = dict(vocab_size=1003, num_genres=10, emb_dim=512, n_layers=6, n_heads=8,
          mlp_ratio=4)
LM_CHUNKS = 20
LM_SHAPES = ((8, 2048), (4, 4096))
LM_ITERS = 3
# phase 11 also times each flash kernel and SDPA over bursts of this many calls
FLASH_BURST = 10
# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# fp32 CUDA cores, HBM bandwidth
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, inner: int = 1) -> float:
    """Median over reps of the CUDA-event time of ``inner`` back-to-back
    calls of fn, per call (inner > 1 hides the host's launch cost behind
    the card's work for sub-millisecond calls)."""
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


def build_model(device, dtype, poly_mixers=False, state=None):
    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.utils.init import seeded_init_

    model = PreEncoder.from_config(MELS, GeneratorConfig(), dtype=dtype,
                                   poly_mixers=poly_mixers)
    if state is None:
        seeded_init_(model, SEED)
    else:
        model.load_state_dict(state)
    return model.to(device).eval()


def block_cases(model):
    """(name, block) for the six trunk blocks of a round trip."""
    return ([(f"enc{i}", b) for i, b in enumerate(model.encoder_blocks)]
            + [(f"dec{i}", b) for i, b in enumerate(model.decoder_blocks)])


def _fsq_near_midpoint(h, w, b, consts):
    """(N,) bool: some code dim's plain pre-round value is within 1e-4 of a
    rounding midpoint."""
    import torch

    z = h.float() @ w + b
    half_l, offset, shift = consts[0], consts[1], consts[2]
    bounded = torch.tanh(z + shift) * half_l - offset
    frac = bounded - torch.floor(bounded)
    return ((frac - 0.5).abs() < 1e-4).any(dim=-1)


def compare_kernels(model, device, b, t, lengths, dtypes) -> dict:
    """Phase 3: every kernel against its plain version; returns each
    kernel's largest |kernel - plain| in bf16, the main path's dtype (for
    the FSQ head: the largest index difference away from a midpoint)."""
    import torch

    from mqgan_tpu_torch.ops.block_kernels import (fused_residual_block,
                                                   residual_block_plain)
    from mqgan_tpu_torch.ops.fsq_kernels import (fsq_encode_head,
                                                 fsq_encode_plain)
    from mqgan_tpu_torch.ops.mixer_kernels import (fused_mel_mixer,
                                                   mel_mixer_plain)

    gen = torch.Generator().manual_seed(SEED + 1)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    errs = {k: 0.0 for k in ("residual_block", "mel_mixer", "fsq_head")}

    def judge(kernel, name, got, want, dtype):
        ok, max_abs, detail = _judge("", got, want, dtype)
        if dtype != torch.float32:
            errs[kernel] = max(errs[kernel], max_abs)
        print(f"  {kernel:15s} {name:5s} {str(dtype)[6:]:8s} {detail.strip()}, "
              f"max|k-p| {max_abs:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{kernel} {name} {dtype}: {detail}")

    for dtype in dtypes:
        for name, blk in block_cases(model):
            cin = blk.conv1.v.shape[1]
            x = torch.randn((b, t, cin), generator=gen).to(device, dtype)
            wts = blk.kernel_weights(dtype)
            got = fused_residual_block(x, lens, wts, causal=blk.causal)
            want = residual_block_plain(x, lens, wts, causal=blk.causal)
            judge("residual_block", name, got, want, dtype)
        for name, mixer in (("pre", model.pre), ("post", model.post)):
            c = model.proj.weight.shape[0]
            x = torch.randn((b, t, c), generator=gen).to(device, dtype)
            wts = mixer.kernel_weights()
            got = fused_mel_mixer(x, lens, wts)
            want = mel_mixer_plain(x, lens, wts)
            judge("mel_mixer", name, got, want, dtype)
            pad_rows = torch.arange(t, device=device)[None, :] >= lens[:, None]
            if not bool((got.float()[pad_rows] == wts.consts[1].to(dtype).float()).all()):
                fail(f"mel_mixer {name} {dtype}: padded rows are not b_out")
        c = model.q_in_proj.weight.shape[1]
        h = torch.randn((b * t, c), generator=gen).to(device, dtype)
        w = model.q_in_proj.weight.float().t().contiguous()
        bias = model.q_in_proj.bias.float()
        got = fsq_encode_head(h, w, bias, model.fsq_consts)
        want = fsq_encode_plain(h, w, bias, model.fsq_consts)
        near = _fsq_near_midpoint(h, w, bias, model.fsq_consts)
        mism = got != want
        far_err = int((got - want)[~near].abs().max()) if bool((~near).any()) else 0
        print(f"  {'fsq_head':15s} {'':5s} {str(dtype)[6:]:8s} "
              f"{int(mism.sum())} of {got.numel()} indices differ, "
              f"{int((mism & near).sum())} of them within 1e-4 of a midpoint "
              f"{'ok' if far_err == 0 else 'FAIL'}")
        if far_err:
            fail(f"fsq_head {dtype}: indices differ away from a midpoint")
        if int(got.min()) < 0 or int(got.max()) >= model.codebook_size:
            fail("fsq_head: index out of range")
        errs["fsq_head"] = max(errs["fsq_head"], float(far_err))
    return errs


def compare_round_trip(state, device) -> None:
    """Phase 3b: the fp32 round trip through the kernels against the same
    weights through the plain versions on the CPU, on a small input."""
    import torch

    rng = np.random.default_rng(SEED + 2)
    b, t = 2, 48
    x = torch.from_numpy(rng.standard_normal((b, t, MELS)).astype(np.float32))
    lengths = torch.tensor([t, 31], dtype=torch.int32)
    pad = torch.arange(t)[None, :] >= lengths[:, None]
    ref = build_model("cpu", torch.float32, state=state)
    dev = build_model(device, torch.float32, state=state)
    with torch.no_grad():
        idx_ref = ref.encode(x, pad)
        idx_dev = dev.encode(x.to(device), pad.to(device)).cpu()
        out_ref = ref.decode(idx_ref, pad)
        out_dev = dev.decode(idx_ref.to(device), pad.to(device)).float().cpu()
        h = ref._encode_trunk(x, pad)
        near = _fsq_near_midpoint(
            h.reshape(-1, h.shape[-1]), ref.q_in_proj.weight.t(),
            ref.q_in_proj.bias, ref.fsq_consts).reshape(idx_ref.shape)
    flips = idx_ref != idx_dev
    err = float((out_dev - out_ref).abs().max())
    ok = (bool(torch.allclose(out_dev, out_ref, atol=2e-4, rtol=2e-4))
          and not bool((flips & ~near).any()))
    print(f"  round trip fp32 vs CPU plain, B={b} T={t}: {int(flips.sum())} "
          f"token flips of {idx_ref.numel()} ({int((flips & near).sum())} "
          f"within 1e-4 of a midpoint), decode max|err| {err:.3e} "
          f"(atol=rtol=2e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("fp32 round trip disagrees with the plain CPU path")


def log_mel_library(wav, window, fbank, n_fft: int, hop: int, win: int):
    """The library yardstick of the log-mel kernel: torch.stft (cuFFT on the
    card; center, reflect, the periodic Hann window padded to n_fft) ->
    |.| -> fbank matmul -> clamp -> log. No one PyTorch call computes the
    function; the port never calls this chain."""
    import torch

    spec = torch.stft(wav, n_fft, hop, win, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    mel = spec.abs().transpose(1, 2) @ fbank
    return torch.log(torch.clamp(mel, min=1e-5))


def compare_log_mel(device) -> float:
    """Phase 3, log-mel: each kernel against its plain version (TF32 off);
    returns the largest |kernel - plain|."""
    import torch

    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel,
                                                  log_mel_plain, log_mel_tables)
    from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    floor = torch.log(torch.tensor(LOG_CLIP_VAL, device=device))
    worst = 0.0
    small = SpectrogramConfig(sampling_rate=16000, filter_length=512, hop_length=128,
                              win_length=512, n_mel_channels=80, mel_fmax=8000.0)
    odd = SpectrogramConfig(sampling_rate=16000, filter_length=1200, hop_length=300,
                            win_length=1200, n_mel_channels=80, mel_fmax=8000.0)
    # n_fft 1000 is no multiple of the DFT kernel's 16-sample stage
    ragged = SpectrogramConfig(sampling_rate=16000, filter_length=1000, hop_length=250,
                               win_length=1000, n_mel_channels=80, mel_fmax=8000.0)
    # odd log2(n_fft / 2): the FFT kernel's radix-2 pass; 32 and 2 frames a block
    fft256 = SpectrogramConfig(sampling_rate=8000, filter_length=256, hop_length=64,
                               win_length=256, n_mel_channels=40, mel_fmax=4000.0)
    fft1024 = SpectrogramConfig(sampling_rate=16000, filter_length=1024, hop_length=256,
                                win_length=1024, n_mel_channels=80, mel_fmax=8000.0)
    fft4096 = SpectrogramConfig(filter_length=4096, hop_length=1024, win_length=4096,
                                n_mel_channels=256)
    # (label, spec, clips, samples, leading silence of clip 0 in samples,
    # the kernel its shape selects)
    cases = (("hifispeech", SpectrogramConfig(), 8, AUDIO_SAMPLES, 44_100, "log_mel"),
             ("hifispeech", SpectrogramConfig(), 1, 100_003, 0, "log_mel"),
             ("hifispeech edges", SpectrogramConfig(), 3, 1_025, 0, "log_mel"),
             ("hifimusic", SpectrogramConfig(n_mel_channels=160), 2, AUDIO_SAMPLES, 0,
              "log_mel"),
             ("16k n_fft=512", small, 2, 16_000, 0, "log_mel"),
             ("8k n_fft=256", fft256, 3, 8_001, 1_000, "log_mel"),
             ("16k n_fft=1024", fft1024, 2, 16_000, 0, "log_mel"),
             ("44.1k n_fft=4096 256 mels", fft4096, 2, 100_003, 0, "log_mel"),
             ("16k n_fft=1200", odd, 2, 16_000, 4_000, "log_mel_dft"),
             ("16k n_fft=1000", ragged, 2, 16_003, 0, "log_mel_dft"))
    for label, cfg, b, n, quiet, kernel in cases:
        tables = log_mel_tables(cfg, device)
        cos, sin, _ = (t.to(device) for t in dft_mel_tables(cfg))  # the plain version's
        wav = 0.3 * torch.randn((b, n), generator=gen, device=device)
        wav[0, :quiet] = 0.0
        # frames whose window sees only zeros
        silent = max(0, (quiet - cfg.filter_length // 2) // cfg.hop_length + 1)
        _cuda.COUNTERS.reset()
        got = log_mel(wav, tables)
        launches = _cuda.COUNTERS.snapshot()
        want = log_mel_plain(wav, cos, sin, tables.fbank, cfg.hop_length)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        exact = bool((got[0, :silent] == floor).all() and (want[0, :silent] == floor).all())
        ok = (err <= 1e-4 and exact and launches == {kernel: 1}
              and tuple(got.shape) == (b, n // cfg.hop_length + 1, cfg.n_mel_channels))
        print(f"  {kernel:15s} {label} B={b} x {n}: {tuple(got.shape)} "
              f"max|k-p| {err:.3e} (limit 1e-4), {silent} silent frames "
              f"{'== log(1e-5)' if exact else 'NOT log(1e-5)'}, launches {launches} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{kernel} {label} B={b}: max|k-p| {err:.3e}, silent exact {exact}, "
                 f"launches {launches}")
        worst = max(worst, err)
    return worst


def _judge(label, got, want, dtype, zero=False) -> tuple:
    """(ok, max|k - p|, detail) under the kernel gates: fp32 max|k - p| <=
    1e-4 * max(1, max|p|), bf16 rel-L2 <= 2e-2. ``zero``: the function is
    identically 0 (its plain value is rounding noise), so both dtypes take
    the fp32 gate, as no relative error exists."""
    import torch

    diff = got.float() - want.float()
    max_abs = float(diff.abs().max()) if diff.numel() else 0.0
    if dtype == torch.float32 or zero:
        limit = 1e-4 * max(1.0, float(want.float().abs().max()))
        return max_abs <= limit, max_abs, f"{label} max|k-p| {max_abs:.2e} (<= {limit:.1e})"
    rel = float(diff.norm() / want.float().norm().clamp_min(1e-30))
    return rel <= 2e-2, max_abs, f"{label} rel-L2 {rel:.2e} (<= 2e-2)"


def compare_flash(device) -> dict:
    """Phase 9: the three flash kernels against their plain versions (TF32
    off), fp32 and bf16, T in FLASH_TS, D in FLASH_DS, B=2 H=4; returns each
    kernel's largest |kernel - plain| in bf16."""
    import torch

    from mqgan_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq_plain, flash_attention_fwd,
        flash_attention_fwd_plain)

    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    errs = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for d in FLASH_DS:
            for t in FLASH_TS:
                q, k, v, do = (torch.randn((2, t, 4, d), generator=gen, device=device)
                               .to(dtype) for _ in range(4))
                scale = d ** -0.5
                o, lse = flash_attention_fwd(q, k, v, scale)
                dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, scale)
                torch.cuda.synchronize()
                o_p, lse_p = flash_attention_fwd_plain(q, k, v, scale)
                # the backward plain versions take the kernel's o and lse, so
                # each kernel is held on the same inputs
                dq_p = flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)
                dk_p, dv_p = flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, scale)
                checks = (("flash_fwd", "o", o, o_p), ("flash_fwd", "lse", lse, lse_p),
                          ("flash_bwd_dq", "dq", dq, dq_p),
                          ("flash_bwd_dkv", "dk", dk, dk_p),
                          ("flash_bwd_dkv", "dv", dv, dv_p))
                details, bad = [], []
                for kernel, label, got, want in checks:
                    # one key: softmax has no gradient, dq = dk = 0
                    zero = t == 1 and label in ("dq", "dk")
                    ok, max_abs, detail = _judge(label, got, want, dtype, zero)
                    details.append(detail)
                    if not ok:
                        bad.append(detail)
                    if dtype == torch.bfloat16:
                        errs[kernel] = max(errs[kernel], max_abs)
                print(f"  flash {str(dtype)[6:]:8s} D={d:3d} T={t:4d}: "
                      f"{'; '.join(details)} {'FAIL' if bad else 'ok'}")
                if bad:
                    fail(f"flash {dtype} D={d} T={t}: {bad}")
    return errs


def check_flash_determinism(device) -> None:
    """Phase 9b: the backward (flash_bwd_dq then flash_bwd_dkv) twice on
    the same inputs must give bit-identical dq, dk and dv: every output
    tile is written once by one block, with no atomics."""
    import torch

    from mqgan_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    for dtype in (torch.float32, torch.bfloat16):
        for d in FLASH_DS:
            for t in (129, 2047):
                q, k, v, do = (torch.randn((2, t, 4, d), generator=gen, device=device)
                               .to(dtype) for _ in range(4))
                scale = d ** -0.5
                o, lse = flash_attention_fwd(q, k, v, scale)
                first = flash_attention_bwd(q, k, v, o, lse, do, scale)
                second = flash_attention_bwd(q, k, v, o, lse, do, scale)
                torch.cuda.synchronize()
                same = [torch.equal(a, b) for a, b in zip(first, second)]
                print(f"  determinism {str(dtype)[6:]:8s} D={d:3d} T={t:4d}: "
                      f"dq, dk, dv bit-identical {same}")
                if not all(same):
                    fail(f"flash backward not deterministic: {dtype} D={d} T={t} {same}")


def serve(model, device, counters) -> dict:
    """Phase 4: concurrent clips through the micro-batching server."""
    from mqgan_tpu_torch.deploy.runtime import CodecRuntime
    from mqgan_tpu_torch.deploy.server import CodecServer

    runtime = CodecRuntime(model, buckets=BUCKETS, device=device)
    rng = np.random.default_rng(SEED + 3)
    clips = [rng.standard_normal((n, MELS)).astype(np.float32)
             for n in CLIP_LENGTHS]
    counters.reset()
    with CodecServer(runtime, max_batch=64, max_delay_ms=300.0) as srv:
        with ThreadPoolExecutor(len(clips)) as pool:
            futures = list(pool.map(srv.submit, clips))
        results = [f.result(timeout=600) for f in futures]
        stats = srv.stats.summary()
    launches = counters.snapshot()
    for clip, (idx, mel) in zip(clips, results):
        n = clip.shape[0]
        if idx.shape != (n,) or mel.shape != (n, MELS):
            fail(f"server result shapes {idx.shape} {mel.shape} for {n} frames")
        if idx.min() < 0 or idx.max() >= model.codebook_size:
            fail("server tokens out of [0, codebook_size)")
        if not np.isfinite(mel).all():
            fail("server mel output not finite")
    # a clip alone through the runtime gives the batched clip's tokens
    alone_idx, alone_mel = runtime.reencode(clips[0][None], [clips[0].shape[0]])
    if not np.array_equal(alone_idx[0], results[0][0]):
        fail("a clip's tokens depend on its batch")
    batches = stats["batches"]
    want = {"residual_block": 6 * batches, "fsq_head": batches,
            "mel_mixer": 2 * batches}
    print(f"  server: {stats}")
    print(f"  launches in the served run: {launches} (want {want})")
    if stats["mean_batch_size"] <= 1:
        fail("no micro-batching (mean_batch_size <= 1)")
    if launches != want:
        fail(f"launch counts {launches} != {want}")
    return launches


def throughput(model, device, counters, per_trip) -> float:
    """Phase 5: chained encode -> decode, tokens on the card."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    mels = [torch.randn((BENCH_B, BENCH_T, MELS), generator=gen, device=device)
            for _ in range(WARMUP + ITERS)]
    pad = torch.zeros((BENCH_B, BENCH_T), dtype=torch.bool, device=device)
    with torch.no_grad():
        for mel in mels[:WARMUP]:
            model.decode(model.encode(mel, pad), pad)
        torch.cuda.synchronize()
        counters.reset()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for mel in mels[WARMUP:]:
            out = model.decode(model.encode(mel, pad), pad)
        end.record()
        end.synchronize()
    if not bool(torch.isfinite(out).all()):
        fail("throughput output not finite")
    launches = counters.snapshot()
    want = {k: v * ITERS for k, v in per_trip.items()}
    if launches != want:
        fail(f"throughput launch counts {launches} != {want}")
    return BENCH_B * BENCH_T * ITERS / (start.elapsed_time(end) / 1e3)


KERNEL_GROUPS = (
    ("flash attention", ("flash_fwd", "flash_bwd")),
    ("residual_block", ("conv_gemm", "cbam_", "sam_stats")),
    ("mel_mixer", ("mel_mixer",)),
    ("fsq_head", ("fsq_head",)),
    ("log_mel", ("log_mel",)),
    ("fft (cuFFT)", ("fft",)),
    ("conv (cuDNN/cuBLAS)", ("conv", "gemm", "xmma", "cudnn", "sm90_", "cutlass",
                             "wgrad", "dgrad", "implicit", "nvjet")),
)


def _device_profile(fn):
    """(device events [(kernel name, ms)], wall ms) of one synchronised call
    of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: a CPU op also carries its kernels' time
    events = [(e.key, e.self_device_time_total / 1e3)
              for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return [(k, ms) for k, ms in events if ms > 0], wall_ms


def _report_profile(label, events, wall_ms, top=8) -> float:
    """Print device busy time, idle share, time by kernel group and the
    largest kernels; returns the busy ms (0.0: the profiler saw nothing)."""
    busy = sum(ms for _, ms in events)
    if busy == 0:
        print(f"  {label}: the profiler saw no device time (not measured)")
        return 0.0
    groups: dict = {}
    for key, ms in events:
        low = key.lower()
        group = next((g for g, subs in KERNEL_GROUPS
                      if any(s in low for s in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"  {label}: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle share {1 - busy / wall_ms:.3f}, profiler on)")
    for group, ms in sorted(groups.items(), key=lambda g: -g[1]):
        print(f"    {group:22s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%")
    for key, ms in sorted(events, key=lambda e: -e[1])[:top]:
        print(f"      {ms:9.3f} ms  {key[:90]}")
    return busy


def profile_round_trip(model, device, label: str) -> None:
    """Phase 5b: device time of one B=64, T=512 round trip by kernel group,
    from torch.profiler, and the share of the wall time the card was busy."""
    import torch

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    mel = torch.randn((BENCH_B, BENCH_T, MELS), generator=gen, device=device)
    pad = torch.zeros((BENCH_B, BENCH_T), dtype=torch.bool, device=device)
    _report_profile(label, *_device_profile(
        lambda: model.decode(model.encode(mel, pad), pad)))


def _write_wav(path, samples: np.ndarray, sr: int) -> None:
    import wave

    pcm = (np.clip(samples, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def convert_on_card(counters) -> None:
    """Phase 6: the convert CLI's library entry point with the front end on
    the card."""
    import tempfile

    from mqgan_tpu_torch.core.config import IOConfig, SpecConfig
    from mqgan_tpu_torch.signal import convert

    rng = np.random.default_rng(SEED + 8)
    # (sub-folder, name, seconds, rate): the 22.05 kHz clip is resampled,
    # the 0.5 s one gated out
    clips = [("a", "c0", 1.5, 44100), ("a", "c1", 2.0, 44100),
             ("a", "c2", 3.7, 44100), ("b", "c3", 6.0, 44100),
             ("b", "c4", 9.5, 44100), ("b", "c5", 15.0, 44100),
             ("b", "r22k", 4.0, 22050), ("a", "short", 0.5, 44100)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_convert_") as tmp:
        want = {}
        for sub, name, secs, sr in clips:
            os.makedirs(os.path.join(tmp, "wav", sub), exist_ok=True)
            n = int(round(secs * sr))
            t = np.arange(n) / sr
            x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 2000) * t)
            _write_wav(os.path.join(tmp, "wav", sub, f"{name}.wav"),
                       x + 0.05 * rng.standard_normal(n), sr)
            if secs >= 1.0:
                want[f"{sub}/{name}_mel.npy"] = (n * 44100 // sr) // 512 + 1

        def run(out, workers):
            cfg = SpecConfig(io=IOConfig(input_folder=os.path.join(tmp, "wav"),
                                         output_folder=os.path.join(tmp, out),
                                         audio_extensions=(".wav",)))
            convert.run(cfg, num_workers=workers, device="cuda")
            root = os.path.join(tmp, out)
            return {os.path.relpath(os.path.join(d, f), root): os.path.join(d, f)
                    for d, _, files in os.walk(root) for f in files}

        counters.reset()
        t0 = time.perf_counter()
        first = run("mels", 1)
        secs = time.perf_counter() - t0
        launches = counters.snapshot()
        if sorted(first) != sorted(want):
            fail(f"convert wrote {sorted(first)}, expected {sorted(want)}")
        for rel, path in first.items():
            mel = np.load(path)
            if mel.shape != (want[rel], MELS) or mel.dtype != np.float32 \
                    or not np.isfinite(mel).all():
                fail(f"convert {rel}: {mel.shape} {mel.dtype}, expected "
                     f"({want[rel]}, {MELS}) float32, finite")
        if launches != {"log_mel": len(want)}:
            fail(f"convert launches {launches}, expected log_mel {len(want)}")
        mtimes = {rel: os.path.getmtime(p) for rel, p in first.items()}
        counters.reset()
        run("mels", 1)
        if {rel: os.path.getmtime(p) for rel, p in first.items()} != mtimes \
                or counters.snapshot():
            fail("convert rerun touched a finished file")
        second = run("mels_2w", 2)
        if sorted(second) != sorted(want):
            fail(f"convert with 2 workers wrote {sorted(second)}")
        err = max(float(np.abs(np.load(second[r]) - np.load(first[r])).max())
                  for r in want)
        if err > 1e-6:
            fail(f"convert with 2 workers differs by {err:.3e}")
    print(f"  {len(want)} of {len(clips)} files written in {secs:.2f} s "
          f"(short clip gated, 22.05 kHz clip resampled), launches {launches}; "
          f"rerun skipped every file; 2 spawned workers: same files, max "
          f"diff {err:.1e}")


def _audio_batch(device, seed):
    """(AUDIO_B, AUDIO_SAMPLES) fp32: per clip three sines of random
    frequency and level plus noise, scaled to a peak of 0.3."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    t = torch.arange(AUDIO_SAMPLES, device=device) / 44100.0
    freq = 80.0 + 3920.0 * torch.rand((AUDIO_B, 3, 1), generator=gen, device=device)
    level = torch.rand((AUDIO_B, 3, 1), generator=gen, device=device)
    x = (level * torch.sin(2 * np.pi * freq * t)).sum(dim=1)
    x = x + 0.1 * torch.randn((AUDIO_B, AUDIO_SAMPLES), generator=gen, device=device)
    return 0.3 * x / x.abs().amax(dim=1, keepdim=True)


def audio_round_trip(model, device, counters, card) -> dict:
    """Phase 7: wav -> log-mel -> tokens -> refined mel -> wav at full width;
    returns the launch counts of one trip."""
    import torch

    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.models.istft_vocoder import (ISTFTNetGenerator,
                                                      build_vocoder_fe)
    from mqgan_tpu_torch.signal.griffin_lim import GriffinLimVocoder
    from mqgan_tpu_torch.signal.mel import MelFrontend
    from mqgan_tpu_torch.utils.init import seeded_init_

    cfg = SpectrogramConfig()
    frontend = MelFrontend(cfg, device=device)
    gen = seeded_init_(ISTFTNetGenerator(n_mels=MELS, dtype=torch.bfloat16),
                       SEED + 9).to(device).eval()
    vocoder = build_vocoder_fe(gen, cfg.hop_length // gen.total_upsample)
    pad = torch.zeros((AUDIO_B, BENCH_T), dtype=torch.bool, device=device)
    wavs = [_audio_batch(device, SEED + 10 + i) for i in range(AUDIO_ITERS + 1)]

    def codec(mel):
        return model.decode(model.encode(mel, pad), pad)

    def trip(wav):
        return vocoder(codec(frontend(wav)).transpose(1, 2))

    counters.reset()
    out = trip(wavs[0])
    torch.cuda.synchronize()
    launches = counters.snapshot()
    per_trip = {"log_mel": 1, "residual_block": 6, "fsq_head": 1, "mel_mixer": 2}
    n_out = (BENCH_T * gen.total_upsample - 1) * (cfg.hop_length // gen.total_upsample)
    print(f"  one trip: wav {tuple(wavs[0].shape)} -> {tuple(out.shape)}, "
          f"launches {launches}")
    if launches != per_trip:
        fail(f"audio round trip launches {launches} != {per_trip}")
    if tuple(out.shape) != (AUDIO_B, 1, n_out) or not bool(torch.isfinite(out).all()):
        fail(f"audio round trip output {tuple(out.shape)} (want {(AUDIO_B, 1, n_out)}) "
             f"or not finite")

    fe_ms = time_ms(lambda: [frontend(w) for w in wavs[1:]], 3) / AUDIO_ITERS
    trip_ms = time_ms(lambda: [trip(w) for w in wavs[1:]], 2) / AUDIO_ITERS
    audio_s = AUDIO_B * AUDIO_SAMPLES / cfg.sampling_rate
    print(f"  front end: {fe_ms:.3f} ms per batch, "
          f"{AUDIO_B * BENCH_T / (fe_ms / 1e3):.1f} mel-frames/s [{card}]")
    print(f"  wav -> wav: {trip_ms:.3f} ms per batch of {audio_s:.2f} s of "
          f"audio, {audio_s / (trip_ms / 1e3):.1f} audio-s/s [{card}]")

    post = codec(frontend(wavs[0])).float()
    GriffinLimVocoder(cfg, n_iter=1)(post)  # cuFFT plans
    gl = GriffinLimVocoder(cfg, n_iter=GL_ITERS)
    gl_ms = time_ms(lambda: gl(post), 3)
    gl_out = gl(post)
    if tuple(gl_out.shape) != (AUDIO_B, 1, AUDIO_SAMPLES) \
            or not bool(torch.isfinite(gl_out).all()):
        fail(f"Griffin-Lim output {tuple(gl_out.shape)} or not finite")
    print(f"  Griffin-Lim, {GL_ITERS} iterations on the {AUDIO_B} decoded mels: "
          f"{gl_ms:.3f} ms -> {tuple(gl_out.shape)} [{card}]")
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del gl_out, post

    print(f"[7b] where the time goes, one audio round trip [{card}]")
    events, wall = _device_profile(lambda: trip(wavs[1]))
    _report_profile("wav -> wav", events, wall, top=10)
    # the split: CUDA events between the stages of one trip
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    marks[0].record()
    mel = frontend(wavs[1])
    marks[1].record()
    post = codec(mel)
    marks[2].record()
    vocoder(post.transpose(1, 2))
    marks[3].record()
    marks[3].synchronize()
    total = marks[0].elapsed_time(marks[3])
    print(f"  split of one trip ({total:.3f} ms, CUDA events): " + ", ".join(
        f"{label} {marks[i].elapsed_time(marks[i + 1]):.3f} ms "
        f"({100 * marks[i].elapsed_time(marks[i + 1]) / total:.1f}%)"
        for i, label in enumerate(("front end", "codec", "vocoder"))))
    # kernel groups of each stage, profiled alone
    for label, fn in (("front end", lambda: frontend(wavs[1])),
                      ("codec", lambda: codec(mel)),
                      ("vocoder", lambda: vocoder(post.transpose(1, 2)))):
        _report_profile(label, *_device_profile(fn), top=4)
    return launches


class _KernelRow:
    """One kernel's times summed over its calls in a round trip; its bound
    is the sum over calls of max(ops time, bytes time)."""

    def __init__(self, name, source, replaces):
        self.name, self.source, self.replaces = name, source, replaces
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.ops_ms = self.bytes_ms = 0.0
        self.max_abs_err = 0.0  # kernel vs plain at these shapes, where checked
        self.library_ms = None  # one PyTorch call (or chain) of the same function

    def add(self, ms, plain_ms, ops, peak, nbytes) -> float:
        ops_ms, bytes_ms = 1e3 * ops / peak, 1e3 * nbytes / PEAK_BYTES
        self.ms += ms
        self.plain_ms += plain_ms
        self.ops_ms += ops_ms
        self.bytes_ms += bytes_ms
        self.bound_ms += max(ops_ms, bytes_ms)
        return max(ops_ms, bytes_ms)

    @property
    def bound_by(self) -> str:
        return "operations" if self.ops_ms >= self.bytes_ms else "bytes"


def kernel_times(model, device) -> list:
    """Phase 8: each kernel at its flagship shapes (B=64, T=512, bf16; the
    log-mel kernel fp32 on 64 clips of 512 frames), summed over its calls in
    one round trip. Bounds count each input byte read once and each output
    byte written once; the block's operations are its conv GEMMs at the bf16
    tensor-core peak, the mixer's and the FSQ head's are fp32 operations (a
    tanh counted as one) at the fp32 peak. The log-mel bound is that of the
    function: a real FFT of each frame (2.5 n log2 n), the magnitude, a
    multiply-add per nonzero of the filterbank (not F x n_mels), clamp and
    log, at the fp32 peak, against the waveform, window and the
    filterbank's nonzeros read and the log-mel written. The log-mel kernel
    is also held against its plain version in float64 at these shapes; it
    and the torch.stft chain are timed in bursts of 10 calls."""
    import torch

    from mqgan_tpu_torch.ops.block_kernels import (fused_residual_block,
                                                   residual_block_plain)
    from mqgan_tpu_torch.ops.fsq_kernels import (fsq_encode_head,
                                                 fsq_encode_plain)
    from mqgan_tpu_torch.ops.mixer_kernels import (fused_mel_mixer,
                                                   mel_mixer_plain)

    dt = torch.bfloat16
    b, t = BENCH_B, BENCH_T
    m = b * t
    lens = torch.full((b,), t, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    blk_row = _KernelRow("residual_block", "mqgan_tpu_torch/csrc/residual_block.cu",
                         "mqgan_tpu/ops/block_kernels.py:161")
    for name, blk in block_cases(model):
        cin, cout, k = blk.conv1.v.shape[1], blk.conv1.v.shape[0], blk.kernel_size
        x = torch.randn((b, t, cin), generator=gen, device=device).to(dt)
        wts = blk.kernel_weights(dt)
        ms = time_ms(lambda: fused_residual_block(x, lens, wts,
                                                  causal=blk.causal), 10)
        pms = time_ms(lambda: residual_block_plain(x, lens, wts,
                                                   causal=blk.causal), 3)
        macs = k * cin * cout + k * cout * cout + (cin * cout if cin != cout else 0)
        flops = 2.0 * m * macs
        bound = blk_row.add(ms, pms, flops, PEAK_BF16,
                            2.0 * (m * cin + m * cout + macs))
        print(f"  residual_block {name} {cin}->{cout} k{k}"
              f"{' causal' if blk.causal else ' CBAM'}: {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {bound:.4f} ms ({flops / 1e9:.1f} GFLOP)")

    mix_row = _KernelRow("mel_mixer", "mqgan_tpu_torch/csrc/mel_mixer.cu",
                         "mqgan_tpu/ops/mixer_kernels.py:92")
    for name, mixer in (("pre", model.pre), ("post", model.post)):
        c = model.proj.weight.shape[0]
        x = torch.randn((b, t, c), generator=gen, device=device).to(dt)
        wts = mixer.kernel_weights()
        p, k = wts.w1.shape[0], wts.dwk.shape[0]
        ms = time_ms(lambda: fused_mel_mixer(x, lens, wts), 5)
        pms = time_ms(lambda: mel_mixer_plain(x, lens, wts), 2)
        bound = mix_row.add(ms, pms, m * c * (2.0 * k * k + 6.0 * p), PEAK_FP32,
                            2.0 * 2 * m * c + 4.0 * (k * k + 3 * p + 4))
        print(f"  mel_mixer {name} C={c} P={p}: {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bound:.4f} ms ({m * c * p / 1e9:.2f} G tanh)")

    fsq_row = _KernelRow("fsq_head", "mqgan_tpu_torch/csrc/fsq_head.cu",
                         "mqgan_tpu/ops/fsq_kernels.py:84")
    c = model.q_in_proj.weight.shape[1]
    h = torch.randn((m, c), generator=gen, device=device).to(dt)
    w = model.q_in_proj.weight.float().t().contiguous()
    bias = model.q_in_proj.bias.float()
    d = w.shape[1]
    ms = time_ms(lambda: fsq_encode_head(h, w, bias, model.fsq_consts), 20)
    pms = time_ms(lambda: fsq_encode_plain(h, w, bias, model.fsq_consts), 5)
    bound = fsq_row.add(ms, pms, m * (2.0 * c * d + 8.0 * d), PEAK_FP32,
                        2.0 * m * c + 4.0 * m + 4.0 * (c * d + 6 * d))
    print(f"  fsq_head N={m} C={c}: {ms:.4f} ms, plain {pms:.4f} ms, "
          f"bound {bound:.4f} ms")

    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel,
                                                  log_mel_dft, log_mel_plain,
                                                  log_mel_tables)
    from mqgan_tpu_torch.signal.stft import hann_window

    mel_row = _KernelRow("log_mel", "mqgan_tpu_torch/csrc/log_mel.cu",
                         "mqgan_tpu/ops/stft_kernels.py:95")
    cfg = SpectrogramConfig()
    hop, n_fft, n_freq, n_mels = (cfg.hop_length, cfg.filter_length,
                                  cfg.n_freqs, cfg.n_mel_channels)
    tables = log_mel_tables(cfg, device)
    cos, sin, fbank = (x.to(device) for x in dft_mel_tables(cfg))
    wav = _audio_batch(device, SEED + 5)
    n = AUDIO_B * (AUDIO_SAMPLES // hop + 1)
    window = hann_window(cfg.win_length, device=device)
    # Against the plain version in float64, the function up to float64
    # rounding. In fp32 no algorithm reaches 1e-4 in the log domain at every
    # entry of this batch: a mel over one or two bins whose magnitude lies
    # in the noise's Rayleigh tail (a few 1e-6 of its frame's mel sum) takes
    # an fp32 rounding of the frame's loud bins as a relative error near
    # 1e-4 (the fp32 plain DFT's error there is larger). So the kernel must
    # be within 1e-4 of the function, or at least as close as the plain
    # version in fp32.
    ref = log_mel_plain(wav, *(x.to(device) for x in dft_mel_tables(cfg, np.float64)), hop)
    got = log_mel(wav, tables)
    plain = log_mel_plain(wav, cos, sin, fbank, hop)
    chain = log_mel_library(wav, window, fbank, n_fft, hop, cfg.win_length)
    dft = log_mel_dft(wav, cos, sin, fbank, hop)
    err, plain_err, chain_err = (float((x - ref).abs().max()) for x in (got, plain, chain))
    gaps = [float((x - got).abs().max()) for x in (plain, chain, dft)]
    limit = max(1e-4, plain_err)
    print(f"  log_mel at B={AUDIO_B} x {AUDIO_SAMPLES} against the float64 plain "
          f"version: max|k-p64| {err:.3e} (limit {limit:.3e} = max(1e-4, the fp32 "
          f"plain's {plain_err:.3e})) {'ok' if err <= limit else 'FAIL'}; not gated: "
          f"max|chain-p64| {chain_err:.3e}, max|k-p| {gaps[0]:.3e} (fp32 plain), "
          f"max|chain-k| {gaps[1]:.3e}, max|DFT kernel-k| {gaps[2]:.3e}")
    del got, plain, chain, dft, ref
    if not err <= limit:
        fail(f"log_mel at B={AUDIO_B}: max|k-p64| {err:.3e} > {limit:.3e}")
    mel_row.max_abs_err = err
    ms = time_ms(lambda: log_mel(wav, tables), 10, inner=10)
    dft_ms = time_ms(lambda: log_mel_dft(wav, cos, sin, fbank, hop), 5)
    pms = time_ms(lambda: log_mel_plain(wav, cos, sin, fbank, hop), 3)
    mel_row.library_ms = time_ms(lambda: log_mel_library(
        wav, window, fbank, n_fft, hop, cfg.win_length), 10, inner=10)
    # the function's work: a real FFT of each frame, |.| (two products, a
    # sum, a sqrt), the filterbank's nonzeros (a multiply-add each), clamp
    # and log; a dense count of the mel product (F x n_mels) is printed too
    nnz = int((fbank != 0).sum())
    fft_flops = 2.5 * n * n_fft * math.log2(n_fft) + 4.0 * n * n_freq + 2.0 * n * n_mels
    flops = fft_flops + 2.0 * n * nnz
    dense_flops = fft_flops + 2.0 * n * n_freq * n_mels
    nbytes = 4.0 * (wav.numel() + cfg.win_length + nnz + n * n_mels)
    bound = mel_row.add(ms, pms, flops, PEAK_FP32, nbytes)
    print(f"  log_mel N={n} n_fft={n_fft} F={n_freq} mels={n_mels}: {ms:.4f} ms "
          f"(roofline share {bound / ms:.3f}), the DFT kernel {dft_ms:.4f} ms, plain "
          f"{pms:.4f} ms, torch.stft chain {mel_row.library_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({mel_row.bound_by}: {flops / 1e9:.2f} GFLOP counting the "
          f"filterbank's {nnz} nonzeros, {dense_flops / 1e9:.2f} counting F x n_mels "
          f"= {n_freq * n_mels} densely; {nbytes / 1e6:.1f} MB)")
    return [blk_row, mix_row, fsq_row, mel_row]


def lm_model(device, dtype, route: str, dropout: float = 0.0):
    """The flagship MusicTransformer (seeded) with its attention routed
    through the flash kernels ("kernels"), the naive materialised scores
    ("plain") or torch's scaled_dot_product_attention ("sdpa": the library
    yardstick, defined here; the port never calls it)."""
    import types

    import torch.nn.functional as F

    from mqgan_tpu_torch.models.token_transformer import MusicTransformer
    from mqgan_tpu_torch.utils.init import seeded_init_

    def sdpa_attend(self, q, k, v):
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=q.shape[-1] ** -0.5)
        return out.transpose(1, 2)

    model = MusicTransformer(**LM, dropout=dropout, flash=route == "kernels",
                             dtype=dtype)
    seeded_init_(model, SEED + 12)
    if route == "sdpa":
        for blk in model.blocks:
            blk.attn.attend = types.MethodType(sdpa_attend, blk.attn)
    return model.to(device)


def lm_batch(device, b: int, length: int, seed: int):
    """(tokens (b, length) with BOS first, genres (b,), lengths (b,))."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    tokens = torch.randint(2, LM["vocab_size"], (b, length), generator=gen,
                           device=device)
    tokens[:, 0] = 1
    genres = torch.randint(0, LM["num_genres"], (b,), generator=gen, device=device)
    return tokens, genres, torch.full((b,), length, device=device)


def compare_lm_step(device) -> None:
    """Phase 10a: one fp32 train step of the flagship-width transformer on
    the card through the kernels against the same step on the CPU through
    the plain attention (B=2, L=300, one row padded from 200): loss within
    1e-5 * max(1, |loss|), every gradient within 1e-4 * max(1, max|g|)."""
    import torch

    from mqgan_tpu_torch.models.music_lstm import masked_ce_loss
    from mqgan_tpu_torch.train.lstm_trainer import ClipAdamW, make_lstm_step

    tokens, genres, lengths = lm_batch("cpu", 2, 300, SEED + 13)
    tokens[1, 200:] = 0
    lengths[1] = 200
    cpu = lm_model("cpu", None, "kernels")
    card = lm_model(device, None, "kernels")
    card.load_state_dict(cpu.state_dict())
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, device)):
        logits = model(tokens[:, :-1].to(dev), genres.to(dev))
        loss, _ = masked_ce_loss(logits, tokens[:, 1:].to(dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        out[name] = (float(loss.detach()), [g.cpu() for g in grads])
    loss_err = abs(out["card"][0] - out["cpu"][0])
    g_err = max(float((a - b).abs().max()) for a, b in zip(out["card"][1], out["cpu"][1]))
    g_max = max(float(b.abs().max()) for b in out["cpu"][1])
    ok = loss_err <= 1e-5 * max(1.0, abs(out["cpu"][0])) and g_err <= 1e-4 * max(1.0, g_max)
    # then the trainer's whole step on both (AdamW moves every coordinate by
    # about lr, so a gradient that is 0 up to rounding can move apart: the
    # largest parameter difference is reported, not gated)
    stepped = []
    for model, dev in ((cpu, "cpu"), (card, device)):
        tx = ClipAdamW(1e-3)
        step = make_lstm_step(model, tx, 0, train=True)
        loss = step(tx.init(model.parameters()), tokens.to(dev), genres.to(dev),
                    lengths.to(dev), torch.Generator().manual_seed(0))
        stepped.append((float(loss), torch.cat([p.detach().cpu().flatten()
                                                for p in model.parameters()])))
    p_err = float((stepped[0][1] - stepped[1][1]).abs().max())
    print(f"  fp32 step, flagship width, B=2 L=300: loss card {out['card'][0]:.6f} "
          f"cpu {out['cpu'][0]:.6f} (|d| {loss_err:.2e}), max|dgrad| {g_err:.2e} "
          f"(max|g| {g_max:.2e}) {'ok' if ok else 'FAIL'}; after the AdamW step "
          f"max|dparam| {p_err:.2e}")
    if not ok or not math.isfinite(stepped[1][0]):
        fail("fp32 LM step on the card disagrees with the CPU plain path")


def _write_chunks(root, n: int, length: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "chunks"))
    mapping = {}
    for i in range(n):
        name = f"c{i:03d}.npy"
        np.save(os.path.join(root, "chunks", name),
                rng.integers(2, LM["vocab_size"], length).astype(np.int32))
        mapping[name] = int(i % LM["num_genres"])
    path = os.path.join(root, "fname_to_id.json")
    with open(path, "w") as f:
        json.dump(mapping, f)
    return path


def lm_trainer_cli(counters, device) -> dict:
    """Phase 10b, the slice's main path: the trainer CLI (--arch transformer
    --flash_lm --bf16, flagship defaults) for one epoch over LM_CHUNKS chunks
    of 2047 tokens (input T = 2047): LM_CHUNKS - 2 train rows in steps of 8,
    2 val rows; 6 launches of each flash kernel per train step, 6 forward
    launches per val step. Returns the launch counts."""
    import tempfile

    from mqgan_tpu_torch.train import lstm_trainer

    n_val = max(1, int(0.1 * LM_CHUNKS))
    steps = -(-(LM_CHUNKS - n_val) // 8)
    want = {"flash_fwd": 6 * (steps + 1), "flash_bwd_dq": 6 * steps,
            "flash_bwd_dkv": 6 * steps}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        mapping = _write_chunks(tmp, LM_CHUNKS, 2047, SEED + 14)
        out = os.path.join(tmp, "run")
        counters.reset()
        t0 = time.perf_counter()
        lstm_trainer.main([
            "--chunks_dir", os.path.join(tmp, "chunks"), "--mapping_json", mapping,
            "--vocab_size", str(LM["vocab_size"]), "--num_genres", str(LM["num_genres"]),
            "--arch", "transformer", "--flash_lm", "--bf16", "--batch_size", "8",
            "--epochs", "1", "--log_every", "1", "--out_dir", out, "--device", str(device)])
        secs = time.perf_counter() - t0
        launches = counters.snapshot()
        with open(os.path.join(out, "best.json")) as f:
            best = json.load(f)
    print(f"  trainer CLI: {steps} train + 1 val steps at B=8 L=2048 in {secs:.2f} s "
          f"(set-up included), val loss {best['val_loss']:.4f}; launches {launches} "
          f"(want {want})")
    if launches != want:
        fail(f"trainer launches {launches} != {want}")
    if not math.isfinite(best["val_loss"]):
        fail("trainer val loss not finite")
    return launches


def lm_throughput(device, counters, card) -> None:
    """Phase 10c: training tokens/s, B * (L - 1) per step, bf16, dropout
    0.1, at B=8 L=2048 and B=4 L=4096, through the kernels, the plain
    attention and the SDPA yardstick; peak device memory of each."""
    import torch

    from mqgan_tpu_torch.train.lstm_trainer import ClipAdamW, make_lstm_step

    for b, length in LM_SHAPES:
        for route in ("kernels", "plain", "sdpa"):
            model = lm_model(device, torch.bfloat16, route, dropout=0.1)
            tx = ClipAdamW(1e-3)
            state = tx.init(model.parameters())
            step = make_lstm_step(model, tx, 0, train=True)
            gen = torch.Generator().manual_seed(SEED)
            data = [lm_batch(device, b, length, SEED + 20 + i)
                    for i in range(LM_ITERS + 1)]
            counters.reset()
            step(state, *data[0], gen)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: [step(state, *d, gen) for d in data[1:]], 1) / LM_ITERS
            peak = torch.cuda.max_memory_allocated() / 1e9
            launches = counters.snapshot()
            print(f"  B={b} L={length} {route:8s}: {ms:9.3f} ms/step, "
                  f"{b * (length - 1) / (ms / 1e3):12.1f} tokens/s, peak {peak:6.2f} GB "
                  f"[{card}]")
            n = LM_ITERS + 1
            want = ({"flash_fwd": 6 * n, "flash_bwd_dq": 6 * n, "flash_bwd_dkv": 6 * n}
                    if route == "kernels" else {})
            if launches != want:
                fail(f"{route} launches {launches} != {want}")
            if route == "kernels" and (b, length) == LM_SHAPES[0]:
                print(f"[10d] where the time goes, one training step B={b} "
                      f"L={length} through the kernels [{card}]")
                busy = _report_profile("train step", *_device_profile(
                    lambda: step(state, *data[1], gen)), top=10)
                print(f"  device busy {busy:.3f} ms against the unprofiled "
                      f"{ms:.3f} ms step: idle share {1 - busy / ms:.3f}")
            del model, state, step, data
            torch.cuda.empty_cache()


def lstm_step(device, card) -> None:
    """Phase 10e: one --arch lstm train step at flagship width (emb 512, 2
    layers of 1024, fp32, the trainer's default) at B=8, L=2048."""
    import torch

    from mqgan_tpu_torch.models.token_lm import build_token_lm
    from mqgan_tpu_torch.train.lstm_trainer import ClipAdamW, make_lstm_step
    from mqgan_tpu_torch.utils.init import seeded_init_

    model = build_token_lm(dict(LM, arch="lstm", lstm_hid=1024, lstm_layers=2,
                                pad_id=0), dropout=0.1)
    model = seeded_init_(model, SEED + 15).to(device)
    before = torch.cat([p.detach().flatten() for p in model.parameters()])
    tx = ClipAdamW(1e-3)
    state = tx.init(model.parameters())
    step = make_lstm_step(model, tx, 0, train=True)
    gen = torch.Generator().manual_seed(SEED)
    data = [lm_batch(device, 8, 2048, SEED + 30 + i) for i in range(2)]
    losses = [float(step(state, *data[0], gen))]
    t0 = time.perf_counter()
    losses.append(float(step(state, *data[1], gen)))
    secs = time.perf_counter() - t0
    moved = float((torch.cat([p.detach().flatten() for p in model.parameters()])
                   - before).abs().max())
    print(f"  lstm step B=8 L=2048 fp32: losses {losses[0]:.4f}, {losses[1]:.4f}; "
          f"{secs:.3f} s for the second step ({8 * 2047 / secs:.1f} tokens/s), "
          f"parameters moved up to {moved:.2e} [{card}]")
    if not all(math.isfinite(x) for x in losses) or int(state["count"]) != 2 or moved == 0:
        fail("lstm step did not train")


def flash_times(device, errs) -> list:
    """Phase 11: the three flash kernels at the flagship layer call (B=8,
    H=8, T=2047, D=64, bf16), first held against their plain versions
    there. Bounds are the function's: a product of the causal pairs is
    2*B*H*D*T(T+1)/2 FLOP; the forward does 2, the backward of the function
    5 (S, dP, dV, dK, dQ), of which the dQ row is charged dQ and one of the
    two shared recomputations, the dK/dV row dV, dK and the other (the
    kernels' split does 7 in all); at the bf16 peak, against each input
    read once and each output written once. Library: SDPA forward, and
    SDPA's backward (which computes dq, dk and dv together) for both
    backward rows. Beside the charged rate, each kernel's rate on the
    products it does: 2 (forward), 3 (dQ: S, dP, dQ), 4 (dK/dV: S, dP, dV,
    dK). The times in the kernels line (ms, library_ms) are single calls,
    which count the host's work per call (checks, allocation, autograd)
    where the card waits on it; beside each the time per call in bursts of
    FLASH_BURST calls is printed, where that work hides behind the card's."""
    import torch
    import torch.nn.functional as F

    from mqgan_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
        flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
        flash_attention_fwd, flash_attention_fwd_plain)

    b, t, h, d = 8, 2047, 8, 64
    scale = d ** -0.5
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    q, k, v, do = (torch.randn((b, t, h, d), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = flash_attention_fwd(q, k, v, scale)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    plain = {"o": flash_attention_fwd_plain(q, k, v, scale)[0],
             "dq": flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale)}
    plain["dk"], plain["dv"] = flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, scale)
    names = {"o": "flash_fwd", "dq": "flash_bwd_dq", "dk": "flash_bwd_dkv",
             "dv": "flash_bwd_dkv"}
    for label, got in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        ok, max_abs, detail = _judge(label, got, plain[label], torch.bfloat16)
        print(f"  at B={b} T={t} H={h} D={d} bf16: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash at the flagship shape: {detail}")
        errs[names[label]] = max(errs[names[label]], max_abs)
    del plain

    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    with torch.enable_grad():
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, scale=scale)
        sdpa = {"forward": lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale),
                "backward": lambda: torch.autograd.grad(
                    out, (qg, kg, vg), dot, retain_graph=True)}
        lib_ms = {key: time_ms(fn, 20) for key, fn in sdpa.items()}
        lib_burst = {key: time_ms(fn, 10, FLASH_BURST) for key, fn in sdpa.items()}
    prod = 2.0 * b * h * d * t * (t + 1) / 2
    elems = b * t * h * d  # one (B, T, H, D) bf16 tensor: 2 bytes each
    stats = 4.0 * b * h * t  # one (B, H, T) fp32 vector
    rows = []
    for name, fn, plain_fn, n_prod, n_done, nbytes, lib in (
            ("flash_fwd", lambda: flash_attention_fwd(q, k, v, scale),
             lambda: flash_attention_fwd_plain(q, k, v, scale), 2, 2,
             2.0 * 4 * elems + stats, "forward"),
            ("flash_bwd_dq", lambda: flash_attention_bwd_dq(q, k, v, o, lse, do, scale),
             lambda: flash_attention_bwd_dq_plain(q, k, v, o, lse, do, scale), 2, 3,
             2.0 * 6 * elems + 2 * stats, "backward"),
            ("flash_bwd_dkv", lambda: flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale),
             lambda: flash_attention_bwd_dkv_plain(q, k, v, o, lse, do, scale), 3, 4,
             2.0 * 6 * elems + 2 * stats, "backward")):
        row = _KernelRow(name, "mqgan_tpu_torch/csrc/flash_attention.cu", FLASH_REPLACES[name])
        ms = time_ms(fn, 20)
        burst = time_ms(fn, 10, FLASH_BURST)
        pms = time_ms(plain_fn, 3)
        bound = row.add(ms, pms, n_prod * prod, PEAK_BF16, nbytes)
        row.library_ms = lib_ms[lib]
        print(f"  {name:14s}: {ms:.4f} ms (bursts {burst:.4f}), plain "
              f"{pms:.4f} ms, bound {bound:.4f} ms ({n_prod * prod / 1e9:.1f} GFLOP "
              f"charged, {n_prod * prod / ms / 1e9:.1f} TFLOP/s; {n_done} products "
              f"done, {n_done * prod / 1e9:.1f} GFLOP, {n_done * prod / ms / 1e9:.1f} "
              f"TFLOP/s (bursts {n_done * prod / burst / 1e9:.1f})), SDPA {lib} "
              f"{lib_ms[lib]:.4f} ms (bursts {lib_burst[lib]:.4f})")
        rows.append(row)
    return rows


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from mqgan_tpu_torch.ops import _cuda
    except ImportError as e:
        fail(f"run from the root of a checkout of the repo ({e})")
    torch.set_grad_enabled(False)
    t_start = time.perf_counter()
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] card: {card} ({torch.cuda.device_count()} visible); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    _cuda.LIBRARY.load()
    print(f"[2] kernels built in {_cuda.LIBRARY.build_seconds:.1f} s")
    print(_cuda.ptxas_report())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(device, torch.bfloat16)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    print(f"[3] kernels vs plain versions, B={CMP_B} T={CMP_T} "
          f"lengths {CMP_LENGTHS}")
    errs = compare_kernels(model, device, CMP_B, CMP_T, CMP_LENGTHS,
                           (torch.float32, torch.bfloat16))
    errs["log_mel"] = compare_log_mel(device)
    compare_round_trip(state, device)

    counters = _cuda.COUNTERS
    print("[4] serving (bf16, exact mixers)")
    launches = serve(model, device, counters)
    per_batch = {"residual_block": 6, "fsq_head": 1, "mel_mixer": 2}

    print(f"[5] round-trip throughput, B={BENCH_B} T={BENCH_T} bf16 "
          f"[{card}]")
    torch.cuda.reset_peak_memory_stats()
    exact = throughput(model, device, counters, per_batch)
    poly = build_model(device, torch.bfloat16, poly_mixers="decode", state=state)
    poly_fps = throughput(poly, device, counters, dict(per_batch, mel_mixer=1))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  exact mixers: {exact:.1f} mel-frames/s")
    print(f"  poly-decode mixers: {poly_fps:.1f} mel-frames/s")
    print(f"  peak device memory {peak_gb:.2f} GB")
    print(f"[5b] where the time goes, one round trip B={BENCH_B} T={BENCH_T} "
          f"bf16 [{card}]")
    profile_round_trip(model, device, "exact")
    profile_round_trip(poly, device, "poly-decode")
    del poly

    print("[6] convert on the card (hifispeech spec)")
    convert_on_card(counters)

    print(f"[7] audio round trip, {AUDIO_B} clips x {AUDIO_SAMPLES} samples, "
          f"codec bf16 exact mixers, ISTFTNetGenerator() bf16 [{card}]")
    torch.cuda.reset_peak_memory_stats()
    launches.update(log_mel=audio_round_trip(model, device, counters, card)["log_mel"])

    print(f"[8] kernel times at B={BENCH_B} T={BENCH_T} [{card}]")
    rows = kernel_times(model, device)
    del model
    torch.cuda.empty_cache()

    print(f"[9] flash-attention kernels vs plain versions, T {FLASH_TS}, "
          f"D {FLASH_DS}, B=2 H=4")
    errs.update(compare_flash(device))
    print("[9b] flash backward run twice: bit-identical dq, dk, dv")
    check_flash_determinism(device)
    with torch.enable_grad():
        print("[10] token-LM training slice (MusicTransformer flagship width)")
        compare_lm_step(device)
        launches.update(lm_trainer_cli(counters, device))
        print(f"[10c] training throughput, bf16 [{card}]")
        lm_throughput(device, counters, card)
        print(f"[10e] --arch lstm [{card}]")
        lstm_step(device, card)
    print(f"[11] flash kernel times at the flagship layer call [{card}]")
    rows += flash_times(device, errs)
    kernels = []
    for row in rows:
        kernels.append({
            "name": row.name, "route": "cuda", "source": row.source,
            "replaces": row.replaces, "launches": launches.get(row.name, 0),
            "max_abs_err": max(errs[row.name], row.max_abs_err),
            "ms": row.ms, "plain_ms": row.plain_ms, "bound_ms": row.bound_ms,
            "bound_by": row.bound_by, "library_ms": row.library_ms,
        })
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
