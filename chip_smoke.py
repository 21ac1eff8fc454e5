#!/usr/bin/env python3
"""Drive the PyTorch port's codec serving path, its audio path, its
token-LM training path, its token-LM serving path, its codec deployment
path and its codec training path on one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --fsq-head-of DIR   # time another checkout's FSQ head

Run from the root of a checkout. It needs one CUDA card and exits non-zero,
printing no result, without one. Phases (any failure exits non-zero):

 1. check the card; print its name and power limit (nvidia-smi);
 2. build the hand-written CUDA kernels from mqgan_tpu_torch/csrc (nvcc,
    sm_90a) and print the build time, the ptxas register report and a
    summary of registers and spills of the mma.sync kernels
    (flash_fwd_mma, flash_bwd_dq_mma, flash_bwd_dkv_mma per head size,
    conv_gemm_mma) and of the mixer kernels (the exact kernel per dtype and
    tap count, the Chebyshev mode's five kernels), and, from
    cuobjdump -sass of the built library, the MUFU, FP32 and other
    instructions per evaluation in the mixers' inner loops;
 3. hold each kernel against its plain PyTorch version on the same inputs,
    at the flagship widths (all six residual-block configurations, both
    mel-mixers with padded rows bit for bit b_out, the FSQ head), B=8,
    T=512, ragged lengths: fp32 with TF32
    off (max|k - p| <= 1e-4 * max(1, max|p|)) and bf16 (||k - p|| / ||p||
    <= 2e-2); FSQ indices may differ only where the plain pre-round value
    lies within 1e-4 of a rounding midpoint; the FSQ head also at N = 1,
    4,099 and 32,768 rows, on rows that are not 16-byte aligned (its
    scalar-load instantiation) and with d = 1, 3 and 8 code dims. The same
    for the hifimusic
    generator (160 mels, channels 384/384/512/512, refiner 96: its six
    blocks, two mixers and FSQ head), and for blocks whose widths and B*T
    are not multiples of the conv GEMM's 128 x 128 tile (24 -> 40 k7
    causal and k5 CBAM at B=3 T=77, 40 -> 136 k3 causal at B=2 T=130,
    136 -> 24 k1 CBAM at B=5 T=29), fp32 and bf16. The Chebyshev kernel
    (mel_mixer_poly: the conv and min/max, the fit, the Clenshaw pass)
    against the plain poly_mixer_plain on the flagship and hifimusic
    (P = 384) post mixers, fp32 and bf16, ragged lengths and a plane of
    equal values, and on the flagship post mixer at the main path's B=64
    T=512 with ragged lengths (one of 1), padded rows bit for bit b2, one
    launch a call. Phase 3c:
    FSQ tokens at B=64 T=512 through the pre mixer's kernel against the
    plain pre mixer, beside a control (the plain mixer summing its P units in
    another order): fp32 tokens equal away from midpoints; bf16 output
    equal to the kernel's fp32 arithmetic rounded once, and no more than 1.5x
    the control's tokens differing away from a midpoint. The log-mel kernels in fp32
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
    mixers (poly-decode: one mel_mixer and one mel_mixer_poly launch a
    trip, the main path of the Chebyshev kernel); then profile one round
    trip of each (torch.profiler): device time by kernel group and the
    card's idle share;
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
    bound (each block also with its conv GEMMs' TFLOP/s and, as a yardstick
    outside the kernels line, the same convs through cuDNN's bf16
    conv1d; the exact mixer with its clocks per evaluation per SM at the
    card's maximum SM clock; the Chebyshev mode, one call of five kernel
    launches, also in bursts) and,
    for the log-mel kernel, the torch.stft chain that computes the same
    function and the DFT kernel (the earlier design, now the route for
    other n_fft), and print one JSON line of them; the log-mel kernel is
    first held against its plain version in float64 at that batch (64
    clips; max|k - p64| <= 1e-4, or no more than the fp32 plain version's
    own error, since fp32 rounding reaches ~1e-4 in the log domain at
    near-silent single-bin mels), and its bound is the function's: an FFT
    per frame and the filterbank's nonzeros, not F x n_mels; the FSQ head
    in single calls, in bursts of 10 and by the profiler's kernel time,
    each with its GB/s;
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
    step at flagship width; the trainer's run dir is phase 12's
    transformer;
11. time the flash kernels at the flagship layer call (B=8, H=8, T=2047,
    D=64, bf16) beside their plain versions, their bounds (the function's
    operations) and SDPA's forward and backward, after holding them against
    the plain versions there, and each kernel's rate on the products it
    does (2 forward, 3 dQ, 4 dK/dV) beside the charged bound; kernels and
    SDPA are timed in single calls (the kernels line) and in bursts of 10
    calls (printed beside); print the kernels JSON line (nine rows: the
    DFT log-mel kernel's launches are phase 3's, the front end at n_fft
    1200 and 1000, the only path that selects it);
12. token-LM serving at the flagship widths, on the card (the transformer
    of phase 10b's run, fp32; an LSTM run dir of the trainer's format with
    seeded weights): (a) prefill (B=8, per-row prompt ends) and 16
    step_rows logits against the CPU within 1e-4 * max(1, max|logit|);
    (b) top_k = 1 served tokens, each the CPU's argmax on the card's own
    stream or within twice that of it (a near-tie), both archs; (c) the
    key chain's uniforms bit-equal on CPU and card; (d) LMHTTPServer on
    localhost: 12 concurrent /generate requests (mixed genres, prompt
    lengths 0-200, n 1-4, length 512, two groups of sampling knobs):
    shapes, token range, mean batch size > 1,
    /healthz, and no kernel launch (the decode path has none); (e) at an
    equal dispatch width a row's tokens do not depend on its position or
    neighbours (gated), and the rows served alone that differ from the same
    rows coalesced are printed, with the first step where each does (fp32
    and bf16 KV, LSTM); (f) decode at B=64, prompt 0, L=512: ms/token,
    tokens/s and the device's idle share at L=32 (fp32 KV, bf16 KV, LSTM);
13. codec deployment at flagship width, seeded weights. First its kernels
    against their plain versions at the path's own shapes, fp32 and bf16 at
    phase 3's gates: B=1 T=1024 (a streaming span, full and a short last
    one) and B=7 T=1024 with ragged lengths (a server or re-encode batch at
    the largest bucket): the six blocks, both exact mixers, the FSQ head,
    and the Chebyshev kernel on the post mixer and on the pre mixer (poly
    "encode"/True). Then the path (counts reset just before, read just
    after; residual_block, mel_mixer, mel_mixer_poly and fsq_head must
    launch, log-mel and flash must not): (a) three exports
    through the export CLI at buckets 128/256/512/1024 (bf16 poly-decode,
    the CLI default; fp32 exact and fp32 poly both, re-exported from the
    first's manifest and weights.pt), each verified and reloaded with
    ExportedPreEncoder(dir) on the card; the fp32 artifact's round trip
    equals the in-memory model (tokens away from midpoints, mel within
    1e-4 * max(1, max|x|)); the flips of poly both are counted; (b) the
    re-encode CLI over 16 mels of 100-3000 frames (two chunked) through
    the fp32 and the bf16 artifacts with mel-frames/s: files within one
    bucket give a direct encode's tokens, the chunked files' dumped tokens
    decoded through the chunk plan equal one full-length decode; (c)
    token_stats on the dump; (d) StreamingDecoder (2,000 tokens in chunks
    of 37, window 1024) equal to the offline decode, StreamingEncoder
    equal to an offline pass over its windows, ms per B=1 span and a
    profile of one; (e) StreamingHTTPServer on localhost: 12 concurrent
    CodecClient clips and 2 duplex streams equal to direct runtime calls,
    each op's mean batch size > 1. After the counts are read, one B=2
    window of the bf16 poly-decode artifact against a CPU copy of its model
    (the plain versions): the encoder trunk and the decode at the bf16 gate
    (rel-L2 <= 2e-2), token flips counted;
14. codec GAN training at flagship width (TrainConfig(): the
    hifispeech config), TF32 off: (a) one fp32 warmup step and one fp32
    GAN + feature-matching step on the card against the same steps on the
    CPU, B=2 T=128, dropout inert, the discriminators' lr 0 (the G loss
    runs through the updated discriminators, where Adam's +-lr moves of
    rounding-level gradients would show): losses within 1e-5 * max(1,
    |loss|), gradients within 1e-4 * max(1, max|g|) per model; (b) the
    generator's training-branch forward against its eval forward through
    the kernels, B=16 T=256 fp32 ragged: tokens equal away from midpoints,
    recon_post within 2e-4 * max(1, max|x|); (c) the trainer CLI (bf16,
    fast dropout) on 96 seeded mels of 150-1500 frames, batch 16, crops
    256/192/128, epoch 1 warmup and epoch 2 GAN, eval and save every
    epoch (counts reset just before, read just after): finite losses in
    both phases, no kernel launch inside a train step, 6 residual_block,
    2 mel_mixer and 1 fsq_head launches per eval batch; a third epoch
    resumes from the checkpoint; the trained generator, saved and
    exported (fp32, exact mixers), round-trips through ExportedPreEncoder
    as the in-memory model does (tokens away from midpoints, mel within
    1e-4 * max(1, max|x|)); (d) ms/step, trained mel-frames/s (B*T per
    step) and peak memory of the warmup and the GAN step at B=16 T=256
    bf16 for fast and exact dropout, --remat and grad_accum 2 (2 warm-up,
    5 timed steps, CUDA events); (e) a profile of one fast-dropout GAN
    step: kernel groups, elementwise and optimizer kernels, the device
    span of each part of the step (gan/* ranges) and the idle share;
15. print {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import shutil
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SEED = 0
MELS = 128
BUCKETS = (128, 256, 512)
CMP_B, CMP_T = 8, 512
CMP_LENGTHS = (512, 480, 300, 257, 128, 77, 5, 1)
CLIP_LENGTHS = (100, 117, 128, 140, 201, 256, 300, 384, 450, 500, 512, 333)
# blocks off the conv GEMM's 128 x 128 tile: (Cin, Cout, k, causal, B, T,
# lengths)
RAGGED_BLOCKS = ((24, 40, 7, True, 3, 77, (77, 60, 1)),
                 (24, 40, 5, False, 3, 77, (77, 60, 1)),
                 (40, 136, 3, True, 2, 130, (130, 3)),
                 (136, 24, 1, False, 5, 29, (29, 28, 1, 17, 5)))
# the hifimusic generator, configs/model_config_hifimusic.yaml:14-35 written
# out (the card's machine has no PyYAML)
HIFIMUSIC = dict(mels=160, channels=(384, 384, 512, 512), kernel_sizes=(3, 3, 5, 7),
                 fsq_levels=(8, 5, 5, 5), refiner_base_channels=96, refiner_depth=3,
                 refiner_hidden_proj_divisor=8)
BENCH_B, BENCH_T = 64, 512
# phase 3: the FSQ head at a row count off the 8 rows a warp reduces together
FSQ_RAGGED_N = 4099
# phase 3c, bf16: the pre mixer's kernel may flip at most this many times
# the FSQ tokens (away from a midpoint) that the plain mixer summed in
# another order flips
TOKEN_FLIP_RATIO = 1.5
# ragged lengths at the main path's batch (phase 3's Chebyshev case): every
# length 1..512 reached by a stride of 389, one clip of 1 and one full
BENCH_LENGTHS = tuple(1 + (i * 389) % BENCH_T for i in range(BENCH_B - 1)) + (BENCH_T,)
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
# phase 12, LM serving: the decode throughput shape, the HTTP traffic's
# prompt grid (every prompt of 1..200 tokens shares one bucket, so that
# mixed prompt lengths coalesce), and the logit gate card vs CPU
SERVE_B, SERVE_L = 64, 512
SERVE_PROMPT_GRID = 256
LOGIT_TOL = 1e-4
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


def _kernel_variant(mangled: str):
    """A compiled kernel's template arguments as printed: 'D=64' for a
    flash kernel, 'bf16 taps=5' for a mixer kernel, 'fp32' etc."""
    if "poly_stats" in mangled or "poly_fit" in mangled:
        return None  # no template arguments
    if "fsq_head_kernel" in mangled:
        d, vec = re.findall(r"Li(\d+)E", mangled)[:2]
        return f"{'bf16' if 'nv_bfloat16' in mangled else 'fp32'} d={d} vec={vec}"
    if "mixer_kernel" in mangled or "poly_" in mangled:
        dtype = "bf16" if "nv_bfloat16" in mangled else "fp32"
        arg = re.search(r"Li(\d+)E", mangled)
        return dtype + (f" taps={arg.group(1)}" if arg else "")
    d = re.search(r"ILi(\d+)E", mangled)
    return f"D={d.group(1)}" if d else None


def ptxas_summary(report: str) -> list:
    """(kernel, template variant or None, registers, spill bytes stored,
    spill bytes loaded) of each mma.sync kernel and mixer kernel entry in
    the ptxas report."""
    kernels = ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma", "conv_gemm_mma",
               "fsq_head_kernel",
               "mel_mixer_kernel", "poly_minmax_kernel", "poly_stats_kernel",
               "poly_fit_nodes_kernel", "poly_fit_coef_kernel", "poly_eval_kernel")
    rows, entry = [], None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = next((k for k in kernels if k in found.group(1)), None)
            entry = ([name, _kernel_variant(found.group(1)), None, 0, 0]
                     if name else None)
            continue
        if entry is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            entry[3], entry[4] = int(spill.group(1)), int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            entry[2] = int(regs.group(1))
            rows.append(tuple(entry))
            entry = None
    return sorted(rows, key=lambda r: (r[0], len(r[1] or ""), r[1] or ""))


# SASS opcodes issued to the FP32 pipe (besides MUFU, the SFU's)
FP32_OPCODES = ("FFMA", "FADD", "FMUL", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK",
                "FSWZADD")


def sass_loop_counts(sass: str) -> list:
    """For each mixer kernel in ``cuobjdump -sass`` output (the exact mixer
    and the Chebyshev mode's Clenshaw pass): the instructions of its inner
    loop, the loop between a backward branch and its target that holds the
    most MUFU.EX2 (exact) or FFMA (Chebyshev), innermost on a tie. Rows (kernel,
    variant, evaluations per iteration, {"MUFU.EX2": n, "MUFU.RCP": n,
    "MUFU other": n, "FP32": n, "other": n}); an evaluation is one z tanh z
    (one MUFU.EX2 each, old and new design) or one Clenshaw step of one
    element (one FFMA each), and the loop's opcodes (a Counter). Counts are
    static: both sides of a branch inside the loop count."""
    rows = []
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.split()[0]
        kind = ("exact" if "mel_mixer_kernel" in name
                else "poly" if "poly_eval_kernel" in name else None)
        if kind is None:
            continue
        instrs, labels, pending = [], {}, []
        for line in chunk.splitlines()[1:]:
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not ins:
                continue
            addr = int(ins.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            text = re.sub(r"^@!?U?P\w+\s+", "", ins.group(2))
            instrs.append((addr, text.split()[0], text))
        best = None
        for addr, op, text in instrs:
            if not op.startswith("BRA"):
                continue
            target = re.search(r"`\((\.L_x_\d+)\)", text)
            dest = labels.get(target.group(1)) if target else None
            if dest is None:
                hexa = re.search(r"BRA\S*\s+(0x[0-9a-f]+)", text)
                dest = int(hexa.group(1), 16) if hexa else None
            if dest is None or dest > addr:
                continue
            body = [o for a, o, _ in instrs if dest <= a <= addr]
            key = sum(o == ("MUFU.EX2" if kind == "exact" else "FFMA") for o in body)
            if key and (best is None or (key, -len(body)) > (best[0], -len(best[1]))):
                best = (key, body)
        if best is None:
            continue
        key, body = best
        counts = {"MUFU.EX2": sum(o == "MUFU.EX2" for o in body),
                  "MUFU.RCP": sum(o == "MUFU.RCP" for o in body)}
        counts["MUFU other"] = sum(o.startswith("MUFU") for o in body) - sum(counts.values())
        counts["FP32"] = sum(o.split(".")[0] in FP32_OPCODES for o in body)
        counts["other"] = len(body) - sum(counts.values())
        rows.append((kind, _kernel_variant(name), key, counts,
                     Counter(o.split(".")[0] for o in body)))
    return sorted(rows, key=lambda r: (r[0], r[1] or ""))


def mixer_sass(library: str) -> list:
    """sass_loop_counts of a built kernel library (cuobjdump from the CUDA
    toolkit); [] with a note when cuobjdump is not there."""
    from mqgan_tpu_torch.ops import _cuda

    tool = shutil.which("cuobjdump") or str(Path(_cuda._nvcc()).parent / "cuobjdump")
    if not os.path.exists(tool):
        print("  cuobjdump not found: SASS counts not measured")
        return []
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                         timeout=300, check=True)
    return sass_loop_counts(out.stdout)


def print_mixer_sass(library: str, detail=("bf16 taps=5", "bf16")) -> None:
    """Print the per-evaluation MUFU / FP32 / other instruction counts of
    the mixer kernels' inner loops in a built library, and the opcodes of
    the loops whose variant is in ``detail`` (the main path's); importable
    to read another build of the kernels (an earlier commit's)."""
    for kind, variant, evals, c, ops in mixer_sass(library):
        unit = "z tanh z" if kind == "exact" else "Clenshaw step x element"
        per = {k: v / evals for k, v in c.items()}
        issue = sum(per.values())
        print(f"  SASS {'mel_mixer' if kind == 'exact' else 'mel_mixer_poly Clenshaw'} "
              f"{variant}: {evals} per loop iteration; per {unit}: MUFU.EX2 "
              f"{per['MUFU.EX2']:.3f}, MUFU.RCP {per['MUFU.RCP']:.3f}, MUFU other "
              f"{per['MUFU other']:.3f}, FP32 {per['FP32']:.3f}, other "
              f"{per['other']:.3f}; issue slots {issue:.3f}, SFU "
              f"{sum(v for k, v in per.items() if k.startswith('MUFU')):.3f}")
        if variant in detail:
            print(f"    opcodes per loop iteration: {dict(sorted(ops.items()))}")


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


def build_model(device, dtype, poly_mixers=False, state=None, music=False):
    """The flagship hifispeech generator (seeded), or with ``music`` the
    hifimusic one."""
    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.utils.init import seeded_init_

    if music:
        cfg = dict(HIFIMUSIC)
        mels = cfg.pop("mels")
        model = PreEncoder.from_config(mels, GeneratorConfig(**cfg), dtype=dtype)
    else:
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


def compare_kernels(model, device, b, t, lengths, dtypes, tag="") -> dict:
    """Phase 3: every kernel against its plain version; returns each
    kernel's largest |kernel - plain| in bf16, the main path's dtype (for
    the FSQ head: the largest index difference away from a midpoint).
    ``tag`` prefixes the printed case names."""
    import torch

    from mqgan_tpu_torch.ops.block_kernels import (fused_residual_block,
                                                   residual_block_plain)
    from mqgan_tpu_torch.ops.fsq_kernels import (fsq_encode_head,
                                                 fsq_encode_plain)
    from mqgan_tpu_torch.ops.mixer_kernels import fused_mel_mixer, mel_mixer_plain

    gen = torch.Generator().manual_seed(SEED + 1)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    errs = {k: 0.0 for k in ("residual_block", "mel_mixer", "fsq_head")}

    def judge(kernel, name, got, want, dtype):
        ok, max_abs, detail = _judge("", got, want, dtype)
        if dtype != torch.float32:
            errs[kernel] = max(errs[kernel], max_abs)
        name = tag + name
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
            want = mel_mixer_plain(x, lens, wts)
            got = fused_mel_mixer(x, lens, wts)
            judge("mel_mixer", name, got, want, dtype)
            pad_rows = torch.arange(t, device=device)[None, :] >= lens[:, None]
            if not bool((got.float()[pad_rows] == wts.consts[1].to(dtype).float()).all()):
                fail(f"mel_mixer {tag}{name} {dtype}: padded rows are not b_out")
        c = model.q_in_proj.weight.shape[1]
        h = torch.randn((b * t, c), generator=gen).to(device, dtype)
        w = model.q_in_proj.weight.float().t().contiguous()
        bias = model.q_in_proj.bias.float()
        got = fsq_encode_head(h, w, bias, model.fsq_consts)
        want = fsq_encode_plain(h, w, bias, model.fsq_consts)
        near = _fsq_near_midpoint(h, w, bias, model.fsq_consts)
        mism = got != want
        far_err = int((got - want)[~near].abs().max()) if bool((~near).any()) else 0
        print(f"  {'fsq_head':15s} {tag:5s} {str(dtype)[6:]:8s} "
              f"{int(mism.sum())} of {got.numel()} indices differ, "
              f"{int((mism & near).sum())} of them within 1e-4 of a midpoint "
              f"{'ok' if far_err == 0 else 'FAIL'}")
        if far_err:
            fail(f"fsq_head {dtype}: indices differ away from a midpoint")
        if int(got.min()) < 0 or int(got.max()) >= model.codebook_size:
            fail("fsq_head: index out of range")
        errs["fsq_head"] = max(errs["fsq_head"], float(far_err))
    return errs


def compare_fsq_head(model, device, tag="") -> float:
    """Phase 3, the FSQ head at ragged N: the model's projection (fp32 and
    bf16) at N = 1, FSQ_RAGGED_N (not a multiple of the 8 rows a warp
    reduces together) and the main path's N = 64 * 512; h at an offset of
    one element (not 16-byte aligned: the scalar-load instantiation); and
    random projections to d = 1, 3 and 8 code dims. Indices may differ only
    where the plain pre-round value lies within 1e-4 of a midpoint; returns
    the largest index difference away from one (0)."""
    import torch

    from mqgan_tpu_torch.ops.fsq_kernels import (fsq_encode_head, fsq_encode_plain,
                                                 fsq_head_constants)
    from mqgan_tpu_torch.quant.fsq import FSQSpec

    gen = torch.Generator(device=device).manual_seed(SEED + 23)
    c = model.q_in_proj.weight.shape[1]
    w = model.q_in_proj.weight.float().t().contiguous()
    bias = model.q_in_proj.bias.float()
    cases = []  # (label, h, w, bias, consts, codebook size)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, FSQ_RAGGED_N, BENCH_B * BENCH_T):
            h = torch.randn((n, c), generator=gen, device=device).to(dtype)
            cases.append((f"N={n} {str(dtype)[6:]}", h, w, bias, model.fsq_consts,
                          model.codebook_size))
        flat = torch.randn(FSQ_RAGGED_N * c + 1, generator=gen, device=device).to(dtype)
        cases.append((f"N={FSQ_RAGGED_N} {str(dtype)[6:]} unaligned",
                      flat[1:].view(FSQ_RAGGED_N, c), w, bias, model.fsq_consts,
                      model.codebook_size))
        for levels in ((8,), (8, 5, 5), (8, 5, 5, 5, 5, 5, 5, 5)):
            d = len(levels)
            spec = FSQSpec(levels)
            wd = torch.randn((c, d), generator=gen, device=device) * (2.0 / c ** 0.5)
            bd = torch.randn((d,), generator=gen, device=device) * 0.1
            consts = torch.from_numpy(fsq_head_constants(spec)).to(device)
            h = torch.randn((FSQ_RAGGED_N, c), generator=gen, device=device).to(dtype)
            cases.append((f"N={FSQ_RAGGED_N} {str(dtype)[6:]} d={d}", h, wd, bd, consts,
                          spec.codebook_size))
    worst = 0
    for label, h, wc, bc, consts, size in cases:
        got = fsq_encode_head(h, wc, bc, consts)
        want = fsq_encode_plain(h, wc, bc, consts)
        near = _fsq_near_midpoint(h, wc, bc, consts)
        mism = got != want
        far_err = int((got - want)[~near].abs().max()) if bool((~near).any()) else 0
        ok = far_err == 0 and int(got.min()) >= 0 and int(got.max()) < size
        print(f"  {'fsq_head':15s} {tag}{label}: {int(mism.sum())} of {got.numel()} "
              f"indices differ, {int((mism & near).sum())} of them within 1e-4 of a "
              f"midpoint {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"fsq_head {tag}{label}: indices differ away from a midpoint or "
                 f"leave [0, {size})")
        worst = max(worst, far_err)
    return float(worst)


def compare_poly(model, device, b, t, lengths, tag="", main_path=False,
                 mixer="post") -> float:
    """Phase 3: the Chebyshev kernels (the conv and min/max, the fit, the
    Clenshaw pass) against the plain
    poly_mixer_plain on the post mixer (or ``mixer``), fp32 (TF32 off) and bf16: ragged
    lengths, and a plane whose masked values are all equal (x = 0, every
    frame valid: half clamps to 1e-6); with ``main_path`` also ragged
    lengths at the main path's B=64 T=512 (BENCH_LENGTHS: a min/max over 64
    clips and 8,192 tiles); padded rows must be b2 bit for bit; one
    mel_mixer_poly launch per call. Returns the largest bf16
    |kernel - plain|."""
    import torch

    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.mixer_poly import fused_poly_mixer, poly_mixer_plain

    gen = torch.Generator().manual_seed(SEED + 18)
    c = model.proj.weight.shape[0]
    wts = getattr(model, mixer).kernel_weights()
    # the seeded biases are 0, where g(0) = 0 and a plane of zeros would hold
    # rounding noise against rounding noise: the equal plane takes s = 0.37
    equal_wts = wts._replace(consts=torch.cat([torch.full_like(wts.consts[:1], 0.37),
                                               wts.consts[1:]]))
    cases = [("ragged", b, t, lengths), ("all equal", b, t, (t,) * b)]
    if main_path:
        cases.append((f"B={BENCH_B} T={BENCH_T} ragged", BENCH_B, BENCH_T, BENCH_LENGTHS))
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case, b, t, lens_t in cases:
            lens = torch.tensor(lens_t, dtype=torch.int32, device=device)
            x = torch.randn((b, t, c), generator=gen).to(device, dtype)
            w = wts
            if case == "all equal":
                x.zero_()
                w = equal_wts
            want = poly_mixer_plain(x, lens, w)
            _cuda.COUNTERS.reset()
            got = fused_poly_mixer(x, lens, w)
            launches = _cuda.COUNTERS.snapshot()
            torch.cuda.synchronize()
            ok, max_abs, detail = _judge("", got, want, dtype)
            pad_rows = torch.arange(t, device=device)[None, :] >= lens[:, None]
            pads_exact = bool((got[pad_rows] == wts.consts[1].to(dtype)).all())
            ok = ok and pads_exact and launches == {"mel_mixer_poly": 1}
            if dtype != torch.float32:
                worst = max(worst, max_abs)
            print(f"  {'mel_mixer_poly':15s} {tag}{mixer} {case} {str(dtype)[6:]:8s} "
                  f"{detail.strip()}, max|k-p| {max_abs:.3e}, pads "
                  f"{'== b2' if pads_exact else 'NOT b2'}, launches {launches} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"mel_mixer_poly {tag}{mixer} {case} {dtype}: {detail}, pads exact "
                     f"{pads_exact}, launches {launches}")
    return worst


def compare_pre_mixer_tokens(state, device) -> None:
    """Phase 3c: FSQ tokens at B=64 T=512 through the pre mixer's kernel
    against the same encoder with the plain pre mixer (the blocks and the
    FSQ head through their kernels in both), beside a control: the plain
    pre mixer with its P hidden units summed in another order (the same
    function). fp32: tokens equal wherever the plain path's pre-round value
    lies more than 1e-4 from a rounding midpoint. bf16: no mixer that sums
    in another order than the plain one can hold that (a bf16 rounding of
    the mixer's output flips wherever its fp32 value lies between the two
    sums, and the bf16 blocks carry that ulp to the pre-round values; the
    control shows it), so the gates there are that the bf16 kernel's output
    is its fp32 arithmetic on the same values rounded once, bit for bit,
    that arithmetic within the fp32 gate of the plain version, and that no
    more than TOKEN_FLIP_RATIO times the control's tokens differ from the
    plain path's away from a midpoint."""
    import torch

    from mqgan_tpu_torch.ops.mixer_kernels import fused_mel_mixer, mel_mixer_plain

    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    mel = torch.randn((BENCH_B, BENCH_T, MELS), generator=gen, device=device)
    pad = torch.zeros((BENCH_B, BENCH_T), dtype=torch.bool, device=device)
    lens = torch.full((BENCH_B,), BENCH_T, dtype=torch.int32, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        model = build_model(device, dtype, state=state)
        x = model.proj(mel.to(dtype))
        wts = model.pre.kernel_weights()
        perm = torch.randperm(wts.w1.shape[0], generator=torch.Generator().manual_seed(SEED))
        perm = perm.to(device)
        permuted = wts._replace(w1=wts.w1[perm].contiguous(), b1=wts.b1[perm].contiguous(),
                                w2=wts.w2[perm].contiguous())
        mixed = {"kernel": fused_mel_mixer(x, lens, wts),
                 "plain": mel_mixer_plain(x, lens, wts),
                 "control": mel_mixer_plain(x, lens, permuted)}
        w, bias = model.q_in_proj.weight.float().t(), model.q_in_proj.bias.float()
        idx, pre = {}, {}
        for label, h in mixed.items():
            for block in model.encoder_blocks:
                h = block(h, pad)
            idx[label] = model._fsq_head(h)
            pre[label] = h.reshape(-1, h.shape[-1]).float() @ w + bias
            if label == "plain":
                near = _fsq_near_midpoint(h.reshape(-1, h.shape[-1]), w, bias,
                                          model.fsq_consts).reshape(idx[label].shape)
        far = {}
        for label in ("kernel", "control"):
            flips = idx[label] != idx["plain"]
            far[label] = int((flips & ~near).sum())
            diff = int((mixed[label] != mixed["plain"]).sum())
            print(f"  tokens, pre mixer {label:7s} vs plain, B={BENCH_B} T={BENCH_T} "
                  f"{str(dtype)[6:]:8s}: mixer outputs differ at {diff} elements; "
                  f"{int(flips.sum())} of {flips.numel()} tokens differ, {far[label]} of "
                  f"them away from a midpoint; max|pre-round diff| "
                  f"{float((pre[label] - pre['plain']).abs().max()):.3e}")
        if dtype == torch.float32:
            ok = far["kernel"] == 0
            detail = f"{far['kernel']} tokens differ away from a midpoint"
        else:
            k32 = fused_mel_mixer(x.float(), lens, wts)
            p32 = mel_mixer_plain(x.float(), lens, wts)
            once = torch.equal(mixed["kernel"], k32.to(dtype))
            ok32, _, detail32 = _judge("fp32 arithmetic vs plain:", k32, p32, torch.float32)
            limit = TOKEN_FLIP_RATIO * far["control"]
            ok = once and ok32 and far["kernel"] <= limit
            detail = (f"bf16 output {'==' if once else '!='} its fp32 arithmetic rounded "
                      f"once; {detail32.strip()}; {far['kernel']} tokens differ away from a "
                      f"midpoint (limit {TOKEN_FLIP_RATIO} x the control's {far['control']} "
                      f"= {limit:g})")
        print(f"  tokens gate {str(dtype)[6:]:8s}: {detail} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"pre mixer tokens {dtype}: {detail}")
        del model, x, mixed, idx, pre


def compare_ragged_blocks(device) -> float:
    """Phase 3: blocks whose widths and B*T are off the conv GEMM's tile
    (RAGGED_BLOCKS), seeded, against their plain versions in fp32 and bf16;
    returns the largest bf16 |kernel - plain|."""
    import torch

    from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
    from mqgan_tpu_torch.ops.block_kernels import (fused_residual_block,
                                                   residual_block_plain)
    from mqgan_tpu_torch.utils.init import seeded_init_

    gen = torch.Generator().manual_seed(SEED + 17)
    worst = 0.0
    for cin, cout, k, causal, b, t, lengths in RAGGED_BLOCKS:
        blk = seeded_init_(ResidualBlock1D(cin, cout, k, causal=causal), SEED + 17)
        blk = blk.to(device)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((b, t, cin), generator=gen).to(device, dtype)
            wts = blk.kernel_weights(dtype)
            got = fused_residual_block(x, lens, wts, causal=causal)
            want = residual_block_plain(x, lens, wts, causal=causal)
            ok, max_abs, detail = _judge("", got, want, dtype)
            if dtype == torch.bfloat16:
                worst = max(worst, max_abs)
            print(f"  residual_block  {cin}->{cout} k{k} {'causal' if causal else 'CBAM'} "
                  f"B={b} T={t} lengths {lengths} {str(dtype)[6:]:8s} {detail.strip()}, "
                  f"max|k-p| {max_abs:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"residual_block {cin}->{cout} k{k} B={b} T={t} {dtype}: {detail}")
    return worst


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


def compare_log_mel(device) -> tuple:
    """Phase 3, log-mel: each kernel against its plain version (TF32 off);
    returns the largest |kernel - plain| and the DFT kernel's launches (its
    path: the front end at an even n_fft that is no power of two, counts
    reset before each case and read after)."""
    import torch

    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel,
                                                  log_mel_plain, log_mel_tables)
    from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    floor = torch.log(torch.tensor(LOG_CLIP_VAL, device=device))
    worst, dft_launches = 0.0, 0
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
        dft_launches += launches.get("log_mel_dft", 0)
    return worst, dft_launches


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


def throughput(model, device, counters, per_trip) -> tuple:
    """Phase 5: chained encode -> decode, tokens on the card; returns
    (mel-frames/s, the launch counts of the timed trips)."""
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
    return BENCH_B * BENCH_T * ITERS / (start.elapsed_time(end) / 1e3), launches


KERNEL_GROUPS = (
    ("flash attention", ("flash_fwd", "flash_bwd")),
    ("residual_block", ("conv_gemm", "cbam_", "sam_stats")),
    ("mel_mixer", ("mel_mixer",)),
    ("mel_mixer_poly", ("poly_minmax", "poly_stats", "poly_fit", "poly_eval")),
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


def _report_profile(label, events, wall_ms, top=8, note="profiler on") -> float:
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
          f"(idle share {1 - busy / wall_ms:.3f}, {note})")
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


def conv_yardstick(blk, b: int, t: int, gen, device):
    """A function running a block's convs (the projection, conv1, conv2) as
    cuDNN bf16 conv1d calls on (B, C, T) inputs, causal ones left-padded by
    k - 1 (conv1d pads both sides; the k - 1 extra frames are ~1% more
    work): the yardstick of the block kernel's GEMMs; the port never calls
    it."""
    import torch
    import torch.nn.functional as F

    dt = torch.bfloat16
    cin, cout, k = blk.conv1.v.shape[1], blk.conv1.v.shape[0], blk.kernel_size
    x = torch.randn((b, cin, t), generator=gen, device=device).to(dt)
    h = torch.randn((b, cout, t), generator=gen, device=device).to(dt)
    w1, w2 = (c.folded().to(dt) for c in (blk.conv1, blk.conv2))
    b1, b2 = (c.bias.to(dt) for c in (blk.conv1, blk.conv2))
    pad = k - 1 if blk.causal else k // 2
    proj = None
    if blk.residual is not None:
        proj = (blk.residual.folded().to(dt), blk.residual.bias.to(dt))

    def convs():
        if proj is not None:
            F.conv1d(x, *proj)
        F.conv1d(x, w1, b1, padding=pad)
        F.conv1d(h, w2, b2, padding=pad)
    return convs


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
    from mqgan_tpu_torch.ops.mixer_kernels import fused_mel_mixer, mel_mixer_plain
    from mqgan_tpu_torch.ops.mixer_poly import (POLY_DEGREE, POLY_GRID, fused_poly_mixer,
                                                poly_mixer_plain)

    dt = torch.bfloat16
    b, t = BENCH_B, BENCH_T
    m = b * t
    lens = torch.full((b,), t, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)

    blk_row = _KernelRow("residual_block", "mqgan_tpu_torch/csrc/residual_block.cu",
                         "mqgan_tpu/ops/block_kernels.py:161")
    bursts = [0.0, 0.0, 0.0]  # the block in bursts; cuDNN's convs single, in bursts
    for name, blk in block_cases(model):
        cin, cout, k = blk.conv1.v.shape[1], blk.conv1.v.shape[0], blk.kernel_size
        x = torch.randn((b, t, cin), generator=gen, device=device).to(dt)
        wts = blk.kernel_weights(dt)
        ms = time_ms(lambda: fused_residual_block(x, lens, wts,
                                                  causal=blk.causal), 10)
        burst = time_ms(lambda: fused_residual_block(x, lens, wts,
                                                     causal=blk.causal), 5, 10)
        pms = time_ms(lambda: residual_block_plain(x, lens, wts,
                                                   causal=blk.causal), 3)
        macs = k * cin * cout + k * cout * cout + (cin * cout if cin != cout else 0)
        flops = 2.0 * m * macs
        bound = blk_row.add(ms, pms, flops, PEAK_BF16,
                            2.0 * (m * cin + m * cout + macs))
        convs = conv_yardstick(blk, b, t, gen, device)
        conv_ms, conv_burst = time_ms(convs, 10), time_ms(convs, 5, 10)
        bursts = [b_ + x_ for b_, x_ in zip(bursts, (burst, conv_ms, conv_burst))]
        print(f"  residual_block {name} {cin}->{cout} k{k}"
              f"{' causal' if blk.causal else ' CBAM'}: {ms:.4f} ms (bursts {burst:.4f}), "
              f"plain {pms:.4f} ms, bound {bound:.4f} ms ({flops / 1e9:.1f} GFLOP of conv "
              f"GEMMs, {flops / ms / 1e9:.1f} TFLOP/s over the block's time (bursts "
              f"{flops / burst / 1e9:.1f}){'' if blk.causal else ', CBAM included'}); the same "
              f"convs through cuDNN {conv_ms:.4f} ms (bursts {conv_burst:.4f}, "
              f"{flops / conv_burst / 1e9:.1f} TFLOP/s)")
    print(f"  residual_block, six blocks: {blk_row.ms:.4f} ms (bursts {bursts[0]:.4f}); "
          f"the same convs through cuDNN {bursts[1]:.4f} ms (bursts {bursts[2]:.4f}), a "
          f"yardstick of the GEMMs alone: no one PyTorch call computes the block")

    mix_row = _KernelRow("mel_mixer", "mqgan_tpu_torch/csrc/mel_mixer.cu",
                         "mqgan_tpu/ops/mixer_kernels.py:92")
    props = torch.cuda.get_device_properties(device)
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    for name, mixer in (("pre", model.pre), ("post", model.post)):
        c = model.proj.weight.shape[0]
        x = torch.randn((b, t, c), generator=gen, device=device).to(dt)
        wts = mixer.kernel_weights()
        p, k = wts.w1.shape[0], wts.dwk.shape[0]
        ms = time_ms(lambda: fused_mel_mixer(x, lens, wts), 5)
        pms = time_ms(lambda: mel_mixer_plain(x, lens, wts), 2)
        bound = mix_row.add(ms, pms, m * c * (2.0 * k * k + 6.0 * p), PEAK_FP32,
                            2.0 * 2 * m * c + 4.0 * (k * k + 3 * p + 4))
        clocks = ms * 1e-3 * max_mhz * 1e6 * props.multi_processor_count / (m * c * p)
        print(f"  mel_mixer {name} C={c} P={p}: {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bound:.4f} ms ({m * c * p / 1e9:.2f} G z tanh z evaluations, "
              f"a tanh counted as one operation; {clocks:.4f} clocks per evaluation per "
              f"SM at the maximum {max_mhz:.0f} MHz, {props.multi_processor_count} SMs)")

    poly_row = _KernelRow("mel_mixer_poly", "mqgan_tpu_torch/csrc/mel_mixer.cu",
                          "mqgan_tpu/ops/mixer_poly.py:72")
    c = model.proj.weight.shape[0]
    x = torch.randn((b, t, c), generator=gen, device=device).to(dt)
    wts = model.post.kernel_weights()
    p, k = wts.w1.shape[0], wts.dwk.shape[0]
    ms = time_ms(lambda: fused_poly_mixer(x, lens, wts), 10)
    burst = time_ms(lambda: fused_poly_mixer(x, lens, wts), 5, 10)
    pms = time_ms(lambda: poly_mixer_plain(x, lens, wts), 2)
    # per element: the conv (k*k multiply-adds), the division into t, the
    # Clenshaw steps (an add and a multiply-add each); the fit: g at the
    # nodes (P x (multiply-add, tanh, add, 2 multiplies, multiply-add)) and
    # the cosine projection
    ops = (m * c * (2.0 * k * k + 3.0 * POLY_DEGREE + 6.0)
           + POLY_GRID * p * 8.0 + 2.0 * (POLY_DEGREE + 1) * POLY_GRID)
    bound = poly_row.add(ms, pms, ops, PEAK_FP32, 2.0 * 2 * m * c + 4.0 * (k * k + 3 * p + 4))
    print(f"  mel_mixer_poly post C={c} P={p} degree {POLY_DEGREE} grid {POLY_GRID}, "
          f"one call of five kernel launches: {ms:.4f} ms (bursts {burst:.4f}), "
          f"plain {pms:.4f} ms, bound {bound:.4f} ms ({poly_row.bound_by}: "
          f"{ops / 1e9:.2f} GFLOP)")

    fsq_row = _KernelRow("fsq_head", "mqgan_tpu_torch/csrc/fsq_head.cu",
                         "mqgan_tpu/ops/fsq_kernels.py:84")
    w = model.q_in_proj.weight.float().t().contiguous()
    bias = model.q_in_proj.bias.float()
    ms, burst, kernel_ms, host_us, h = fsq_head_times(device, w, bias, model.fsq_consts)
    c, d = w.shape
    pms = time_ms(lambda: fsq_encode_plain(h, w, bias, model.fsq_consts), 5)
    nbytes = 2.0 * m * c + 4.0 * m + 4.0 * (c * d + 6 * d)
    bound = fsq_row.add(ms, pms, m * (2.0 * c * d + 8.0 * d), PEAK_FP32, nbytes)
    print(f"  fsq_head N={m} C={c} bf16: {ms:.4f} ms single calls ({nbytes / ms / 1e6:.1f} "
          f"GB/s), bursts of 10 {burst:.4f} ms ({nbytes / burst / 1e6:.1f} GB/s), the "
          f"kernel alone {kernel_ms:.4f} ms ({nbytes / kernel_ms / 1e6:.1f} GB/s; "
          f"profiler), the host's wrapper {host_us:.1f} us a call; plain {pms:.4f} ms; "
          f"bound {bound:.4f} ms ({fsq_row.bound_by}: {nbytes / 1e6:.1f} MB): "
          f"{bound / ms:.3f} of it in single calls, {bound / burst:.3f} in bursts, "
          f"{bound / kernel_ms:.3f} for the kernel alone")

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
    err, plain_err, chain_err, dft_err = (float((x - ref).abs().max())
                                          for x in (got, plain, chain, dft))
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
    dft_row = _KernelRow("log_mel_dft", "mqgan_tpu_torch/csrc/log_mel_dft.cu",
                         "mqgan_tpu/ops/stft_kernels.py:95")
    dft_row.add(dft_ms, pms, flops, PEAK_FP32, nbytes)
    dft_row.max_abs_err, dft_row.library_ms = dft_err, mel_row.library_ms
    print(f"  log_mel N={n} n_fft={n_fft} F={n_freq} mels={n_mels}: {ms:.4f} ms "
          f"(roofline share {bound / ms:.3f}), the DFT kernel {dft_ms:.4f} ms, plain "
          f"{pms:.4f} ms, torch.stft chain {mel_row.library_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({mel_row.bound_by}: {flops / 1e9:.2f} GFLOP counting the "
          f"filterbank's {nnz} nonzeros, {dense_flops / 1e9:.2f} counting F x n_mels "
          f"= {n_freq * n_mels} densely; {nbytes / 1e6:.1f} MB)")
    return [blk_row, mix_row, poly_row, fsq_row, mel_row, dft_row]


def fsq_head_times(device, w, bias, consts):
    """Phase 8, the FSQ head at the main path's shape (N = 64 * 512 rows of
    C channels, bf16): (single-call ms, ms per call in bursts of 10, the
    kernel's own device ms from torch.profiler over 20 calls, the host's
    microseconds per call (100 calls enqueued, no sync), h). Imports
    whatever ``mqgan_tpu_torch`` is first on the path, so ``--fsq-head-of``
    times another checkout's kernel with the same code."""
    import torch

    from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_head

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    h = torch.randn((BENCH_B * BENCH_T, w.shape[0]), generator=gen,
                    device=device).to(torch.bfloat16)

    def call():
        return fsq_encode_head(h, w, bias, consts)

    ms = time_ms(call, 20)
    burst = time_ms(call, 10, FLASH_BURST)
    events, _ = _device_profile(lambda: [call() for _ in range(20)])
    kernel_ms = sum(t for k, t in events if "fsq_head" in k) / 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        call()
    host_us = 1e4 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ms, burst, kernel_ms, host_us, h


def fsq_head_of(root: str) -> None:
    """``python3 chip_smoke.py --fsq-head-of DIR``: build the kernels of the
    checkout at DIR and time its FSQ head as phase 8 times this one (the
    flagship projection: seeded, C = 768, d = 4), to set a parent commit's
    times beside this commit's within one call."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.abspath(root))
    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.fsq_kernels import fsq_head_constants
    from mqgan_tpu_torch.quant.fsq import FSQSpec

    if not _cuda.__file__.startswith(os.path.abspath(root)):
        fail(f"mqgan_tpu_torch came from {_cuda.__file__}, not from {root}")
    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    c, levels = 768, (8, 5, 5, 5)
    w = (torch.randn((c, len(levels)), generator=gen) / c ** 0.5).to(device)
    bias = torch.zeros(len(levels), device=device)
    consts = torch.from_numpy(fsq_head_constants(FSQSpec(levels))).to(device)
    ms, burst, kernel_ms, host_us, _ = fsq_head_times(device, w, bias, consts)
    print(f"fsq_head of {root} N={BENCH_B * BENCH_T} C={c} bf16: {ms:.4f} ms single "
          f"calls, bursts of 10 {burst:.4f} ms, the kernel alone {kernel_ms:.4f} ms, "
          f"the host's wrapper {host_us:.1f} us a call [{card_line()}]")


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


def lm_trainer_cli(counters, device, root) -> dict:
    """Phase 10b, the slice's main path: the trainer CLI (--arch transformer
    --flash_lm --bf16, flagship defaults) for one epoch over LM_CHUNKS chunks
    of 2047 tokens (input T = 2047): LM_CHUNKS - 2 train rows in steps of 8,
    2 val rows; 6 launches of each flash kernel per train step, 6 forward
    launches per val step. Its run dir, ``root``/run, is phase 12's
    transformer. Returns the launch counts."""
    from mqgan_tpu_torch.train import lstm_trainer

    n_val = max(1, int(0.1 * LM_CHUNKS))
    steps = -(-(LM_CHUNKS - n_val) // 8)
    want = {"flash_fwd": 6 * (steps + 1), "flash_bwd_dq": 6 * steps,
            "flash_bwd_dkv": 6 * steps}
    mapping = _write_chunks(root, LM_CHUNKS, 2047, SEED + 14)
    out = os.path.join(root, "run")
    counters.reset()
    t0 = time.perf_counter()
    lstm_trainer.main([
        "--chunks_dir", os.path.join(root, "chunks"), "--mapping_json", mapping,
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


def lstm_run_dir(root) -> str:
    """A run dir in the trainer's format (best.json naming a .pt
    state_dict, the trainer's args) holding the flagship LSTM (the
    trainer's defaults: emb 512, 2 layers of 1024) with seeded weights."""
    import torch

    from mqgan_tpu_torch.models.token_lm import build_token_lm
    from mqgan_tpu_torch.train.lstm_trainer import parse_args
    from mqgan_tpu_torch.utils.init import seeded_init_

    out = os.path.join(root, "lstm_run")
    os.makedirs(out)
    args = vars(parse_args(["--vocab_size", str(LM["vocab_size"]), "--num_genres",
                            str(LM["num_genres"]), "--arch", "lstm", "--out_dir", out]))
    path = os.path.join(out, "model_seeded.pt")
    torch.save(seeded_init_(build_token_lm(args), SEED + 21).state_dict(), path)
    with open(os.path.join(out, "best.json"), "w") as f:
        json.dump({"epoch": 0, "val_loss": None, "path": path, "args": args}, f)
    return out


def _serve_mask(device="cpu"):
    """The served vocab mask: pad (0) and BOS (1) are never sampled."""
    import torch

    mask = torch.ones(LM["vocab_size"], dtype=torch.bool, device=device)
    mask[:2] = False
    return mask


def _serve_rows(n: int, p: int, seed: int):
    """n served rows: (genres, seeds, prompt (n, p), prompt lengths in
    [0, p]), on the CPU."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return (torch.randint(0, LM["num_genres"], (n,), generator=gen),
            torch.arange(n) + 7919 * seed,
            torch.randint(2, LM["vocab_size"], (n, p), generator=gen),
            torch.randint(0, p + 1, (n,), generator=gen))


def _served(model, rows, device, max_len, knobs=(1.0, 0, 0.0), **extra):
    """The model's served sampler on ``rows`` (moved to ``device``), tokens
    back on the CPU."""
    from mqgan_tpu_torch.models.token_lm import served_sampler

    genres, seeds, prompt, lens = (x.to(device) for x in rows)
    return served_sampler(model)(model, genres, seeds, prompt, lens, *knobs,
                                 _serve_mask(device), max_len=max_len, bos_id=1,
                                 **extra).cpu()


def compare_decode_logits(cpu, card, device) -> None:
    """Phase 12a: the transformer's fp32 prefill (B=8, a 64-token prompt
    bucket with per-row ends) and 16 step_rows calls on the card against the
    same model on the CPU: every logit within 1e-4 * max(1, max|logit|)."""
    import torch

    from mqgan_tpu_torch.models.token_transformer import init_cache

    b, p, steps = 8, 64, 16
    genres, _, prompt, lens = _serve_rows(b, p, SEED + 30)
    prefix = torch.cat([torch.ones((b, 1), dtype=torch.long), prompt], dim=1)
    toks = torch.randint(2, LM["vocab_size"], (steps, b),
                         generator=torch.Generator().manual_seed(SEED + 31))
    out = {}
    with torch.no_grad():
        for label, model, dev in (("cpu", cpu, "cpu"), ("card", card, device)):
            caches = init_cache(model, b, p + 1 + steps, torch.float32, dev)
            logits, _ = model.prefill(prefix.to(dev), genres.to(dev), caches,
                                      lens.to(dev))
            got = [logits.cpu()]
            for i in range(steps):
                logits, _ = model.step_rows(toks[i].to(dev), genres.to(dev), caches,
                                            (lens + 1 + i).to(dev))
                got.append(logits.cpu())
            out[label] = torch.stack(got)
    err = float((out["card"] - out["cpu"]).abs().max())
    limit = LOGIT_TOL * max(1.0, float(out["cpu"].abs().max()))
    ok = err <= limit and bool(torch.isfinite(out["card"]).all())
    print(f"  (a) fp32 prefill B={b} P={p} (prompt lengths {lens.tolist()}) + {steps} "
          f"step_rows, card vs CPU: max|d logit| {err:.3e} (limit {limit:.3e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"decode logits card vs CPU: {err:.3e} > {limit:.3e}")


def compare_key_chain(device) -> None:
    """Phase 12c: the key chain's uniforms bit for bit on the CPU and the
    card (seeds at the 32-bit edges, steps up to 2^20); the Gumbel-argmax
    draws from the same logits are printed, not gated (log may round
    differently)."""
    import torch

    from mqgan_tpu_torch.models.lm_sampling import KeyChain, row_seeds

    seeds = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, -5, 123456789, 42])
    steps = torch.tensor([0, 1, 511, 7, 2**20, 3, 0, 99])
    chains = {"cpu": KeyChain(row_seeds(seeds, 8), LM["vocab_size"]),
              "card": KeyChain(row_seeds(seeds, 8, device), LM["vocab_size"])}
    logits = torch.randn((8, LM["vocab_size"]),
                         generator=torch.Generator().manual_seed(SEED + 32))
    equal, draws = True, 0
    for st in (0, 17, 511, steps):
        card_st = st if isinstance(st, int) else st.to(device)
        equal &= torch.equal(chains["cpu"].uniforms(st),
                             chains["card"].uniforms(card_st).cpu())
        draws += int((chains["cpu"].draw(logits, st)
                      == chains["card"].draw(logits.to(device), card_st).cpu()).sum())
    print(f"  (c) key chain uniforms, 8 rows x {LM['vocab_size']} ids x 4 steps: "
          f"{'bit-equal' if equal else 'DIFFER'} on CPU and card; Gumbel-argmax draws "
          f"equal {draws} of 32 {'ok' if equal else 'FAIL'}")
    if not equal:
        fail("key chain uniforms differ between the CPU and the card")


def compare_greedy(name, cpu, card, device) -> None:
    """Phase 12b: top_k = 1 served tokens (B=4, prompt lengths 0..16, 64
    tokens) on the card against the CPU's. Streams may part at a logit
    near-tie, so each card token is held, teacher-forced on the card's own
    stream through the CPU model's forward, to be the CPU's argmax or within
    2 * 1e-4 * max(1, max|logit|) of it; equal streams are counted."""
    import torch

    b, p, length = 4, 16, 64
    rows = _serve_rows(b, p, SEED + 33)
    genres, _, prompt, lens = rows
    knobs = (1.0, 1, 0.0)
    cpu_out = _served(cpu, rows, "cpu", length, knobs)
    card_out = _served(card, rows, device, length, knobs)
    equal = sum(torch.equal(cpu_out[i], card_out[i]) for i in range(b))
    off_argmax, worst = 0, 0.0
    mask = _serve_mask()
    for i in range(b):
        n = int(lens[i])
        seq = torch.cat([torch.ones(1, dtype=torch.long), prompt[i, :n], card_out[i]])
        with torch.no_grad():
            logits = cpu(seq[None], genres[i:i + 1])[0, n:n + length].float()
        logits = logits.masked_fill(~mask, float("-inf"))
        top = logits.max(dim=-1).values
        gap = top - logits.gather(-1, card_out[i][:, None])[:, 0]
        off_argmax += int((gap > 0).sum())
        worst = max(worst, float(gap.max()) / max(1.0, float(top.abs().max())))
    ok = worst <= 2 * LOGIT_TOL
    print(f"  (b) {name} top_k=1 served tokens, B={b} L={length}: {equal} of {b} "
          f"streams equal the CPU's; teacher-forced, {off_argmax} card tokens are not "
          f"the CPU's argmax, the largest gap {worst:.2e} of max(1, max|logit|) "
          f"(near-tie limit {2 * LOGIT_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} greedy tokens on the card leave the CPU's argmax by {worst:.2e}")


def serve_lm_http(run, device, counters, card) -> None:
    """Phase 12d: LMHTTPServer on localhost over the flagship transformer
    run: 12 concurrent /generate requests (mixed genres, prompt lengths
    0..200, n 1..4, length 512, two groups of sampling knobs), on shapes
    not warmed up (the CPU tests cover the warm-up grid; on the card a
    shape's first run compiles nothing); shapes, token range (pad and BOS
    never drawn), mean batch size > 1, /healthz. The path runs none of the
    hand-written kernels (JAX's decode attends through its plain
    attention): the counts stay 0."""
    import urllib.request
    from io import BytesIO

    from mqgan_tpu_torch.deploy.http_lm import LMHTTPServer, LMHTTPService

    service = LMHTTPService(run, max_length=SERVE_L, prompt_grid=SERVE_PROMPT_GRID,
                            max_delay_ms=500, device=device)
    rng = np.random.default_rng(SEED + 34)
    groups = (dict(temperature=1.0, top_k=0, top_p=0.9),
              dict(temperature=0.8, top_k=50, top_p=0.0))
    specs = []
    for i, p_len in enumerate((0, 0, 17, 64, 130, 200, 0, 5, 33, 99, 150, 200)):
        spec = dict(genre=i % LM["num_genres"], length=SERVE_L, n=1 + i % 4,
                    seed=1000 + i, **groups[i // 6])
        if p_len:
            spec["prompt_tokens"] = rng.integers(2, LM["vocab_size"], p_len).tolist()
        specs.append(spec)

    def get(url):
        with urllib.request.urlopen(url, timeout=300) as r:
            return json.loads(r.read())

    def post(url, spec):
        req = urllib.request.Request(url + "/generate", data=json.dumps(spec).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            return np.load(BytesIO(r.read()), allow_pickle=False)

    counters.reset()
    with LMHTTPServer(service) as srv:
        health = get(srv.url + "/healthz")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(specs)) as pool:
            outs = list(pool.map(lambda spec: post(srv.url, spec), specs))
        secs = time.perf_counter() - t0
        stats = get(srv.url + "/statz")
    launches = counters.snapshot()
    rows = sum(spec["n"] for spec in specs)
    ok_shapes = all(o.shape == (spec["n"], SERVE_L) and o.dtype == np.int32
                    for o, spec in zip(outs, specs))
    ok_range = all(int(o.min()) >= 2 and int(o.max()) < LM["vocab_size"] for o in outs)
    ok = (ok_shapes and ok_range and health["ok"] and stats["mean_batch_size"] > 1
          and launches == {})
    print(f"  (d) HTTP: 12 concurrent requests, {rows} rows x {SERVE_L} tokens in "
          f"{secs:.2f} s "
          f"({rows * SERVE_L / secs:.1f} tokens/s); shapes {'ok' if ok_shapes else 'BAD'}, "
          f"tokens in [2, {LM['vocab_size']}) {'ok' if ok_range else 'BAD'}; /healthz "
          f"{health['ok']} ({health['arch']}, {health['device']}); /statz {stats}; kernel "
          f"launches {launches} {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        fail("LM HTTP serving: bad responses, no coalescing or kernel launches")


def served_determinism(name, model, device, **extra) -> int:
    """Phase 12e: at an equal dispatch width (8), a row's tokens do not
    depend on its batch position or its neighbours (gated: equal); a row
    served alone (width 1) against the same row coalesced (width 8) is
    printed: rows that differ and the first step where each does (cuBLAS
    may pick another GEMM for another M). Returns the rows that differ."""
    import torch

    p, length = 64, 64
    knobs = (1.0, 0, 0.95)
    rows = _serve_rows(8, p, SEED + 35)
    others = _serve_rows(4, p, SEED + 36)
    base = _served(model, rows, device, length, knobs, **extra)
    perm = [5, 2, 7, 0, 3, 6, 1, 4]
    permuted = _served(model, [x[perm] for x in rows], device, length, knobs, **extra)
    mixed = _served(model, [torch.cat([o, x[:4]]) for o, x in zip(others, rows)],
                    device, length, knobs, **extra)
    ok = torch.equal(permuted, base[perm]) and torch.equal(mixed[4:], base[:4])
    diverged = []
    for i in range(8):
        solo = _served(model, [x[i:i + 1] for x in rows], device, length, knobs, **extra)
        if not torch.equal(solo[0], base[i]):
            diverged.append((i, int((solo[0] != base[i]).nonzero()[0])))
    print(f"  (e) {name}: width 8, rows permuted and among other neighbours: "
          f"{'equal' if ok else 'DIFFER'} {'ok' if ok else 'FAIL'}; solo (width 1) vs "
          f"coalesced (width 8), L={length}: {len(diverged)} of 8 rows differ"
          f"{'' if not diverged else ' (row, first step): ' + str(diverged)}")
    if not ok:
        fail(f"{name}: served rows depend on their batch position or neighbours")
    return len(diverged)


def decode_throughput(name, model, device, card, **extra) -> None:
    """Phase 12f: one served dispatch at B=64, prompt 0, L=512 after an
    L=32 warm-up: ms per decode step (a token for each of the 64 rows),
    tokens/s, and the device's idle share: the profiler's device busy time
    of an L=32 dispatch against the same dispatch unprofiled (a longer one
    costs the profiler minutes: ~470 launches a step)."""
    import torch

    rows = (torch.arange(SERVE_B) % LM["num_genres"], torch.arange(SERVE_B),
            torch.zeros((SERVE_B, 1), dtype=torch.long),
            torch.zeros(SERVE_B, dtype=torch.long))
    short = 32
    _served(model, rows, device, short, **extra)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = _served(model, rows, device, SERVE_L, **extra)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    _served(model, rows, device, short, **extra)
    short_ms = 1e3 * (time.perf_counter() - t0)
    events, _ = _device_profile(lambda: _served(model, rows, device, short, **extra))
    ok = (tuple(out.shape) == (SERVE_B, SERVE_L) and int(out.min()) >= 2
          and int(out.max()) < LM["vocab_size"])
    print(f"  (f) {name} decode B={SERVE_B} prompt 0 L={SERVE_L}: {secs:.3f} s, "
          f"{1e3 * secs / SERVE_L:.3f} ms/token, {SERVE_B * SERVE_L / secs:.1f} tokens/s "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    _report_profile(f"{name} L={short}", events, short_ms, top=4,
                    note="busy from the profiler, wall of the same dispatch unprofiled")
    if not ok:
        fail(f"{name} decode: bad output {tuple(out.shape)}")


def lm_serving(tf_run, lstm_run, device, counters, card) -> None:
    """Phase 12: token-LM serving at the flagship widths (the transformer of
    phase 10b's run, the seeded LSTM), on the card."""
    import torch

    from mqgan_tpu_torch.deploy.export_lm import load_lm_from_run

    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    tf_card, _ = load_lm_from_run(tf_run, device)
    tf_cpu, _ = load_lm_from_run(tf_run, "cpu")
    lstm_card, _ = load_lm_from_run(lstm_run, device)
    lstm_cpu, _ = load_lm_from_run(lstm_run, "cpu")
    lap("load")
    compare_decode_logits(tf_cpu, tf_card, device)
    lap("a")
    compare_greedy("transformer", tf_cpu, tf_card, device)
    compare_greedy("lstm", lstm_cpu, lstm_card, device)
    lap("b")
    compare_key_chain(device)
    del tf_cpu, lstm_cpu
    lap("c")
    serve_lm_http(tf_run, device, counters, card)
    lap("d")
    diverged = [served_determinism("transformer fp32 KV", tf_card, device),
                served_determinism("transformer bf16 KV", tf_card, device,
                                   kv_dtype=torch.bfloat16),
                served_determinism("lstm", lstm_card, device)]
    print(f"  solo vs coalesced: {sum(diverged)} of 24 rows differ {diverged}")
    lap("e")
    decode_throughput("transformer fp32 KV", tf_card, device, card)
    decode_throughput("transformer bf16 KV", tf_card, device, card,
                      kv_dtype=torch.bfloat16)
    decode_throughput("lstm", lstm_card, device, card)
    lap("f")
    print(f"  phase 12 seconds by part: {seconds}")


# phase 13, codec deployment: the export buckets, the re-encoded directory
# (14 clips within the largest bucket, in batches of 7, then 2 chunked
# ones), the streaming chunk and the HTTP traffic
DEPLOY_BUCKETS = (128, 256, 512, 1024)
REENCODE_LENGTHS = (100, 177, 256, 300, 384, 450, 512, 600, 700, 777, 900,
                    1000, 1023, 1024, 2000, 3000)
REENCODE_BATCH = 7
# phase 13a's round trip through the artifact: a clip between two buckets
ROUND_T = 700
# the generator config written for the export CLI: {} is GeneratorConfig(),
# the flagship
DEPLOY_GENERATOR: dict = {}
STREAM_T, STREAM_CHUNK = 2000, 37
# phase 13's kernel checks at the path's own shapes (B, T, lengths): a
# streaming span (the largest bucket is the window), full and a stream's
# short last one, and a batch of REENCODE_BATCH at that bucket, ragged
DEPLOY_CMP = ((1, DEPLOY_BUCKETS[-1], (DEPLOY_BUCKETS[-1],)),
              (1, DEPLOY_BUCKETS[-1], (333,)),
              (REENCODE_BATCH, DEPLOY_BUCKETS[-1], (1024, 1000, 777, 600, 384, 129, 1)))
# (encode, decode, reencode) * 4: each op has two or more clips of a bucket
HTTP_LENGTHS = (100, 130, 400, 120, 200, 450, 700, 256, 512, 900, 300, 1000)


def _deploy_tol(want) -> float:
    """The phase's fp32 mel gate: 1e-4 * max(1, max|x|)."""
    return 1e-4 * max(1.0, float(np.abs(want).max()))


def _near_midpoints(model, x, lengths):
    """(B, T) bool: a token of mel x (B, T, mel) whose fp32 pre-round value
    lies within 1e-4 of a rounding midpoint (model: the fp32 in-memory
    generator), under the runtime's own padding."""
    import torch

    x = torch.from_numpy(np.ascontiguousarray(x)).to(model.fsq_consts.device)
    lengths = torch.as_tensor(np.asarray(lengths), device=x.device)
    pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
    h = model._encode_trunk(x, pad)
    near = _fsq_near_midpoint(h.reshape(-1, h.shape[-1]), model.q_in_proj.weight.t(),
                              model.q_in_proj.bias, model.fsq_consts)
    return near.reshape(h.shape[:2]).cpu().numpy()


def _check_tokens(label, got, want, near) -> int:
    """Fail unless got == want wherever near is False; returns the flips."""
    flips = got != want
    if (flips & ~near).any():
        fail(f"{label}: {int((flips & ~near).sum())} tokens differ away from a "
             f"midpoint")
    return int(flips.sum())


def _padded_decode(model, tokens):
    """One full-length fp32 decode of (T,) tokens, with the masked tail of
    32 frames every window also has (the padded convention)."""
    import torch

    t = len(tokens)
    idx = np.zeros((1, t + 32), np.int32)
    idx[0, :t] = tokens
    pad = torch.from_numpy(np.arange(t + 32)[None, :] >= t)
    dev = model.fsq_consts.device
    return model.decode(torch.from_numpy(idx).to(dev), pad.to(dev))[0, :t].float().cpu().numpy()


def _stream(stream, data, chunk):
    outs = [stream.feed(data[i:i + chunk]) for i in range(0, len(data), chunk)]
    outs.append(stream.flush())
    return np.concatenate(outs, axis=0)


def _stream_windows(t, window, halo):
    """The encoder stream's windows (start, stop, keep_lo, keep_hi):
    [k * stride, k * stride + window), stride = window - 2 * halo, kept from
    halo past the start (0 for the first) to halo before the end, the last
    to the clip end."""
    spans, emitted = [], 0
    while emitted < t:
        ws = max(0, emitted - halo)
        we = min(t, ws + window)
        up = t if we == t else we - halo
        spans.append((ws, we, emitted, up))
        emitted = up
    return spans


def _windowed_encode(rt, model, mel, spans):
    """An offline encode over spans (each padded to the largest bucket):
    (tokens, near-midpoint flags)."""
    window = rt.buckets[-1]
    out = np.zeros(len(mel), np.int32)
    near = np.zeros(len(mel), bool)
    for ws, we, lo, hi in spans:
        x = np.zeros((1, window, MELS), np.float32)
        x[0, :we - ws] = mel[ws:we]
        out[lo:hi] = rt.encode(x, [we - ws])[0, lo - ws:hi - ws]
        near[lo:hi] = _near_midpoints(model, x, [we - ws])[0, lo - ws:hi - ws]
    return out, near


class _SpanTimer:
    """Wraps a streamer's window fn: counts the spans and their host-clock
    time (the runtime returns numpy, so each span ends synchronised)."""

    def __init__(self, fn):
        self.fn, self.n, self.seconds = fn, 0, 0.0

    def __call__(self, x, mask):
        t0 = time.perf_counter()
        out = self.fn(x, mask)
        self.seconds += time.perf_counter() - t0
        self.n += 1
        return out

    def ms(self) -> float:
        return 1e3 * self.seconds / max(1, self.n)


def deploy_export(root, state, fp32) -> dict:
    """Phase 13a: three exports through the CLI (bf16 with the default
    poly-decode mixers; fp32 exact and fp32 with both mixers Chebyshev, both
    re-exported from the first artifact's manifest and weights), each
    verified and reloaded on the card; the fp32 artifact's round trip
    against the in-memory model."""
    import torch

    from mqgan_tpu_torch.deploy import export
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

    cfg = os.path.join(root, "flagship.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": DEPLOY_GENERATOR}}, f)
    buckets = [str(b) for b in DEPLOY_BUCKETS]
    dirs = {"bf16": os.path.join(root, "exp_bf16")}
    export.main(["--config", cfg, "--seed", str(SEED), "--output", dirs["bf16"],
                 "--bf16", "--buckets", *buckets])
    weights = os.path.join(dirs["bf16"], "weights.pt")
    for name, flags in (("fp32", ["--exact_mixers"]), ("both", ["--poly_mixers"])):
        dirs[name] = os.path.join(root, f"exp_{name}")
        export.main(["--manifest", dirs["bf16"], "--checkpoint", weights,
                     "--output", dirs[name], "--buckets", *buckets, *flags])
    saved = torch.load(weights, weights_only=True)
    if set(saved) != set(state) or not all(torch.equal(saved[k], state[k]) for k in state):
        fail("the exported weights are not the seeded flagship generator's")
    rts = {}
    for name, d in dirs.items():
        export.verify_export(d)
        rts[name] = ExportedPreEncoder(d)
        m = rts[name].manifest
        print(f"  export {name}: dtype {m['dtype']}, poly_mixers {m['poly_mixers']}, "
              f"buckets {m['buckets']}, halos {m['halos']}, decoder_halos "
              f"{m['decoder_halos']}, encoder_halo {m['encoder_halo']}, align "
              f"{m['halo_align']}, device {rts[name].device}")
    if rts["bf16"].device.type != "cuda":
        fail("ExportedPreEncoder(dir) did not default to the card")

    rng = np.random.default_rng(SEED + 20)
    t = ROUND_T
    lengths = np.array([t, 3 * t // 4, t // 2, 1], np.int32)
    x = rng.standard_normal((4, t, MELS)).astype(np.float32)
    rt = rts["fp32"]
    tokens, mel = rt.reencode(x, lengths)
    tb = rt.bucket_for(t)
    xp = np.zeros((4, tb, MELS), np.float32)
    xp[:, :t] = x
    near = _near_midpoints(fp32, xp, lengths)[:, :t]
    dev = fp32.fsq_consts.device
    pad = torch.from_numpy(np.arange(tb)[None, :] >= lengths[:, None]).to(dev)
    want_tokens = fp32.encode(torch.from_numpy(xp).to(dev), pad)[:, :t].cpu().numpy()
    valid = np.arange(t)[None, :] < lengths[:, None]
    flips = _check_tokens("artifact vs in-memory encode", tokens[valid],
                          want_tokens[valid], near[valid])
    idx = np.zeros((4, tb), np.int32)
    idx[:, :t] = tokens
    want = fp32.decode(torch.from_numpy(idx).to(dev), pad)[:, :t].cpu().numpy()
    err = float(np.abs(mel - want)[valid].max())
    print(f"  fp32 artifact vs in-memory model, B=4 T={t} lengths "
          f"{lengths.tolist()}: {flips} token flips, decode max|err| {err:.3e} "
          f"(limit {_deploy_tol(want):.3e})")
    if err > _deploy_tol(want):
        fail("the fp32 artifact's decode disagrees with the in-memory model")
    both_tokens = rts["both"].encode(x, lengths)
    print(f"  poly_mixers=True (the pre mixer through mel_mixer_poly), fp32: "
          f"{int((both_tokens != tokens)[valid].sum())} of {int(valid.sum())} "
          f"tokens differ from the exact export (counted, not gated)")
    return rts


def deploy_reencode(root, rts, fp32) -> str:
    """Phase 13b/c: the re-encode CLI over a directory through the fp32 exact
    artifact (gated) and the bf16 poly-decode one (timed), then token stats
    on the dump; returns the dump's directory."""
    import torch

    from mqgan_tpu_torch.core.chunking import chunk_plan
    from mqgan_tpu_torch.deploy import reencode, token_stats

    src = os.path.join(root, "mels")
    rng = np.random.default_rng(SEED + 21)
    mels = {}
    for i, n in enumerate(REENCODE_LENGTHS):
        name = f"{'long' if n > DEPLOY_BUCKETS[-1] else 'clip'}_{i:02d}.npy"
        mels[name] = rng.standard_normal((n, MELS)).astype(np.float32)
        os.makedirs(os.path.join(src, "set"), exist_ok=True)
        np.save(os.path.join(src, "set", name), mels[name])
    frames = sum(REENCODE_LENGTHS)
    toks_dir = os.path.join(root, "tokens")
    for label, d in (("fp32 exact", "fp32"), ("bf16 poly-decode", "bf16")):
        out = os.path.join(root, f"out_{d}")
        args = ["--input_dir", src, "--output_dir", out, "--model_dir",
                os.path.join(root, f"exp_{d}"), "--batch_size", str(REENCODE_BATCH)]
        if d == "fp32":
            args += ["--save_tokens", "--tokens_dir", toks_dir]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = reencode.main(args)
        seconds = time.perf_counter() - t0
        if result != {"processed": len(mels), "failed": 0, "frames": frames}:
            fail(f"re-encode {label}: {result}")
        for name, m in mels.items():
            got = np.load(os.path.join(out, "set", name))
            if got.shape != m.shape or not np.isfinite(got).all():
                fail(f"re-encode {label}: {name} {got.shape}")
        print(f"  re-encode CLI, {label}: {len(mels)} files, {frames} frames in "
              f"{seconds:.3f} s: {frames / seconds:.1f} mel-frames/s (batch "
              f"{REENCODE_BATCH}, the CLI's whole run: loading, windows, writes)")
    rt = rts["fp32"]
    dec_l, dec_r = rt.decoder_halos
    window = rt.buckets[-1]
    flips = 0
    worst = 0.0
    for name, m in mels.items():
        toks = np.load(os.path.join(toks_dir, "set", name))
        if len(m) <= window:  # within one bucket: a direct encode's tokens
            want = rt.encode(m[None])[0]
            tb = rt.bucket_for(len(m))
            xp = np.zeros((1, tb, MELS), np.float32)
            xp[0, :len(m)] = m
            near = _near_midpoints(fp32, xp, [len(m)])[0, :len(m)]
            flips += _check_tokens(f"re-encode {name} vs a direct encode",
                                   toks.astype(np.int32), want, near)
            continue
        # chunked: the dumped tokens decoded through the decode-side chunk
        # plan against one full-length decode
        out = np.zeros((len(m), MELS), np.float32)
        for s in chunk_plan(len(m), window, dec_l, dec_r, align=rt.halo_align):
            idx = np.zeros((1, window), np.int32)
            idx[0, :s.stop - s.start] = toks[s.start:s.stop]
            seg = rt.decode(idx, [s.stop - s.start])[0]
            out[s.keep_lo:s.keep_hi] = seg[s.local_lo:s.local_hi]
        want = _padded_decode(fp32, toks.astype(np.int32))
        err = float(np.abs(out - want).max())
        worst = max(worst, err / _deploy_tol(want))
        print(f"  {name} ({len(m)} frames): chunked decode of its tokens vs one "
              f"full-length decode, max|err| {err:.3e} (limit {_deploy_tol(want):.3e})")
        if err > _deploy_tol(want):
            fail(f"chunked decode of {name} disagrees with the full-length decode")
    print(f"  files within one bucket: tokens equal a direct encode ({flips} "
          f"flips at midpoints)")
    stats = token_stats.compute_token_stats(toks_dir, rt.codebook_size)
    print(f"  token stats: {stats.n_files} files, {stats.n_tokens} tokens, "
          f"{stats.used_codes}/{stats.codebook_size} codes, unigram "
          f"{stats.unigram_entropy_bits:.2f} bits")
    if (stats.n_tokens != frames or stats.n_files != len(mels) or stats.n_failed
            or stats.out_of_range_tokens or stats.special_tokens):
        fail(f"token stats disagree with the dump: {stats.summary()}")
    return toks_dir


def deploy_streaming(root, rts, fp32, toks_dir, card) -> None:
    """Phase 13d: streaming decode and encode at B=1 through the fp32 exact
    artifact (gated against offline), and the time a span takes there and
    through the bf16 poly-decode artifact."""
    from mqgan_tpu_torch.core.chunking import chunk_plan
    from mqgan_tpu_torch.deploy.streaming import StreamingDecoder, StreamingEncoder

    name = f"long_{REENCODE_LENGTHS.index(STREAM_T):02d}.npy"
    tokens = np.load(os.path.join(toks_dir, "set", name)).astype(np.int32)
    rt = rts["fp32"]
    dec = StreamingDecoder.from_runtime(rt)
    dec.fn = timer = _SpanTimer(dec.fn)
    streamed = _stream(dec, tokens, STREAM_CHUNK)
    want = _padded_decode(fp32, tokens)
    err = float(np.abs(streamed - want).max())
    print(f"  StreamingDecoder fp32 exact, window {dec.window}, {STREAM_T} tokens "
          f"in chunks of {STREAM_CHUNK}: {timer.n} spans of (1, {dec.window}), "
          f"{timer.ms():.3f} ms a span [{card}]; latency {dec.latency_frames} "
          f"frames; vs the offline decode max|err| {err:.3e} (limit "
          f"{_deploy_tol(want):.3e})")
    if streamed.shape != want.shape or err > _deploy_tol(want):
        fail("streamed decode disagrees with the offline decode")
    fast = StreamingDecoder.from_runtime(rts["bf16"])
    fast.fn = fast_timer = _SpanTimer(fast.fn)
    out = _stream(fast, tokens, STREAM_CHUNK)
    if out.shape != want.shape or not np.isfinite(out).all():
        fail("bf16 poly-decode stream: bad output")
    print(f"  StreamingDecoder bf16 poly-decode: {fast_timer.n} spans, "
          f"{fast_timer.ms():.3f} ms a span [{card}]")

    mel = np.random.default_rng(SEED + 22).standard_normal(
        (STREAM_T, MELS)).astype(np.float32)
    enc = StreamingEncoder.from_runtime(rt)
    enc.fn = enc_timer = _SpanTimer(enc.fn)
    got = _stream(enc, mel, STREAM_CHUNK)
    halo, window = rt.encoder_halo, rt.buckets[-1]
    want_tokens, near = _windowed_encode(rt, fp32, mel, _stream_windows(STREAM_T, window, halo))
    flips = _check_tokens("streamed tokens vs the offline pass over the stream's "
                          "windows", got, want_tokens, near)
    plan = [(s.start, s.stop, s.keep_lo, s.keep_hi)
            for s in chunk_plan(STREAM_T, window, halo, halo, align=1)]
    plan_tokens, _ = _windowed_encode(rt, fp32, mel, plan)
    print(f"  StreamingEncoder fp32 exact: {enc_timer.n} spans, {enc_timer.ms():.3f} "
          f"ms a span [{card}]; latency {enc.latency_frames} frames; tokens equal "
          f"the offline pass over its windows ({flips} flips at midpoints); "
          f"{int((plan_tokens != want_tokens).sum())} of {STREAM_T} differ from "
          f"chunk_plan's windows (CBAM statistics over other frames, printed)")

    x = tokens[None, :window]
    for name in ("fp32", "bf16"):
        for _ in range(3):
            rts[name].decode(x)
        events, wall = _device_profile(lambda: rts[name].decode(x))
        _report_profile(f"one B=1 decode span, {name} artifact [{card}]",
                        events, wall, top=5)


def deploy_http(rts, fp32) -> None:
    """Phase 13e: StreamingHTTPServer on localhost over the fp32 exact
    artifact: 12 concurrent whole clips (encode, decode and reencode) and 2
    duplex streams, answers against direct runtime calls."""
    from mqgan_tpu_torch.deploy.http_client import CodecClient
    from mqgan_tpu_torch.deploy.http_streaming import (StreamingHTTPServer,
                                                       StreamingHTTPService)
    from mqgan_tpu_torch.deploy.streaming import StreamingDecoder, StreamingEncoder

    rt = rts["fp32"]
    rng = np.random.default_rng(SEED + 23)
    ops = ("encode", "decode", "reencode") * 4
    clips = [rng.standard_normal((n, MELS)).astype(np.float32) for n in HTTP_LENGTHS]
    toks = [rng.integers(0, rt.codebook_size, n).astype(np.int32) for n in HTTP_LENGTHS]
    duplex_mels = [rng.standard_normal((600, MELS)).astype(np.float32) for _ in range(2)]
    service = StreamingHTTPService(runtime=rt, max_batch=64, max_delay_ms=300.0,
                                   stream_max_batch=8, stream_max_delay_ms=20.0)
    results = {}
    with StreamingHTTPServer(service) as srv:
        client = CodecClient(srv.url)

        def clip(i):
            op = ops[i]
            results[i] = getattr(client, op)(toks[i] if op == "decode" else clips[i])

        def duplex(j):
            with client.open_duplex() as s:
                results[f"duplex{j}"] = _stream(s, duplex_mels[j], 50)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(ops) + 2) as pool:
            futures = [pool.submit(clip, i) for i in range(len(ops))]
            futures += [pool.submit(duplex, j) for j in range(2)]
            for f in futures:
                f.result(timeout=600)
        seconds = time.perf_counter() - t0
        stats, stream_stats = client.stats(), client.stream_stats()
        health = client.health()
    if health["device"] != str(rt.device):
        fail(f"HTTP health {health}")
    flips = 0
    for i, op in enumerate(ops):
        got = results[i]
        n = HTTP_LENGTHS[i]
        if op == "decode":
            want = rt.decode(toks[i][None])[0]
            if got.shape != want.shape or np.abs(got - want).max() > _deploy_tol(want):
                fail(f"HTTP decode of {n} tokens disagrees with the runtime")
            continue
        tb = rt.bucket_for(n)
        xp = np.zeros((1, tb, MELS), np.float32)
        xp[0, :n] = clips[i]
        near = _near_midpoints(fp32, xp, [n])[0, :n]
        want_tokens = rt.encode(clips[i][None])[0]
        got_tokens = got[0] if op == "reencode" else got
        flips += _check_tokens(f"HTTP {op} of {n} frames", got_tokens, want_tokens, near)
        if op == "reencode":
            want = rt.decode(got_tokens[None])[0]
            if np.abs(got[1] - want).max() > _deploy_tol(want):
                fail(f"HTTP reencode mel of {n} frames disagrees with the runtime")
    for j in range(2):
        solo_tokens = _stream(StreamingEncoder.from_runtime(rt), duplex_mels[j], 50)
        want = _stream(StreamingDecoder.from_runtime(rt), solo_tokens, 50)
        got = results[f"duplex{j}"]
        err = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
        print(f"  duplex stream {j}: {got.shape[0]} frames, vs the solo duplex "
              f"max|err| {err:.3e} (limit {_deploy_tol(want):.3e})")
        if err > _deploy_tol(want):
            fail(f"duplex stream {j} disagrees with a solo duplex")
    means = {op: stats[op]["mean_batch_size"] for op in stats}
    spans = {k: stream_stats[k]["mean_batch_size"] for k in ("decode", "encode")}
    print(f"  HTTP: {len(ops)} clips + 2 duplex streams in {seconds:.3f} s; "
          f"mean batch size {means}, of the duplex spans {spans}; {flips} token "
          f"flips at midpoints")
    if not all(m > 1 for m in means.values()):
        fail(f"HTTP clips were not batched: {means}")


def deploy_kernel_checks(state, device) -> dict:
    """Phase 13, before the path: every codec kernel of the deployment path
    against its plain version at that path's own shapes (DEPLOY_CMP), fp32
    and bf16 at phase 3's gates: the six blocks, both exact mixers, the FSQ
    head, and the Chebyshev kernel on the post mixer (poly-decode) and the
    pre mixer (poly "encode"/True). Returns each kernel's largest bf16
    |kernel - plain|."""
    import torch

    model = build_model(device, torch.bfloat16, state=state)
    errs = {}
    for b, t, lengths in DEPLOY_CMP:
        tag = f"B={b} T={t} "
        found = compare_kernels(model, device, b, t, lengths,
                                (torch.float32, torch.bfloat16), tag=tag)
        found["mel_mixer_poly"] = max(
            compare_poly(model, device, b, t, lengths, tag=tag, mixer=mixer)
            for mixer in ("post", "pre"))
        for kernel, err in found.items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
    return errs


def compare_bf16_artifact(rt, state) -> None:
    """Phase 13, after the path: one B=2 window (lengths the largest bucket
    and ROUND_T) of the bf16 artifact (poly-decode, the CLI's default)
    against a CPU copy of its model, which runs the plain versions: the
    encoder trunk and the decode of the CPU's tokens through the artifact,
    each at the bf16 kernel gate (rel-L2 <= 2e-2) over the valid frames;
    token flips are counted, not gated (bf16 sums in another order flip
    some, phase 3c)."""
    import torch

    t = rt.buckets[-1]
    lengths = np.array([t, ROUND_T], np.int32)
    x = np.random.default_rng(SEED + 24).standard_normal((2, t, MELS)).astype(np.float32)
    pad = torch.from_numpy(np.arange(t)[None, :] >= lengths[:, None])
    valid = ~pad
    cpu = build_model("cpu", torch.bfloat16, poly_mixers=rt.model.poly_mixers, state=state)
    xt = torch.from_numpy(x)
    h_cpu = cpu._encode_trunk(xt, pad)
    idx_cpu = cpu.encode(xt, pad)
    mel_cpu = cpu.decode(idx_cpu, pad)
    h_card = rt.model._encode_trunk(xt.to(rt.device), pad.to(rt.device)).cpu()
    tokens = rt.encode(x, lengths)
    mel = torch.from_numpy(rt.decode(idx_cpu.numpy(), lengths))
    ok_h, _, det_h = _judge("encoder trunk", h_card[valid], h_cpu[valid], torch.bfloat16)
    ok_m, _, det_m = _judge("decode", mel[valid], mel_cpu[valid], torch.bfloat16)
    flips = int((torch.from_numpy(tokens) != idx_cpu)[valid].sum())
    ok = ok_h and ok_m and mel.shape == mel_cpu.shape
    print(f"  bf16 artifact ({rt.manifest['poly_mixers']}) vs a CPU copy (plain "
          f"versions), B=2 T={t} lengths {lengths.tolist()}: {det_h.strip()}; "
          f"{det_m.strip()}; {flips} of {int(valid.sum())} tokens differ (counted) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"the bf16 artifact disagrees with its plain CPU copy: {det_h}; {det_m}")


def codec_deployment(state, device, counters, card) -> dict:
    """Phase 13: the codec deployment path at flagship width, seeded
    weights: its kernels against their plain versions at its own shapes,
    then export and reload, the re-encode CLI over a directory, token
    stats, streaming at B=1, the HTTP servers (launches counted), and the
    bf16 artifact against its plain CPU copy; returns each kernel's largest
    bf16 |kernel - plain| of the phase."""
    import torch

    print(f"  [13k] kernels vs plain versions at the deployment path's shapes {DEPLOY_CMP}")
    errs = deploy_kernel_checks(state, device)
    root = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    fp32 = build_model(device, torch.float32, state=state)
    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    try:
        counters.reset()
        rts = deploy_export(root, state, fp32)
        lap("a")
        toks_dir = deploy_reencode(root, rts, fp32)
        lap("bc")
        deploy_streaming(root, rts, fp32, toks_dir, card)
        lap("d")
        deploy_http(rts, fp32)
        lap("e")
        launches = counters.snapshot()
        compare_bf16_artifact(rts["bf16"], state)
        lap("bf16 vs CPU")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  launches in phase 13: {launches}")
    for name in ("residual_block", "mel_mixer", "mel_mixer_poly", "fsq_head"):
        if launches.get(name, 0) <= 0:
            fail(f"phase 13: {name} was not launched on the deployment path")
    for name in ("log_mel", "log_mel_dft", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if launches.get(name, 0):
            fail(f"phase 13: {name} launched on the deployment path")
    print(f"  phase 13 seconds by part: {seconds}")
    return errs


# phase 14, codec GAN training at flagship width: (a) steps card vs CPU,
# (b) the training branch vs the kernel path, (c) the trainer on seeded
# mels (lengths drawn from TRAIN_CLIP_FRAMES), (d) step times
TRAIN_CMP_B, TRAIN_CMP_T = 2, 128
TRAIN_B, TRAIN_T = 16, 256
TRAIN_CLIPS, TRAIN_CLIP_FRAMES = 96, (150, 1500)
TRAIN_WARM, TRAIN_ITERS = 2, 5
TRAIN_EVAL_BATCH = {"residual_block": 6, "mel_mixer": 2, "fsq_head": 1}


def gan_config(inert: bool, **training):
    """The flagship config (TrainConfig()'s defaults are
    configs/model_config_hifispeech.yaml's values, which the card's machine
    cannot read: no PyYAML); ``inert``: dropout and FSQ noise at rate 0."""
    import dataclasses

    from mqgan_tpu_torch.core.config import TrainConfig

    cfg = TrainConfig()
    gen = cfg.model.generator
    if inert:
        gen = dataclasses.replace(gen, dropout=0.0, fsq_noise_dropout=0.0)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, generator=gen),
        training=dataclasses.replace(cfg.training, **training))


def gan_state(cfg, device, dtype=None, weights=None, inert=False):
    """A TrainState of seeded (or ``weights``') flagship models on device."""
    from mqgan_tpu_torch.train.state import create_train_state
    from mqgan_tpu_torch.train.step import build_models
    from mqgan_tpu_torch.utils.init import seeded_init_

    models = build_models(cfg, dtype)
    for i, m in enumerate(models):
        if weights is None:
            seeded_init_(m, SEED + 40 + i)
        else:
            m.load_state_dict(weights[i])
    state = create_train_state(*(m.to(device) for m in models), cfg.training,
                               device)
    if inert:
        state.dropout_rng = state.fsq_rng = None
    return state


def _param_grads(state) -> dict:
    """Every parameter's gradient on the CPU by model (0 where none reached
    it: the generator's hidden_proj feeds only the detached refiner input)."""
    import torch

    return {name: [(torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu()
                   for p in m.parameters()]
            for name, m in (("gen", state.gen), ("patch", state.patch),
                            ("multibin", state.multibin))}


def compare_gan_steps(device) -> None:
    """Phase 14a: one fp32 warmup step and one fp32 GAN + feature-matching
    step of the flagship on the card against the same steps on the CPU
    (plain versions), B=2 T=128 (one row of 97 frames), dropout inert, the
    flagship learning rates: loss terms within 1e-5 * max(1, |loss|),
    gradients within 1e-4 * max(1, max|g|) per model. The D update is held
    on its own: the spectral stats it writes within 1e-5 * max(1, max|x|),
    and each weight's update within lr_d / 10 of the CPU's where the D
    gradient is not 0 up to the gradient gate (elsewhere Adam steps by
    +-lr_d with the rounding's sign, ROADMAP.md Queue 3: within 2 lr_d).
    Then the card's discriminators take the CPU's updated weights and
    stats, so that the G loss and its gradients run through the same
    discriminators on both sides."""
    import torch

    from mqgan_tpu_torch.train.step import make_train_step

    cfg = gan_config(True, use_fm_loss=True)
    lr_d = cfg.training.lr * cfg.training.lr_d_factor
    gen = torch.Generator().manual_seed(SEED + 41)
    mel = torch.randn((TRAIN_CMP_B, TRAIN_CMP_T, MELS), generator=gen)
    lengths = torch.tensor([TRAIN_CMP_T, 97], dtype=torch.int32)

    def discs(st):
        return (("patch", st.patch), ("multibin", st.multibin))

    for train_d in (False, True):
        cpu = gan_state(cfg, torch.device("cpu"), inert=True)
        weights = [{k: v.clone() for k, v in m.state_dict().items()}
                   for m in (cpu.gen, cpu.patch, cpu.multibin)]
        card = gan_state(cfg, device, weights=weights, inert=True)
        card_d = {}  # the card's own D state after its update
        card_d_step = card.disc_opt.step

        def d_step_then_cpu_weights():
            norm = card_d_step()
            with torch.no_grad():
                for (name, m), (_, src) in zip(discs(card), discs(cpu)):
                    card_d[name] = {k: v.detach().cpu().clone()
                                    for k, v in m.state_dict().items()}
                    for k, v in m.state_dict().items():
                        v.copy_(src.state_dict()[k])
            return norm

        card.disc_opt.step = d_step_then_cpu_weights
        out = {}
        for name, st, dev in (("cpu", cpu, "cpu"), ("card", card, device)):
            m = make_train_step(cfg, train_d=train_d)(st, mel.to(dev), lengths.to(dev))
            out[name] = ({k: float(v) for k, v in m.items()}, _param_grads(st))
        loss_err = max(abs(out["card"][0][k] - v) / max(1.0, abs(v))
                       for k, v in out["cpu"][0].items() if k.startswith("loss"))
        ok = loss_err <= 1e-5
        parts = []
        for model, want in out["cpu"][1].items():
            got = out["card"][1][model]
            g_max = max(float(g.abs().max()) for g in want)
            g_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ok = ok and g_err <= 1e-4 * max(1.0, g_max)
            parts.append(f"{model} max|dgrad| {g_err:.2e} (max|g| {g_max:.2e})")
        if train_d:
            upd_live = upd_rest = stat_err = 0.0
            for i, (name, m) in enumerate(discs(cpu), 1):
                grads = dict(m.named_parameters())
                for k, v in m.state_dict().items():
                    mine = card_d[name][k]
                    if k not in grads:  # u, sigma
                        err = float((mine - v).abs().max())
                        stat_err = max(stat_err, err)
                        ok = ok and err <= 1e-5 * max(1.0, float(v.abs().max()))
                        continue
                    g = grads[k].grad
                    live = g.abs() > 1e-4 * max(1.0, float(g.abs().max()))
                    d = ((mine - weights[i][k]) - (v - weights[i][k])).abs()
                    upd_live = max(upd_live, float(d[live].max()) if live.any() else 0.0)
                    upd_rest = max(upd_rest, float(d[~live].max()) if (~live).any() else 0.0)
            ok = ok and upd_live <= lr_d / 10 and upd_rest <= 2 * lr_d
            parts.append(f"D update: spectral stats max|d| {stat_err:.2e}, weight "
                         f"updates max|d| {upd_live:.2e} (<= lr_d/10 = {lr_d / 10:.2e}) "
                         f"where the D gradient is live, {upd_rest:.2e} "
                         f"(<= 2 lr_d) elsewhere")
        print(f"  14a {'GAN+FM' if train_d else 'warmup'} step fp32 B={TRAIN_CMP_B} "
              f"T={TRAIN_CMP_T}: loss_g_total card {out['card'][0]['loss_g_total']:.6f} "
              f"cpu {out['cpu'][0]['loss_g_total']:.6f}, loss_d "
              f"{out['card'][0]['loss_d']:.6f}; max rel |dloss| {loss_err:.2e}; "
              f"{'; '.join(parts)} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("phase 14a: the GAN step on the card disagrees with the CPU")


def compare_train_branch(device) -> None:
    """Phase 14b: the generator's training-branch forward (fp32, dropout
    inert) against its eval forward through the kernels, B=16 T=256 with
    ragged lengths: tokens equal away from midpoints; recon_post within
    2e-4 * max(1, max|x|) on the rows whose tokens all agree."""
    import torch

    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.utils.init import seeded_init_

    cfg = gan_config(True)
    model = PreEncoder.from_config(MELS, cfg.model.generator)
    model = seeded_init_(model, SEED + 42).to(device)
    gen = torch.Generator(device=device).manual_seed(SEED + 43)
    mel = torch.randn((TRAIN_B, TRAIN_T, MELS), generator=gen, device=device)
    lengths = torch.linspace(TRAIN_T, 100, TRAIN_B, device=device).int()
    with torch.no_grad():
        _, post_t, tok_t = model(mel, lengths, deterministic=False)
        _, post_k, tok_k = model(mel, lengths)
    near = _near_midpoints(model, mel.cpu().numpy(), lengths.cpu().numpy())
    valid = (np.arange(TRAIN_T)[None, :] < lengths.cpu().numpy()[:, None])
    flips = _check_tokens("14b tokens", tok_t.cpu().numpy() * valid,
                          tok_k.cpu().numpy() * valid, near)
    rows = ~((tok_t.cpu().numpy() != tok_k.cpu().numpy()) & valid).any(axis=1)
    want = post_k.float().cpu().numpy()[rows]
    err = float(np.abs(post_t.float().cpu().numpy()[rows] - want).max())
    tol = 2e-4 * max(1.0, float(np.abs(want).max()))
    print(f"  14b training branch vs kernel path fp32 B={TRAIN_B} T={TRAIN_T}: "
          f"{flips} token flips near midpoints; recon_post max|d| {err:.2e} "
          f"(gate {tol:.2e}, {int(rows.sum())} rows) {'ok' if err <= tol else 'FAIL'}")
    if err > tol:
        fail("phase 14b: the training branch disagrees with the kernel path")


def trainer_cli(device, counters, card) -> dict:
    """Phase 14c, the slice's main path: the trainer CLI, flagship config,
    bf16, default fast dropout, on TRAIN_CLIPS seeded mels, epoch 1 warmup
    and epoch 2 GAN, eval and save every epoch; no launch inside a train
    step, TRAIN_EVAL_BATCH per eval batch; a third epoch resumes; the saved
    generator exports (fp32 exact mixers) and round-trips through
    ExportedPreEncoder like the in-memory model. Returns the launches."""
    import dataclasses

    import torch

    from mqgan_tpu_torch.deploy import export
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.train import trainer as trainer_mod
    from mqgan_tpu_torch.utils.checkpoint import save_generator_only

    root = tempfile.mkdtemp(prefix="chip_smoke_gan_")
    rng = np.random.default_rng(SEED + 44)
    os.makedirs(os.path.join(root, "mels"))
    for i in range(TRAIN_CLIPS):
        t = int(rng.integers(*TRAIN_CLIP_FRAMES))
        np.save(os.path.join(root, "mels", f"m{i:03d}.npy"),
                rng.standard_normal((t, MELS)).astype(np.float32))
    cfg = dataclasses.asdict(gan_config(False, num_epochs=2,
                                        discriminator_train_start_epoch=2))
    cfg["data"].update(data_dir=os.path.join(root, "mels"),
                       output_dir=os.path.join(root, "run"))
    cfg["logging"].update(eval_interval=1, save_interval=1, num_plot_examples=1)
    cfg_path = os.path.join(root, "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    seen = {"train": 0, "eval": 0, "step_launches": {}}
    eval_inputs = []  # (mel, lengths) of each eval call of the first run
    make_step, make_eval = trainer_mod.make_train_step, trainer_mod.make_eval_step

    def counting_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, mel, lengths):
            before = counters.snapshot()
            out = step(state, mel, lengths)
            for k, v in counters.snapshot().items():
                if v != before.get(k, 0):
                    seen["step_launches"][k] = v - before.get(k, 0)
            seen["train"] += 1
            return out
        return run

    def counting_eval(*a, **kw):
        ev = make_eval(*a, **kw)

        def run(gen, mel, lengths):
            seen["eval"] += 1
            if not seen.get("resumed"):
                eval_inputs.append((mel.clone(), lengths.clone()))
            return ev(gen, mel, lengths)
        return run

    args = ["--config", cfg_path, "--no_wandb", "--device", str(device)]
    try:
        trainer_mod.make_train_step, trainer_mod.make_eval_step = counting_step, counting_eval
        counters.reset()
        t0 = time.perf_counter()
        trainer = trainer_mod.main(args)
        secs = time.perf_counter() - t0
        launches, n_eval, n_train = counters.snapshot(), seen["eval"], seen["train"]
        cfg["training"]["num_epochs"] = 3
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        seen["resumed"] = True
        resumed = trainer_mod.main(args)
    finally:
        trainer_mod.make_train_step, trainer_mod.make_eval_step = make_step, make_eval
    with open(os.path.join(root, "run", "train_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    by_epoch = {e: [r for r in recs if r.get("epoch") == e and "loss_g_total" in r]
                for e in (1.0, 2.0, 3.0)}
    want = {k: v * n_eval for k, v in TRAIN_EVAL_BATCH.items()}
    finite = all(math.isfinite(v) for r in recs for v in r.values()
                 if isinstance(v, float))
    phases_ok = (by_epoch[1.0] and all(r["loss_d"] == 0.0 for r in by_epoch[1.0])
                 and by_epoch[2.0] and all(r["loss_d"] > 0.0 for r in by_epoch[2.0]))
    print(f"  14c trainer CLI: {n_train} train steps (B={cfg['data']['batch_size']}, crops "
          f"256/192/128, bf16, fast dropout) and {n_eval} eval batches in "
          f"{secs:.2f} s (set-up, eval and checkpoints included); last losses "
          f"epoch 1 {by_epoch[1.0][-1]['loss_g_total']:.4f}, epoch 2 "
          f"{by_epoch[2.0][-1]['loss_g_total']:.4f} (loss_d "
          f"{by_epoch[2.0][-1]['loss_d']:.4f}); launches {launches} (want {want}); "
          f"launches inside train steps {seen['step_launches']}")
    if not finite or not phases_ok:
        fail("phase 14c: non-finite losses or a phase missing")
    if launches != want or seen["step_launches"]:
        fail(f"phase 14c: launches {launches} != {want}, or a train step "
             f"launched {seen['step_launches']}")
    if resumed.start_epoch != 3 or not by_epoch[3.0]:
        fail("phase 14c: the third epoch did not resume from the checkpoint")
    print(f"  14c resumed at epoch {resumed.start_epoch}: {seen['train'] - n_train} "
          f"more train steps, to step {resumed.state.step}")
    compare_eval_kernels(trainer.state.gen, eval_inputs)
    # the trained generator: export and round trip
    gen_path = save_generator_only(root, trainer.state.gen.state_dict())
    art = os.path.join(root, "artifact")
    export.main(["--config", cfg_path, "--checkpoint", gen_path, "--output", art,
                 "--buckets", "256", "512", "--exact_mixers", "--device", str(device)])
    rt = ExportedPreEncoder(art, device=device)
    model = PreEncoder.from_config(MELS, trainer.config.model.generator)
    model.load_state_dict(torch.load(gen_path, weights_only=True))
    model = model.to(device).eval()
    mel = rng.standard_normal((2, 512, MELS)).astype(np.float32)
    lengths = np.array([512, 300], np.int32)
    tokens = rt.encode(mel, lengths)
    x = torch.from_numpy(mel).to(device)
    pad = torch.from_numpy(np.arange(512)[None, :] >= lengths[:, None]).to(device)
    ref_tokens = model.encode(x, pad).cpu().numpy()
    flips = _check_tokens("14c artifact tokens", tokens, ref_tokens,
                          _near_midpoints(model, mel, lengths))
    got = rt.decode(ref_tokens, lengths)
    ref = model.decode(torch.from_numpy(ref_tokens).to(device), pad).float().cpu().numpy()
    err = max(float(np.abs(got[i, :n] - ref[i, :n]).max()) for i, n in enumerate(lengths))
    tol = _deploy_tol(ref)
    print(f"  14c export of the trained generator: {flips} token flips near "
          f"midpoints; decode max|d| {err:.2e} (gate {tol:.2e}) "
          f"{'ok' if err <= tol else 'FAIL'}")
    shutil.rmtree(root, ignore_errors=True)
    if err > tol:
        fail("phase 14c: the exported generator disagrees with the trained one")
    return launches


def compare_eval_kernels(gen, inputs) -> None:
    """Phase 14c, after the counted runs: the trainer's own eval inputs
    (each epoch's train-image batch, fill rows of length 0 included, and
    each eval window at its bucket) through the trained bf16 generator's
    eval step again, each kernel call held against its plain version on the
    same arguments at phase 3's gates (bf16 rel-L2 <= 2e-2; FSQ indices
    equal away from midpoints), and the padded frames of the block and the
    mixer bit-equal to the plain version's."""
    import torch

    from mqgan_tpu_torch.models import preencoder
    from mqgan_tpu_torch.nn import blocks, mixer2d
    from mqgan_tpu_torch.ops.block_kernels import residual_block_plain
    from mqgan_tpu_torch.ops.fsq_kernels import fsq_encode_plain
    from mqgan_tpu_torch.ops.mixer_kernels import mel_mixer_plain
    from mqgan_tpu_torch.train.step import make_eval_step

    if not any(bool((lengths == 0).any()) for _, lengths in inputs):
        fail("phase 14c: no eval input of the trainer holds a zero-length row")
    found = {k: {"calls": 0, "max_abs": 0.0, "rel": 0.0, "bad": 0}
             for k in TRAIN_EVAL_BATCH}

    def note(kernel, ok, max_abs, rel=0.0):
        f = found[kernel]
        f["calls"] += 1
        f["max_abs"] = max(f["max_abs"], max_abs)
        f["rel"] = max(f["rel"], rel)
        f["bad"] += not ok

    def held(kernel, wrapper, plain):
        def run(x, lengths, w, **kw):
            got = wrapper(x, lengths, w, **kw)
            want = plain(x, lengths, w, **kw)
            ok, max_abs, _ = _judge("", got, want, x.dtype)
            diff = (got.float() - want.float()).norm()
            pad = torch.arange(x.shape[1], device=x.device)[None, :] >= lengths[:, None]
            ok = ok and bool((got[pad] == want[pad]).all())
            note(kernel, ok, max_abs,
                 float(diff / want.float().norm().clamp_min(1e-30)))
            return got
        return run

    def held_fsq(h, w, bias, consts):
        got = _fsq_head(h, w, bias, consts)
        want = fsq_encode_plain(h, w, bias, consts)
        near = _fsq_near_midpoint(h, w, bias, consts)
        far = (got - want)[~near]
        far_err = int(far.abs().max()) if far.numel() else 0
        note("fsq_head", far_err == 0, float(far_err))
        return got

    _block, _mixer, _fsq_head = (blocks.fused_residual_block, mixer2d.fused_mel_mixer,
                                 preencoder.fsq_encode_head)
    eval_step = make_eval_step()
    try:
        blocks.fused_residual_block = held("residual_block", _block, residual_block_plain)
        mixer2d.fused_mel_mixer = held("mel_mixer", _mixer, mel_mixer_plain)
        preencoder.fsq_encode_head = held_fsq
        for mel, lengths in inputs:
            eval_step(gen, mel, lengths)
    finally:
        blocks.fused_residual_block, mixer2d.fused_mel_mixer = _block, _mixer
        preencoder.fsq_encode_head = _fsq_head
    shapes = [f"B={m.shape[0]} T={m.shape[1]} shortest row {int(n.min())}"
              for m, n in inputs]
    print(f"  14c the trainer's {len(inputs)} eval inputs ({'; '.join(shapes)}) "
          f"again, bf16, each kernel call vs its plain version:")
    for kernel, f in found.items():
        what = ("indices differ away from a midpoint by at most "
                f"{f['max_abs']:.0f}" if kernel == "fsq_head" else
                f"worst rel-L2 {f['rel']:.2e} (<= 2e-2), max|k-p| {f['max_abs']:.3e}, "
                f"padded frames bit-equal")
        print(f"    {kernel:15s} {f['calls']} calls: {what} "
              + ("ok" if not f["bad"] else f"FAIL in {f['bad']}"))
    want_calls = {k: v * len(inputs) for k, v in TRAIN_EVAL_BATCH.items()}
    if {k: f["calls"] for k, f in found.items()} != want_calls:
        fail(f"phase 14c: kernel calls compared {found} != {want_calls}")
    if any(f["bad"] for f in found.values()):
        fail("phase 14c: a kernel disagrees with its plain version on the "
             "trainer's eval inputs")


GAN_PARTS = ("gan/g_forward", "gan/d_forward", "gan/d_backward", "gan/d_optimizer",
             "gan/g_loss", "gan/g_backward", "gan/g_optimizer")


def _split_by_part(fn) -> dict:
    """{part: [span ms, kernel ms, elementwise kernel ms]} of one call of
    ``fn`` (a train step) in which each of the step's gan/* ranges
    synchronises the card where it starts and where it ends, so that every
    kernel runs within the host span of the range that launched it, the
    ones that autograd's device thread launches for a backward included;
    a kernel goes to the range whose span holds its start. The span is
    host time: it holds the card's idle time while the host launches."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mqgan_tpu_torch.train import step as step_mod

    real = step_mod.record_function

    @contextlib.contextmanager
    def synced(name):
        torch.cuda.synchronize()
        with real(name):
            yield
            torch.cuda.synchronize()

    step_mod.record_function = synced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        step_mod.record_function = real
    events = prof.events()
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU and e.name in GAN_PARTS}
    out = {name: [(end - start) / 1e3, 0.0, 0.0] for name, (start, end) in spans.items()}
    out["outside the ranges"] = [0.0, 0.0, 0.0]
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("gan/"):
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        owner = next((n for n, (a, b) in spans.items()
                      if a <= e.time_range.start <= b), "outside the ranges")
        out[owner][1] += ms
        if "elementwise" in e.name.lower():
            out[owner][2] += ms
    return out


def train_step_times(device, card) -> None:
    """Phase 14d: ms/step and trained mel-frames/s (B * T per step) of the
    warmup and the GAN step at B=16 T=256 bf16, flagship, for fast dropout
    (the CLI default), exact dropout, --remat and --grad_accum 2:
    TRAIN_WARM warm-up then TRAIN_ITERS timed steps (CUDA events), peak
    device memory; then a profile of one fast-dropout GAN step by part."""
    import dataclasses

    import torch

    from mqgan_tpu_torch.train.step import make_train_step

    base = gan_config(False)
    variants = (("fast dropout", {"fast_dropout": True}, 1),
                ("exact dropout", {}, 1),
                ("--remat", {"fast_dropout": True, "remat": True}, 1),
                ("--grad_accum 2", {"fast_dropout": True}, 2))
    gen = torch.Generator(device=device).manual_seed(SEED + 45)
    data = [torch.randn((TRAIN_B, TRAIN_T, MELS), generator=gen, device=device)
            for _ in range(TRAIN_WARM + TRAIN_ITERS)]
    lengths = torch.full((TRAIN_B,), TRAIN_T, dtype=torch.int32, device=device)
    for label, gen_kw, accum in variants:
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, generator=dataclasses.replace(base.model.generator, **gen_kw)))
        for train_d in (False, True):
            state = gan_state(cfg, device, torch.bfloat16)
            step = make_train_step(cfg, train_d=train_d, dtype=torch.bfloat16,
                                   grad_accum=accum)
            for mel in data[:TRAIN_WARM]:
                step(state, mel, lengths)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: [step(state, mel, lengths)
                                  for mel in data[TRAIN_WARM:]], 1) / TRAIN_ITERS
            peak = torch.cuda.max_memory_allocated() / 1e9
            m = step(state, data[0], lengths)
            loss = float(m["loss_g_total"])
            print(f"  14d {label:15s} {'GAN   ' if train_d else 'warmup'}: "
                  f"{ms:9.3f} ms/step, {TRAIN_B * TRAIN_T / (ms / 1e3):10.1f} "
                  f"mel-frames/s, peak {peak:6.2f} GB, loss {loss:.4f} [{card}]")
            if not math.isfinite(loss):
                fail(f"phase 14d: {label} loss not finite")
            if label == "fast dropout" and train_d:
                profile_gan_step(lambda: step(state, data[1], lengths), ms, card)
            del state, step
            torch.cuda.empty_cache()


def profile_gan_step(run, step_ms, card) -> None:
    """Phase 14e: where one GAN step's time goes: the kernels of one
    profiled step and the card's idle share against the unprofiled step
    time, then the step by part from a second, synchronised pass
    (_split_by_part)."""
    events, wall = _device_profile(run)
    # (the gan/* ranges' own device spans are not kernels)
    events = [(k, ms) for k, ms in events if not k.startswith("gan/")]
    print(f"[14e] where the time goes, one GAN step B={TRAIN_B} T={TRAIN_T} bf16 "
          f"fast dropout [{card}]")
    busy = _report_profile("GAN step", events, wall, top=10)
    print(f"    device busy {busy:.3f} ms against the unprofiled {step_ms:.3f} ms "
          f"step: idle share {1 - busy / step_ms:.3f}")
    parts = _split_by_part(run)
    print("    by part, a second pass that synchronises the card at each part's "
          "start and end (span: the part's host time, the card's idle time "
          "while the host launches included; kernels: the card's busy time):")
    for name in GAN_PARTS + ("outside the ranges",):
        span, kern, elem = parts.get(name, (0.0, 0.0, 0.0))
        print(f"    {name:18s} " + (f"span {span:9.3f} ms, kernels {kern:9.3f} ms "
                                     f"(elementwise {elem:8.3f} ms)" if kern else
                                     "not measured (no kernel of its own)"))
    kern = {n: parts.get(n, (0.0, 0.0, 0.0))[1] for n in GAN_PARTS}
    total = sum(p[1] for p in parts.values())
    print(f"    kernels by part: G forward {kern['gan/g_forward']:.3f} ms, G loss "
          f"through the D's {kern['gan/g_loss']:.3f} ms, G backward "
          f"{kern['gan/g_backward']:.3f} ms, D forward {kern['gan/d_forward']:.3f} ms, "
          f"D backward {kern['gan/d_backward']:.3f} ms, optimizers "
          f"{kern['gan/d_optimizer'] + kern['gan/g_optimizer']:.3f} ms, elementwise "
          f"(all parts) {sum(p[2] for p in parts.values()):.3f} ms, of {total:.3f} ms")


def codec_training(device, counters, card) -> dict:
    """Phase 14: codec GAN training at flagship width (a)-(d); returns the
    trainer CLI's launches."""
    import torch

    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    with torch.enable_grad():
        compare_gan_steps(device)
        lap("a")
        compare_train_branch(device)
        lap("b")
        launches = trainer_cli(device, counters, card)
        lap("c")
        train_step_times(device, card)
        lap("d")
    print(f"  phase 14 seconds by part: {seconds}")
    return launches


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

    def at() -> str:
        return f"(at {time.perf_counter() - t_start:.0f} s)"

    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] card: {card} ({torch.cuda.device_count()} visible); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    _cuda.LIBRARY.load()
    print(f"[2] kernels built in {_cuda.LIBRARY.build_seconds:.1f} s")
    report = _cuda.ptxas_report()
    print(report)
    for kernel, variant, regs, st, ld in ptxas_summary(report):
        print(f"  ptxas {kernel}{'' if variant is None else f' {variant}'}: {regs} "
              f"registers, spill stores {st} B, spill loads {ld} B")
    print_mixer_sass(str(_cuda.build_library()[0]))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(device, torch.bfloat16)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    print(f"[3] kernels vs plain versions, B={CMP_B} T={CMP_T} "
          f"lengths {CMP_LENGTHS} {at()}")
    errs = compare_kernels(model, device, CMP_B, CMP_T, CMP_LENGTHS,
                           (torch.float32, torch.bfloat16))
    music = build_model(device, torch.bfloat16, music=True)
    for kernel, err in compare_kernels(music, device, CMP_B, CMP_T, CMP_LENGTHS,
                                       (torch.float32, torch.bfloat16),
                                       tag="hifimusic ").items():
        errs[kernel] = max(errs[kernel], err)
    errs["fsq_head"] = max(errs["fsq_head"], compare_fsq_head(model, device),
                           compare_fsq_head(music, device, tag="hifimusic "))
    errs["mel_mixer_poly"] = max(
        compare_poly(model, device, CMP_B, CMP_T, CMP_LENGTHS, main_path=True),
        compare_poly(music, device, CMP_B, CMP_T, CMP_LENGTHS, tag="hifimusic "))
    del music
    errs["residual_block"] = max(errs["residual_block"], compare_ragged_blocks(device))
    print(f"[3c] FSQ tokens through the pre mixer's kernel, B={BENCH_B} T={BENCH_T} {at()}")
    compare_pre_mixer_tokens(state, device)
    errs["log_mel"], dft_launches = compare_log_mel(device)
    compare_round_trip(state, device)

    counters = _cuda.COUNTERS
    print(f"[4] serving (bf16, exact mixers) {at()}")
    launches = serve(model, device, counters)
    per_batch = {"residual_block": 6, "fsq_head": 1, "mel_mixer": 2}

    print(f"[5] round-trip throughput, B={BENCH_B} T={BENCH_T} bf16 "
          f"[{card}] {at()}")
    torch.cuda.reset_peak_memory_stats()
    exact, _ = throughput(model, device, counters, per_batch)
    poly = build_model(device, torch.bfloat16, poly_mixers="decode", state=state)
    # poly-decode, the serving default: the post mixer through the
    # Chebyshev kernel (the main path of mel_mixer_poly)
    poly_fps, poly_launches = throughput(poly, device, counters,
                                         dict(per_batch, mel_mixer=1, mel_mixer_poly=1))
    launches["mel_mixer_poly"] = poly_launches["mel_mixer_poly"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  exact mixers: {exact:.1f} mel-frames/s")
    print(f"  poly-decode mixers: {poly_fps:.1f} mel-frames/s")
    print(f"  peak device memory {peak_gb:.2f} GB")
    print(f"[5b] where the time goes, one round trip B={BENCH_B} T={BENCH_T} "
          f"bf16 [{card}]")
    profile_round_trip(model, device, "exact")
    profile_round_trip(poly, device, "poly-decode")
    del poly

    print(f"[6] convert on the card (hifispeech spec) {at()}")
    convert_on_card(counters)

    print(f"[7] audio round trip, {AUDIO_B} clips x {AUDIO_SAMPLES} samples, "
          f"codec bf16 exact mixers, ISTFTNetGenerator() bf16 [{card}] {at()}")
    torch.cuda.reset_peak_memory_stats()
    launches.update(log_mel=audio_round_trip(model, device, counters, card)["log_mel"],
                    log_mel_dft=dft_launches)

    print(f"[8] kernel times at B={BENCH_B} T={BENCH_T} [{card}] {at()}")
    rows = kernel_times(model, device)
    del model
    torch.cuda.empty_cache()

    print(f"[9] flash-attention kernels vs plain versions, T {FLASH_TS}, "
          f"D {FLASH_DS}, B=2 H=4 {at()}")
    errs.update(compare_flash(device))
    print("[9b] flash backward run twice: bit-identical dq, dk, dv")
    check_flash_determinism(device)
    lm_root = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    try:
        with torch.enable_grad():
            print(f"[10] token-LM training slice (MusicTransformer flagship width) {at()}")
            compare_lm_step(device)
            launches.update(lm_trainer_cli(counters, device, lm_root))
            print(f"[10c] training throughput, bf16 [{card}] {at()}")
            lm_throughput(device, counters, card)
            print(f"[10e] --arch lstm [{card}]")
            lstm_step(device, card)
        print(f"[11] flash kernel times at the flagship layer call [{card}] {at()}")
        rows += flash_times(device, errs)
        print(f"[12] token-LM serving, flagship widths [{card}] {at()}")
        lm_serving(os.path.join(lm_root, "run"), lstm_run_dir(lm_root), device,
                   counters, card)
    finally:
        shutil.rmtree(lm_root, ignore_errors=True)
    print(f"[13] codec deployment, flagship width, seeded weights [{card}] {at()}")
    for kernel, err in codec_deployment(state, device, counters, card).items():
        errs[kernel] = max(errs.get(kernel, 0.0), err)
    print(f"[14] codec GAN training, flagship width [{card}] {at()}")
    codec_training(device, counters, card)
    kernels = []
    for row in rows:
        kernels.append({
            "name": row.name, "route": "cuda", "source": row.source,
            "replaces": row.replaces, "launches": launches.get(row.name, 0),
            "max_abs_err": max(errs.get(row.name, 0.0), row.max_abs_err),
            "ms": row.ms, "plain_ms": row.plain_ms, "bound_ms": row.bound_ms,
            "bound_by": row.bound_by, "library_ms": row.library_ms,
        })
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--fsq-head-of":
        fsq_head_of(sys.argv[2])
    else:
        main()
