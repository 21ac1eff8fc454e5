#!/usr/bin/env python3
"""Drive the PyTorch port's codec serving path, its audio path, its
token-LM training path, its token-LM serving path, its codec deployment
path, its codec training path, its vocoder training path, its LM
artifact with codec attach, its parallel codec serving, its
data-parallel and pipelined training, its sequence-parallel training and
its codec artifact's traced programs (CUDA graphs, the int8 refiner) on
one NVIDIA GPU (H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --fsq-head-of DIR   # time another checkout's FSQ head
    python3 chip_smoke.py --seq-training      # phase 19 alone, no result line

Run from the root of a checkout. It needs one CUDA card and exits non-zero,
printing no result, without one. Phases (any failure exits non-zero):

 1. check the card; print its name and power limit (nvidia-smi);
 2. build the hand-written CUDA kernels from mqgan_tpu_torch/csrc (nvcc,
    sm_90a) and print the build time, the ptxas register report and a
    summary of registers and spills of the mma.sync kernels
    (flash_fwd_mma, flash_bwd_dq_mma, flash_bwd_dkv_mma per head size,
    conv_gemm_mma), of the int8 conv's wgmma kernel per (BN, BK) and of
    the mixer kernels (the exact kernel per dtype and
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
    where a radix-2 pass ends the FFT; the mixed-radix kernel at n_fft 1200
    (16 kHz, hop 300, 80 mels, 0.25 s of leading silence), at n_fft 1000
    (hop 250), at 1764 (44.1 kHz: radix 7), at 480 (48 kHz, 8 frames a
    block), at 128 on B=3 x 65 samples (reflected edges only) and at 8192
    (one frame a block); the Bluestein kernel at n_fft 1201 (odd, 15,000
    samples that hop 300 divides: JAX's frame count, one fewer than samples
    // hop + 1), at 2050 (n_fft / 2 = 5^2 * 41), at 1144 (11 * 13) and at 88
    on B=3 x 45 samples (reflected edges only); the DFT kernel at n_fft 9605
    (odd, past the Bluestein kernel's L). Then the whole fp32 round trip
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
    function and the DFT kernel (the first design, now the route for the
    shapes no other kernel takes) at that n_fft; row 4b, the mixed-radix
    kernel at its own shapes (phase 3's n_fft 1200 and 1000 on the 64-clip
    batch, beside its bound, the DFT kernel at the same n_fft, its earlier
    design, and the torch.stft chain); row 4c, the Bluestein kernel at
    n_fft 2050 and 1201 on that batch (its L, the DFT kernel there, the
    row's earlier design, and the torch.stft chain); row 4d, the DFT kernel
    at n_fft 9605 on phase 3's B=2 case; and print one JSON line of them; the log-mel kernel and
    rows 4b and 4c are first held against their plain version in float64 at that
    batch (64 clips; max|k - p64| <= 1e-4, or no more than the fp32 plain
    version's own error, since fp32 rounding reaches ~1e-4 in the log
    domain at near-silent single-bin mels), and their bounds are the
    function's: an FFT per frame and the filterbank's nonzeros, not F x
    n_mels; the FSQ head
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
    calls (printed beside); print the kernels JSON line (twelve rows: the
    mixed-radix and DFT log-mel kernels' launches are phase 3's, the front
    end at the n_fft each takes, the only path that selects them);
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
    through the export CLI at buckets 128/512/1024 (bf16 poly-decode,
    the CLI default; fp32 exact and, at 1024 alone, fp32 poly both,
    re-exported from the first's manifest and weights.pt; each a traced
    program per op, bucket and platform), each verified and reloaded with
    ExportedPreEncoder(dir) on the card (a CUDA graph per shape); the fp32 artifact's round trip
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
    fast dropout, --async_checkpoint) on 96 seeded mels of 150-1500
    frames, batch 16, crops 256/192/128, epoch 1 warmup and epoch 2 GAN,
    eval and save every epoch (counts reset just before, read just
    after): finite losses in both phases, no kernel launch inside a train
    step, 6 residual_block, 2 mel_mixer and 1 fsq_head launches per eval
    batch; a third epoch resumes from the background writer's
    checkpoint; the trained generator, saved and
    exported (fp32, exact mixers), round-trips through ExportedPreEncoder
    as the in-memory model does (tokens away from midpoints, mel within
    1e-4 * max(1, max|x|)); (d) ms/step, trained mel-frames/s (B*T per
    step) and peak memory of the warmup and the GAN step at B=16 T=256
    bf16 for fast and exact dropout, --remat and grad_accum 2 (2 warm-up,
    5 timed steps, CUDA events); (e) a profile of one fast-dropout GAN
    step: kernel groups, elementwise and optimizer kernels, the device
    span of each part of the step (gan/* ranges) and the idle share;
15. vocoder training at full width (the vocoder trainer CLI's defaults:
    the hifispeech spec, B=16 segments of 32 frames, upsample 8 x 8 from
    512 channels, iSTFT n_fft 16, MPD periods 2/3/5/7/11, MSD 3 scales),
    TF32 off: (a) one fp32 spectral step and one adversarial step on the
    card against the same steps on the CPU, B=2, the same log-mels: losses
    within 1e-5 * max(1, |loss|), each update within lr / 10 of the CPU's
    where the gradient is live and the two sides agree on it to 5% (the
    adversarial step's D update on its own, then the card's discriminators
    take the CPU's weights); printed: the generator's backward card vs CPU
    beside the CPU's own spread, the MR-STFT gradient on noise;
    (b) one SegmentSampler batch (16 x 16,384 samples) through the log-mel
    kernel against its plain version in float64, one launch: the mel power
    error relative to each frame's power no more than max(1e-6, the fp32
    plain version's) (a resampled clip's empty top bands make the log
    domain ill-conditioned at the 1e-5 floor); (c) the
    trainer CLI on 12 seeded wavs, 3 spectral then 3 adversarial steps,
    --export_dir (counts reset just before, read just after): finite losses
    under the JAX metric keys, one log_mel launch per batch and none else,
    checkpoints, ISTFTNetFE.load_ts serving the artifact's program (a
    symbolic batch and frame count) at (b, t) = (1, 10) and (3, 23): spec
    and phase as the in-memory generator's, the waveform as the in-memory
    wrapper's (1e-5 * max(1, max|x|)); (d) ms/step, trained
    audio-s/s and peak memory, spectral and adversarial, fp32 and --bf16
    (2 warm-up, 5 timed steps, CUDA events), no host synchronisation in a
    step (CUDA sync debug mode; one torch.istft call's are printed); (e) a
    profile of one fp32
    adversarial step: kernel groups, idle share, kernel ms per voc/* range;
16. the LM artifact and codec attach: (a) the phase-10 transformer run
    (fp32 and bf16 KV) and the seeded LSTM run exported through the
    export_lm CLI (torch.export programs traced on the card, verified
    there), each artifact replayed as CUDA graphs: its sampled and greedy
    tokens equal to its in-process model's served sampler at the padded
    bucket (the capturing dispatch and a replay), its scores within
    1e-5 * max(1, |nll|), its step program writing the cache or carries
    in place; (b) the codec's decode kernels (3 blocks, the Chebyshev
    post mixer) against their plain versions at the traffic's decode
    shapes, and LMHTTPServer over the transformer artifact with phase
    13's bf16 poly-decode codec: 12 concurrent /generate requests with
    decode true (counts reset just before, read just after): tokens in
    [2, 1000), each mel equal to ExportedPreEncoder.decode of its tokens,
    3 residual_block and 1 mel_mixer_poly launches per decode, no other;
    (c) each artifact's replayed decode at B=64, prompt 0, L=512: ms per
    token beside 12f's eager figure, host synchronisations per dispatch
    (none in the loop), the idle share of an L=32 dispatch, the graphs'
    memory;
17. parallel codec serving (flagship generator, seeded, TF32 off): (a) the
    split residual_block launch of the three CBAM blocks (begin: conv
    GEMMs and the pool over a frame range; finish: gate MLP, SAM, tail)
    against the unsplit kernel with the range [0, length) and no
    reduction at phase 3's shapes (max difference printed, expect 0), and
    against its plain version on the 4 windows of a B=2 clip pair of
    16,384 and 11,000 frames, statistics reduced over the windows, at
    phase 3's gates; (b) seq-parallel re-encode (tokens, x_recon, x_post)
    and decode of that pair on 4 windows of the card, fp32, against one
    full-length pass (counts reset just before, read just after: tokens
    equal away from midpoints, the mels within 1e-4 * max(1, max|x|) of a
    full-length decode of the same tokens; residual_block_split,
    residual_block, mel_mixer and fsq_head launched, mel_mixer_poly not),
    the thread route against the stacked one, and ms and peak memory of
    the bf16 seq-parallel call and of one full pass (2 warm-up, 5 timed,
    CUDA events); (c) phase 13's fp32 exact and bf16 poly-decode artifacts
    with data_parallel over [cuda:0, cuda:0] against one device on a
    ragged batch of 7 (tokens equal; fp32 mels within 1e-4 * max(1,
    max|x|), expect 0; bf16 poly-decode mels at the bf16 gate: each slice
    fits its own Chebyshev range), and the re-encode CLI with
    --seq_parallel over phase 13's mels (each file's tokens equal a
    full-length encode away from midpoints); then the split launch's time
    at the windows' shapes (row 1b of the kernels line);
18. data-parallel and pipelined training at flagship width (TrainConfig(),
    the LM trainer's LSTM; TF32 off): (a) two ranks (``parallel/
    multihost.py`` ``launch``; gloo on the one card, NCCL where there are
    two) against one process on the global batch, 3 fp32 GAN + feature-
    matching steps, B=4 T=128 with lengths 128, 128 | 97, 0 (unequal
    valid counts and a fill row on the two ranks), dropout inert: losses
    within 1e-5 * max(1, |loss|) every step; after the first step (both
    from the same weights, as phase 14a holds a step) the gradients within
    1e-4 * max(1, max|g|) per model, LeCam and the spectral stats within
    1e-5 * max(1, max|x|), updates within lr / 10 where the gradient is
    live; the last step's printed; the ranks bit-equal; the same run with
    rank-local denominators printed; (b) the trainer CLI under two ranks
    on phase 14c's data and config (bf16, epoch 1 warmup, epoch 2 GAN,
    eval and save each epoch): the ranks bit-equal, finite losses, no
    launch inside a train step, rank 0's eval 6 residual_block, 2
    mel_mixer and 1 fsq_head per eval batch and rank 1 none (counts reset
    just before, read just after), rank 0 alone writing; then 4 epochs
    with a SIGTERM on both ranks at epoch 3's first step (one checkpoint,
    both exit 0) and a two-rank rerun that resumes at epoch 4; (c) ms/step
    and peak memory per rank of the 2 x 8 bf16 GAN step against the 1 x 16
    step at B=16 T=256 (2 warm-up, 5 timed, CUDA events), the all-reduce's
    ms and bytes per step; (d) the flagship LSTM's stack pipelined, a
    layer a stage x 4 microbatches on the card, against the serial stack
    (fp32 within 1e-5 * max(1, max|x|), bf16 rel-L2 <= 2e-2, logits and
    gradients), train-step tokens/s of both at B=8 L=256, and the LM
    trainer CLI with and without --pipe (finite losses);
19. sequence-parallel training at flagship width (TF32 off): (a) seq ranks
    (``launch``; gloo on the one card) against one process on the whole
    crop at 18a's gates, with cuDNN's deterministic algorithms, fp32 GAN +
    feature matching x 3, B=4: 2 seq ranks at T=128 (lengths 128, 40, 97,
    0: a row ending inside seq rank 0's shard and a fill row) and at T=40
    (20-frame shards, off the discriminators' 8-frame stride grid), and a
    data 2 x seq 2 grid of four ranks at T=128; the ranks bit-equal; the
    same run with each shard zero-padded at its edges (no exchange) must
    break the gates; (b) the trainer CLI with --seq_par 2 (bf16, epoch 1
    warmup, epoch 2 GAN, eval and save each epoch): the ranks bit-equal,
    finite losses, no launch inside a train step, rank 0's plots and eval
    (on its own card) launching residual_block, mel_mixer and fsq_head,
    rank 1 none; SIGTERM at epoch 3's first step (one checkpoint) and a
    rerun that resumes at epoch 4; (c) ms/step, peak and held memory per
    rank of the bf16 GAN step with B=16 T=256 over 2 seq ranks against one
    process, and the halo exchanges' calls, bytes and ms in a synchronised
    step. These launch counts are printed on their own line and stay out
    of the kernels line, as phase 18's do;
20. the codec artifact as traced programs (flagship width, seeded
    weights, TF32 off): (a) each kernel's torch.library op (mqgan::*)
    against its kernel wrapper on the same card inputs, bit for bit, and
    torch.library.opcheck on the card; the host's microseconds per call of
    the int8 conv's and the FSQ head's ops against their wrappers at the
    main path's shapes (the eager entry points call the wrappers); (b)
    three exports through the CLI at buckets 128/512 (fp32 exact, bf16
    poly-decode, bf16 poly-decode --int8_refiner), each one's programs
    called eagerly against the in-memory model on the kernels (tokens equal away from midpoints, the
    decode of the same tokens at phase 3's gates) at B=1 T=128, B=1 T=77,
    B=7 ragged and B=2 T=512, with the launches of one encode + decode (6
    residual_block, 1 fsq_head, the mixers, 14 int8_conv), and the fp32
    artifact's CPU programs (the card's, moved) on the CPU against the
    model there, bit for bit; (c) each
    runtime's CUDA-graph calls (the capturing call and a replay) equal to
    the eager programs bit for bit at B=1 and B=7 ragged in both buckets,
    encode and reencode, and the graph of 8 repeat-padded rows against
    the unpadded 7-row call (tokens equal, the mel at phase 13's gates:
    cuBLAS and cuDNN may take another algorithm for 7 rows); a B=1 decode
    span (T=1024, phase 13's bf16
    artifact) timed eager vs replayed with its idle share, and the
    graphs' memory (that span and B=64); (d) int8_conv against its plain
    version at each of the refiner's 14 int8 conv shapes (B=2 T=512, fp32
    and bf16: codes and int32 sums equal, the output within one ulp), its
    whole-call time at B=64 T=512 beside the plain version, its bound (int8
    ops at 1,979 TOP/s or bytes) and cuDNN's bf16 conv2d (the yardstick),
    one profiled call of each conv split into the max pass, the quantize
    pass and the conv kernel beside their bounds (the conv's TOP/s and
    share of the peak); the same gates at B=3 on every combination of H 1,
    13, 40, W 100, 144, Cin 64, 192, 768 and Cout 64, 256, 512 (tiles cut
    by the image's edges, BK 64, N tiles of 64 and 256), fp32 and bf16; an
    eager bf16 int8 round trip at B=3 T=77 against a CPU copy of its model
    (the decode of the card's tokens at the bf16 gate, rel-L2 <= 2e-2);
    and the bf16 round trip at B=64 T=512 with and without the int8
    refiner (mel-frames/s printed; deviation within 0.1 * max|mel|, the
    JAX test's bound), each profiled once by kernel, with the per-call
    weight quantization of the 14 convs timed alone (printed, not
    gated). Counts reset before (b), read after (c); the int8_conv row
    joins the kernels line;
21. print {"ok": true, "device": {...}} as the last line.

A fatal signal prints every thread's Python stack (faulthandler). Once the
last line is out, and every process the script started has been joined,
the script leaves with os._exit(0): the interpreter's teardown runs the
CUDA runtime's and the profiler's (CUPTI's) exit handlers, which can race
and abort an otherwise finished run ("Fatal glibc error:
pthread_mutex_lock ... assertion failed", exit code 134).
"""

from __future__ import annotations

import faulthandler
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
# phase 3's case of the DFT kernel, the only one its route gives it (clips,
# samples, leading silence of clip 0), which phase 8 times as row 4d
DFT_ONLY_BATCH = (2, 60_001, 12_000)
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
# 12f's dispatch by name: (its eager ms per token, its tokens), which 16c
# prints beside the replayed decode's and holds the artifact's tokens to
EAGER_DECODE: dict = {}
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
    if "conv_kernelILi" in mangled:  # the int8 conv's <BN, BK>
        bn, bk = re.findall(r"Li(\d+)E", mangled)[:2]
        return f"BN={bn} BK={bk}"
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
    spill bytes loaded) of each mma.sync kernel, the int8 conv's wgmma
    kernel and each mixer kernel entry in the ptxas report."""
    kernels = ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma", "conv_gemm_mma",
               "conv_kernel", "fsq_head_kernel",
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


def mixed_configs() -> tuple:
    """The two spectrogram configs of row 4b: even n_fft that are no power
    of two, so that the front end takes the mixed-radix kernel: n_fft 1200
    (M = 600 = 4 * 2 * 3 * 5 * 5) and 1000 (M = 500 = 4 * 5 * 5 * 5), 16
    kHz, 80 mels."""
    from mqgan_tpu_torch.core.config import SpectrogramConfig

    return tuple(SpectrogramConfig(sampling_rate=16000, filter_length=n, hop_length=n // 4,
                                   win_length=n, n_mel_channels=80, mel_fmax=8000.0)
                 for n in (1200, 1000))


def dft_config():
    """Row 4c's first spec, on the Bluestein kernel's route (the DFT
    kernel's before it): n_fft 2050 (M = 1025 = 5^2 * 41), hop 512 (512
    frames of the audio batch's clips), 128 mels."""
    from mqgan_tpu_torch.core.config import SpectrogramConfig

    return SpectrogramConfig(filter_length=2050, hop_length=512, win_length=2050)


def bluestein_configs() -> tuple:
    """Row 4c's specs: n_fft 2050 (dft_config) and the odd n_fft 1201 (hop
    300, 873 frames of the audio batch's clips), 128 mels, 44.1 kHz."""
    from mqgan_tpu_torch.core.config import SpectrogramConfig

    return dft_config(), SpectrogramConfig(filter_length=1201, hop_length=300,
                                           win_length=1201)


def dft_only_config():
    """Row 4d's spec, a shape only the DFT kernel takes: the odd n_fft 9605,
    past the Bluestein kernel's 14406-point L, hop 2401, 128 mels, 44.1
    kHz."""
    from mqgan_tpu_torch.core.config import SpectrogramConfig

    return SpectrogramConfig(filter_length=9605, hop_length=2401, win_length=9605)


def _log_mel_work(wav, cfg, fbank) -> tuple:
    """(flops, bytes, frames) of the log-mel function on wav at cfg, counted
    as for row 4: a real FFT of each frame, |.|, the filterbank's nonzeros
    (a multiply-add each), clamp and log; the waveform read once, the
    window, the nonzeros and the log-mel written once."""
    from mqgan_tpu_torch.signal.stft import frame_count

    n_fft, n_freq, n_mels = cfg.filter_length, cfg.n_freqs, cfg.n_mel_channels
    n = wav.shape[0] * frame_count(wav.shape[1], n_fft, cfg.hop_length)
    nnz = int((fbank != 0).sum())
    flops = (2.5 * n * n_fft * math.log2(n_fft) + 4.0 * n * n_freq + 2.0 * n * n_mels
             + 2.0 * n * nnz)
    nbytes = 4.0 * (wav.numel() + cfg.win_length + nnz + n * n_mels)
    return flops, nbytes, n


def log_mel_mixed_row(device) -> "_KernelRow":
    """Phase 8, row 4b at its own shapes: the mixed-radix kernel at the two
    mixed configs on the audio trip's batch (AUDIO_B clips of
    AUDIO_SAMPLES), held against its float64 plain version (max|k - p64| <=
    max(1e-4, the fp32 plain's own error), as row 4), timed with CUDA events
    beside its bound, its fp32 plain version, the DFT kernel at the same
    n_fft (the earlier design of the row) and the torch.stft chain; the row
    sums the two configs."""
    import torch

    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel, log_mel_dft,
                                                  log_mel_plain, log_mel_tables)
    from mqgan_tpu_torch.signal.stft import hann_window

    row = _KernelRow("log_mel_mixed", "mqgan_tpu_torch/csrc/log_mel_mixed.cu",
                     "mqgan_tpu/ops/stft_kernels.py:95")
    wav = _audio_batch(device, SEED + 5)
    row.library_ms = 0.0
    for cfg in mixed_configs():
        hop, n_fft = cfg.hop_length, cfg.filter_length
        tables = log_mel_tables(cfg, device)
        if tables.route != "mixed":
            fail(f"row 4b: n_fft {n_fft} takes the {tables.route} route")
        cos, sin, fbank = (x.to(device) for x in dft_mel_tables(cfg))
        ref = log_mel_plain(wav, *(x.to(device) for x in dft_mel_tables(cfg, np.float64)),
                            hop)
        err = float((log_mel(wav, tables) - ref).abs().max())
        plain_err = float((log_mel_plain(wav, cos, sin, fbank, hop) - ref).abs().max())
        dft_err = float((log_mel_dft(wav, cos, sin, fbank, hop) - ref).abs().max())
        del ref
        limit = max(1e-4, plain_err)
        print(f"  log_mel_mixed n_fft={n_fft} at B={AUDIO_B} x {AUDIO_SAMPLES} against "
              f"the float64 plain version: max|k-p64| {err:.3e} (limit {limit:.3e} = "
              f"max(1e-4, the fp32 plain's {plain_err:.3e})) "
              f"{'ok' if err <= limit else 'FAIL'}; not gated: the DFT kernel's "
              f"{dft_err:.3e}")
        if not err <= limit:
            fail(f"log_mel_mixed n_fft {n_fft} at B={AUDIO_B}: max|k-p64| {err:.3e} > "
                 f"{limit:.3e}")
        window = hann_window(cfg.win_length, device=device)
        ms = time_ms(lambda: log_mel(wav, tables), 10, inner=10)
        dft_ms = time_ms(lambda: log_mel_dft(wav, cos, sin, fbank, hop), 5)
        pms = time_ms(lambda: log_mel_plain(wav, cos, sin, fbank, hop), 3)
        lib = time_ms(lambda: log_mel_library(wav, window, fbank, n_fft, hop,
                                              cfg.win_length), 10, inner=10)
        flops, nbytes, n = _log_mel_work(wav, cfg, fbank)
        bound = row.add(ms, pms, flops, PEAK_FP32, nbytes)
        by = "operations" if flops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes"
        row.library_ms += lib
        row.max_abs_err = max(row.max_abs_err, err)
        print(f"  log_mel_mixed N={n} n_fft={n_fft} F={cfg.n_freqs} "
              f"mels={cfg.n_mel_channels}: {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"plain {pms:.4f} ms, the DFT kernel {dft_ms:.4f} ms, torch.stft chain "
              f"{lib:.4f} ms (the kernel {ms / lib:.2f}x the chain, "
              f"{dft_ms / ms:.1f}x faster than the DFT kernel)")
    return row


def log_mel_bluestein_row(device) -> "_KernelRow":
    """Phase 8, row 4c: the Bluestein kernel at n_fft 2050 and 1201
    (bluestein_configs) on the audio trip's batch, held against its float64
    plain version (max|k - p64| <= max(1e-4, the fp32 plain's own error), as
    rows 4 and 4b), timed with CUDA events beside its bound (the function's,
    an FFT per frame), its fp32 plain version, the DFT kernel at the same
    n_fft (the row's earlier design) and the torch.stft chain; the row sums
    the two configs."""
    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel, log_mel_dft,
                                                  log_mel_plain, log_mel_tables)
    from mqgan_tpu_torch.signal.stft import hann_window

    row = _KernelRow("log_mel_bluestein", "mqgan_tpu_torch/csrc/log_mel_bluestein.cu",
                     "mqgan_tpu/ops/stft_kernels.py:95")
    wav = _audio_batch(device, SEED + 5)
    row.library_ms = 0.0
    for cfg in bluestein_configs():
        hop, n_fft = cfg.hop_length, cfg.filter_length
        tables = log_mel_tables(cfg, device)
        if tables.route != "bluestein":
            fail(f"row 4c: n_fft {n_fft} takes the {tables.route} route")
        length = tables.spectrum.shape[0]
        radices = tables.plan[:, 0].tolist()
        cos, sin, fbank = (x.to(device) for x in dft_mel_tables(cfg))
        ref = log_mel_plain(wav, *(x.to(device) for x in dft_mel_tables(cfg, np.float64)),
                            hop)
        err = float((log_mel(wav, tables) - ref).abs().max())
        plain_err = float((log_mel_plain(wav, cos, sin, fbank, hop) - ref).abs().max())
        dft_err = float((log_mel_dft(wav, cos, sin, fbank, hop) - ref).abs().max())
        del ref
        limit = max(1e-4, plain_err)
        print(f"  log_mel_bluestein n_fft={n_fft} L={length} {radices} at B={AUDIO_B} x "
              f"{AUDIO_SAMPLES} against the float64 plain version: max|k-p64| {err:.3e} "
              f"(limit {limit:.3e} = max(1e-4, the fp32 plain's {plain_err:.3e})) "
              f"{'ok' if err <= limit else 'FAIL'}; not gated: the DFT kernel's "
              f"{dft_err:.3e}")
        if not err <= limit:
            fail(f"log_mel_bluestein n_fft {n_fft} at B={AUDIO_B}: max|k-p64| {err:.3e} > "
                 f"{limit:.3e}")
        window = hann_window(cfg.win_length, device=device)
        ms = time_ms(lambda: log_mel(wav, tables), 10, inner=10)
        dft_ms = time_ms(lambda: log_mel_dft(wav, cos, sin, fbank, hop), 5)
        pms = time_ms(lambda: log_mel_plain(wav, cos, sin, fbank, hop), 3)
        lib = time_ms(lambda: log_mel_library(wav, window, fbank, n_fft, hop,
                                              cfg.win_length), 10, inner=10)
        flops, nbytes, n = _log_mel_work(wav, cfg, fbank)
        bound = row.add(ms, pms, flops, PEAK_FP32, nbytes)
        by = "operations" if flops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes"
        row.library_ms += lib
        row.max_abs_err = max(row.max_abs_err, err)
        own = 2 * 5.0 * n * length * math.log2(length)  # two complex FFTs a frame
        print(f"  log_mel_bluestein N={n} n_fft={n_fft} F={cfg.n_freqs} "
              f"mels={cfg.n_mel_channels} L={length}: {ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), plain {pms:.4f} ms, the DFT kernel {dft_ms:.4f} ms (the earlier "
              f"design), torch.stft chain {lib:.4f} ms (the kernel {ms / lib:.2f}x the "
              f"chain, {dft_ms / ms:.2f}x faster than the DFT kernel); its two L-point "
              f"FFTs {own / 1e9:.2f} GFLOP in fp64, {own / ms / 1e9:.2f} TFLOP/s")
    return row


def log_mel_dft_row(device) -> "_KernelRow":
    """Phase 8, row 4d: the DFT kernel at the one shape its route gives it
    on the main path, phase 3's case (dft_only_config, the odd n_fft 9605,
    on DFT_ONLY_BATCH), seeded, against its float64 plain version (printed
    beside the fp32 plain's error), timed beside its bound (the function's,
    an FFT per frame), its fp32 plain version and the torch.stft chain."""
    import torch

    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel,
                                                  log_mel_plain, log_mel_tables)
    from mqgan_tpu_torch.signal.stft import hann_window

    row = _KernelRow("log_mel_dft", "mqgan_tpu_torch/csrc/log_mel_dft.cu",
                     "mqgan_tpu/ops/stft_kernels.py:95")
    b, n, quiet = DFT_ONLY_BATCH
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    wav = 0.3 * torch.randn((b, n), generator=gen, device=device)
    wav[0, :quiet] = 0.0
    cfg = dft_only_config()
    hop, n_fft = cfg.hop_length, cfg.filter_length
    tables = log_mel_tables(cfg, device)
    if tables.route != "dft":
        fail(f"row 4d: n_fft {n_fft} takes the {tables.route} route")
    cos, sin, fbank = tables.cos, tables.sin, tables.fbank
    ref = log_mel_plain(wav, *(x.to(device) for x in dft_mel_tables(cfg, np.float64)), hop)
    err = float((log_mel(wav, tables) - ref).abs().max())
    plain_err = float((log_mel_plain(wav, cos, sin, fbank, hop) - ref).abs().max())
    del ref
    window = hann_window(cfg.win_length, device=device)
    ms = time_ms(lambda: log_mel(wav, tables), 5)
    pms = time_ms(lambda: log_mel_plain(wav, cos, sin, fbank, hop), 10)
    row.library_ms = time_ms(lambda: log_mel_library(wav, window, fbank, n_fft, hop,
                                                     cfg.win_length), 10, inner=10)
    flops, nbytes, frames = _log_mel_work(wav, cfg, fbank)
    bound = row.add(ms, pms, flops, PEAK_FP32, nbytes)
    row.max_abs_err = err
    product = 4.0 * frames * n_fft * cfg.n_freqs
    print(f"  log_mel_dft N={frames} (B={b} x {n}) n_fft={n_fft} F={cfg.n_freqs} "
          f"mels={cfg.n_mel_channels}: {ms:.4f} ms, bound {bound:.4f} ms "
          f"({row.bound_by}), plain {pms:.4f} ms, torch.stft chain "
          f"{row.library_ms:.4f} ms (the kernel {ms / row.library_ms:.2f}x the chain; "
          f"{product / 1e9:.1f} GFLOP as a product, {product / ms / 1e9:.1f} TFLOP/s); "
          f"max|k-p64| {err:.3e} (the fp32 plain's {plain_err:.3e})")
    return row


def compare_log_mel(device) -> tuple:
    """Phase 3, log-mel: each kernel against its plain version (TF32 off);
    returns the largest |kernel - plain| and the launches of the mixed-radix,
    Bluestein and DFT kernels (their path: the front end at an n_fft the FFT
    kernel does not take, counts reset before each case and read after)."""
    import torch

    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.ops.stft_kernels import (dft_mel_tables, log_mel,
                                                  log_mel_plain, log_mel_tables)
    from mqgan_tpu_torch.signal.mel import LOG_CLIP_VAL
    from mqgan_tpu_torch.signal.stft import frame_count

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    floor = torch.log(torch.tensor(LOG_CLIP_VAL, device=device))
    worst, routed = 0.0, {"log_mel_mixed": 0, "log_mel_bluestein": 0, "log_mel_dft": 0}

    def spec(rate, n_fft, hop, mels):
        return SpectrogramConfig(sampling_rate=rate, filter_length=n_fft, hop_length=hop,
                                 win_length=n_fft, n_mel_channels=mels, mel_fmax=rate / 2)

    cfg1200, cfg1000 = mixed_configs()
    # (label, spec, clips, samples, leading silence of clip 0 in samples,
    # the kernel its shape selects); the FFT kernel: odd log2(n_fft / 2) for
    # its radix-2 pass, 32 and 2 frames a block; the mixed-radix kernel:
    # radix 7, 8 frames a block, 32 frames a block on reflected edges only,
    # one frame a block; the Bluestein kernel: odd n_fft with a sample count
    # that hop divides (JAX's frame count), a prime factor 41, primes 11 and
    # 13, 20 frames a block on reflected edges only; the DFT kernel: an odd
    # n_fft past the Bluestein kernel's limit
    cases = (("hifispeech", SpectrogramConfig(), 8, AUDIO_SAMPLES, 44_100, "log_mel"),
             ("hifispeech", SpectrogramConfig(), 1, 100_003, 0, "log_mel"),
             ("hifispeech edges", SpectrogramConfig(), 3, 1_025, 0, "log_mel"),
             ("hifimusic", SpectrogramConfig(n_mel_channels=160), 2, AUDIO_SAMPLES, 0,
              "log_mel"),
             ("16k n_fft=512", spec(16000, 512, 128, 80), 2, 16_000, 0, "log_mel"),
             ("8k n_fft=256", spec(8000, 256, 64, 40), 3, 8_001, 1_000, "log_mel"),
             ("16k n_fft=1024", spec(16000, 1024, 256, 80), 2, 16_000, 0, "log_mel"),
             ("44.1k n_fft=4096 256 mels", spec(44100, 4096, 1024, 256), 2, 100_003, 0,
              "log_mel"),
             ("16k n_fft=1200", cfg1200, 2, 16_000, 4_000, "log_mel_mixed"),
             ("16k n_fft=1000", cfg1000, 2, 16_003, 0, "log_mel_mixed"),
             ("44.1k n_fft=1764", spec(44100, 1764, 441, 128), 2, 44_100, 4_410,
              "log_mel_mixed"),
             ("48k n_fft=480", spec(48000, 480, 120, 80), 3, 9_001, 0, "log_mel_mixed"),
             ("16k n_fft=128 edges", spec(16000, 128, 32, 40), 3, 65, 0, "log_mel_mixed"),
             ("44.1k n_fft=8192", spec(44100, 8192, 2048, 128), 2, 30_001, 8_192,
              "log_mel_mixed"),
             ("16k n_fft=1201 odd", spec(16000, 1201, 300, 80), 2, 15_000, 4_000,
              "log_mel_bluestein"),
             ("44.1k n_fft=2050", dft_config(), 2, 20_000, 0, "log_mel_bluestein"),
             ("44.1k n_fft=1144", spec(44100, 1144, 286, 128), 3, 20_001, 4_410,
              "log_mel_bluestein"),
             ("16k n_fft=88 edges", spec(16000, 88, 22, 40), 3, 45, 0, "log_mel_bluestein"),
             ("44.1k n_fft=9605 odd", dft_only_config(), *DFT_ONLY_BATCH, "log_mel_dft"))
    for label, cfg, b, n, quiet, kernel in cases:
        n_fft, hop = cfg.filter_length, cfg.hop_length
        tables = log_mel_tables(cfg, device)
        cos, sin, _ = (t.to(device) for t in dft_mel_tables(cfg))  # the plain version's
        wav = 0.3 * torch.randn((b, n), generator=gen, device=device)
        wav[0, :quiet] = 0.0
        # frames whose window sees only zeros: the last sample of frame t is
        # t * hop + n_fft - n_fft // 2 - 1
        silent = max(0, (quiet - (n_fft - n_fft // 2)) // hop + 1)
        _cuda.COUNTERS.reset()
        got = log_mel(wav, tables)
        launches = _cuda.COUNTERS.snapshot()
        want = log_mel_plain(wav, cos, sin, tables.fbank, hop)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        exact = bool((got[0, :silent] == floor).all() and (want[0, :silent] == floor).all())
        ok = (err <= 1e-4 and exact and launches == {kernel: 1}
              and tuple(got.shape) == (b, frame_count(n, n_fft, hop), cfg.n_mel_channels))
        print(f"  {kernel:15s} {label} B={b} x {n}: {tuple(got.shape)} "
              f"max|k-p| {err:.3e} (limit 1e-4), {silent} silent frames "
              f"{'== log(1e-5)' if exact else 'NOT log(1e-5)'}, launches {launches} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{kernel} {label} B={b}: max|k-p| {err:.3e}, silent exact {exact}, "
                 f"launches {launches}")
        worst = max(worst, err)
        for name in routed:
            routed[name] += launches.get(name, 0)
    return worst, routed


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
    largest kernels; returns the busy ms (0.0: the profiler saw nothing).
    ``wall_ms`` None: kernel times summed, no idle share (kernels that
    overlap would count twice)."""
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
    if wall_ms is None:
        print(f"  {label}: kernels summed {busy:.3f} ms ({note})")
    else:
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
    mixed_row, blue_row = log_mel_mixed_row(device), log_mel_bluestein_row(device)
    dft_row = log_mel_dft_row(device)
    print(f"  log_mel N={n} n_fft={n_fft} F={n_freq} mels={n_mels}: {ms:.4f} ms "
          f"(roofline share {bound / ms:.3f}), the DFT kernel {dft_ms:.4f} ms at this "
          f"n_fft, plain "
          f"{pms:.4f} ms, torch.stft chain {mel_row.library_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({mel_row.bound_by}: {flops / 1e9:.2f} GFLOP counting the "
          f"filterbank's {nnz} nonzeros, {dense_flops / 1e9:.2f} counting F x n_mels "
          f"= {n_freq * n_mels} densely; {nbytes / 1e6:.1f} MB)")
    return [blk_row, mix_row, poly_row, fsq_row, mel_row, mixed_row, blue_row, dft_row]


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


def lstm_step_of(root: str) -> None:
    """``python3 chip_smoke.py --lstm-step-of DIR``: the flagship LSTM train
    step of the checkout at DIR (emb 512, 2 layers of 1024, dropout 0.1,
    ClipAdamW) at B=8 L=2048, bf16 and fp32 (TF32 off): ms/step (median of
    LSTM_OF_ITERS after a warm-up step, CUDA events), tokens/s and peak
    memory, to set a parent commit's times beside this commit's within one
    call. No kernel is on this path."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.abspath(root))
    from mqgan_tpu_torch.models import token_lm
    from mqgan_tpu_torch.train.lstm_trainer import ClipAdamW, make_lstm_step
    from mqgan_tpu_torch.utils.init import seeded_init_

    if not token_lm.__file__.startswith(os.path.abspath(root)):
        fail(f"mqgan_tpu_torch came from {token_lm.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    device, (b, length) = torch.device("cuda"), LSTM_OF_SHAPE
    data = lm_batch(device, b, length, SEED + 30)
    for dtype in (torch.bfloat16, None):
        model = seeded_init_(token_lm.build_token_lm(
            dict(LM, arch="lstm", pad_id=0, **PIPE_LSTM), dropout=0.1, dtype=dtype),
            SEED + 15).to(device)
        tx = ClipAdamW(1e-3)
        state = tx.init(model.parameters())
        step = make_lstm_step(model, tx, 0, train=True)
        gen = torch.Generator().manual_seed(SEED)
        loss = float(step(state, *data, gen))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: step(state, *data, gen), LSTM_OF_ITERS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        if not math.isfinite(loss):
            fail(f"lstm step of {root}: loss {loss}")
        print(f"lstm step of {root} B={b} L={length} "
              f"{'bf16' if dtype else 'fp32'}: {ms:.3f} ms/step, "
              f"{b * (length - 1) / (ms / 1e3):.1f} tokens/s, peak {peak:.2f} GB, "
              f"first loss {loss:.4f} [{card_line()}]")
        del model, state, step
        torch.cuda.empty_cache()


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
    EAGER_DECODE[name] = (1e3 * secs / SERVE_L, out)
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
# each bucket is a traced program per op and platform (seconds to trace
# each): phase 20's (128, 512) and the streaming window
DEPLOY_BUCKETS = (128, 512, 1024)
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
    poly-decode mixers; fp32 exact and, at the largest bucket, fp32 with
    both mixers Chebyshev, both re-exported from the first artifact's
    manifest and weights), each verified and reloaded on the card; the fp32 artifact's round trip
    against the in-memory model."""
    import torch

    from mqgan_tpu_torch.deploy import export
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

    cfg = os.path.join(root, "flagship.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": DEPLOY_GENERATOR}}, f)
    buckets = [str(b) for b in DEPLOY_BUCKETS]
    dirs = {"bf16": os.path.join(root, "exp_bf16")}
    t0 = time.perf_counter()
    export.main(["--config", cfg, "--seed", str(SEED), "--output", dirs["bf16"],
                 "--bf16", "--buckets", *buckets])
    secs = {"bf16": round(time.perf_counter() - t0, 1)}
    weights = os.path.join(dirs["bf16"], "weights.pt")
    # the poly-both artifact serves one encode at T=ROUND_T: its largest
    # bucket alone (each bucket is a traced program per platform)
    for name, flags in (("fp32", ["--exact_mixers", "--buckets", *buckets]),
                        ("both", ["--poly_mixers", "--buckets", buckets[-1]])):
        dirs[name] = os.path.join(root, f"exp_{name}")
        t0 = time.perf_counter()
        export.main(["--manifest", dirs["bf16"], "--checkpoint", weights,
                     "--output", dirs[name], *flags])
        secs[name] = round(time.perf_counter() - t0, 1)
    print(f"  export CLI seconds (tracing, saving, verifying): {secs}")
    saved = torch.load(weights, weights_only=True)
    if set(saved) != set(state) or not all(torch.equal(saved[k], state[k]) for k in state):
        fail("the exported weights are not the seeded flagship generator's")
    rts = {}
    for name, d in dirs.items():  # each verified by the CLI
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


def codec_deployment(state, device, counters, card, root=None) -> dict:
    """Phase 13: the codec deployment path at flagship width, seeded
    weights: its kernels against their plain versions at its own shapes,
    then export and reload, the re-encode CLI over a directory, token
    stats, streaming at B=1, the HTTP servers (launches counted), and the
    bf16 artifact against its plain CPU copy; returns each kernel's largest
    bf16 |kernel - plain| of the phase. With ``root`` the artifacts stay
    there (exp_bf16 is phase 16's codec); without, a temporary directory
    is removed."""
    import torch

    print(f"  [13k] kernels vs plain versions at the deployment path's shapes {DEPLOY_CMP}")
    errs = deploy_kernel_checks(state, device)
    keep = root is not None
    root = root or tempfile.mkdtemp(prefix="chip_smoke_deploy_")
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
        if not keep:
            shutil.rmtree(root, ignore_errors=True)
    print(f"  launches in phase 13: {launches}")
    for name in ("residual_block", "mel_mixer", "mel_mixer_poly", "fsq_head"):
        if launches.get(name, 0) <= 0:
            fail(f"phase 13: {name} was not launched on the deployment path")
    for name in ("log_mel", "log_mel_mixed", "log_mel_bluestein", "log_mel_dft",
                 "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
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


def _trainer_run_config(root, rng, clips=TRAIN_CLIPS, frames=TRAIN_CLIP_FRAMES):
    """Phase 14c's run (and phase 18b's and 19b's): ``clips`` seeded mels of
    ``frames`` frames under ``root``/mels, the flagship config for epoch 1
    warmup and epoch 2 GAN, eval and save every epoch, one plot; returns
    (the config dict, its JSON path)."""
    import dataclasses

    os.makedirs(os.path.join(root, "mels"))
    for i in range(clips):
        t = int(rng.integers(*frames))
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
    return cfg, cfg_path


def trainer_cli(device, counters, card) -> dict:
    """Phase 14c, the slice's main path: the trainer CLI, flagship config,
    bf16, default fast dropout, --async_checkpoint, on TRAIN_CLIPS seeded
    mels, epoch 1 warmup and epoch 2 GAN, eval and save every epoch; no
    launch inside a train step, TRAIN_EVAL_BATCH per eval batch; a third
    epoch resumes from the background writer's checkpoint; the saved
    generator exports (fp32 exact mixers) and round-trips through
    ExportedPreEncoder like the in-memory model. Returns the launches."""
    import torch

    from mqgan_tpu_torch.deploy import export
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.train import trainer as trainer_mod
    from mqgan_tpu_torch.utils.checkpoint import save_generator_only

    root = tempfile.mkdtemp(prefix="chip_smoke_gan_")
    rng = np.random.default_rng(SEED + 44)
    cfg, cfg_path = _trainer_run_config(root, rng)
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

    args = ["--config", cfg_path, "--no_wandb", "--device", str(device),
            "--async_checkpoint"]
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
          f"256/192/128, bf16, fast dropout, --async_checkpoint) and {n_eval} eval batches in "
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
    if (resumed.start_epoch != 3 or not by_epoch[3.0]
            or not trainer.config.logging.async_save):
        fail("phase 14c: the third epoch did not resume from the background "
             "writer's checkpoint")
    print(f"  14c resumed at epoch {resumed.start_epoch}: {seen['train'] - n_train} "
          f"more train steps, to step {resumed.state.step}")
    compare_eval_kernels(trainer.state.gen, eval_inputs)
    # the trained generator: export and round trip
    gen_path = save_generator_only(root, trainer.state.gen.state_dict())
    art = os.path.join(root, "artifact")
    export.main(["--config", cfg_path, "--checkpoint", gen_path, "--output", art,
                 "--buckets", "512", "1024", "--exact_mixers", "--device", str(device)])
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


def _union_ms(intervals) -> float:
    """Total length in ms of the union of (start, end) intervals in us."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _split_by_part(fn, module=None, parts=GAN_PARTS, union=False) -> dict:
    """{part: [span ms, kernel ms, elementwise kernel ms]} of one call of
    ``fn`` (a train step) in which each of the step's ranges (``parts``,
    opened through ``module.record_function``; default the GAN step's
    gan/* ranges) synchronises the card where it starts and where it ends,
    so that every kernel runs within the host span of the range that
    launched it, the ones that autograd's device thread launches for a
    backward included; a kernel goes to the range whose span holds its
    start. A range opened several times sums its spans. The span is host
    time: it holds the card's idle time while the host launches. With
    ``union`` a range's kernel ms is the union of its kernels' intervals
    (kernels that overlap, as some of cuDNN's do, count once)."""
    import contextlib

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if module is None:
        from mqgan_tpu_torch.train import step as module

    real = module.record_function

    @contextlib.contextmanager
    def synced(name):
        torch.cuda.synchronize()
        with real(name):
            yield
            torch.cuda.synchronize()

    module.record_function = synced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        module.record_function = real
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.device_type == DeviceType.CPU and e.name in parts]
    out = {name: [0.0, 0.0, 0.0] for name, _, _ in spans}
    for name, start, end in spans:
        out[name][0] += (end - start) / 1e3
    out["outside the ranges"] = [0.0, 0.0, 0.0]
    intervals = {name: [] for name in out}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in parts:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3
        owner = next((n for n, a, b in spans if a <= e.time_range.start <= b),
                     "outside the ranges")
        out[owner][1] += ms
        intervals[owner].append((e.time_range.start, e.time_range.end))
        if "elementwise" in e.name.lower():
            out[owner][2] += ms
    if union:
        for name, iv in intervals.items():
            out[name][1] = _union_ms(iv)
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


# phase 15, vocoder training at full width (the vocoder trainer CLI's
# defaults, benchmarks/probe_vocoder_adv.py's flagship step): the hifispeech
# spec, B=16 segments of 32 frames (16,384 samples), upsample 8 x 8 from 512
# channels, iSTFT n_fft 16 (hop 8), MPD periods 2/3/5/7/11, MSD 3 scales
VOC_B, VOC_FRAMES = 16, 32
VOC_CMP_B = 2
VOC_LR = 2e-4
VOC_CLIPS, VOC_CLIP_SECONDS = 12, (0.5, 3.0)
VOC_CLI_STEPS, VOC_CLI_ADV_START = 6, 3
# 15c: the (b, t) shapes at which the vocoder artifact's program is held
VOC_PROGRAM_SHAPES = ((1, 10), (3, 23))
VOC_WARM, VOC_ITERS = 2, 5
VOC_PARTS = ("voc/sample", "voc/g_forward", "voc/stft_loss", "voc/d_forward",
             "voc/d_backward", "voc/g_backward", "voc/optim")


def vocoder_models(device, seed, bf16=False, adversarial=True):
    """The CLI's generator (and discriminators) at full width, seeded, on
    device: (gen, mpd, msd, istft_hop)."""
    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.models.wave_discriminators import (MultiPeriodDiscriminator,
                                                            MultiScaleDiscriminator)
    from mqgan_tpu_torch.train.vocoder_trainer import build_generator
    from mqgan_tpu_torch.utils.init import seeded_init_

    spec = SpectrogramConfig()
    gen = seeded_init_(build_generator(spec.n_mel_channels, (8, 8), 512, 16, bf16),
                       seed).to(device).train()
    mpd = msd = None
    if adversarial:
        mpd = seeded_init_(MultiPeriodDiscriminator(), seed + 1).to(device).train()
        msd = seeded_init_(MultiScaleDiscriminator(), seed + 2).to(device).train()
    return gen, mpd, msd, spec.hop_length // gen.total_upsample


def _voc_wav(b, seed):
    """(b, VOC_FRAMES * 512) fp32 segments: three sines and 10% noise per
    row, peak 0.3 (the audio batch of phase 7)."""
    rng = np.random.default_rng(seed)
    n = VOC_FRAMES * 512
    t = np.arange(n) / 44100.0
    freq = 80.0 + 3920.0 * rng.random((b, 3, 1))
    x = (rng.random((b, 3, 1)) * np.sin(2 * np.pi * freq * t)).sum(axis=1)
    x = x + 0.1 * rng.standard_normal((b, n))
    return (0.3 * x / np.abs(x).max(axis=1, keepdims=True)).astype(np.float32)


class _RecordingAdamW:
    """Wraps a ClipAdamW: keeps the gradients of its last update and, if
    ``after`` is set, calls it once the update is done."""

    def __init__(self, tx, after=None):
        self.tx, self.after, self.last = tx, after, None

    def init(self, params):
        return self.tx.init(params)

    def step_(self, params, grads, state, ok):
        self.last = [g.detach().float().cpu() for g in grads]
        self.tx.step_(params, grads, state, ok)
        if self.after is not None:
            self.after()


def _voc_update_gate(before, cpu_after, card_after, cpu_grads, card_grads, lr):
    """One update (after - before) of each weight (lists of CPU tensors),
    card vs CPU: within lr / 10 where the CPU's gradient is live: above
    1e-4 * max(1, max|g|) and the two sides agree on it to 5% (else Adam's
    update of it can differ by more than lr / 10); within 2.01 lr elsewhere
    (Adam's bias-corrected step is at most 1.0014 lr in a run's first two
    steps, plus the weight decay). The MR-STFT's gradient is set by
    rounding at the random generator's near-0 |STFT| bins (ROADMAP.md
    Queue 3), so most generator weights are contested. Returns (ok, live
    max|d|, rest max|d|, contested count, live count)."""
    g_max = max(float(g.abs().max()) for g in cpu_grads)
    live_d = rest_d = 0.0
    n_live = n_cont = 0
    for w0, wc, wk, g, gk in zip(before, cpu_after, card_after, cpu_grads, card_grads):
        above = g.abs() > 1e-4 * max(1.0, g_max)
        contested = above & (g.abs() * 0.05 < (gk - g).abs())
        live = above & ~contested
        n_live += int(live.sum())
        n_cont += int(contested.sum())
        d = ((wk - w0) - (wc - w0)).abs()
        if live.any():
            live_d = max(live_d, float(d[live].max()))
        if (~live).any():
            rest_d = max(rest_d, float(d[~live].max()))
    ok = n_live > 0 and live_d <= lr / 10 and rest_d <= 2.01 * lr
    return ok, live_d, rest_d, n_cont, n_live


def _cpu_weights(model) -> list:
    return [p.detach().float().cpu().clone() for p in model.parameters()]


def compare_vocoder_steps(device) -> None:
    """Phase 15a: one fp32 spectral step and one adversarial step of the
    full-width vocoder on the card against the same steps on the CPU (plain
    versions), B=2 x 32 frames, the CLI's learning rates, TF32 off, the
    same log-mels on both sides: losses within 1e-5 * max(1, |loss|); each
    update within lr / 10 of the CPU's where the gradient is live
    (_voc_update_gate). Printed beside them: the generator + iSTFT backward
    of a seeded cotangent, card vs CPU and the CPU against itself with its
    input moved by 1e-6, and the MR-STFT's gradient on noise, card vs CPU
    (the generator's 36 leaky-ReLU layers and the loss's near-0
    |STFT| bins make both gradients move with the forward's rounding,
    ROADMAP.md Queue 3). The adversarial
    step's D update is held on its own, then the card's discriminators take
    the CPU's updated weights, so that the G loss runs through the same
    discriminators on both sides."""
    import torch

    from mqgan_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
    from mqgan_tpu_torch.signal.mel import MelFrontend
    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.train import vocoder_trainer as vt
    from mqgan_tpu_torch.train.state import ClipAdamW

    wav = torch.from_numpy(_voc_wav(VOC_CMP_B, SEED + 50))
    mel = MelFrontend(SpectrogramConfig(), "cpu")(wav)[:, :VOC_FRAMES].transpose(1, 2)
    target = VOC_FRAMES * 512
    sides = {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", device)):
        gen, mpd, msd, hop = vocoder_models(dev, SEED + 51)
        sides[name] = dict(gen=gen, mpd=mpd, msd=msd, dev=dev,
                           mel=mel.contiguous().to(dev), wav=wav.to(dev))
    kw = dict(n_fft=16, istft_hop=hop, target_len=target)

    # printed, not gated: the generator + iSTFT backward of one seeded
    # cotangent beside the CPU's own spread (the same backward with the mel
    # moved by 1e-6 relative), and the MR-STFT's gradient on two noise
    # signals: both move with rounding at kinks and near-0 bins (ROADMAP.md
    # Queue 3)
    gen_cot = torch.Generator().manual_seed(SEED + 56)
    cot = torch.randn((VOC_CMP_B, target - 8), generator=gen_cot)
    moved = mel * (1 + 1e-6 * torch.randn(mel.shape, generator=gen_cot))
    vjps = {}
    for label, n, m in (("cpu", "cpu", mel), ("card", "card", mel), ("cpu moved", "cpu", moved)):
        sd = sides[n]
        pred = vt.synth(sd["gen"], m.to(sd["dev"]), 16, hop)[:, : cot.shape[1]]
        vjps[label] = (pred.detach().cpu(), [g.float().cpu() for g in torch.autograd.grad(
            pred, list(sd["gen"].parameters()), cot.to(sd["dev"]))])
    g_max = max(float(g.abs().max()) for g in vjps["cpu"][1])

    def spread(label):
        return (float((vjps[label][0] - vjps["cpu"][0]).abs().max()),
                max(float((a - b).abs().max()) for a, b in zip(vjps[label][1], vjps["cpu"][1])))

    noise = torch.randn((2, VOC_CMP_B, target), generator=gen_cot)
    loss_g = {}
    for label, dev in (("cpu", "cpu"), ("card", device)):
        x = noise[0].to(dev).requires_grad_(True)
        multi_resolution_stft_loss(x, noise[1].to(dev)).backward()
        loss_g[label] = x.grad.cpu()
    (p_card, g_card), (p_moved, g_moved) = spread("card"), spread("cpu moved")
    print(f"  15a fp32 B={VOC_CMP_B} x {target} samples (printed, not gated): generator "
          f"+ iSTFT backward of a seeded cotangent, card vs CPU: output max|d| "
          f"{p_card:.2e}, gradients max|d| {g_card:.2e} (max|g| {g_max:.2e}); the CPU "
          f"against itself with the mel moved by 1e-6: output {p_moved:.2e}, "
          f"gradients {g_moved:.2e}; MR-STFT dL/dx on noise, card vs CPU max|d| "
          f"{float((loss_g['card'] - loss_g['cpu']).abs().max()):.2e} (max "
          f"{float(loss_g['cpu'].abs().max()):.2e})")

    ok = True
    # the spectral step
    res = {}
    for name in ("cpu", "card"):
        sd = sides[name]
        sd["before"] = _cpu_weights(sd["gen"])
        sd["tx"] = _RecordingAdamW(ClipAdamW(VOC_LR, float("inf")))
        sd["opt"] = sd["tx"].init(sd["gen"].parameters())
        step = vt.make_spectral_step(sd["gen"], sd["tx"], sd["opt"], **kw)
        res[name] = float(step(sd["mel"], sd["wav"]))
    loss_err = abs(res["card"] - res["cpu"]) / max(1.0, abs(res["cpu"]))
    gate = _voc_update_gate(sides["cpu"]["before"], _cpu_weights(sides["cpu"]["gen"]),
                            _cpu_weights(sides["card"]["gen"]), sides["cpu"]["tx"].last,
                            sides["card"]["tx"].last, VOC_LR)
    step_ok = loss_err <= 1e-5 and gate[0]
    ok = ok and step_ok
    print(f"  15a spectral step fp32: loss card {res['card']:.6f} cpu {res['cpu']:.6f} "
          f"(rel {loss_err:.2e}); G update max|d| {gate[1]:.2e} where live "
          f"({gate[4]} weights; <= lr/10 = {VOC_LR / 10:.1e}), {gate[2]:.2e} elsewhere "
          f"(<= 2.01 lr), {gate[3]} contested {'ok' if step_ok else 'FAIL'}")

    # the adversarial step, from the CPU's state after the spectral step
    cpu, card = sides["cpu"], sides["card"]
    with torch.no_grad():
        for k, p in card["gen"].named_parameters():
            p.copy_(dict(cpu["gen"].named_parameters())[k])
        for key in ("mu", "nu"):
            for a, b in zip(card["opt"][key], cpu["opt"][key]):
                a.copy_(b)
    d_state = {}

    def d_params(sd):
        return list(sd["mpd"].named_parameters()) + [
            (f"msd.{k}", p) for k, p in sd["msd"].named_parameters()]

    def cpu_after_d():
        d_state["cpu"] = [p.detach().clone() for _, p in d_params(cpu)]

    def card_after_d():
        d_state["card"] = [p.detach().float().cpu().clone() for _, p in d_params(card)]
        with torch.no_grad():
            for (_, p), w in zip(d_params(card), d_state["cpu"]):
                p.copy_(w)

    metrics = {}
    for name, after in (("cpu", cpu_after_d), ("card", card_after_d)):
        sd = sides[name]
        sd["before"] = _cpu_weights(sd["gen"])
        sd["d_before"] = [p.detach().float().cpu().clone() for _, p in d_params(sd)]
        sd["dtx"] = _RecordingAdamW(ClipAdamW(VOC_LR, float("inf")), after)
        d_opt = sd["dtx"].init([p for _, p in d_params(sd)])
        step = vt.make_adv_step(sd["gen"], sd["mpd"], sd["msd"], sd["tx"], sd["dtx"],
                                sd["opt"], d_opt, **kw)
        metrics[name] = {k: float(v) for k, v in step(sd["mel"], sd["wav"]).items()}
    loss_err = max(abs(metrics["card"][k] - v) / max(1.0, abs(v))
                   for k, v in metrics["cpu"].items())
    # the D update on its own (the card's own update, before it took the CPU's)
    d_gate = _voc_update_gate(cpu["d_before"], d_state["cpu"], d_state["card"],
                              cpu["dtx"].last, card["dtx"].last, VOC_LR)
    gate = _voc_update_gate(cpu["before"], _cpu_weights(cpu["gen"]),
                            _cpu_weights(card["gen"]), cpu["tx"].last, card["tx"].last,
                            VOC_LR)
    adv_ok = loss_err <= 1e-5 and d_gate[0] and gate[0]
    ok = ok and adv_ok
    print(f"  15a adversarial step fp32: g_total card {metrics['card']['g_total']:.6f} "
          f"cpu {metrics['cpu']['g_total']:.6f}, d_loss {metrics['card']['d_loss']:.6f}; "
          f"max rel |dloss| {loss_err:.2e} over {sorted(metrics['cpu'])}; D update "
          f"max|d| {d_gate[1]:.2e} where live ({d_gate[4]}), {d_gate[2]:.2e} elsewhere, "
          f"{d_gate[3]} contested; G update max|d| {gate[1]:.2e} where live ({gate[4]}), "
          f"{gate[2]:.2e} elsewhere, {gate[3]} contested {'ok' if adv_ok else 'FAIL'}")
    if not ok:
        fail("phase 15a: a vocoder step on the card disagrees with the CPU")


def _voc_wav_dir(root) -> str:
    """VOC_CLIPS seeded 44.1 kHz 16-bit wavs of 0.5-3 s: three sines and
    noise each, one at 22.05 kHz (resampled on load), one shorter than a
    segment (skipped)."""
    rng = np.random.default_rng(SEED + 52)
    d = os.path.join(root, "wavs")
    os.makedirs(d)
    for i in range(VOC_CLIPS):
        sr = 22050 if i == 3 else 44100
        secs = 0.2 if i == 5 else float(rng.uniform(*VOC_CLIP_SECONDS))
        t = np.arange(int(sr * secs)) / sr
        x = sum(rng.random() * np.sin(2 * np.pi * rng.uniform(80, 4000) * t)
                for _ in range(3)) + 0.1 * rng.standard_normal(t.shape)
        _write_wav(os.path.join(d, f"c{i:02d}.wav"), 0.3 * x / np.abs(x).max(), sr)
    return d


def compare_sampler_mels(wav_dir, device, counters) -> float:
    """Phase 15b: one SegmentSampler batch at the CLI's shape (16 x 16,384
    samples) through the log-mel kernel (one launch) against the plain
    version in float64. A resampled clip has no energy above 11.025 kHz:
    its top mel bands sit at the 1e-5 floor, where fp32 rounding of the
    frame's loud bins (~1e-8 of its power) moves the log by up to ~0.4 in
    any fp32 algorithm. So the gate is on the mel power, relative to each
    frame's total: max |exp(k) - exp(p64)| / sum_m exp(p64) <= max(1e-6, the
    fp32 plain version's own error); the log-domain errors are printed.
    The segments must equal a CPU sampler's of the same seed."""
    import torch

    from mqgan_tpu_torch.core.config import SpecConfig
    from mqgan_tpu_torch.ops.stft_kernels import dft_mel_tables, log_mel_plain
    from mqgan_tpu_torch.train import vocoder_trainer as vt

    cfg = SpecConfig().spectrogram
    files = vt.find_wavs(wav_dir)
    card = vt.SegmentSampler(files, SpecConfig(), VOC_FRAMES, SEED, device)
    cpu = vt.SegmentSampler(files, SpecConfig(), VOC_FRAMES, SEED, "cpu")
    counters.reset()
    mel, wav = card.batch(VOC_B)
    torch.cuda.synchronize()
    launches = counters.snapshot()
    _, wav_cpu = cpu.batch(VOC_B)

    def frames(tables):
        return log_mel_plain(wav.cpu(), *tables, cfg.hop_length)[:, :VOC_FRAMES]

    ref = frames(dft_mel_tables(cfg, np.float64)).double()
    plain = frames(dft_mel_tables(cfg)).double()
    got = mel.cpu().transpose(1, 2).double()
    total = ref.exp().sum(dim=2, keepdim=True)

    def power_err(x):
        return float(((x.exp() - ref.exp()).abs() / total).max())

    err, plain_err = power_err(got), power_err(plain)
    limit = max(1e-6, plain_err)
    log_err, plain_log = (float((x - ref).abs().max()) for x in (got, plain))
    same = torch.equal(wav.cpu(), wav_cpu)
    ok = (err <= limit and same and launches == {"log_mel": 1}
          and tuple(mel.shape) == (VOC_B, 128, VOC_FRAMES))
    print(f"  15b sampler batch {tuple(wav.shape)} -> mel {tuple(mel.shape)}: log-mel "
          f"kernel vs the float64 plain version, mel power error / frame power "
          f"{err:.3e} (limit {limit:.3e} = max(1e-6, the fp32 plain's {plain_err:.3e})); "
          f"log domain (not gated) max|k-p64| {log_err:.3e}, fp32 plain {plain_log:.3e}; "
          f"launches {launches}; segments equal to a CPU sampler's {same} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("phase 15b: the sampler's log-mel kernel disagrees with its plain version")
    return log_err


def vocoder_trainer_cli(root, wav_dir, device, counters, card) -> dict:
    """Phase 15c, the slice's main path: the trainer CLI at its defaults
    (B=16, 32 frames, 8 x 8 from 512, iSTFT 16) on the seeded wavs,
    VOC_CLI_ADV_START spectral steps then adversarial ones, --export_dir
    (counts reset just before, read just after): finite losses under the
    JAX keys, one log_mel launch per batch (its init batch and one a step)
    and none else, checkpoints; then ISTFTNetFE.load_ts serves the
    artifact's program (a symbolic batch and frame count) at (b, t) =
    VOC_PROGRAM_SHAPES: spec and phase equal to the in-memory generator's
    and the waveform to the in-memory wrapper's (1e-5 * max(1, max|x|))."""
    import dataclasses

    import torch

    from mqgan_tpu_torch.core.config import SpecConfig
    from mqgan_tpu_torch.models.istft_vocoder import build_vocoder_fe
    from mqgan_tpu_torch.signal.vocoder import ISTFTNetFE
    from mqgan_tpu_torch.train import vocoder_trainer as vt

    spec_path = os.path.join(root, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"spectrogram": dataclasses.asdict(SpecConfig().spectrogram)}, f)
    run, exp = os.path.join(root, "run"), os.path.join(root, "export")
    counters.reset()
    t0 = time.perf_counter()
    gen = vt.main(["--wav_dir", wav_dir, "--spec_config", spec_path, "--out_dir", run,
                   "--steps", str(VOC_CLI_STEPS), "--log_every", "1",
                   "--save_every", str(VOC_CLI_STEPS), "--adversarial",
                   "--adv_start_step", str(VOC_CLI_ADV_START), "--export_dir", exp])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = counters.snapshot()
    with open(os.path.join(run, "vocoder_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    keys = {"vocoder/loss", "steps_per_sec", "_time", "_step"}
    adv_keys = keys | {f"vocoder/{k}" for k in ("g_total", "stft", "adv", "fm", "d_loss")}
    keys_ok = [set(r) for r in recs] == ([keys] * VOC_CLI_ADV_START
                                         + [adv_keys] * (VOC_CLI_STEPS - VOC_CLI_ADV_START))
    finite = all(math.isfinite(v) for r in recs for v in r.values())
    files_ok = {f"vocoder_step_{VOC_CLI_STEPS}.pt",
                f"vocoder_disc_step_{VOC_CLI_STEPS}.pt"} <= set(os.listdir(run))
    want = {"log_mel": VOC_CLI_STEPS + 1}
    fe = ISTFTNetFE.load_ts(exp)
    mem = build_vocoder_fe(gen, fe.stft.hop_length)
    rng = np.random.default_rng(SEED + 53)
    art_err, art_ok = 0.0, next(fe.program.parameters()).device.type == "cuda"
    for b, frames in VOC_PROGRAM_SHAPES:
        mel = rng.standard_normal((b, 128, frames)).astype(np.float32)
        with torch.no_grad():
            x = torch.from_numpy(mel).to(device)
            pairs = list(zip(fe.program(x), gen.eval()(x)))
        pairs.append((fe(mel), mem(mel)))
        for got, ref in ((g.float().cpu().numpy(), r.float().cpu().numpy())
                         for g, r in pairs):
            err = float(np.abs(got - ref).max())
            art_err = max(art_err, err)
            art_ok = (art_ok and got.shape == ref.shape
                      and err <= 1e-5 * max(1.0, float(np.abs(ref).max())))
        # the iSTFT of 64 frames a mel frame, hop 8, n_fft 16: 512 t - 8 samples
        art_ok = art_ok and pairs[-1][0].shape == (b, 1, frames * 512 - 8)
    print(f"  15c trainer CLI: {VOC_CLI_STEPS} steps ({VOC_CLI_ADV_START} spectral, then "
          f"adversarial) in {secs:.2f} s (set-up, 12 wav loads and checkpoints included); "
          f"losses {[round(r['vocoder/loss'], 4) for r in recs]}; keys "
          f"{'ok' if keys_ok else 'BAD'}; launches {launches} (want {want}); "
          f"checkpoints {'ok' if files_ok else 'MISSING'}; the artifact's program vs "
          f"the in-memory generator and wrapper at (b, t) {VOC_PROGRAM_SHAPES} max|d| "
          f"{art_err:.2e} [{card}]")
    if not (keys_ok and finite and files_ok and launches == want and art_ok):
        fail("phase 15c: the vocoder trainer CLI's run or its artifact is wrong")
    return launches


def _count_syncs(fn) -> int:
    """Host synchronisations torch reports while ``fn`` runs (CUDA sync
    debug mode "warn")."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def vocoder_step_times(wav_dir, device, card) -> None:
    """Phase 15d: ms/step and trained audio-s/s (B x 16,384 samples per
    step at 44.1 kHz) of the spectral and the adversarial step at the CLI's
    shape, fp32 and --bf16: VOC_WARM warm-up then VOC_ITERS timed steps
    (CUDA events) on batches drawn beforehand, peak device memory, the
    sampler's ms per batch; a step must not synchronise the host (counted
    in CUDA sync debug mode; one torch.istft call's are printed: its
    envelope check reads back); then (e) a profile of one fp32 adversarial
    step."""
    import torch

    from mqgan_tpu_torch.core.config import SpecConfig
    from mqgan_tpu_torch.signal.stft import istft
    from mqgan_tpu_torch.train import vocoder_trainer as vt
    from mqgan_tpu_torch.train.state import ClipAdamW

    sampler = vt.SegmentSampler(vt.find_wavs(wav_dir), SpecConfig(), VOC_FRAMES,
                                SEED + 54, device)
    sample_ms = time_ms(lambda: sampler.batch(VOC_B), 5)
    data = [sampler.batch(VOC_B) for _ in range(VOC_WARM + VOC_ITERS)]
    audio_s = VOC_B * VOC_FRAMES * 512 / 44100.0
    mag = torch.rand((VOC_B, 9, VOC_FRAMES * 64 + 1), device=device)
    syncs_istft = _count_syncs(lambda: istft(mag, mag, 16, 8, 16))
    print(f"  15d sampler: {sample_ms:.3f} ms per batch of {VOC_B} (host draw, copy, "
          f"one log-mel launch); torch.istft: {syncs_istft} host synchronisation(s) "
          f"per call (the training path overlap-adds itself)")
    for bf16 in (False, True):
        for adversarial in (False, True):
            gen, mpd, msd, hop = vocoder_models(device, SEED + 55, bf16, adversarial)
            tx = ClipAdamW(VOC_LR, float("inf"))
            opt = tx.init(gen.parameters())
            kw = dict(n_fft=16, istft_hop=hop, target_len=VOC_FRAMES * 512)
            if adversarial:
                d_tx = ClipAdamW(VOC_LR, float("inf"))
                d_opt = d_tx.init(list(mpd.parameters()) + list(msd.parameters()))
                step = vt.make_adv_step(gen, mpd, msd, tx, d_tx, opt, d_opt, **kw)
            else:
                step = vt.make_spectral_step(gen, tx, opt, **kw)
            for mel, wav in data[:VOC_WARM]:
                step(mel, wav)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = time_ms(lambda: [step(m, w) for m, w in data[VOC_WARM:]], 1) / VOC_ITERS
            peak = torch.cuda.max_memory_allocated() / 1e9
            syncs = _count_syncs(lambda: step(*data[0]))
            out = step(*data[1])
            loss = float(out["g_total"] if adversarial else out)
            label = f"{'bf16' if bf16 else 'fp32'} {'adversarial' if adversarial else 'spectral'}"
            print(f"  15d {label:16s}: {ms:9.3f} ms/step, {audio_s / (ms / 1e3):8.2f} "
                  f"audio-s/s trained, peak {peak:6.2f} GB, host syncs in a step "
                  f"{syncs}, loss {loss:.4f} [{card}]")
            if not math.isfinite(loss) or syncs:
                fail(f"phase 15d: {label}: loss not finite, or the step synchronised "
                     f"the host with the card")
            if adversarial and not bf16:
                profile_vocoder_step(lambda: step(*sampler.batch(VOC_B)), ms, card)
            del gen, mpd, msd, step, tx, opt
            torch.cuda.empty_cache()


def _device_busy(fn):
    """(kernel ms summed, the union of the kernels' intervals in ms, wall
    ms) of one synchronised call of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    iv = [(e.time_range.start, e.time_range.end) for e in prof.events()
          if e.device_type == DeviceType.CUDA and e.name not in VOC_PARTS]
    return sum(b - a for a, b in iv) / 1e3, _union_ms(iv), wall_ms


def profile_vocoder_step(run, step_ms, card) -> None:
    """Phase 15e: one fp32 adversarial step with its batch draw: kernel
    groups (summed kernel times), the card's busy time as the union of the
    kernels' intervals (some of cuDNN's overlap) and the idle share against
    the unprofiled step time, then the kernel time per voc/* range (union
    per range) from a second, synchronised pass."""
    from mqgan_tpu_torch.train import vocoder_trainer as vt

    events, wall = _device_profile(run)
    events = [(k, ms) for k, ms in events if k not in VOC_PARTS]
    print(f"[15e] where the time goes, one adversarial step B={VOC_B} x "
          f"{VOC_FRAMES * 512} samples fp32 (its batch draw included) [{card}]")
    _report_profile("vocoder step", events, None, top=10,
                    note="profiler on; by group below")
    summed, busy, wall = _device_busy(run)
    print(f"    device busy (union of kernel intervals) {busy:.3f} ms, kernels summed "
          f"{summed:.3f} ms, profiled wall {wall:.3f} ms; against the unprofiled "
          f"{step_ms:.3f} ms step (without its draw): idle share "
          f"{1 - busy / step_ms:.3f}")
    parts = _split_by_part(run, vt, VOC_PARTS, union=True)
    print("    by range, a second pass that synchronises the card at each range's "
          "start and end (span: host time; kernels: the union of their intervals):")
    for name in VOC_PARTS + ("outside the ranges",):
        span, kern, elem = parts.get(name, (0.0, 0.0, 0.0))
        print(f"    {name:18s} " + (f"span {span:9.3f} ms, kernels {kern:9.3f} ms "
                                     f"(elementwise summed {elem:8.3f} ms)" if kern else
                                     "not measured (no kernel of its own)"))


def vocoder_training(device, counters, card) -> dict:
    """Phase 15: vocoder training at full width, (a)-(e); returns the
    trainer CLI's launches."""
    import torch

    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    root = tempfile.mkdtemp(prefix="chip_smoke_voc_")
    try:
        with torch.enable_grad():
            compare_vocoder_steps(device)
            lap("a")
            wav_dir = _voc_wav_dir(root)
            compare_sampler_mels(wav_dir, device, counters)
            lap("b")
            launches = vocoder_trainer_cli(root, wav_dir, device, counters, card)
            lap("c")
            vocoder_step_times(wav_dir, device, card)
            lap("de")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  phase 15 seconds by part: {seconds}")
    return launches


# phase 16, the LM artifact and codec attach: the export buckets (32 for
# 16c's profiled dispatch; every pair and score bucket shares its programs,
# so buckets cost no trace), 16a's length (in the 512 bucket), the three
# artifacts (name, 12f's name, export flags), and the HTTP traffic: 12
# requests of (n, length), decode true, two lengths per bucket of the codec
# artifact so that decodes run at a few shapes
LM_EXPORT_BUCKETS = dict(gen=(32, 128, 512), prompt=(1, 256), score=(512, 2048))
LM_ARTIFACT_L = 300
LM_ARTIFACTS = (("transformer", "transformer fp32 KV", ()),
                ("transformer_bf16", "transformer bf16 KV", ("--kv_bf16",)),
                ("lstm", "lstm", ()))
LM_DECODE_REQUESTS = ((1, 100), (3, 100), (1, 120), (3, 128), (1, 400), (3, 400),
                      (1, 512), (3, 480), (1, 100), (3, 400), (1, 512), (3, 100))


def _state_writes(out, arch) -> dict:
    """{op: [state inputs]} of the card's step program of an LM artifact
    (the transformer's layer, the LSTM's step): the ops that take a cache
    or carry input, or the result of an in-place op on one (its alias),
    and the number of mutations the program returns as outputs (a
    functionalised graph would copy the whole cache)."""
    import torch

    from mqgan_tpu_torch.deploy.runtime import program_path

    name = "step_block.pt2" if arch == "transformer" else "step.pt2"
    ep = torch.export.load(program_path(out, "cuda", name))
    state = {n for n in ep.graph.nodes if n.op == "placeholder"
             and (n.name in ("k", "v") or n.name.startswith("state_"))}
    found = {"mutations returned": len(ep.graph_signature.user_inputs_to_mutate)}
    for node in ep.graph.nodes:
        if node.op != "call_function" or not node.args or node.args[0] not in state:
            continue
        op = str(node.target).split(".")[1]
        found.setdefault(op, []).append(node.args[0].name)
        if op.endswith("_"):  # an in-place op returns its input
            state.add(node)
    return found


def compare_lm_artifact(name, out, run, device, kv=None) -> None:
    """Phase 16a: the exported LM on the card, replayed as CUDA graphs,
    against the in-process model of its run: 8 rows (mixed prompt lengths
    0-200, per-row seeds, length LM_ARTIFACT_L in the 512 bucket) sampled
    (temperature 0.9, top-k 50, top-p 0.95) and greedy give the served
    sampler's tokens at the padded bucket (equal), at the shape's first
    dispatch (its capture) and a second; score of 4 rows of 2,048 tokens
    within 1e-5 * max(1, |nll|) of score_tokens; the step program writes
    its state in place (index_put_ / copy_ on its inputs, no mutation
    returned, no whole-cache copy of an fp32 cache)."""
    import torch

    from mqgan_tpu_torch.deploy.export_lm import ExportedMusicLM, load_lm_from_run
    from mqgan_tpu_torch.models.lm_sampling import score_tokens
    from mqgan_tpu_torch.models.token_lm import served_sampler

    rt = ExportedMusicLM(out)
    model, args = load_lm_from_run(run, device)
    rng = np.random.default_rng(SEED + 60)
    lens = [0, 0, 1, 17, 64, 130, 200, 5]
    prompts = [None if n == 0 else rng.integers(2, args["vocab_size"], n) for n in lens]
    genres = rng.integers(0, args["num_genres"], len(lens))
    seeds = rng.integers(0, 2 ** 32, len(lens))
    prompt = np.zeros((len(lens), rt.prompt_buckets[-1]), np.int64)
    for i, p in enumerate(prompts):
        if p is not None:
            prompt[i, : len(p)] = p
    forbidden = (args["pad_id"], args["bos_id"])
    mask = torch.ones(args["vocab_size"], dtype=torch.bool)
    mask[list(forbidden)] = False
    ok, same = True, []
    for knobs in ((0.9, 50, 0.95), (1.0, 1, 0.0)):
        want = served_sampler(model)(
            model, torch.from_numpy(genres).to(device), torch.from_numpy(seeds).to(device),
            torch.from_numpy(prompt).to(device),
            torch.tensor(lens, device=device), *knobs, mask.to(device),
            max_len=rt._bucket(rt.gen_buckets, LM_ARTIFACT_L, "length"),
            bos_id=args["bos_id"], **({"kv_dtype": kv} if kv else {})
        )[:, :LM_ARTIFACT_L].cpu().numpy()
        for _ in range(2):
            got = rt.generate_rows(genres, seeds, LM_ARTIFACT_L, prompts=prompts,
                                   temperature=knobs[0], top_k=knobs[1],
                                   top_p=knobs[2], forbidden=forbidden)
            same.append(int((got == want).all(axis=1).sum()))
            ok = ok and np.array_equal(got, want)
    tokens = rng.integers(2, args["vocab_size"], (4, 2048))
    tokens[:, 0] = args["bos_id"]
    tokens[2, 1500:] = args["pad_id"]
    nll, n = rt.score(tokens, genres[:4])
    wn, wv = score_tokens(model, torch.from_numpy(tokens).to(device),
                          torch.from_numpy(genres[:4]).to(device))
    s_err = float(np.abs(nll - wn.cpu().numpy()).max())
    writes = _state_writes(out, rt.arch)
    # a bf16 cache is cast whole to fp32 where it is read (the port's
    # arithmetic, kept); nothing else copies a cache
    whole = {"copy_", "copy", "clone", "index_put", "slice_scatter"} | (
        set() if kv else {"_to_copy"})
    in_place = writes.pop("mutations returned") == 0 and (
        "index_put_" in writes and not whole & set(writes)
        if rt.arch == "transformer" else "copy_" in writes)
    writes = {k: len(v) for k, v in writes.items()}
    ok = (ok and s_err <= 1e-5 * max(1.0, float(np.abs(nll).max())) and in_place
          and np.array_equal(n, wv.cpu().numpy()) and rt.device.type == "cuda"
          and len(rt.graphs) == 1)
    print(f"  16a {name} artifact ({rt.arch}, buckets {rt.gen_buckets}/{rt.prompt_buckets}/"
          f"{rt.score_buckets}) through CUDA graphs vs the in-process model: rows "
          f"equal sampled {same[:2]}/8, greedy {same[2:]}/8 (capturing dispatch, "
          f"replay); score max|d| {s_err:.2e}; the step program's state ops "
          f"{writes} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"phase 16a: the {name} LM artifact disagrees with its model")


def lm_graph_decode(label, out, card) -> None:
    """Phase 16c: the artifact's decode at 12f's shape (B=64, prompt 0,
    L=512, 12f's seeds, genres and vocab mask) through its CUDA graphs, on
    a runtime whose state buffers are sized for that shape first:
    the capturing dispatch's tokens equal 12f's eager served sampler's and
    a replay's; ms per token of 3 dispatches after the capturing one (host
    clock, tokens to the host), beside 12f's; host synchronisations per
    dispatch at L=32 and L=512 (CUDA sync debug mode; none more at L=512:
    none in the loop); the idle share of an L=32 dispatch (the profiler's
    busy time against the same dispatch unprofiled, as 12f takes it); the
    graphs' memory: the state buffers and what the capturing dispatch
    reserved beside them."""
    import gc

    import torch

    from mqgan_tpu_torch.deploy.export_lm import ExportedMusicLM

    gc.collect()  # the earlier runtimes' graphs and buffers go first
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rt = ExportedMusicLM(out)
    rt.reserve(SERVE_B, 1, SERVE_L)
    genres, seeds = np.arange(SERVE_B) % LM["num_genres"], np.arange(SERVE_B)
    forbidden = tuple(int(i) for i in np.flatnonzero(~_serve_mask().numpy()))

    def dispatch(length):
        return rt.generate_rows(genres, seeds, length, forbidden=forbidden)

    mem0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    first = dispatch(SERVE_L)
    first_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved() - mem0
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = dispatch(SERVE_L)
        times.append(1e3 * (time.perf_counter() - t0) / SERVE_L)
    dispatch(32)
    syncs = (_count_syncs(lambda: dispatch(32)), _count_syncs(lambda: dispatch(SERVE_L)))
    events, _ = _device_profile(lambda: dispatch(32))
    t0 = time.perf_counter()
    dispatch(32)
    wall = 1e3 * (time.perf_counter() - t0)
    busy = sum(ms for _, ms in events)
    eager_ms, eager_out = EAGER_DECODE.get(label, (None, None))
    same = None if eager_out is None else int((first == eager_out.numpy()).all(axis=1).sum())
    ok = (same == SERVE_B and np.array_equal(first, again)
          and first.shape == (SERVE_B, SERVE_L) and int(first.min()) >= 2
          and int(first.max()) < LM["vocab_size"] and syncs[1] <= syncs[0])
    print(f"  16c {label} B={SERVE_B} prompt 0 L={SERVE_L} through the artifact's graphs: "
          f"rows equal to 12f's eager served sampler {same}/{SERVE_B}; "
          f"{min(times):.4f} ms/token (3 dispatches {[round(x, 4) for x in times]}; "
          f"capturing dispatch {first_s:.2f} s), 12f's eager served sampler "
          f"{'not measured' if eager_ms is None else f'{eager_ms:.4f}'} ms/token; host "
          f"syncs per dispatch L=32 {syncs[0]}, L={SERVE_L} {syncs[1]}; L=32 dispatch "
          f"busy {busy:.3f} of {wall:.3f} ms, idle share "
          f"{'not measured' if not busy else f'{1 - busy / wall:.3f}'}; state buffers "
          f"{rt.state_bytes() / 1e6:.1f} MB, the capturing dispatch reserved "
          f"{reserved / 1e6:.1f} MB more {'ok' if ok else 'FAIL'} [{card}]")
    if not ok:
        fail(f"phase 16c: the {label} artifact's replayed decode is wrong, differs from "
             f"12f's or synchronises in its loop")


def lm_artifacts(tf_run, lstm_run, codec_dir, device, counters, card) -> dict:
    """Phase 16: export the phase-10 transformer (fp32 and bf16 KV) and the
    seeded LSTM run through the export CLI (traced programs,
    verify_lm_export on the card), hold each artifact, replayed as CUDA
    graphs, against its model (16a), then (16b) LMHTTPServer over the
    transformer artifact with the bf16 poly-decode codec artifact of phase
    13: first the codec's decode kernels against their plain versions at
    the shapes the traffic's decodes take, then 12 concurrent /generate
    requests with decode true (counts reset just before, read just after):
    3 residual_block and 1 mel_mixer_poly launches per decode and no other
    kernel; tokens in [2, codebook size); each mel equal to
    ExportedPreEncoder.decode of its tokens (1e-4 * max(1, max|x|)); then
    (16c) each artifact's replayed decode at 12f's shape. Returns the path's
    launches and the kernels' largest |kernel - plain|."""
    import urllib.request
    from io import BytesIO

    import torch

    from mqgan_tpu_torch.deploy import export_lm
    from mqgan_tpu_torch.deploy.http_lm import LMHTTPServer, LMHTTPService
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

    root = tempfile.mkdtemp(prefix="chip_smoke_lm_export_")
    try:
        outs = {}
        for name, _, flags in LM_ARTIFACTS:
            run = lstm_run if name == "lstm" else tf_run
            outs[name] = os.path.join(root, name)
            t0 = time.perf_counter()
            export_lm.main(["--lm_run", run, "--output", outs[name],
                            "--gen_buckets", *map(str, LM_EXPORT_BUCKETS["gen"]),
                            "--prompt_buckets", *map(str, LM_EXPORT_BUCKETS["prompt"]),
                            "--score_buckets", *map(str, LM_EXPORT_BUCKETS["score"]),
                            *flags])
            print(f"  16a export of the {name} run (traced programs, the card's and "
                  f"the CPU's) with verify_lm_export: {time.perf_counter() - t0:.2f} s")
            compare_lm_artifact(name, outs[name], run, device,
                                torch.bfloat16 if flags else None)

        codec = ExportedPreEncoder(codec_dir)
        if codec.manifest["poly_mixers"] != "decode" or codec.manifest["dtype"] != "bfloat16":
            fail("phase 16: the codec artifact is not phase 13's bf16 poly-decode one")
        state = {k: v.cpu() for k, v in codec.model.state_dict().items()}
        shortest = {}
        for n, length in LM_DECODE_REQUESTS:
            key = (n, codec.bucket_for(length))
            shortest[key] = min(length, shortest.get(key, length))
        shapes = sorted((n, t, length) for (n, t), length in shortest.items())
        print(f"  16b codec decode kernels vs plain versions at the traffic's "
              f"(B, T bucket, length) {shapes}")
        model = build_model(device, torch.bfloat16, state=state)
        errs = {}
        for b, t, length in shapes:
            tag = f"decode B={b} T={t} "
            found = compare_kernels(model, device, b, t, (length,) * b,
                                    (torch.float32, torch.bfloat16), tag=tag)
            found["mel_mixer_poly"] = compare_poly(model, device, b, t, (length,) * b,
                                                   tag=tag, mixer="post")
            for k, v in found.items():
                errs[k] = max(errs.get(k, 0.0), v)
        del model

        service = LMHTTPService(lm_export=outs["transformer"], codec_dir=codec_dir,
                                max_delay_ms=500)
        specs = [dict(genre=i % LM["num_genres"], length=length, n=n, seed=2000 + i,
                      temperature=1.0, top_k=0, top_p=0.9, decode=True)
                 for i, (n, length) in enumerate(LM_DECODE_REQUESTS)]

        def post(url, spec):
            req = urllib.request.Request(url + "/generate",
                                         data=json.dumps(spec).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                with np.load(BytesIO(r.read()), allow_pickle=False) as z:
                    return dict(z)

        counters.reset()
        with LMHTTPServer(service) as srv:
            with urllib.request.urlopen(srv.url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(specs)) as pool:
                answers = list(pool.map(lambda spec: post(srv.url, spec), specs))
            secs = time.perf_counter() - t0
            stats = service.stats()
        torch.cuda.synchronize()
        launches = counters.snapshot()
        want = {"residual_block": 3 * len(specs), "mel_mixer_poly": len(specs)}
        size = codec.codebook_size
        tok_ok = all(a["tokens"].shape == (s["n"], s["length"]) and a["tokens"].min() >= 2
                     and a["tokens"].max() < size for a, s in zip(answers, specs))
        mel_err, mel_ok = 0.0, True
        for a, s in zip(answers, specs):
            ref = codec.decode(a["tokens"])
            err = float(np.abs(a["mel"] - ref).max())
            mel_err = max(mel_err, err)
            mel_ok = (mel_ok and a["mel"].shape == (s["n"], s["length"], codec.mel_channels)
                      and np.isfinite(a["mel"]).all() and err <= _deploy_tol(ref))
        ok = (tok_ok and mel_ok and launches == want and health["has_codec"]
              and health["codebook_size"] == size and stats["mean_batch_size"] > 1)
        rows = sum(s["n"] for s in specs)
        print(f"  16b HTTP over the transformer artifact + bf16 poly-decode codec: "
              f"{len(specs)} concurrent requests, {rows} rows, decode true, in "
              f"{secs:.2f} s; /healthz has_codec {health['has_codec']}, codebook "
              f"{health['codebook_size']}, mel {health['mel_channels']}; tokens in "
              f"[2, {size}) {'ok' if tok_ok else 'BAD'}; mel vs ExportedPreEncoder.decode "
              f"max|d| {mel_err:.2e}; mean batch size {stats['mean_batch_size']:.2f}; "
              f"launches {launches} (want {want}) {'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("phase 16b: the LM server's codec attach is wrong")
        for name, label, _ in LM_ARTIFACTS:
            lm_graph_decode(label, outs[name], card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, errs


# phase 17, parallel serving: the clip pair that 17b re-encodes in windows,
# their count (one card holds them all), and 17c's ragged batch
SEQ_LENGTHS = (16_384, 11_000)
SEQ_WINDOWS = 4
DP_LENGTHS = (1000, 1000, 777, 600, 384, 129, 1)
DP_T = 1000
SEQ_ITERS = 5


def _window_inputs(plan, lengths, device):
    """Per window of ``plan`` (stacked along the batch axis, window-major):
    lengths (clip(len - s, 0, w)) and the CBAM stats range (the window's
    interior frames that are valid), int32 on ``device``."""
    import torch

    lens, lo, hi = [], [], []
    for i in range(plan.n):
        s, off = plan.geometry(i)
        for n in lengths:
            wl = min(max(n - s, 0), plan.window)
            lens.append(wl)
            lo.append(off)
            hi.append(max(off, min(off + plan.chunk, wl)))
    return tuple(torch.tensor(v, dtype=torch.int32, device=device)
                 for v in (lens, lo, hi))


def compare_split_kernel(model, device) -> float:
    """Phase 17a: the split launch of the three CBAM blocks against the
    unsplit kernel (the range [0, length), no reduction) at phase 3's
    shapes, and against its plain version on the windows of the clip pair
    (statistics reduced over the windows), fp32 and bf16 at phase 3's
    gates; returns the largest bf16 |kernel - plain| of the windows."""
    import torch

    from mqgan_tpu_torch.ops.block_kernels import (
        fused_residual_block, residual_block_plain_begin,
        residual_block_plain_finish, split_residual_block)
    from mqgan_tpu_torch.parallel.seqpar import _group_reduce, plan_seq_reencode

    gen = torch.Generator().manual_seed(SEED + 30)
    lens = torch.tensor(CMP_LENGTHS, dtype=torch.int32, device=device)
    plan = plan_seq_reencode(max(SEQ_LENGTHS), SEQ_WINDOWS, model.kernel_sizes,
                             model.refiner_depth)
    wlens, lo, hi = _window_inputs(plan, SEQ_LENGTHS, device)
    b = len(SEQ_LENGTHS)
    reduce = _group_reduce(SEQ_WINDOWS, b, None, 0)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, blk in enumerate(model.encoder_blocks):
            cin = blk.conv1.v.shape[1]
            wts = blk.kernel_weights(dtype)
            x = torch.randn((CMP_B, CMP_T, cin), generator=gen).to(device, dtype)
            whole = fused_residual_block(x, lens, wts, causal=False)
            split = split_residual_block(x, lens, wts, torch.zeros_like(lens), lens, None)
            same = float((split.float() - whole.float()).abs().max())
            ok_same, _, _ = _judge("", split, whole, dtype)
            x = torch.randn((SEQ_WINDOWS * b, plan.window, cin), generator=gen).to(device, dtype)
            got = split_residual_block(x, wlens, wts, lo, hi, reduce)
            res, z, part = residual_block_plain_begin(x, wlens, wts, lo, hi)
            count = (hi - lo).float()
            s_, m_ = reduce(torch.cat([part[:, 1], count[:, None]], 1), part[:, 0])
            want = residual_block_plain_finish(
                x, wlens, wts, res, z, torch.stack([m_, s_[:, :-1]], 1), s_[:, -1])
            ok, max_abs, detail = _judge("", got, want, dtype)
            if dtype == torch.bfloat16:
                worst = max(worst, max_abs)
            print(f"  residual_block_split enc{i} {str(dtype)[6:]:8s} at B={CMP_B} "
                  f"T={CMP_T}, range [0, length), no reduction: max|split - unsplit| "
                  f"{same:.3e} (expect 0) {'ok' if ok_same else 'FAIL'}; {SEQ_WINDOWS} "
                  f"windows of {plan.window} x B={b} (lengths {SEQ_LENGTHS}), reduced "
                  f"statistics vs the plain split: {detail.strip()}, max|k-p| "
                  f"{max_abs:.3e} {'ok' if ok else 'FAIL'}")
            if not (ok and ok_same):
                fail(f"residual_block_split enc{i} {dtype}: the split launch "
                     f"disagrees (unsplit {same:.3e}; windows {detail})")
    return worst


def _seq_clip(model):
    """The clip pair of 17b (seeded, a drifting mean and a burst: the
    statistics differ window to window) padded to the plan, its lengths
    and the plan."""
    from mqgan_tpu_torch.parallel.seqpar import plan_seq_reencode

    t = max(SEQ_LENGTHS)
    plan = plan_seq_reencode(t, SEQ_WINDOWS, model.kernel_sizes, model.refiner_depth)
    rng = np.random.default_rng(SEED + 31)
    mel = rng.standard_normal((len(SEQ_LENGTHS), t, MELS)).astype(np.float32)
    mel += np.linspace(-2.0, 2.0, t, dtype=np.float32)[None, :, None]
    mel[:, t // 3:t // 3 + 400] += 3.0
    return mel, np.asarray(SEQ_LENGTHS, np.int32), plan


def _full_pass(model, mel, lengths, t_pad):
    """One full-length pass at t_pad frames (the padded convention):
    (tokens, x_recon, x_post, pad mask) on the card."""
    import torch

    dev = model.fsq_consts.device
    x = torch.zeros((mel.shape[0], t_pad, MELS), device=dev)
    x[:, :mel.shape[1]] = torch.as_tensor(mel).to(dev)
    pad = torch.arange(t_pad, device=dev)[None, :] >= torch.as_tensor(lengths).to(dev)[:, None]
    idx = model.encode(x, pad)
    post, recon = model.decode(idx, pad, return_recon=True)
    return idx, recon, post, pad


def seq_parallel_check(state, device, counters) -> dict:
    """Phase 17b: seq-parallel re-encode and decode of the clip pair on
    SEQ_WINDOWS windows of the card (fp32, stacked) against one
    full-length pass (counts reset just before the seq-parallel calls,
    read just after); the thread route once, against the stacked one.
    Returns the launches."""
    import torch

    from mqgan_tpu_torch.parallel.seqpar import seq_parallel_decode, seq_parallel_reencode

    model = build_model(device, torch.float32, state=state)
    mel, lengths, plan = _seq_clip(model)
    devices = [device] * SEQ_WINDOWS
    t = mel.shape[1]
    f_idx, f_recon, f_post, pad = _full_pass(model, mel, lengths, plan.t_pad)
    x = torch.zeros((mel.shape[0], plan.t_pad, MELS))
    x[:, :t] = torch.from_numpy(mel)
    near = _near_midpoints(model, x.numpy(), lengths)[:, :t]
    torch.cuda.synchronize()
    counters.reset()
    idx, recon, post = seq_parallel_reencode(model, mel, lengths, devices,
                                             return_recon=True)
    dec = seq_parallel_decode(model, f_idx[:, :t], lengths, devices)
    torch.cuda.synchronize()
    launches = counters.snapshot()
    valid = (np.arange(t)[None, :] < lengths[:, None])
    flips = _check_tokens("seq-parallel re-encode vs the full pass",
                          idx.cpu().numpy()[valid], f_idx[:, :t].cpu().numpy()[valid],
                          near[valid])
    # a token flipped at a midpoint moves its frames' decode by a code step:
    # the mels are held against one full-length decode of the same tokens
    own = torch.zeros_like(f_idx)
    own[:, :t] = idx
    o_post, o_recon = model.decode(own, pad, return_recon=True)
    worst = {}
    for name, got, want in (("x_post", post, o_post), ("x_recon", recon, o_recon),
                            ("decode", dec, f_post)):
        g, w = got.cpu().numpy()[valid], want[:, :t].cpu().numpy()[valid]
        err = float(np.abs(g - w).max())
        worst[name] = err
        if err > _deploy_tol(w):
            fail(f"seq-parallel {name} disagrees with the full pass: {err:.3e} > "
                 f"{_deploy_tol(w):.3e}")
    print(f"  seq-parallel re-encode of B={len(SEQ_LENGTHS)} lengths {SEQ_LENGTHS} on "
          f"{SEQ_WINDOWS} windows of {device} (chunk {plan.chunk}, window {plan.window}, "
          f"t_pad {plan.t_pad}, halos {plan.halo_l}/{plan.halo_r}, redundancy "
          f"{plan.redundancy:.4f}) vs one full-length pass, fp32: {flips} token flips at "
          f"midpoints; max|err| against a full-length decode of the same tokens: x_post "
          f"{worst['x_post']:.3e}, x_recon {worst['x_recon']:.3e}; seq-parallel decode "
          f"of the full pass's tokens {worst['decode']:.3e} (limit 1e-4 * max(1, "
          f"max|x|)) ok")
    print(f"  launches of the seq-parallel calls: {launches}")
    for name in ("residual_block_split", "residual_block", "mel_mixer", "fsq_head"):
        if launches.get(name, 0) <= 0:
            fail(f"phase 17b: {name} was not launched on the seq-parallel path")
    if launches.get("mel_mixer_poly", 0):
        fail("phase 17b: mel_mixer_poly launched on the seq-parallel path")
    t_idx, t_post = seq_parallel_reencode(model, mel, lengths, devices, stack=False)
    err = float((t_post - post).abs().max())
    print(f"  the thread route ({SEQ_WINDOWS} threads meeting at a barrier) vs the "
          f"stacked route: {int((t_idx != idx).sum())} token flips, max|x_post diff| "
          f"{err:.3e}")
    if err > _deploy_tol(post.cpu().numpy()):
        fail("phase 17b: the thread route disagrees with the stacked one")
    return launches


def seq_parallel_times(state, device, card) -> None:
    """Phase 17b, timed: the bf16 seq-parallel re-encode of the clip pair
    and one full-length pass (2 warm-up, SEQ_ITERS timed calls, CUDA
    events), each with its peak device memory."""
    import torch

    from mqgan_tpu_torch.parallel.seqpar import seq_parallel_reencode

    model = build_model(device, torch.bfloat16, state=state)
    mel, lengths, plan = _seq_clip(model)
    mel_dev = torch.from_numpy(mel).to(device)
    lens_dev = torch.from_numpy(lengths).to(device)
    calls = {
        "seq-parallel": lambda: seq_parallel_reencode(
            model, mel_dev, lens_dev, [device] * SEQ_WINDOWS, return_recon=True),
        "full pass": lambda: _full_pass(model, mel_dev, lens_dev, plan.t_pad),
    }
    frames = int(lengths.sum())
    for label, fn in calls.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(fn, SEQ_ITERS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        print(f"  {label} re-encode (tokens, x_recon, x_post), bf16, B=2 lengths "
              f"{SEQ_LENGTHS}: {ms:.4f} ms ({frames / ms * 1e3:.1f} mel-frames/s), "
              f"peak device memory {peak:.3f} GB [{card}]")
    print(f"  plan redundancy {plan.redundancy:.4f} ({SEQ_WINDOWS} windows of "
          f"{plan.window} frames for {plan.t_pad}); one card: not a speed claim")


def data_parallel_check(root, state, device) -> None:
    """Phase 17c: phase 13's fp32 exact and bf16 poly-decode artifacts with
    data_parallel over [cuda:0, cuda:0] against single-device calls, a
    ragged batch of 7; then the re-encode CLI with --seq_parallel over
    phase 13's mels, each file's tokens against a full-length encode."""
    import torch

    from mqgan_tpu_torch.deploy import reencode
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

    rng = np.random.default_rng(SEED + 32)
    lengths = np.asarray(DP_LENGTHS, np.int32)
    x = rng.standard_normal((len(lengths), DP_T, MELS)).astype(np.float32)
    valid = np.arange(DP_T)[None, :] < lengths[:, None]
    for name in ("fp32", "bf16"):
        d = os.path.join(root, f"exp_{name}")
        one = ExportedPreEncoder(d)
        two = ExportedPreEncoder(d, data_parallel=True, devices=[device, device])
        if two.n_devices != 2 or ExportedPreEncoder(d, data_parallel=True).n_devices != \
                torch.cuda.device_count():
            fail("phase 17c: ExportedPreEncoder(data_parallel=True) n_devices is wrong")
        tok1, mel1 = one.reencode(x, lengths)
        tok2, mel2 = two.reencode(x, lengths)
        dec1, dec2 = one.decode(tok1, lengths), two.decode(tok1, lengths)
        flips = int((tok1 != tok2)[valid].sum())
        err = float(np.abs(mel1 - mel2)[valid].max())
        derr = float(np.abs(dec1 - dec2)[valid].max())
        poly = one.manifest["poly_mixers"]
        if poly:  # each slice fits its own Chebyshev range
            ok, _, detail = _judge("mel", torch.from_numpy(mel2[valid]),
                                   torch.from_numpy(mel1[valid]), torch.bfloat16)
        else:
            ok = err <= _deploy_tol(mel1[valid]) and derr <= _deploy_tol(dec1[valid])
            detail = f"limit {_deploy_tol(mel1[valid]):.1e}"
        ok = ok and flips == 0
        print(f"  data-parallel {name} ({one.manifest['dtype']}, poly_mixers {poly}) "
              f"over [cuda:0, cuda:0] vs one device, B=7 T={DP_T} lengths "
              f"{DP_LENGTHS}: {flips} token flips, max|mel diff| re-encode {err:.3e}, "
              f"decode {derr:.3e} ({detail}; expect 0 for the exact mixers) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"phase 17c: data-parallel {name} disagrees with one device")
    out, toks = os.path.join(root, "out_seq"), os.path.join(root, "tokens_seq")
    src = os.path.join(root, "mels")
    t0 = time.perf_counter()
    result = reencode.main([
        "--input_dir", src, "--output_dir", out, "--checkpoint",
        os.path.join(root, "exp_fp32", "weights.pt"), "--config",
        os.path.join(root, "flagship.json"), "--seq_parallel", "--save_tokens",
        "--tokens_dir", toks, "--batch_size", str(REENCODE_BATCH)])
    seconds = time.perf_counter() - t0
    fp32 = build_model(device, torch.float32, state=state)
    flips = 0
    for rel in sorted(os.listdir(os.path.join(src, "set"))):
        m = np.load(os.path.join(src, "set", rel))
        got = np.load(os.path.join(toks, "set", rel)).astype(np.int32)
        tp = -(-len(m) // 256) * 256
        xp = np.zeros((1, tp, MELS), np.float32)
        xp[0, :len(m)] = m
        pad = torch.arange(tp, device=device)[None, :] >= len(m)
        want = fp32.encode(torch.from_numpy(xp).to(device), pad)[0, :len(m)].cpu().numpy()
        near = _near_midpoints(fp32, xp, [len(m)])[0, :len(m)]
        flips += _check_tokens(f"--seq_parallel re-encode of {rel}", got, want, near)
    print(f"  re-encode CLI --seq_parallel (checkpoint fp32, {torch.cuda.device_count()} "
          f"card(s), whole files a call): {result['processed']} files in "
          f"{seconds:.3f} s; tokens equal a full-length encode ({flips} flips at "
          f"midpoints)")
    if result["failed"] or result["processed"] != len(REENCODE_LENGTHS):
        fail(f"phase 17c: re-encode --seq_parallel {result}")


def split_kernel_times(model, device, errs) -> "_KernelRow":
    """Phase 17, row 1b: the split launch of the three CBAM blocks at the
    windows' shapes (SEQ_WINDOWS x B=2 windows of the plan, bf16, the
    statistics reduced over the windows), the plain split beside it; the
    bound counts the conv GEMMs' operations, as row 1 does."""
    import torch

    from mqgan_tpu_torch.ops.block_kernels import (
        residual_block_plain_begin, residual_block_plain_finish,
        split_residual_block)
    from mqgan_tpu_torch.parallel.seqpar import _group_reduce, plan_seq_reencode

    dt = torch.bfloat16
    plan = plan_seq_reencode(max(SEQ_LENGTHS), SEQ_WINDOWS, model.kernel_sizes,
                             model.refiner_depth)
    wlens, lo, hi = _window_inputs(plan, SEQ_LENGTHS, device)
    b = len(SEQ_LENGTHS)
    reduce = _group_reduce(SEQ_WINDOWS, b, None, 0)
    m = SEQ_WINDOWS * b * plan.window
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    row = _KernelRow("residual_block_split", "mqgan_tpu_torch/csrc/residual_block.cu",
                     "mqgan_tpu/ops/block_kernels.py:161")
    for i, blk in enumerate(model.encoder_blocks):
        cin, cout, k = blk.conv1.v.shape[1], blk.conv1.v.shape[0], blk.kernel_size
        x = torch.randn((SEQ_WINDOWS * b, plan.window, cin), generator=gen,
                        device=device).to(dt)
        wts = blk.kernel_weights(dt)

        def plain():
            res, z, part = residual_block_plain_begin(x, wlens, wts, lo, hi)
            count = (hi - lo).float()
            s_, m_ = reduce(torch.cat([part[:, 1], count[:, None]], 1), part[:, 0])
            return residual_block_plain_finish(
                x, wlens, wts, res, z, torch.stack([m_, s_[:, :-1]], 1), s_[:, -1])

        ms = time_ms(lambda: split_residual_block(x, wlens, wts, lo, hi, reduce), 10)
        pms = time_ms(plain, 3)
        macs = k * cin * cout + k * cout * cout + (cin * cout if cin != cout else 0)
        flops = 2.0 * m * macs
        bound = row.add(ms, pms, flops, PEAK_BF16, 2.0 * (m * cin + m * cout + macs))
        print(f"  residual_block_split enc{i} {cin}->{cout} k{k} at {SEQ_WINDOWS} x B={b} "
              f"windows of {plan.window}: {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound:.4f} ms ({flops / 1e9:.1f} GFLOP of conv GEMMs, "
              f"{flops / ms / 1e9:.1f} TFLOP/s over the split block's time)")
    row.max_abs_err = errs
    return row


def parallel_serving(state, root, device, counters, card) -> tuple:
    """Phase 17: returns (the seq-parallel path's launches, row 1b)."""
    import torch

    print(f"  [17a] the split launch vs the unsplit kernel and vs its plain version")
    model = build_model(device, torch.float32, state=state)
    err = compare_split_kernel(model, device)
    print(f"  [17b] seq-parallel re-encode and decode vs one full-length pass [{card}]")
    launches = seq_parallel_check(state, device, counters)
    seq_parallel_times(state, device, card)
    print(f"  [17c] data-parallel vs one device; re-encode CLI --seq_parallel [{card}]")
    data_parallel_check(root, state, device)
    row = split_kernel_times(model, device, err)
    return launches, row


# phase 18, data-parallel and pipelined training at flagship width: (a) the
# step of two ranks against one process on the global batch, (b) the trainer
# CLI under two ranks, (c) step times, (d) the LSTM stack's pipeline
DP_RANKS = 2
DP_CMP_B, DP_CMP_T, DP_CMP_STEPS = 4, 128, 3
# rank 0's rows hold 256 valid frames, rank 1's 97 and a zero-length fill row
DP_CMP_LENGTHS = (128, 128, 97, 0)
DP_PROBE = 2  # steps whose reductions are synchronised and timed
DP_TIMEOUT_S = 600
PIPE_B, PIPE_L, PIPE_MICRO, PIPE_ITERS = 8, 256, 4, 3
PIPE_CHUNKS = 24
PIPE_LSTM = dict(emb_dim=512, lstm_hid=1024, lstm_layers=2)  # the CLI's defaults
LSTM_OF_SHAPE, LSTM_OF_ITERS = (8, 2048), 7  # --lstm-step-of: phase 10e's shape


def _dp_devices():
    """Phase 18's ranks: a card each where there are DP_RANKS cards (NCCL),
    else DP_RANKS ranks on card 0 (gloo)."""
    import torch

    n = torch.cuda.device_count()
    return [f"cuda:{i if n >= DP_RANKS else 0}" for i in range(DP_RANKS)]


def _dp_batch(device, b, t, lengths, seed):
    """A seeded (b, t, MELS) batch, zero past each row's length (as the
    loader builds it), and its lengths."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    mel = torch.randn((b, t, MELS), generator=gen, device=device)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=device)
    mel = mel * (torch.arange(t, device=device)[None, :, None] < lengths[:, None, None])
    return mel, lengths


def _dp_tensors(state) -> dict:
    """The parameters and buffers (spectral stats) of each model."""
    return {name: dict(list(m.named_parameters()) + list(m.named_buffers()))
            for name, m in (("gen", state.gen), ("patch", state.patch),
                            ("multibin", state.multibin))}


def _dp_checksum(state) -> str:
    """A hash of every parameter, buffer, optimizer moment and LeCam value:
    equal on two ranks only if their states are bit-equal."""
    import hashlib

    h = hashlib.sha256()
    for t in state.tensors():
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_run(cfg, device, mel, lengths, dp, seq=None):
    """DP_CMP_STEPS fp32 GAN + feature-matching steps of the seeded flagship
    state (dropout inert; with ``dp``, rank 0's state replicated) on (mel,
    lengths), with ``seq`` this rank's seq group; returns (state, each
    step's losses, the first step's gradients after the reduction)."""
    import torch

    from mqgan_tpu_torch.train.step import make_train_step

    state = gan_state(cfg, device, inert=True)
    if dp is not None:
        state.replicate_()
    step = make_train_step(cfg, train_d=True, dp=dp, seq=seq)
    losses, grads, first = [], None, None
    for i in range(DP_CMP_STEPS):
        m = step(state, mel, lengths)
        losses.append({k: float(v) for k, v in m.items() if k.startswith("loss")})
        if i == 0:
            grads = {name: {k: (torch.zeros_like(p) if p.grad is None
                                else p.grad.detach().clone())
                            for k, p in mod.named_parameters()}
                     for name, mod in (("gen", state.gen), ("patch", state.patch),
                                       ("multibin", state.multibin))}
            first = _dp_snapshot(state)
    return {"losses": losses, "grads": grads, "first": first,
            "last": _dp_snapshot(state), "checksum": _dp_checksum(state)}


def _dp_snapshot(state) -> dict:
    """Copies of the models' parameters and buffers and of LeCam."""
    import torch

    out = {name: {k: v.detach().clone() for k, v in ts.items()}
           for name, ts in _dp_tensors(state).items()}
    out["lecam"] = {"ema": torch.stack([state.lecam.ema_real.detach(),
                                        state.lecam.ema_fake.detach()])}
    return out


def _dp_compare(cfg, grads, mine, theirs, init) -> tuple:
    """(LeCam and spectral stats max |d| / max(1, max|x|), each model's
    largest update difference where the reference's first gradient is live,
    in units of its first step's lr) of snapshot ``mine`` against
    ``theirs``, both taken from ``init``."""
    tr = cfg.training
    lrs = {"gen": tr.lr * min(1.0, 1.0 / tr.warmup_steps),
           "patch": tr.lr * tr.lr_d_factor, "multibin": tr.lr * tr.lr_d_factor}
    a, b = mine["lecam"]["ema"], theirs["lecam"]["ema"]
    stat = float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
    upd = {}
    for name, want in grads.items():
        upd[name] = 0.0
        for k, t in theirs[name].items():
            if k not in want:  # u, sigma
                stat = max(stat, float((mine[name][k] - t).abs().max())
                           / max(1.0, float(t.abs().max())))
                continue
            g = want[k]
            live = g.abs() > 1e-4 * max(1.0, float(g.abs().max()))
            if live.any():
                d = ((mine[name][k] - init[name][k]) - (t - init[name][k])).abs()[live]
                upd[name] = max(upd[name], float(d.max()) / lrs[name])
    return stat, upd


def _dp_errors(cfg, ref, got, init) -> dict:
    """18a's measures of run ``got`` against the one-process ``ref``: the
    losses' max |d| / max(1, |loss|) over the steps; after the first step
    (both from the same weights, as phase 14a holds a step) each model's
    gradients' max |d| / max(1, max|g|), LeCam's and the spectral stats'
    max |d| / max(1, max|x|) and each model's update difference where the
    gradient is live, in units of its lr; the same two after the last step
    (printed: Adam turns a rounding-level difference into +-lr steps from
    the second step on, ROADMAP.md Queue 3)."""
    import torch

    with torch.no_grad():
        out = {"loss": max(abs(a[k] - b[k]) / max(1.0, abs(b[k]))
                           for a, b in zip(got["losses"], ref["losses"]) for k in b)}
        for name, want in ref["grads"].items():
            g_max = max(float(g.abs().max()) for g in want.values())
            out[f"grad/{name}"] = max(float((got["grads"][name][k] - g).abs().max())
                                      for k, g in want.items()) / max(1.0, g_max)
        for when in ("first", "last"):
            stat, upd = _dp_compare(cfg, ref["grads"], got[when], ref[when], init)
            out[f"stats/{when}"] = stat
            out.update({f"update/{when}/{k}": v for k, v in upd.items()})
    return out


def _dp_gate(err) -> bool:
    return (err["loss"] <= 1e-5 and err["stats/first"] <= 1e-5
            and all(v <= 1e-4 for k, v in err.items() if k.startswith("grad/"))
            and all(v <= 0.1 for k, v in err.items() if k.startswith("update/first/")))


def _rank_local_dp():
    """This rank's DataParallel as a DDP-style average computes the step:
    each rank's loss denominators count its own rows, and the gradients
    and loss metrics are averaged over the ranks (the error the global
    counts avoid; 18a prints it)."""
    import torch

    from mqgan_tpu_torch.parallel import dp as dp_mod

    class RankLocal(dp_mod.DataParallel):
        def count_lengths(self, lengths):
            return lengths

        def reduce_grads_(self, params):
            params = list(params)
            nbytes = super().reduce_grads_(params)
            torch._foreach_div_([p.grad for p in params], float(self.world))
            return nbytes

        def reduce_metrics_(self, tensors):
            tensors = list(tensors)
            nbytes = dp_mod.all_reduce_(tensors)
            torch._foreach_div_(tensors, float(self.world))
            return nbytes

    return RankLocal.current()


def _dp_step_rank(rank, world, device, times_b, times_t):
    """Phase 18a and 18c on one rank."""
    import torch

    from mqgan_tpu_torch.parallel import dp as dp_mod
    from mqgan_tpu_torch.parallel.mesh import batch_rows
    from mqgan_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, ref, init = {}, None, None
    # (a) the global batch on every rank; each steps on its rows
    cfg = gan_config(True, use_fm_loss=True)
    mel, lengths = _dp_batch(device, DP_CMP_B, DP_CMP_T, DP_CMP_LENGTHS, SEED + 60)
    rows = batch_rows(DP_CMP_B, rank, world)
    if rank == 0:  # the one-process reference, on this card (no collective)
        ref = _dp_run(cfg, device, mel, lengths, None)
        init = {name: {k: v.detach().clone() for k, v in ts.items()}
                for name, ts in _dp_tensors(gan_state(cfg, device, inert=True)).items()}
    got = _dp_run(cfg, device, mel[rows], lengths[rows], dp_mod.DataParallel.current())
    local = _dp_run(cfg, device, mel[rows], lengths[rows], _rank_local_dp())
    out["checksum"] = got.pop("checksum")
    if rank == 0:
        out["errors"] = _dp_errors(cfg, ref, got, init)
        out["local_errors"] = _dp_errors(cfg, ref, local, init)
        out["losses"] = (ref["losses"][-1], got["losses"][-1], local["losses"][-1])
    del ref, got, local
    torch.cuda.empty_cache()
    # (c) bf16 GAN steps of this rank's rows of a times_b x times_t batch
    cfg = gan_config(False)
    state = gan_state(cfg, device, dtype=torch.bfloat16)
    state.replicate_()
    step = make_train_step(cfg, train_d=True, dtype=torch.bfloat16,
                           dp=dp_mod.DataParallel.current())
    rows = batch_rows(times_b, rank, world)
    batches = [tuple(x[rows] for x in _dp_batch(device, times_b, times_t,
                                                [times_t] * times_b, SEED + 61 + i))
               for i in range(TRAIN_WARM + TRAIN_ITERS + DP_PROBE)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mel, lengths in batches[:TRAIN_WARM]:
        step(state, mel, lengths)
    times = []
    for mel, lengths in batches[TRAIN_WARM:TRAIN_WARM + TRAIN_ITERS]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = step(state, mel, lengths)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out["ms"] = times
    out["finite"] = all(math.isfinite(float(v)) for v in m.values())
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    reduce, spent = dp_mod.all_reduce_, []

    def timed(tensors, op=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = reduce(tensors, op)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0, nbytes))
        return nbytes

    dp_mod.all_reduce_ = timed
    try:
        for mel, lengths in batches[TRAIN_WARM + TRAIN_ITERS:]:
            step(state, mel, lengths)
    finally:
        dp_mod.all_reduce_ = reduce
    out["allreduce_ms"] = 1e3 * sum(s for s, _ in spent) / DP_PROBE
    out["allreduce_bytes"] = sum(n for _, n in spent) / DP_PROBE
    out["allreduce_calls"] = len(spent) / DP_PROBE
    return out


def _one_process_step_times(device, b, t) -> tuple:
    """18c's reference: the bf16 GAN step of one process on the whole b x t
    batch (ms per step, peak GB)."""
    import torch

    from mqgan_tpu_torch.train.step import make_train_step

    cfg = gan_config(False)
    state = gan_state(cfg, device, dtype=torch.bfloat16)
    step = make_train_step(cfg, train_d=True, dtype=torch.bfloat16)
    batches = [_dp_batch(device, b, t, [t] * b, SEED + 61 + i)
               for i in range(TRAIN_WARM + TRAIN_ITERS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mel, lengths in batches[:TRAIN_WARM]:
        step(state, mel, lengths)
    times = []
    for mel, lengths in batches[TRAIN_WARM:]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(state, mel, lengths)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, step, batches
    torch.cuda.empty_cache()
    return times, peak


def _dp_trainer_rank(rank, world, device, cfg_path, sig_cfg_path, resume, extra=()):
    """Phase 18b (and 19b, with ``extra`` CLI arguments) on one rank: the
    trainer CLI (``--multihost`` in the launcher's group) with its launches
    counted, in train steps and in all; then, run on to 4 epochs, a SIGTERM
    to this process at its first step of epoch 3. With ``resume``: the
    rerun of that run."""
    import signal

    import torch

    from mqgan_tpu_torch.ops import _cuda
    from mqgan_tpu_torch.train import trainer as trainer_mod

    counters = _cuda.COUNTERS
    seen = {"eval": 0, "steps": 0, "step_launches": {}, "signal_at": None}
    make_step, make_eval = trainer_mod.make_train_step, trainer_mod.make_eval_step

    def counting_step(*a, **kw):
        step = make_step(*a, **kw)

        def run(state, mel, lengths):
            before = counters.snapshot()
            out = step(state, mel, lengths)
            for k, v in counters.snapshot().items():
                if v != before.get(k, 0):
                    seen["step_launches"][k] = v - before.get(k, 0)
            seen["steps"] += 1
            if seen["steps"] == seen["signal_at"]:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return run

    def counting_eval(*a, **kw):
        ev = make_eval(*a, **kw)

        def run(gen, mel, lengths):
            seen["eval"] += 1
            return ev(gen, mel, lengths)
        return run

    def cli(path):
        return trainer_mod.main(["--config", path, "--no_wandb", "--device",
                                 str(device), "--multihost", *extra])

    trainer_mod.make_train_step, trainer_mod.make_eval_step = counting_step, counting_eval
    try:
        if resume:
            t = cli(sig_cfg_path)
            return {"start_epoch": t.start_epoch, "step": t.state.step}
        counters.reset()
        t = cli(cfg_path)
        out = {"launches": counters.snapshot(), "eval": seen["eval"],
               "steps": seen["steps"], "step_launches": dict(seen["step_launches"]),
               "checksum": _dp_checksum(t.state), "logger": type(t.logger).__name__,
               "files": sorted(os.listdir(t.config.data.output_dir))}
        seen.update(steps=0, signal_at=1)
        t = cli(sig_cfg_path)
        out.update(stopped=t._stop_requested, stop_step=t.state.step,
                   files_after_signal=sorted(os.listdir(t.config.data.output_dir)))
        del t
        torch.cuda.empty_cache()
        return out
    finally:
        trainer_mod.make_train_step, trainer_mod.make_eval_step = make_step, make_eval


def dp_step_check(device, card) -> None:
    """Phases 18a and 18c: DP_RANKS ranks (``launch``) against one process."""
    from mqgan_tpu_torch.parallel import multihost

    ref_ms, ref_peak = _one_process_step_times(device, TRAIN_B, TRAIN_T)
    devices = _dp_devices()
    t0 = time.perf_counter()
    ranks = multihost.launch(_dp_step_rank, devices, (TRAIN_B, TRAIN_T),
                             timeout_s=DP_TIMEOUT_S)
    secs = time.perf_counter() - t0
    r0 = ranks[0]
    err, lerr = r0["errors"], r0["local_errors"]
    same = all(r["checksum"] == r0["checksum"] for r in ranks)
    ok = _dp_gate(err) and same
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())  # noqa: E731
    print(f"  18a {DP_RANKS} ranks ({multihost.choose_backend(devices)} on "
          f"{devices}) vs one process, fp32 GAN+FM x {DP_CMP_STEPS}, B={DP_CMP_B} "
          f"T={DP_CMP_T} lengths {DP_CMP_LENGTHS}: {fmt(err)} (gates: loss 1e-5 "
          f"every step; after the first step grad 1e-4, stats 1e-5, update 0.1 lr "
          f"where live; after the last, printed); ranks bit-equal {same} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    ref_l, got_l, loc_l = r0["losses"]
    print(f"  18a the same run with rank-local denominators (a DDP-style average): "
          f"{fmt(lerr)}; last loss_g_total one process {ref_l['loss_g_total']:.6f}, "
          f"global counts {got_l['loss_g_total']:.6f}, rank-local "
          f"{loc_l['loss_g_total']:.6f}")
    if not ok:
        fail("phase 18a: the data-parallel step disagrees with one process")
    ms = [r["ms"] for r in ranks]
    print(f"  18c bf16 GAN step, B={TRAIN_B} T={TRAIN_T}: one process "
          f"{np.median(ref_ms):.3f} ms/step (min {min(ref_ms):.3f}, max "
          f"{max(ref_ms):.3f}), peak {ref_peak:.3f} GB; {DP_RANKS} x "
          f"{TRAIN_B // DP_RANKS} ranks on {devices}: "
          + "; ".join(f"rank {i} {np.median(m):.3f} ms/step (min {min(m):.3f}, max "
                      f"{max(m):.3f}), peak {r['peak_gb']:.3f} GB"
                      for i, (m, r) in enumerate(zip(ms, ranks)))
          + f"; all-reduce {r0['allreduce_ms']:.3f} ms and "
          f"{r0['allreduce_bytes'] / 1e6:.3f} MB in {r0['allreduce_calls']:.0f} "
          f"calls per step (synchronised) [{card}]; {secs:.1f} s for the launch")
    if not all(r["finite"] for r in ranks):
        fail("phase 18c: a data-parallel step's metrics are not finite")


def dp_trainer_check(device, card) -> dict:
    """Phase 18b: the trainer CLI under DP_RANKS ranks on phase 14c's
    dataset and config, then SIGTERM mid-run and a rerun; returns rank 0's
    launches."""
    from mqgan_tpu_torch.parallel import multihost

    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        cfg, cfg_path = _trainer_run_config(root, np.random.default_rng(SEED + 44))
        cfg["training"]["num_epochs"] = 4
        sig_path = os.path.join(root, "cfg_4.json")
        with open(sig_path, "w") as f:
            json.dump(cfg, f)
        devices = _dp_devices()
        t0 = time.perf_counter()
        ranks = multihost.launch(_dp_trainer_rank, devices,
                                 (cfg_path, sig_path, False), timeout_s=DP_TIMEOUT_S)
        secs = time.perf_counter() - t0
        resumed = multihost.launch(_dp_trainer_rank, devices,
                                   (cfg_path, sig_path, True), timeout_s=DP_TIMEOUT_S)
        with open(os.path.join(root, "run", "train_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0, r1 = ranks
    want = {k: v * r0["eval"] for k, v in TRAIN_EVAL_BATCH.items()}
    train_recs = [r for r in recs if "loss_g_total" in r and r.get("epoch") in (1.0, 2.0)]
    finite = all(math.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))
    steps_per_epoch = r0["steps"] // 2
    logged = sum(1 for n in range(1, steps_per_epoch + 1) if n == 1 or n % 10 == 0)
    ckpts = [f for f in r0["files"] if f.startswith("checkpoint_epoch_")]
    new = sorted(set(r0["files_after_signal"]) - set(r0["files"]))
    print(f"  18b trainer CLI on {devices}: {r0['steps']} steps a rank (B="
          f"{cfg['data']['batch_size']} global), {secs:.1f} s for both runs; rank 0 "
          f"{r0['eval']} eval batches, launches {r0['launches']} (want {want}), rank 1 "
          f"launches {r1['launches']} ({r1['eval']} eval batches); launches inside "
          f"train steps {r0['step_launches']} / {r1['step_launches']}; ranks bit-equal "
          f"{r0['checksum'] == r1['checksum']}; loggers {r0['logger']} / {r1['logger']}; "
          f"{len(train_recs)} train records (want {2 * logged}), checkpoints {ckpts}")
    print(f"  18b SIGTERM at each rank's first step of epoch 3: stopped "
          f"{r0['stopped']} / {r1['stopped']} at step {r0['stop_step']} / "
          f"{r1['stop_step']}, new files {new}; the rerun resumed at epoch "
          f"{resumed[0]['start_epoch']} / {resumed[1]['start_epoch']} and ended at step "
          f"{resumed[0]['step']} [{card}]")
    ok = (finite and r0["checksum"] == r1["checksum"] and r0["launches"] == want
          and not r1["launches"] and r1["eval"] == 0
          and not r0["step_launches"] and not r1["step_launches"]
          and r0["logger"] == "MetricsLogger" and r1["logger"] == "NullLogger"
          and len(train_recs) == 2 * logged
          and ckpts == ["checkpoint_epoch_001.pt", "checkpoint_epoch_002.pt"])
    if not ok:
        fail("phase 18b: the data-parallel trainer CLI's run is wrong")
    if (not (r0["stopped"] and r1["stopped"]) or new != ["checkpoint_epoch_003.pt"]
            or r0["stop_step"] != r1["stop_step"]
            or [r["start_epoch"] for r in resumed] != [4, 4]):
        fail("phase 18b: SIGTERM did not stop both ranks with one checkpoint, "
             "or the rerun did not resume")
    return r0["launches"]


def pipeline_check(device, card) -> None:
    """Phase 18d: the flagship LSTM (emb 512, 2 layers of 1024) with its
    stack pipelined, one layer a stage, PIPE_MICRO microbatches, every
    stage on this card: logits and gradients against the serial stack
    (fp32 with TF32 off within 1e-5 * max(1, max|x|); bf16 rel-L2 <= 2e-2),
    train-step tokens/s of both, and the LM trainer CLI with --pipe."""
    import torch

    from mqgan_tpu_torch.models.music_lstm import masked_ce_loss
    from mqgan_tpu_torch.models.token_lm import build_token_lm
    from mqgan_tpu_torch.parallel.pipeline import music_lstm_pipelined_logits
    from mqgan_tpu_torch.train import lstm_trainer
    from mqgan_tpu_torch.train.lstm_trainer import ClipAdamW, make_lstm_step
    from mqgan_tpu_torch.utils.init import seeded_init_

    args = dict(LM, arch="lstm", pad_id=0, **PIPE_LSTM)
    stages = [device] * args["lstm_layers"]
    tokens, genres, lengths = lm_batch(device, PIPE_B, PIPE_L, SEED + 70)
    targets = torch.roll(tokens, -1, dims=1)
    targets[:, -1] = 0
    ok = True
    for dtype in (None, torch.bfloat16):
        model = seeded_init_(build_token_lm(args, dropout=0.1, dtype=dtype),
                             SEED + 71).to(device)
        outs = []
        for piped in (False, True):
            model.zero_grad()
            logits = (music_lstm_pipelined_logits(model, tokens, genres, stages,
                                                  PIPE_MICRO)
                      if piped else model(tokens, genres))
            masked_ce_loss(logits, targets)[0].backward()
            outs.append([logits.detach().float()]
                        + [p.grad.detach().float() for p in model.parameters()])
        if dtype is None:
            err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                      for a, b in zip(outs[1], outs[0]))
            good, gate = err <= 1e-5, "1e-5 * max(1, max|x|)"
        else:
            err = max(float(torch.linalg.vector_norm(a - b)
                            / torch.linalg.vector_norm(b).clamp_min(1e-30))
                      for a, b in zip(outs[1], outs[0]))
            good, gate = err <= 2e-2, "rel-L2 2e-2"
        ok = ok and good
        print(f"  18d pipelined vs serial LSTM stack, {len(stages)} stages x "
              f"{PIPE_MICRO} microbatches on {[str(d) for d in stages]}, B={PIPE_B} "
              f"L={PIPE_L} {'bf16' if dtype else 'fp32'}: logits and gradients "
              f"{err:.2e} (gate {gate}) {'ok' if good else 'FAIL'}")
        del model, outs
    # train-step tokens/s, fp32 (the trainer's default), serial and pipelined
    rates = {}
    for name, pipe in (("serial", None), ("pipelined", stages)):
        model = seeded_init_(build_token_lm(args, dropout=0.1), SEED + 71).to(device)
        tx = ClipAdamW(1e-3)
        state = tx.init(model.parameters())
        step = make_lstm_step(model, tx, 0, train=True, pipe_devices=pipe,
                              pipe_micro=PIPE_MICRO)
        gen = torch.Generator().manual_seed(SEED)
        step(state, tokens, genres, lengths, gen)
        ms = time_ms(lambda: [step(state, tokens, genres, lengths, gen)
                              for _ in range(PIPE_ITERS)], 1) / PIPE_ITERS
        rates[name] = (ms, PIPE_B * (PIPE_L - 1) / (ms / 1e3))
        del model, state, step
    print(f"  18d LM train step fp32 B={PIPE_B} L={PIPE_L}: "
          + "; ".join(f"{k} {ms:.3f} ms, {tps:.1f} tokens/s" for k, (ms, tps)
                      in rates.items()) + f" [{card}]")
    root = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        mapping = _write_chunks(root, PIPE_CHUNKS, PIPE_L - 1, SEED + 72)
        best = {}
        pipe = ["--pipe", str(PIPE_LSTM["lstm_layers"]), "--pipe_micro", str(PIPE_MICRO)]
        for name, extra in (("serial", []), ("pipelined", pipe)):
            out = os.path.join(root, name)
            t0 = time.perf_counter()
            lstm_trainer.main([
                "--chunks_dir", os.path.join(root, "chunks"), "--mapping_json", mapping,
                "--vocab_size", str(LM["vocab_size"]), "--num_genres",
                str(LM["num_genres"]), *(x for k, v in PIPE_LSTM.items()
                                         for x in (f"--{k}", str(v))),
                "--batch_size", str(PIPE_B), "--epochs", "1",
                "--log_every", "1", "--out_dir", out, "--device", str(device), *extra])
            secs = time.perf_counter() - t0
            with open(os.path.join(out, "lstm_metrics.jsonl")) as f:
                losses = [r["train/loss_step"] for r in map(json.loads, f)
                          if "train/loss_step" in r]
            with open(os.path.join(out, "best.json")) as f:
                best[name] = json.load(f)["val_loss"]
            ok = ok and bool(losses) and all(math.isfinite(x) for x in losses)
            print(f"  18d LM trainer CLI {name}: {len(losses)} steps, losses "
                  f"{[round(x, 4) for x in losses]}, val loss {best[name]:.4f}, "
                  f"{secs:.2f} s with set-up")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not ok:
        fail("phase 18d: the pipelined LSTM stack disagrees with the serial one, "
             "or the --pipe trainer did not train")


def parallel_training(device, card) -> dict:
    """Phase 18: (a)-(d); returns rank 0's launches in the trainer CLI."""
    import torch

    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    with torch.enable_grad():
        print(f"  [18a, 18c] the data-parallel step vs one process; step times")
        dp_step_check(device, card)
        lap("a+c")
        print(f"  [18b] the trainer CLI under {DP_RANKS} ranks")
        launches = dp_trainer_check(device, card)
        lap("b")
        print(f"  [18d] the pipelined LSTM stack")
        pipeline_check(device, card)
        lap("d")
    print(f"  phase 18 seconds by part: {seconds}")
    return launches


# phase 19, sequence-parallel codec GAN training at flagship width: (a) the
# step of seq ranks against one process on the whole crop, (b) the trainer
# CLI with --seq_par 2, (c) step times, peak memory and the halo exchanges
SEQ_CMP = {  # label: (seq ranks, ranks, T, lengths), B = DP_CMP_B
    # 40 valid frames end inside seq rank 0's shard; a zero-length fill row
    "seq2": (2, 2, 128, (128, 40, 97, 0)),
    # 20-frame shards: off the 8-frame grids of both discriminators' time
    # strides and of the refiner's pools
    "seq2_t40": (2, 2, 40, (40, 13, 27, 0)),
    "data2_seq2": (2, 4, 128, (128, 40, 97, 0)),
}
SEQ_TEETH = "seq2"
SEQ_TRAIN_CLIPS, SEQ_CLIP_FRAMES = 50, (150, 400)  # 49 train clips, 1 eval clip
# rank 0's plots and eval on its own card, as in a data-parallel run
SEQ_EVAL_KERNELS = ("residual_block", "mel_mixer", "fsq_head")
SEQ_PROBE = 1  # steps whose exchanges are synchronised and timed


def _seq_devices(n):
    """n ranks: a card each where there are n cards, else all on card 0."""
    import torch

    k = torch.cuda.device_count()
    return [f"cuda:{i if k >= n else 0}" for i in range(n)]


def _no_exchange(group):
    """``group`` with each shard zero-padded at its edges: a window's frames
    that the rank does not own are zeros (19a's teeth)."""
    import torch.nn.functional as F

    from mqgan_tpu_torch.parallel.seqtrain import SeqGroup

    class NoExchange(SeqGroup):
        def fetch(self, x, dim, bounds, need):
            a, e = need[self.index]
            start, stop = bounds[self.index], bounds[self.index + 1]
            lo = min(max(start, a), e)
            hi = max(min(stop, e), lo)
            own = x.narrow(dim, lo - start, hi - lo)
            return F.pad(own.movedim(dim, -1), (lo - a, e - hi)).movedim(-1, dim)

    return NoExchange(group.index, group.size, group.group)


def _count_exchanges(group) -> list:
    """The bytes of each collective ``group`` issues from now on (its
    ``all_reduce_`` wrapped)."""
    sent, reduce = [], group.all_reduce_

    def counted(t, op=None):
        sent.append(t.numel() * t.element_size())
        return reduce(t, op)

    group.all_reduce_ = counted
    return sent


def _timed_steps(step, state, batches):
    """(ms of each step after TRAIN_WARM warm-up steps, peak GB, GB held
    between steps (weights, gradients, Adam moments), finite metrics)."""
    import torch

    for mel, lengths in batches[:TRAIN_WARM]:
        step(state, mel, lengths)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times = []
    for mel, lengths in batches[TRAIN_WARM:]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        m = step(state, mel, lengths)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    finite = all(math.isfinite(float(v)) for v in m.values())
    return times, torch.cuda.max_memory_allocated() / 1e9, base, finite


def _seq_step_times(rank, world, device, b, t):
    """19c on one rank: the bf16 GAN step with the b x t batch's time axis
    over the ``world`` ranks; then SEQ_PROBE steps whose exchanges are
    synchronised and timed."""
    import torch

    from mqgan_tpu_torch.parallel import multihost
    from mqgan_tpu_torch.parallel.dp import DataParallel
    from mqgan_tpu_torch.parallel.mesh import frame_range
    from mqgan_tpu_torch.parallel.seqtrain import SeqGroup
    from mqgan_tpu_torch.train.step import make_train_step

    cfg = gan_config(False)
    state = gan_state(cfg, device, dtype=torch.bfloat16)
    state.replicate_()
    group = SeqGroup.create(rank, world, world, multihost.group_timeout_s())
    step = make_train_step(cfg, train_d=True, dtype=torch.bfloat16,
                           dp=DataParallel(rank, world, world), seq=group)
    frames = frame_range(t, rank, world)
    batches = [(mel[:, frames].contiguous(), lengths) for mel, lengths in
               (_dp_batch(device, b, t, [t] * b, SEED + 61 + i)
                for i in range(TRAIN_WARM + TRAIN_ITERS + SEQ_PROBE))]
    times, peak, base, finite = _timed_steps(step, state,
                                             batches[:TRAIN_WARM + TRAIN_ITERS])
    reduce, spent = group.all_reduce_, []

    def timed(tensor, op=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(tensor, op)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0, tensor.numel() * tensor.element_size()))
        return out

    group.all_reduce_ = timed
    for mel, lengths in batches[TRAIN_WARM + TRAIN_ITERS:]:
        step(state, mel, lengths)
    group.all_reduce_ = reduce
    return {"ms": times, "peak_gb": peak, "base_gb": base, "finite": finite,
            "exchange_ms": 1e3 * sum(x for x, _ in spent) / SEQ_PROBE,
            "exchange_bytes": sum(n for _, n in spent) / SEQ_PROBE,
            "exchange_calls": len(spent) / SEQ_PROBE}


def _worst_grad(ref, got) -> tuple:
    """(model.parameter, max |d| / max(1, the model's max|g|)) of the
    first-step gradient furthest from ``ref``'s."""
    import torch

    worst = ("", 0.0)
    with torch.no_grad():
        for name, want in ref["grads"].items():
            g_max = max(1.0, max(float(g.abs().max()) for g in want.values()))
            for k, g in want.items():
                d = float((got["grads"][name][k] - g).abs().max()) / g_max
                if d > worst[1]:
                    worst = (f"{name}.{k}", d)
    return worst


def _seq_step_rank(rank, world, device, labels, times_b, times_t):
    """Phases 19a (the SEQ_CMP cells ``labels``) and 19c (with
    ``times_b``) on one rank."""
    import torch

    from mqgan_tpu_torch.parallel import multihost
    from mqgan_tpu_torch.parallel.dp import DataParallel
    from mqgan_tpu_torch.parallel.mesh import batch_rows, frame_range, train_grid
    from mqgan_tpu_torch.parallel.seqtrain import SeqGroup

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's nondeterministic weight-gradient algorithms move the
    # one-process reference itself between two runs; with deterministic ones
    # it repeats bit for bit within a run (printed)
    torch.backends.cudnn.deterministic = True
    out, init = {}, None
    cfg = gan_config(True, use_fm_loss=True)
    for label in labels:
        n_seq, _, t, lengths = SEQ_CMP[label]
        group = SeqGroup.create(rank, world, n_seq, multihost.group_timeout_s())
        data, n_data, s = train_grid(rank, world, n_seq)
        mel, lens = _dp_batch(device, DP_CMP_B, t, lengths, SEED + 80)
        rows, frames = batch_rows(DP_CMP_B, data, n_data), frame_range(t, s, n_seq)
        x, lx = mel[rows][:, frames].contiguous(), lens[rows]
        dp = DataParallel(rank, world, n_seq)
        ref = repeat = None
        if rank == 0:  # the one-process reference on the whole crop
            ref = _dp_run(cfg, device, mel, lens, None)
            if label == SEQ_TEETH:  # the reference run again: does it repeat?
                repeat = _worst_grad(ref, _dp_run(cfg, device, mel, lens, None))
            if init is None:
                init = {name: {k: v.detach().clone() for k, v in ts.items()}
                        for name, ts in _dp_tensors(gan_state(cfg, device,
                                                              inert=True)).items()}
        sent = _count_exchanges(group)
        got = _dp_run(cfg, device, x, lx, dp, group)
        res = {"checksum": got.pop("checksum"), "calls": len(sent) / DP_CMP_STEPS,
               "bytes": sum(sent) / DP_CMP_STEPS}
        if rank == 0:
            res["errors"] = _dp_errors(cfg, ref, got, init)
            res["losses"] = (ref["losses"][-1], got["losses"][-1])
            res["worst"], res["repeat"] = _worst_grad(ref, got), repeat
        if label == SEQ_TEETH:
            bad = _dp_run(cfg, device, x, lx, dp, _no_exchange(group))
            if rank == 0:
                res["teeth"] = _dp_errors(cfg, ref, bad, init)
            del bad
        out[label] = res
        del ref, got
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    if times_b:
        out["times"] = _seq_step_times(rank, world, device, times_b, times_t)
    return out


def _seq_reference_times(device, b, t):
    """19c's reference: the bf16 GAN step of one process on the whole b x t
    batch."""
    import torch

    from mqgan_tpu_torch.train.step import make_train_step

    cfg = gan_config(False)
    state = gan_state(cfg, device, dtype=torch.bfloat16)
    step = make_train_step(cfg, train_d=True, dtype=torch.bfloat16)
    batches = [_dp_batch(device, b, t, [t] * b, SEED + 61 + i)
               for i in range(TRAIN_WARM + TRAIN_ITERS)]
    out = _timed_steps(step, state, batches)
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def seq_step_check(device, card) -> None:
    """Phases 19a and 19c: seq ranks (``launch``, gloo on one card) against
    one process."""
    from mqgan_tpu_torch.parallel import multihost

    ref_ms, ref_peak, ref_base, ref_finite = _seq_reference_times(device, TRAIN_B,
                                                                  TRAIN_T)
    fmt = lambda e: ", ".join(f"{k} {v:.2e}" for k, v in e.items())  # noqa: E731
    ok, times = ref_finite, None
    for world in (2, 4):
        labels = [k for k, v in SEQ_CMP.items() if v[1] == world]
        devices = _seq_devices(world)
        t0 = time.perf_counter()
        ranks = multihost.launch(_seq_step_rank, devices,
                                 (labels, TRAIN_B if world == 2 else 0, TRAIN_T),
                                 timeout_s=DP_TIMEOUT_S)
        secs = time.perf_counter() - t0
        times = ranks if world == 2 else times
        for label in labels:
            n_seq, _, t, lengths = SEQ_CMP[label]
            r0 = ranks[0][label]
            same = all(r[label]["checksum"] == r0["checksum"] for r in ranks)
            good = _dp_gate(r0["errors"]) and same
            ok = ok and good
            ref_l, got_l = r0["losses"]
            print(f"  19a {label}: {world // n_seq} data x {n_seq} seq ranks "
                  f"({multihost.choose_backend(devices)} on {devices}) vs one process, "
                  f"fp32 GAN+FM x {DP_CMP_STEPS}, B={DP_CMP_B} T={t} lengths {lengths}: "
                  f"{fmt(r0['errors'])} (cuDNN deterministic; gates: loss 1e-5 every "
                  f"step; after the first step grad 1e-4, stats 1e-5, update 0.1 lr "
                  f"where live; after the last, printed); ranks bit-equal {same}; last "
                  f"loss_g_total "
                  f"{ref_l['loss_g_total']:.6f} / {got_l['loss_g_total']:.6f}; "
                  f"{r0['calls']:.0f} seq collectives and {r0['bytes'] / 1e6:.3f} MB "
                  f"a step {'ok' if good else 'FAIL'} [{card}]")
            name, err = r0["worst"]
            print(f"  19a {label}: the furthest first-step gradient {name} {err:.2e}"
                  + ("" if r0["repeat"] is None else
                     f"; the one-process reference run twice: furthest "
                     f"{r0['repeat'][0] or '(none)'} {r0['repeat'][1]:.2e}"))
            if "teeth" in r0:
                broke = not _dp_gate(r0["teeth"])
                ok = ok and broke
                print(f"  19a {label} with each shard zero-padded at its edges (no "
                      f"exchange): {fmt(r0['teeth'])}; breaks the gates {broke}")
        print(f"  19a {secs:.1f} s for the launch of {world} ranks")
    if not ok:
        fail("phase 19a: the sequence-parallel step disagrees with one process, or "
             "the run without exchange passed the gates")
    tr = [r["times"] for r in times]
    act = lambda peak, base: peak - base  # noqa: E731
    print(f"  19c bf16 GAN step, B={TRAIN_B} T={TRAIN_T}: one process "
          f"{np.median(ref_ms):.3f} ms/step (min {min(ref_ms):.3f}, max "
          f"{max(ref_ms):.3f}), peak {ref_peak:.3f} GB of which {ref_base:.3f} GB "
          f"held between steps (activations {act(ref_peak, ref_base):.3f} GB); "
          f"2 seq ranks on {_seq_devices(2)}: "
          + "; ".join(f"rank {i} {np.median(r['ms']):.3f} ms/step (min "
                      f"{min(r['ms']):.3f}, max {max(r['ms']):.3f}), peak "
                      f"{r['peak_gb']:.3f} GB, held {r['base_gb']:.3f} GB "
                      f"(activations {act(r['peak_gb'], r['base_gb']):.3f} GB, "
                      f"{act(r['peak_gb'], r['base_gb']) / act(ref_peak, ref_base):.3f}"
                      f" of one process's)" for i, r in enumerate(tr))
          + f"; exchanges a step (synchronised): {tr[0]['exchange_calls']:.0f} calls, "
          f"{tr[0]['exchange_bytes'] / 1e6:.3f} MB, {tr[0]['exchange_ms']:.3f} ms "
          f"[{card}]")
    if not all(r["finite"] for r in tr):
        fail("phase 19c: a sequence-parallel step's metrics are not finite")


def seq_trainer_check(device, card) -> dict:
    """Phase 19b: the trainer CLI with --seq_par 2 on SEQ_TRAIN_CLIPS mels,
    SIGTERM mid-run and a rerun; returns rank 0's launches."""
    from mqgan_tpu_torch.parallel import multihost

    root = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    extra = ("--seq_par", "2")
    try:
        cfg, cfg_path = _trainer_run_config(root, np.random.default_rng(SEED + 45),
                                            SEQ_TRAIN_CLIPS, SEQ_CLIP_FRAMES)
        cfg["training"]["num_epochs"] = 4
        sig_path = os.path.join(root, "cfg_4.json")
        with open(sig_path, "w") as f:
            json.dump(cfg, f)
        devices = _seq_devices(2)
        t0 = time.perf_counter()
        ranks = multihost.launch(_dp_trainer_rank, devices,
                                 (cfg_path, sig_path, False, extra),
                                 timeout_s=DP_TIMEOUT_S)
        secs = time.perf_counter() - t0
        resumed = multihost.launch(_dp_trainer_rank, devices,
                                   (cfg_path, sig_path, True, extra),
                                   timeout_s=DP_TIMEOUT_S)
        with open(os.path.join(root, "run", "train_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0, r1 = ranks
    train_recs = [r for r in recs if "loss_g_total" in r and r.get("epoch") in (1.0, 2.0)]
    finite = all(math.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))
    steps_per_epoch = r0["steps"] // 2
    logged = sum(1 for n in range(1, steps_per_epoch + 1) if n == 1 or n % 10 == 0)
    ckpts = [f for f in r0["files"] if f.startswith("checkpoint_epoch_")]
    new = sorted(set(r0["files_after_signal"]) - set(r0["files"]))
    evals = [r for r in recs if "eval_recon_post_mse" in r]
    print(f"  19b trainer CLI --seq_par 2 on {devices}: {r0['steps']} steps a rank (B="
          f"{cfg['data']['batch_size']}, crops {cfg['data']['crop_len']}, each rank "
          f"half of every crop), {secs:.1f} s for both runs; rank 0 launches "
          f"{r0['launches']} ({r0['eval']} eval-step calls: plot batches and eval "
          f"clips; {len(evals)} evals logged), "
          f"rank 1 launches {r1['launches']}; launches inside train steps "
          f"{r0['step_launches']} / {r1['step_launches']}; ranks bit-equal "
          f"{r0['checksum'] == r1['checksum']}; loggers {r0['logger']} / "
          f"{r1['logger']}; {len(train_recs)} train records (want {2 * logged}), "
          f"checkpoints {ckpts}")
    print(f"  19b SIGTERM at each rank's first step of epoch 3: stopped "
          f"{r0['stopped']} / {r1['stopped']} at step {r0['stop_step']} / "
          f"{r1['stop_step']}, new files {new}; the rerun resumed at epoch "
          f"{resumed[0]['start_epoch']} / {resumed[1]['start_epoch']} and ended at step "
          f"{resumed[0]['step']} [{card}]")
    ok = (finite and r0["checksum"] == r1["checksum"] and evals
          and all(r0["launches"].get(k, 0) > 0 for k in SEQ_EVAL_KERNELS)
          and not r1["launches"] and r1["eval"] == 0
          and not r0["step_launches"] and not r1["step_launches"]
          and r0["logger"] == "MetricsLogger" and r1["logger"] == "NullLogger"
          and len(train_recs) == 2 * logged
          and ckpts == ["checkpoint_epoch_001.pt", "checkpoint_epoch_002.pt"])
    if not ok:
        fail("phase 19b: the sequence-parallel trainer CLI's run is wrong")
    if (not (r0["stopped"] and r1["stopped"]) or new != ["checkpoint_epoch_003.pt"]
            or r0["stop_step"] != r1["stop_step"]
            or [r["start_epoch"] for r in resumed] != [4, 4]):
        fail("phase 19b: SIGTERM did not stop both ranks with one checkpoint, "
             "or the rerun did not resume")
    return r0["launches"]


def seq_parallel_training(device, card) -> dict:
    """Phase 19: (a)-(c); returns rank 0's launches in the trainer CLI."""
    import torch

    seconds, t0 = {}, time.perf_counter()
    with torch.enable_grad():
        print("  [19a, 19c] the sequence-parallel step vs one process; step times")
        seq_step_check(device, card)
        seconds["a+c"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        print("  [19b] the trainer CLI with --seq_par 2")
        launches = seq_trainer_check(device, card)
        seconds["b"] = round(time.perf_counter() - t0, 1)
    print(f"  phase 19 seconds by part: {seconds}")
    return launches


def seq_training_alone() -> None:
    """``python3 chip_smoke.py --seq-training``: phase 19 alone (the kernels
    built first, since rank 0's eval launches them), for a quick check of
    the sequence-parallel path; prints no result line."""
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mqgan_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    card = card_line()
    _cuda.LIBRARY.load()
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; kernels "
          f"built in {_cuda.LIBRARY.build_seconds:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    launches = seq_parallel_training(torch.device("cuda"), card)
    print(f"  launches of the sequence-parallel trainer: {launches}; total "
          f"{time.perf_counter() - t0:.1f} s")


# phase 20, the codec artifact as the JAX package exports it: (a) the
# kernels' ops against their kernel wrappers, (b) three traced artifacts at
# flagship width, (c) CUDA-graph replay against the eager programs, (d) the
# int8 refiner conv
ARTIFACT_BUCKETS = (128, 512)
ARTIFACT_CMP = ((1, (128,)), (1, (77,)), (7, (128, 127, 100, 77, 64, 9, 1)),
                (2, (512, 300)))
INT8_CMP_B, INT8_B, INT8_T = 2, 64, 512
# phase 20d's ragged shapes at B=3: heights, widths, Cin, Cout (every
# combination, fp32 and bf16)
INT8_RAGGED_B = 3
INT8_RAGGED = ((1, 13, 40), (100, 144), (64, 192, 768), (64, 256, 512))
INT8_TRIP_LENGTHS = (77, 60, 13)  # the eager int8 round trip at B=3 T=77
INT8_CONVS = 14  # the refiner's downs, mid and ups: 7 ConvBlocks of 2 convs
PEAK_INT8 = 1979e12  # H100 SXM dense int8 tensor-core ops/s (data sheet)
GRAPH_SPAN_T, GRAPH_BIG_B = DEPLOY_BUCKETS[-1], 64


def _op_cases(device) -> dict:
    """Phase 20a: name -> (op, its kernel wrapper, arguments on the card),
    small shapes the kernels take (bf16 blocks and the int8 conv need
    channels % 16, the flash kernels D in 32/64/128)."""
    import torch

    from mqgan_tpu_torch.core.config import SpectrogramConfig
    from mqgan_tpu_torch.nn.blocks import ResidualBlock1D
    from mqgan_tpu_torch.nn.mixer2d import MelMixer2D
    from mqgan_tpu_torch.ops import (block_kernels as bk, flash_attention as fa,
                                     fsq_kernels as fk, int8_conv as ik,
                                     mixer_kernels as mk, mixer_poly as mp,
                                     stft_kernels as sk)
    from mqgan_tpu_torch.quant.fsq import FSQSpec
    from mqgan_tpu_torch.utils.init import seeded_init_

    gen = torch.Generator(device=device).manual_seed(SEED + 40)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def detached(w):
        return type(w)(*(None if t is None else t.detach().to(device) for t in w))

    dt, b, t = torch.bfloat16, 3, 77
    lengths = torch.tensor([77, 40, 1], dtype=torch.int32, device=device)
    lo, hi = torch.zeros_like(lengths), lengths.clone()
    cbam = detached(seeded_init_(ResidualBlock1D(32, 48, 3, causal=False), 1)
                    .to(device).kernel_weights(dt))
    causal = detached(seeded_init_(ResidualBlock1D(48, 48, 5, causal=True), 2)
                      .to(device).kernel_weights(dt))
    x32, x48 = rand(b, t, 32, dtype=dt), rand(b, t, 48, dtype=dt)
    z, part, proj = bk.residual_block_begin_kernel(x32, lengths, *cbam, lo, hi)
    mix = detached(seeded_init_(MelMixer2D(64), 3).to(device).kernel_weights())
    xm = rand(b, t, 64, dtype=dt)
    spec = FSQSpec((8, 5, 5, 5))
    h = rand(b * t, 48, dtype=dt)
    fw, fb = rand(48, 4), rand(4)
    consts = torch.from_numpy(fk.fsq_head_constants(spec)).to(device)
    tables = sk.log_mel_tables(SpectrogramConfig(), device)
    mixed = sk.log_mel_tables(mixed_configs()[0], device)
    odd = SpectrogramConfig(sampling_rate=16000, filter_length=1201, hop_length=300,
                            win_length=1201, n_mel_channels=80, mel_fmax=8000.0)
    dft = [x.to(device) for x in sk.dft_mel_tables(odd)]
    blue = {name: sk.log_mel_tables(cfg, device)
            for name, cfg in (("log_mel_bluestein", odd),
                              ("log_mel_bluestein even", dft_config()))}
    wav = rand(2, 9000)
    q, k, v = (rand(2, 65, 2, 64, dtype=dt) for _ in range(3))
    o, lse = fa.flash_attention_fwd(q, k, v, 0.125)
    do = rand(2, 65, 2, 64, dtype=dt)
    img = rand(2, 32, 12, 144, dtype=dt).contiguous(memory_format=torch.channels_last)
    wq, sw = ik.quantize_weights(rand(48, 32, 3, 3, dtype=dt))
    bias = rand(48)
    ops = torch.ops.mqgan
    return {
        "fsq_head": (ops.fsq_head, fk.fsq_head_kernel, (h, fw, fb, consts)),
        "residual_block": (ops.residual_block, bk.residual_block_kernel,
                           (x32, lengths, *cbam, False)),
        "residual_block causal": (ops.residual_block, bk.residual_block_kernel,
                                  (x48, lengths, *causal, True)),
        "residual_block_begin": (ops.residual_block_begin, bk.residual_block_begin_kernel,
                                 (x32, lengths, *cbam, lo, hi)),
        "residual_block_finish": (ops.residual_block_finish,
                                  bk.residual_block_finish_kernel,
                                  (x32, lengths, *cbam, proj, z, part.contiguous(),
                                   lengths.float())),
        "mel_mixer": (ops.mel_mixer, mk.mel_mixer_kernel, (xm, lengths, *mix)),
        "mel_mixer_poly": (ops.mel_mixer_poly, mp.poly_mixer_kernel,
                           (xm, lengths, *mix, mp.POLY_DEGREE, mp.POLY_GRID)),
        "log_mel": (ops.log_mel, sk.log_mel_kernel,
                    (wav, tables.fbank, tables.cos, tables.sin, tables.window,
                     tables.twiddles, tables.bands, tables.weights, tables.hop,
                     tables.n_fft)),
        "log_mel_mixed": (ops.log_mel_mixed, sk.log_mel_mixed_kernel,
                          (wav, mixed.fbank, mixed.cos, mixed.sin, mixed.window,
                           mixed.plan, mixed.twiddles, mixed.bands, mixed.weights,
                           mixed.hop, mixed.n_fft)),
        **{name: (ops.log_mel_bluestein, sk.log_mel_bluestein_kernel,
                  (wav, t.fbank, None, None, t.premul, t.chirp, t.plan, t.twiddles,
                   t.spectrum, t.split, t.bands, t.weights, t.hop, t.n_fft))
           for name, t in blue.items()},
        "log_mel_dft": (ops.log_mel_dft, sk.log_mel_dft_kernel,
                        (wav, dft[0], dft[1], dft[2], 300)),
        "flash_fwd": (ops.flash_fwd, fa.flash_attention_fwd, (q, k, v, 0.125)),
        "flash_bwd": (ops.flash_bwd, fa.flash_attention_bwd, (q, k, v, o, lse, do, 0.125)),
        "int8_conv": (ops.int8_conv, ik.int8_conv_kernel, (img, wq, sw, bias)),
    }


def compare_ops(device) -> None:
    """Phase 20a: each op's CUDA implementation against its kernel wrapper
    on the same inputs, bit for bit, and torch.library.opcheck on the
    card (schema, fake implementation, AOT dispatch with dynamic shapes)."""
    import torch

    for name, (op, kernel, args) in _op_cases(device).items():
        got = op(*args)
        want = kernel(*args)
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        same = len(got) == len(want) and all(
            g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want))
        try:
            torch.library.opcheck(op.default, args)
            checked = "ok"
        except Exception as e:  # reported, then failed below
            checked = f"FAIL ({str(e)[:300]})"
        print(f"  20a {name}: op == kernel wrapper bit for bit "
              f"{'ok' if same else 'FAIL'}; opcheck on the card {checked}")
        if not same or checked != "ok":
            fail(f"phase 20a: the op {name} disagrees with its kernel wrapper or "
                 f"fails opcheck")


def op_dispatch(device, state, card) -> None:
    """Phase 20a: the host's microseconds per call of the int8 conv's and
    the FSQ head's ops (torch.library dispatch) against their kernel
    wrappers at the main path's shapes (the refiner's mid conv at B=64
    T=512; the head over 64 * 512 rows), each a run of calls enqueued with
    no sync, in turns op, wrapper, wrapper, op (medians)."""
    import torch

    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.nn.unet import _int8_args
    from mqgan_tpu_torch.ops import fsq_kernels as fk, int8_conv as ik

    model = build_model(device, torch.bfloat16, state=state)
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    conv = model.refiner.mid.conv1
    width = MELS + MELS // GeneratorConfig().refiner_hidden_proj_divisor
    cin = (conv.v if conv.weight_norm else conv.weight).shape[1]
    x = torch.randn((INT8_B, cin, INT8_T // 8, width), generator=gen,
                    device=device).to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    w = model.q_in_proj.weight.float().t().contiguous()
    h = torch.randn((BENCH_B * BENCH_T, w.shape[0]), generator=gen,
                    device=device).to(torch.bfloat16)
    cases = {"int8_conv": (ik.int8_conv_op, ik.int8_conv_kernel,
                           (x, *_int8_args(conv, torch.bfloat16)), 20),
             "fsq_head": (fk.fsq_head_op, fk.fsq_head_kernel,
                          (h, w, model.q_in_proj.bias.float(), model.fsq_consts), 200)}

    def host_us(fn, args, calls) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        us = 1e6 * (time.perf_counter() - t0) / calls
        torch.cuda.synchronize()
        return us

    for name, (op, kernel, args, calls) in cases.items():
        op(*args), kernel(*args)
        times = {op: [], kernel: []}
        for _ in range(3):
            for fn in (op, kernel, kernel, op):
                times[fn].append(host_us(fn, args, calls))
        op_us, kernel_us = np.median(times[op]), np.median(times[kernel])
        print(f"  20a {name} on the host, {calls} calls enqueued a run: the op "
              f"{op_us:.1f} us a call, the wrapper {kernel_us:.1f} us, the op's "
              f"dispatch {op_us - kernel_us:.1f} us [{card}]")
    del model, x, h
    torch.cuda.empty_cache()


def _artifact_exports(root) -> dict:
    """Phase 20b: the export CLI at flagship width, buckets ARTIFACT_BUCKETS:
    fp32 exact, bf16 poly-decode (the CLI default) and bf16 poly-decode with
    --int8_refiner; name -> (directory, export seconds)."""
    from mqgan_tpu_torch.deploy import export

    cfg = os.path.join(root, "flagship20.json")
    with open(cfg, "w") as f:
        json.dump({"model": {"mel_channels": MELS, "generator": DEPLOY_GENERATOR}}, f)
    buckets = [str(b) for b in ARTIFACT_BUCKETS]
    out = {}
    for name, flags in (("fp32", ["--exact_mixers"]), ("bf16", ["--bf16"]),
                        ("int8", ["--bf16", "--int8_refiner"])):
        d = os.path.join(root, f"exp20_{name}")
        t0 = time.perf_counter()
        export.main(["--config", cfg, "--seed", str(SEED), "--output", d,
                     "--buckets", *buckets, *flags])
        out[name] = (d, time.perf_counter() - t0)
    return out


def _program_round_trip(rt, model, x, lengths, bucket, counters):
    """The loaded programs called eagerly at bucket (no graph): (tokens,
    mel, launches of one encode + decode)."""
    import torch

    dev = rt.device
    b, t = x.shape[:2]
    xp = np.zeros((b, bucket, MELS), np.float32)
    xp[:, :t] = x
    pad = torch.from_numpy(np.arange(bucket)[None, :] >= lengths[:, None]).to(dev)
    enc = rt.program("encode", bucket, dev)
    dec = rt.program("decode", bucket, dev)
    with torch.no_grad():
        enc(torch.from_numpy(xp).to(dev), pad)  # load and warm
        before = counters.snapshot()
        idx = enc(torch.from_numpy(xp).to(dev), pad)
        mel = dec(idx, pad)
        torch.cuda.synchronize()
        after = counters.snapshot()
    launches = {k: after.get(k, 0) - before.get(k, 0) for k in after
                if after.get(k, 0) != before.get(k, 0)}
    return idx[:, :t].cpu().numpy(), mel[:, :t].float().cpu().numpy(), launches, pad


def artifact_programs(root, state, device, counters, card) -> dict:
    """Phase 20b: each artifact's loaded programs against the in-memory
    model on the kernels (tokens equal away from midpoints, the mel at
    phase 13's gates) and the launches of one round trip through them;
    returns name -> runtime."""
    import torch

    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder
    from mqgan_tpu_torch.models.preencoder import PreEncoder

    dirs = _artifact_exports(root)
    fp32 = build_model(device, torch.float32, state=state)
    rts = {}
    for name, (d, secs) in dirs.items():
        rt = rts[name] = ExportedPreEncoder(d)
        m = rt.manifest
        sizes = sum(os.path.getsize(os.path.join(d, p, f)) for p in m["platforms"]
                    for files in m["files"].values() for f in files.values())
        dtype = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32
        model = PreEncoder.from_config(MELS, GeneratorConfig(), dtype=dtype,
                                       poly_mixers=m["poly_mixers"],
                                       int8_refiner=m["int8_refiner"])
        model.load_state_dict(state)
        model = model.to(device).eval()
        print(f"  20b export {name}: {secs:.1f} s, platforms {m['platforms']}, files "
              f"{m['files']['128']}, {sizes / 1e6:.0f} MB of programs")
        want_launches = {"residual_block": 6, "fsq_head": 1,
                         "mel_mixer": 2 if not m["poly_mixers"] else 1}
        if m["poly_mixers"]:
            want_launches["mel_mixer_poly"] = 1
        if m["int8_refiner"]:
            want_launches["int8_conv"] = INT8_CONVS
        for bsz, lens in ARTIFACT_CMP:
            lengths = np.array(lens, np.int32)
            t = int(lengths.max())
            x = np.random.default_rng(SEED + 41 + bsz).standard_normal(
                (bsz, t, MELS)).astype(np.float32)
            bucket = rt.bucket_for(t)
            tokens, mel, launches, pad = _program_round_trip(rt, model, x, lengths,
                                                             bucket, counters)
            xp = np.zeros((bsz, bucket, MELS), np.float32)
            xp[:, :t] = x
            with torch.no_grad():
                want_tokens = model.encode(torch.from_numpy(xp).to(device), pad)
            want_tokens = want_tokens[:, :t].cpu().numpy()
            near = _near_midpoints(fp32, xp, lengths)[:, :t]
            valid = np.arange(t)[None, :] < lengths[:, None]
            flips = _check_tokens(f"20b {name} program vs model", tokens[valid],
                                  want_tokens[valid], near[valid])
            # the decode of the same tokens (a flipped token moves its frames)
            with torch.no_grad():
                idx = torch.from_numpy(np.pad(tokens, ((0, 0), (0, bucket - t)))).to(device)
                want = model.decode(idx, pad)[:, :t].float().cpu().numpy()
            ok, max_abs, detail = _judge("mel", torch.from_numpy(mel[valid]),
                                         torch.from_numpy(want[valid]), dtype)
            print(f"    B={bsz} T={t} (bucket {bucket}) lengths {list(lens)}: "
                  f"program vs in-memory model {flips} token flips (midpoints), "
                  f"{detail.strip()}, max|d| {max_abs:.3e}; launches of one encode + "
                  f"decode {launches} {'ok' if ok and launches == want_launches else 'FAIL'}")
            if not ok or launches != want_launches:
                fail(f"phase 20b: the {name} artifact's programs disagree with the "
                     f"model or launch {launches} (want {want_launches})")
    # the CPU programs of a card export are its programs moved to the CPU:
    # the fp32 ones against the model on the CPU (the plain versions)
    cpu_rt = ExportedPreEncoder(dirs["fp32"][0], device="cpu")
    cpu = build_model("cpu", torch.float32, state=state)
    x = np.random.default_rng(SEED + 45).standard_normal((1, 77, MELS)).astype(np.float32)
    tokens, mel = cpu_rt.reencode(x, [77])
    xp = torch.zeros((1, 128, MELS))
    xp[0, :77] = torch.from_numpy(x[0])
    pad = torch.arange(128)[None, :] >= 77
    want_tokens = cpu.encode(xp, pad)
    want = cpu.decode(want_tokens, pad)[:, :77].numpy()
    same = np.array_equal(tokens, want_tokens[:, :77].numpy()) and np.array_equal(mel, want)
    print(f"  20b fp32 artifact's CPU programs (moved from the card's) on the CPU vs "
          f"the model on the CPU, B=1 T=77: tokens and mel equal bit for bit "
          f"{'ok' if same else 'FAIL'}")
    if not same:
        fail("phase 20b: the artifact's CPU programs disagree with the CPU model")
    return rts


def _eager_call(rt, op, x, lengths):
    """The runtime's op through its programs called eagerly (no graph), on
    the same padded rows the runtime's graph takes."""
    import torch

    from mqgan_tpu_torch.deploy.runtime import graph_rows
    from mqgan_tpu_torch.parallel.mesh import repeat_pad_rows

    arr, pad_mask, t = rt._prepare(np.asarray(x), lengths)
    rows = arr.shape[0]
    arr, pad_mask = repeat_pad_rows((arr, pad_mask), graph_rows(rows))
    fn = rt._call(op, rt.device, arr.shape[1])
    with torch.no_grad():
        outs = fn(torch.from_numpy(arr).to(rt.device), torch.from_numpy(pad_mask).to(rt.device))
        unpadded = fn(torch.from_numpy(arr[:rows]).to(rt.device),
                      torch.from_numpy(pad_mask[:rows]).to(rt.device))
    return ([o[:rows, :t].cpu().numpy() for o in outs],
            [o[:, :t].cpu().numpy() for o in unpadded])


def graph_replay(rts, span_rt, card) -> None:
    """Phase 20c: the runtimes' CUDA-graph calls against the eager programs,
    bit for bit, at B=1 and B=7 ragged in both buckets (the graph's first
    call answers from its warm-up, the second replays), the padded-rows
    graph against the unpadded call (tokens equal, the mel at phase 13's
    gates); B=1 span ms eager vs replayed on phase
    13's bf16 artifact with the idle share, and the graphs' memory."""
    import torch

    from mqgan_tpu_torch.deploy.runtime import graph_rows

    for name in ("fp32", "bf16", "int8"):
        rt = rts[name]
        for bsz, lens in ((1, (128,)), (1, (300,)), (7, (512, 500, 300, 129, 128, 64, 1)),
                          (7, (128, 120, 77, 60, 9, 2, 1))):
            lengths = np.array(lens, np.int32)
            t = int(lengths.max())
            x = np.random.default_rng(SEED + 50 + bsz + t).standard_normal(
                (bsz, t, MELS)).astype(np.float32)
            for op, arg in (("encode", x), ("reencode", x)):
                first = rt.reencode(arg, lengths) if op == "reencode" else (rt.encode(arg, lengths),)
                again = rt.reencode(arg, lengths) if op == "reencode" else (rt.encode(arg, lengths),)
                eager, unpadded = _eager_call(rt, op, arg, lengths)
                same = all(np.array_equal(a, e) for a, e in zip(first, eager)) and \
                    all(np.array_equal(a, e) for a, e in zip(again, eager))
                # the padded rows leave the mixers' Chebyshev range as it
                # is, but cuBLAS and cuDNN may take another algorithm for
                # 7 rows than for 8: tokens equal, the mel at phase 13's gate
                pad_tokens = np.array_equal(again[0], unpadded[0])
                pad_ok, pad_diff = pad_tokens, 0.0
                if op == "reencode":
                    dt = torch.float32 if rt.manifest["dtype"] == "float32" else torch.bfloat16
                    ok_mel, pad_diff, _ = _judge("", torch.from_numpy(again[1]),
                                                 torch.from_numpy(unpadded[1]), dt)
                    pad_ok = pad_ok and ok_mel
                print(f"  20c {name} {op} B={bsz} T={t} (bucket {rt.bucket_for(t)}, "
                      f"graph rows {graph_rows(bsz)}): the capturing call and a replay "
                      f"== the eager program bit for bit {'ok' if same else 'FAIL'}; "
                      f"the padded-rows graph vs the unpadded call: tokens equal "
                      f"{pad_tokens}, mel max|d| {pad_diff:.3e} "
                      f"{'ok' if pad_ok else 'FAIL'}")
                if not (same and pad_ok):
                    fail(f"phase 20c: the {name} {op} graph disagrees with the eager "
                         f"call (replay {same}, padded rows {pad_ok})")
        print(f"    {name}: {len(rt.graphs)} graphs captured")

    rt = span_rt
    tokens = np.random.default_rng(SEED + 51).integers(
        0, rt.codebook_size, (1, GRAPH_SPAN_T)).astype(np.int32)
    prog = rt.program("decode", GRAPH_SPAN_T, rt.device)
    pad = torch.zeros((1, GRAPH_SPAN_T), dtype=torch.bool, device=rt.device)

    def eager():
        with torch.no_grad():
            return prog(torch.from_numpy(tokens).to(rt.device), pad).float().cpu().numpy()

    def replayed():
        return rt.decode(tokens)

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_reserved()
    if not np.array_equal(replayed(), eager()):  # the capture, then its check
        fail("phase 20c: the B=1 span's graph disagrees with the eager program")
    span_mem = torch.cuda.memory_reserved() - mem0
    for label, fn in (("eager program", eager), ("CUDA graph", replayed)):
        for _ in range(3):
            fn()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        events, wall = _device_profile(fn)
        busy = sum(ms for _, ms in events)
        idle = f"{1 - busy / wall:.3f}" if busy else "not measured"
        print(f"  20c B=1 decode span T={GRAPH_SPAN_T}, bf16 poly-decode (phase 13's "
              f"artifact), {label}: median {np.median(times):.3f} ms (min "
              f"{min(times):.3f}) host clock incl. copies; profiled: busy {busy:.3f} "
              f"of {wall:.3f} ms, idle share {idle} [{card}]")
    big = np.random.default_rng(SEED + 52).integers(
        0, rt.codebook_size, (GRAPH_BIG_B, GRAPH_SPAN_T)).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0, peak0 = torch.cuda.memory_reserved(), torch.cuda.max_memory_allocated()
    rt.decode(big)
    torch.cuda.synchronize()
    print(f"  20c graphs' memory: the B=1 T={GRAPH_SPAN_T} decode graph reserved "
          f"{span_mem / 1e6:.1f} MB; the B={GRAPH_BIG_B} T={GRAPH_SPAN_T} decode "
          f"graph {(torch.cuda.memory_reserved() - mem0) / 1e9:.2f} GB more reserved, "
          f"peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"(the pool is shared by the runtime's graphs) [{card}]")


def _int8_levels(model) -> list:
    """(name, conv, T divisor) of the int8 refiner's 14 convs."""
    ref = model.refiner
    out = []
    for i, blk in enumerate(ref.downs):
        out += [(f"down{i}.conv{j}", getattr(blk, f"conv{j}"), 2 ** (i + 1)) for j in (1, 2)]
    out += [(f"mid.conv{j}", getattr(ref.mid, f"conv{j}"), 2 ** ref.depth) for j in (1, 2)]
    for i, blk in enumerate(ref.ups):
        out += [(f"up{i}.conv{j}", getattr(blk, f"conv{j}"), 2 ** (ref.depth - 1 - i))
                for j in (1, 2)]
    return out


def _ulps(got, want) -> int:
    """The largest distance in units in the last place between two tensors
    of one float dtype (same-signed values; 0 where equal)."""
    import torch

    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
    return int((got.view(bits).long() - want.view(bits).long()).abs().max())


def _int8_compare(x, wq, sw, bias) -> tuple:
    """The kernel against its plain version on the same inputs: (codes
    equal, int32 sums equal, the output's distance in ulps)."""
    import torch

    from mqgan_tpu_torch.ops.int8_conv import (activation_scale, int8_conv_accumulators,
                                               int8_conv_kernel, int8_conv_plain,
                                               quantize_activations)

    xq, acc = int8_conv_kernel(x, wq, sw, bias, accumulators=True)
    pxq = quantize_activations(x.permute(0, 2, 3, 1), activation_scale(x))
    pacc = int8_conv_accumulators(pxq, wq)
    y, py = int8_conv_kernel(x, wq, sw, bias), int8_conv_plain(x, wq, sw, bias)
    return torch.equal(xq, pxq), torch.equal(acc, pacc), _ulps(y, py)


def int8_ragged(device, gen) -> None:
    """Phase 20d: the int8 conv against its plain version at B=3 and every
    shape of INT8_RAGGED (heights off the tile's 8 rows, widths off its 16
    columns, Cin % 128 != 0, Cout below, at and above one N tile), fp32 and
    bf16, under the 14 shapes' gates."""
    import torch

    from mqgan_tpu_torch.ops.int8_conv import int8_tile_plan, quantize_weights

    worst, n_ok, n = 0, 0, 0
    hs, ws, cins, couts = INT8_RAGGED
    for h in hs:
        for w in ws:
            for cin in cins:
                for cout in couts:
                    for dtype in (torch.float32, torch.bfloat16):
                        x = torch.randn((INT8_RAGGED_B, cin, h, w), generator=gen,
                                        device=device)
                        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
                        k = torch.randn((cout, cin, 3, 3), generator=gen, device=device)
                        wq, sw = quantize_weights(k.to(dtype))
                        bias = torch.randn((cout,), generator=gen, device=device)
                        codes, sums, ulps = _int8_compare(x, wq, sw, bias)
                        ok = codes and sums and ulps <= 1
                        worst, n, n_ok = max(worst, ulps), n + 1, n_ok + ok
                        if not ok:
                            plan = int8_tile_plan(INT8_RAGGED_B, h, w, cin, cout)
                            print(f"  20d ragged B={INT8_RAGGED_B} {cin}->{cout} H={h} "
                                  f"W={w} {str(dtype)[6:]} (bn {plan.bn}, bk {plan.bk}, "
                                  f"box {plan.box_w}x{plan.box_h}): codes equal {codes}, "
                                  f"sums equal {sums}, {ulps} ulp FAIL")
    print(f"  20d ragged shapes (B={INT8_RAGGED_B}, H {hs}, W {ws}, Cin {cins}, Cout "
          f"{couts}, fp32 and bf16): {n_ok} of {n} with codes and int32 sums equal "
          f"and the output within 1 ulp (worst {worst}) {'ok' if n_ok == n else 'FAIL'}")
    if n_ok != n:
        fail("phase 20d: int8_conv disagrees with its plain version at a ragged shape")


def _int8_split(shapes, device, gen, card) -> None:
    """Phase 20d: one profiled call of each of the 14 convs at B=64 T=512
    (bf16), split into the max pass, the quantize pass and the conv
    kernel, each beside its bound (bytes for the passes, the larger of
    operations and bytes for the conv); shapes: (name, cin, cout, h, w,
    wq, sw, bias)."""
    import torch

    from mqgan_tpu_torch.ops.int8_conv import int8_conv_kernel

    parts = ("absmax_kernel", "quantize_kernel", "conv_kernel")
    totals = [0.0] * 6
    measured = 0
    for name, cin, cout, h, w, wq, sw, bias in shapes:
        x = torch.randn((INT8_B, cin, h, w), generator=gen, device=device)
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        # late in a long run the profiler may miss a profile's device
        # events: up to three profiles a conv
        for _ in range(3):
            events, _ = _device_profile(lambda: int8_conv_kernel(x, wq, sw, bias))
            got = {p: sum(ms for k, ms in events if p in k) for p in parts}
            if all(got.values()):
                break
        del x
        if not all(got.values()):
            print(f"  20d split {name}: the profiler saw {got} (not measured)")
            continue
        m = INT8_B * h * w
        x_bytes, xq_bytes, y_bytes = 2.0 * m * cin, 1.0 * m * cin, 2.0 * m * cout
        ops = 2.0 * m * cout * 9 * cin
        bounds = (1e3 * x_bytes / PEAK_BYTES, 1e3 * (x_bytes + xq_bytes) / PEAK_BYTES,
                  max(1e3 * ops / PEAK_INT8,
                      1e3 * (xq_bytes + 9 * cin * cout + y_bytes + 8 * cout) / PEAK_BYTES))
        if any(got[p] < bound for p, bound in zip(parts, bounds)):
            print(f"  20d split {name}: the profiler's {got} lie below the bounds "
                  f"{[round(b, 4) for b in bounds]} (not measured)")
            continue
        measured += 1
        for j, p in enumerate(parts):
            totals[j] += got[p]
            totals[3 + j] += bounds[j]
        rate = ops / got["conv_kernel"] / 1e9
        print(f"  20d split {name} {cin}->{cout} H={h}: max {got['absmax_kernel']:.4f} ms "
              f"(bound {bounds[0]:.4f}), quantize {got['quantize_kernel']:.4f} ms (bound "
              f"{bounds[1]:.4f}), conv {got['conv_kernel']:.4f} ms (bound {bounds[2]:.4f}, "
              f"{rate:.1f} TOP/s = {1e12 * rate / PEAK_INT8:.3f} of 1,979)")
    print(f"  20d split over {measured} of the {len(shapes)} convs (profiler, one call "
          f"each): max {totals[0]:.3f} ms (bound {totals[3]:.3f}), quantize "
          f"{totals[1]:.3f} ms (bound {totals[4]:.3f}), conv {totals[2]:.3f} ms (bound "
          f"{totals[5]:.3f}) [{card}]")


def _int8_small_trip(state, int8, device) -> None:
    """Phase 20d: one eager bf16 round trip with the int8 refiner at B=3
    T=77 (int8 convs at 40, 20 and 10 frames) against a CPU copy of its
    model (plain versions): the decode of the card's tokens on both, over
    the valid frames, at the bf16 kernel gate (rel-L2 <= 2e-2); token
    flips counted."""
    import torch

    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.models.preencoder import PreEncoder

    lengths = np.array(INT8_TRIP_LENGTHS)
    t = int(lengths.max())
    x = np.random.default_rng(SEED + 61).standard_normal((len(lengths), t, MELS))
    xt = torch.from_numpy(x.astype(np.float32))
    pad = torch.from_numpy(np.arange(t)[None, :] >= lengths[:, None])
    cpu = PreEncoder.from_config(MELS, GeneratorConfig(), dtype=torch.bfloat16,
                                 poly_mixers="decode", int8_refiner=True)
    cpu.load_state_dict(state)
    cpu = cpu.eval()
    with torch.no_grad():
        tokens = int8.encode(xt.to(device), pad.to(device))
        mel = int8.decode(tokens, pad.to(device)).float().cpu()
        want = cpu.decode(tokens.cpu(), pad).float()
        flips = int((cpu.encode(xt, pad) != tokens.cpu())[~pad].sum())
    ok, _, detail = _judge("int8 decode", mel[~pad], want[~pad], torch.bfloat16)
    ok = ok and mel.shape == want.shape
    print(f"  20d eager bf16 int8 round trip B={len(lengths)} T={t} lengths "
          f"{lengths.tolist()} vs a CPU copy (plain versions): {detail.strip()}; "
          f"{flips} of {int((~pad).sum())} tokens differ (counted) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"phase 20d: the int8 round trip at B=3 T=77 disagrees with its CPU copy: "
             f"{detail}")


def _int8_trip_profiles(flt, int8, levels, mel, pad, card) -> None:
    """Phase 20d: where the int8 round trip's time goes beside the float
    one's: one profiled B=64 T=512 round trip of each (device time by
    kernel group, the kernels whose time differs most), and the per-call
    weight quantization of the 14 convs (nn/unet.py _int8_args) alone.
    Printed only."""
    import torch

    from mqgan_tpu_torch.nn.unet import _int8_args

    by_name = {}
    for label, m in (("float refiner", flt), ("int8 refiner", int8)):
        events, wall = _device_profile(lambda: m.decode(m.encode(mel, pad), pad))
        _report_profile(f"20d {label} round trip B={BENCH_B} T={BENCH_T}", events, wall,
                        top=6)
        by_name[label] = dict(events)
    f, q = by_name["float refiner"], by_name["int8 refiner"]
    diff = sorted(((q.get(k, 0.0) - f.get(k, 0.0), k) for k in set(f) | set(q)),
                  reverse=True)
    print(f"  20d int8 - float device ms by kernel (largest first): " + "; ".join(
        f"{d:+.3f} {k[:60]}" for d, k in diff[:8] if d > 0))
    print(f"  20d float - int8 device ms by kernel (largest first): " + "; ".join(
        f"{-d:+.3f} {k[:60]}" for d, k in reversed(diff[-6:]) if d < 0))

    def quantize_all():
        return [_int8_args(conv, torch.bfloat16) for _, conv, _ in levels]

    events, _ = _device_profile(quantize_all)
    ms = time_ms(quantize_all, 5)
    print(f"  20d weight quantization of the 14 convs per call (nn/unet.py _int8_args, "
          f"re-run on every eager forward): {ms:.3f} ms, device "
          f"{sum(t for _, t in events):.3f} ms in {len(events)} kernel names [{card}]")


def int8_conv_checks(state, device, card) -> "_KernelRow":
    """Phase 20d: the int8 conv against its plain version at each of the
    int8 refiner's 14 conv shapes (B=2 T=512, fp32 and bf16: codes and
    int32 sums equal, the output within one ulp) and at the ragged shapes
    of INT8_RAGGED; its times at B=64 T=512 beside the plain version, the
    bound and cuDNN's bf16 conv2d, and split into its three kernels; then
    an eager B=3 T=77 int8 round trip against a CPU copy, and the bf16
    round trip at B=64 T=512 with and without the int8 refiner, each
    profiled."""
    import torch
    import torch.nn.functional as F

    from mqgan_tpu_torch.core.config import GeneratorConfig
    from mqgan_tpu_torch.models.preencoder import PreEncoder
    from mqgan_tpu_torch.nn.unet import _int8_args
    from mqgan_tpu_torch.ops.int8_conv import int8_conv_kernel, int8_conv_plain

    model = build_model(device, torch.bfloat16, state=state)
    width = MELS + MELS // GeneratorConfig().refiner_hidden_proj_divisor
    gen = torch.Generator(device=device).manual_seed(SEED + 60)
    row = _KernelRow("int8_conv", "mqgan_tpu_torch/csrc/int8_conv.cu",
                     "mqgan_tpu/nn/unet.py:51 (XLA int8 conv, no Pallas)")
    yardstick = 0.0  # cuDNN's bf16 conv2d: another function, not library_ms
    worst_ulps = 0
    levels = _int8_levels(model)
    shapes = []
    for name, conv, div in levels:
        cout, cin = conv.weight.shape[:2] if not conv.weight_norm else conv.v.shape[:2]
        for dtype in (torch.float32, torch.bfloat16):
            h = INT8_T // div
            x = torch.randn((INT8_CMP_B, cin, h, width), generator=gen, device=device)
            x = x.to(dtype).contiguous(memory_format=torch.channels_last)
            codes, sums, ulps = _int8_compare(x, *_int8_args(conv, dtype))
            worst_ulps = max(worst_ulps, ulps)
            ok = codes and sums and ulps <= 1
            if not ok or dtype == torch.bfloat16:
                print(f"  20d {name} {cin}->{cout} at B={INT8_CMP_B} H={h} W={width} "
                      f"{str(dtype)[6:]}: codes equal {codes}, int32 sums equal {sums}, "
                      f"output {ulps} ulp from plain {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"phase 20d: int8_conv {name} {dtype} disagrees with its plain version")
        dt = torch.bfloat16
        h = INT8_T // div
        x = torch.randn((INT8_B, cin, h, width), generator=gen, device=device)
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        wq, sw, bias = _int8_args(conv, dt)
        shapes.append((name, cin, cout, h, width, wq, sw, bias))
        w16, b16 = conv.folded().to(dt), conv.bias.to(dt)
        ms = time_ms(lambda: int8_conv_kernel(x, wq, sw, bias), 10)
        pms = time_ms(lambda: int8_conv_plain(x, wq, sw, bias), 1)
        lib = time_ms(lambda: F.conv2d(x, w16, b16, padding=1), 10)
        m = INT8_B * h * width
        ops = 2.0 * m * cout * 9 * cin
        nbytes = 2.0 * m * (cin + cout) + 9 * cin * cout + 8 * cout
        bound = row.add(ms, pms, ops, PEAK_INT8, nbytes)
        yardstick += lib
        print(f"  20d {name} {cin}->{cout} at B={INT8_B} H={h} W={width} bf16: "
              f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), plain {pms:.2f} ms, bound "
              f"{bound:.4f} ms, cuDNN bf16 conv2d {lib:.4f} ms [{card}]")
        del x
        torch.cuda.empty_cache()
    row.max_abs_err = 0.0
    print(f"  20d int8_conv over the 14 convs at B={INT8_B} T={INT8_T}: {row.ms:.3f} ms, "
          f"plain {row.plain_ms:.1f} ms, bound {row.bound_ms:.3f} ms "
          f"({row.bound_by}), cuDNN bf16 {yardstick:.3f} ms; worst output "
          f"{worst_ulps} ulp from plain [{card}]")
    _int8_split(shapes, device, gen, card)
    int8_ragged(device, gen)

    int8 = PreEncoder.from_config(MELS, GeneratorConfig(), dtype=torch.bfloat16,
                                  poly_mixers="decode", int8_refiner=True)
    int8.load_state_dict(state)
    int8 = int8.to(device).eval()
    _int8_small_trip(state, int8, device)
    flt = build_model(device, torch.bfloat16, poly_mixers="decode", state=state)
    mel = torch.randn((BENCH_B, BENCH_T, MELS), generator=gen, device=device)
    pad = torch.zeros((BENCH_B, BENCH_T), dtype=torch.bool, device=device)
    rates, outs = {}, {}
    with torch.no_grad():
        for label, m in (("float refiner", flt), ("int8 refiner", int8)):
            outs[label] = m.decode(m.encode(mel, pad), pad).float()
            ms = time_ms(lambda: m.decode(m.encode(mel, pad), pad), ITERS)
            rates[label] = BENCH_B * BENCH_T / (ms / 1e3)
        dev = float((outs["int8 refiner"] - outs["float refiner"]).abs().max())
        scale = float(outs["float refiner"].abs().max())
        ok = dev < 0.1 * scale and bool(torch.isfinite(outs["int8 refiner"]).all())
        print(f"  20d bf16 poly-decode round trip B={BENCH_B} T={BENCH_T}: "
              f"{rates['float refiner']:.1f} mel-frames/s float refiner, "
              f"{rates['int8 refiner']:.1f} int8 refiner (printed, not claimed); int8 vs "
              f"float max|d| {dev:.4f} = {dev / scale:.4f} of max|mel| (limit 0.1) "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        if not ok:
            fail("phase 20d: the int8 refiner's round trip deviates beyond 0.1 * max|mel|")
        del outs
        _int8_trip_profiles(flt, int8, levels, mel, pad, card)
    return row


def traced_artifacts(state, device, counters, card, deploy_root) -> tuple:
    """Phase 20: (the int8_conv row, the launches of 20b + 20c)."""
    import torch

    from mqgan_tpu_torch.deploy.runtime import ExportedPreEncoder

    seconds, t0 = {}, time.perf_counter()

    def lap(part):
        nonlocal t0
        seconds[part] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    print(f"  [20a] ops vs kernel wrappers, opcheck on the card")
    compare_ops(device)
    op_dispatch(device, state, card)
    lap("a")
    root = tempfile.mkdtemp(prefix="chip_smoke_artifact_")
    try:
        counters.reset()
        rts = artifact_programs(root, state, device, counters, card)
        lap("b")
        graph_replay(rts, ExportedPreEncoder(os.path.join(deploy_root, "exp_bf16")), card)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        lap("c")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"  launches in 20b-20c (programs and their graphs): {launches}")
    for name in ("residual_block", "mel_mixer", "mel_mixer_poly", "fsq_head", "int8_conv"):
        if launches.get(name, 0) <= 0:
            fail(f"phase 20: {name} was not launched through the artifacts")
    row = int8_conv_checks(state, device, card)
    lap("d")
    print(f"  phase 20 seconds by part: {seconds}")
    return row, launches


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
    errs["log_mel"], routed_launches = compare_log_mel(device)
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
                    **routed_launches)

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
    deploy_root = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
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
        lstm_run = lstm_run_dir(lm_root)
        lm_serving(os.path.join(lm_root, "run"), lstm_run, device, counters, card)
        print(f"[13] codec deployment, flagship width, seeded weights [{card}] {at()}")
        for kernel, err in codec_deployment(state, device, counters, card,
                                            deploy_root).items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"[14] codec GAN training, flagship width [{card}] {at()}")
        codec_training(device, counters, card)
        print(f"[15] vocoder training, full width (the trainer CLI's defaults) "
              f"[{card}] {at()}")
        voc_launches = vocoder_training(device, counters, card)
        print(f"[16] the LM artifact and codec attach [{card}] {at()}")
        lm_launches, lm_errs = lm_artifacts(os.path.join(lm_root, "run"), lstm_run,
                                            os.path.join(deploy_root, "exp_bf16"),
                                            device, counters, card)
        for kernel, err in lm_errs.items():
            errs[kernel] = max(errs.get(kernel, 0.0), err)
        print(f"  launches on the new paths: vocoder trainer CLI {voc_launches}, "
              f"LM server decodes {lm_launches}")
        print(f"[17] parallel serving: seq-parallel and data-parallel codec [{card}] {at()}")
        seq_launches, split_row = parallel_serving(state, deploy_root, device,
                                                   counters, card)
        rows.insert(1, split_row)
        launches["residual_block_split"] = seq_launches["residual_block_split"]
        print(f"[18] data-parallel and pipelined training, flagship width [{card}] {at()}")
        dp_launches = parallel_training(device, card)
        print(f"  launches of the data-parallel trainer (rank 0's eval): {dp_launches}")
        print(f"[19] sequence-parallel training, flagship width [{card}] {at()}")
        seq_train_launches = seq_parallel_training(device, card)
        print(f"  launches of the sequence-parallel trainer (rank 0's plots and "
              f"eval; none in a step): {seq_train_launches}")
        print(f"[20] the codec artifact's traced programs, CUDA graphs and the int8 "
              f"refiner [{card}] {at()}")
        int8_row, artifact_launches = traced_artifacts(state, device, counters, card,
                                                       deploy_root)
        rows.append(int8_row)
        launches["int8_conv"] = artifact_launches["int8_conv"]
    finally:
        shutil.rmtree(lm_root, ignore_errors=True)
        shutil.rmtree(deploy_root, ignore_errors=True)
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
    faulthandler.enable(all_threads=True)
    if len(sys.argv) == 3 and sys.argv[1] == "--fsq-head-of":
        fsq_head_of(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--lstm-step-of":
        lstm_step_of(sys.argv[2])
    elif sys.argv[1:] == ["--seq-training"]:
        seq_training_alone()
    else:
        main()
    # reached only when the run succeeded (a failure raises SystemExit or
    # an exception above): skip the teardown, as the docstring says
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
