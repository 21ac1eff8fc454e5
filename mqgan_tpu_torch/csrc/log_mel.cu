// Fused log-mel front end: waveform -> (frames, n_mels) log-mel in fp32, by
// an FFT of each frame. The route of ops/stft_kernels.py for power-of-two
// n_fft from 256 to 4096 (every spec config of the repo); log_mel_dft.cu
// takes the other shapes.
//
// Replaces: mqgan_tpu/ops/stft_kernels.py:95 _log_mel_frames_pallas (the
// Pallas TPU kernel behind PallasMelFrontend, a DFT product on the MXU).
//
//   frame n = (b, t): x[j] = wav[b, reflect(t * hop + j - n_fft / 2)] * w[j]
//   X[k]      = sum_j x[j] exp(-2 pi i j k / n_fft),   k = 0 .. n_fft / 2
//   out[n, m] = log(max(sum_{k in [lo_m, hi_m)} |X[k]| * fbank[k, m], 1e-5))
//
// What bounds the function: operations, barely. At the flagship shape
// (N = 64 clips x 512 frames = 32768, n_fft 2048, F 1025, 128 mels whose
// filterbank has 2,019 nonzeros of 131,200) it needs a real FFT per frame
// (2.5 n_fft log2 n_fft flops), the magnitudes (4 F), the filterbank's
// nonzeros (2 per nonzero), clamp and log (2 n_mels): 2.12 GFLOP, 0.032 ms
// at the fp32 peak (67 TFLOP/s); it moves 84 MB (67 MB of waveform read,
// 17 MB of log-mel written), 0.025 ms at 3.35 TB/s. The DFT product it
// replaces did 275 GFLOP.
//
// Why fp32 on CUDA cores, without TF32 or bf16 tensor cores: TF32 keeps
// about three decimal digits, which in the log domain is an error of ~1e-3,
// over the 5e-4 the front end is held to against the JAX reference.
//
// Design. A block of 256 threads owns kBlockPoints / (n_fft / 2) consecutive
// frames (4 at n_fft 2048; they may span two clips) and runs:
//  1. load: the n_fft real samples of a frame become an M = n_fft / 2-point
//     complex sequence z[n] = x[2n] + i x[2n+1]. Samples are read straight
//     from the unpadded waveform (the reflect padding is index arithmetic,
//     so no padded copy of the batch exists), windowed as they load, and
//     fed to the first pass; overlapping frames share L1/L2 lines.
//  2. a Stockham (autosorting) FFT of z: a first radix-16 pass in registers
//     (a 4 x 4 decomposition), radix-4 passes, and a radix-2 pass when
//     log2 M is odd; every pass reads one shared-memory buffer and writes
//     the other, one barrier between passes. The buffers are padded by one
//     slot per 16 points, which makes every pass's reads and writes free of
//     bank conflicts (the radix-16 pass writes 16 consecutive points per
//     thread). Twiddles come from a table computed in float64 on the host,
//     laid out in the order each pass reads them (consecutive threads read
//     consecutive entries); none is computed on the card.
//  3. the real-FFT split: X[k] = (Z[k] + conj Z[M-k]) / 2
//     + W^k (Z[k] - conj Z[M-k]) / 2i for the F = M + 1 bins, and |X[k]|,
//     written to the other buffer.
//  4. the banded mel: each thread takes one (mel, frame) and sums the band
//     [lo_m, hi_m) of nonzero filter weights in a fixed order (at most two
//     filters overlap a bin; the widest band is 56 bins), no atomics, the
//     result is deterministic; then the clamp, the exact logf, and a store
//     in which neighbouring threads write neighbouring frames of one mel.
// One launch per call on the caller's stream; the kernel allocates
// nothing. Exact sqrtf and logf: the library is built without
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kThreadsLog2 = 8;
constexpr int kBlockPoints = 4096;  // complex FFT points per block
constexpr int kPadded = kBlockPoints + kBlockPoints / 16;
constexpr float kLogClip = 1e-5f;

// shared-memory slot of point e: one pad slot after every 16 points
__device__ __forceinline__ int slot(int e) { return e + (e >> 4); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// in-place 4-point DFT: a_q <- sum_m a_m exp(-2 pi i m q / 4)
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2,
                                     float2& a3) {
  const float2 v0 = cadd(a0, a2), v1 = csub(a0, a2);
  const float2 v2 = cadd(a1, a3), d = csub(a1, a3);
  const float2 v3 = make_float2(d.y, -d.x);  // -i (a1 - a3)
  a0 = cadd(v0, v2);
  a1 = cadd(v1, v3);
  a2 = csub(v0, v2);
  a3 = csub(v1, v3);
}

// sample pos of a clip of `samples`, reflected at both ends (pos is within
// one reflection: the wrapper asks for samples > n_fft / 2)
__device__ __forceinline__ float reflected(const float* __restrict__ clip,
                                           int pos, int samples) {
  pos = pos < 0 ? -pos : pos;
  pos = pos >= samples ? 2 * (samples - 1) - pos : pos;
  return __ldg(clip + pos);
}

__global__ void __launch_bounds__(kThreads)
log_mel_fft_kernel(const float* __restrict__ wav,
                   const float* __restrict__ window,
                   const float2* __restrict__ tw,
                   const int* __restrict__ bands,
                   const float* __restrict__ weights,
                   float* __restrict__ out, int n_total, int frames_per_clip,
                   int samples, int hop, int n_fft, int n_mels) {
  extern __shared__ float2 smem[];
  float2* src = smem;
  float2* dst = smem + kPadded;

  const int tid = threadIdx.x;
  const int m = n_fft / 2;
  const int log2m = __ffs(m) - 1;
  const int frames = kBlockPoints / m;  // a power of two, 2 .. 32
  const int log2f = __ffs(frames) - 1;
  const int n0 = blockIdx.x * frames;

  // 1-2a. load and the radix-16 pass: u_q = z[i + q M/16] -> Y[16 i + c]
  {
    const int log2t = log2m - 4;
    const float2* win2 = reinterpret_cast<const float2*>(window);
    for (int idx = tid; idx < kBlockPoints / 16; idx += kThreads) {
      const int f = idx >> log2t;
      const int i = idx & ((1 << log2t) - 1);
      const int n = n0 + f;
      float2 u[16];
      if (n < n_total) {
        const int b = n / frames_per_clip;
        const float* clip = wav + static_cast<size_t>(b) * samples;
        const int start = (n - b * frames_per_clip) * hop - n_fft / 2;
        // a frame inside its clip, 8-byte aligned: sample pairs as float2
        const bool paired = start >= 0 && start + n_fft <= samples &&
                            (reinterpret_cast<size_t>(clip + start) & 7) == 0;
        const float2* pairs = reinterpret_cast<const float2*>(clip + start);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int h = i + (q << log2t);  // z[h] = x[2h] + i x[2h + 1]
          const float2 w = __ldg(win2 + h);
          const float2 x = paired
              ? __ldg(pairs + h)
              : make_float2(reflected(clip, start + 2 * h, samples),
                            reflected(clip, start + 2 * h + 1, samples));
          u[q] = make_float2(x.x * w.x, x.y * w.y);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) u[q] = make_float2(0.0f, 0.0f);
      }
      // q = 4a + b: a 4-point DFT over a for each b leaves A_b[c] in u[4c + b]
#pragma unroll
      for (int b = 0; b < 4; ++b) dft4(u[b], u[4 + b], u[8 + b], u[12 + b]);
#pragma unroll
      for (int c = 1; c < 4; ++c) {
#pragma unroll
        for (int b = 1; b < 4; ++b) u[4 * c + b] = cmul(u[4 * c + b], __ldg(tw + b * c));
      }
      // a 4-point DFT over b leaves Y[c + 4d] in u[4c + d]
#pragma unroll
      for (int c = 0; c < 4; ++c) dft4(u[4 * c], u[4 * c + 1], u[4 * c + 2], u[4 * c + 3]);
      const int base = (f << log2m) + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int d = 0; d < 4; ++d) dst[slot(base + c + 4 * d)] = u[4 * c + d];
      }
    }
  }
  // The later passes give each thread fixed butterflies (lanes of
  // consecutive i) over a group of frames: a twiddle loads once per
  // butterfly and serves every frame.
  int tw_off = 16;
  int p = 16;  // length of the sub-transforms done so far
  // 2b. radix-4 passes: inputs z[i + q M/4], outputs at 4(i - k) + k + q p
  for (; 4 * p <= m; p *= 4) {
    float2* t = src; src = dst; dst = t;
    __syncthreads();
    const int quarter = m / 4;
    const int log2l = min(log2m - 2, kThreadsLog2);
    for (int i = tid & ((1 << log2l) - 1); i < quarter; i += 1 << log2l) {
      const int k = i & (p - 1);
      const float2 w1 = __ldg(tw + tw_off + k);
      const float2 w2 = __ldg(tw + tw_off + p + k);
      const float2 w3 = __ldg(tw + tw_off + 2 * p + k);
      const int o = ((i - k) << 2) + k;
      for (int f = tid >> log2l; f < frames; f += kThreads >> log2l) {
        const int row = f << log2m;
        float2 a0 = src[slot(row + i)];
        float2 a1 = cmul(src[slot(row + i + quarter)], w1);
        float2 a2 = cmul(src[slot(row + i + 2 * quarter)], w2);
        float2 a3 = cmul(src[slot(row + i + 3 * quarter)], w3);
        dft4(a0, a1, a2, a3);
        dst[slot(row + o)] = a0;
        dst[slot(row + o + p)] = a1;
        dst[slot(row + o + 2 * p)] = a2;
        dst[slot(row + o + 3 * p)] = a3;
      }
    }
    tw_off += 3 * p;
  }
  // 2c. a radix-2 pass (p = M/2) when log2 M is odd
  if (2 * p == m) {
    float2* t = src; src = dst; dst = t;
    __syncthreads();
    const int log2l = min(log2m - 1, kThreadsLog2);
    for (int i = tid & ((1 << log2l) - 1); i < p; i += 1 << log2l) {
      const float2 w = __ldg(tw + tw_off + i);
      for (int f = tid >> log2l; f < frames; f += kThreads >> log2l) {
        const int in = (f << log2m) + i;
        const float2 a0 = src[slot(in)];
        const float2 a1 = cmul(src[slot(in + p)], w);
        dst[slot(in)] = cadd(a0, a1);
        dst[slot(in + p)] = csub(a0, a1);
      }
    }
    tw_off += p;
  }
  // 3. split to the F = M + 1 bins of the real FFT, and the magnitudes
  {
    float2* t = src; src = dst; dst = t;
    __syncthreads();
    float* mag = reinterpret_cast<float*>(dst);  // [frames][M + 1]
    const int n_freq = m + 1;
    const int log2l = min(log2m, kThreadsLog2);
    for (int k = tid & ((1 << log2l) - 1); k <= m; k += 1 << log2l) {
      const float2 w = __ldg(tw + tw_off + k);
      const int ka = k & (m - 1), kb = (m - k) & (m - 1);
      for (int f = tid >> log2l; f < frames; f += kThreads >> log2l) {
        const float2 a = src[slot((f << log2m) + ka)];
        const float2 b = src[slot((f << log2m) + kb)];
        const float2 even = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
        const float2 odd = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
        const float2 x = cadd(even, cmul(w, odd));
        mag[f * n_freq + k] = sqrtf(fmaf(x.x, x.x, x.y * x.y));
      }
    }
  }
  __syncthreads();
  // 4. banded mel, clamp, log
  const float* mag = reinterpret_cast<const float*>(dst);
  for (int idx = tid; idx < (n_mels << log2f); idx += kThreads) {
    const int mel = idx >> log2f;
    const int f = idx & (frames - 1);
    const int n = n0 + f;
    if (n >= n_total) continue;
    const int lo = __ldg(bands + 3 * mel);
    const int hi = __ldg(bands + 3 * mel + 1);
    const float* w = weights + __ldg(bands + 3 * mel + 2);
    const float* row = mag + f * (m + 1);
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = fmaf(row[k], __ldg(w + (k - lo)), acc);
    out[static_cast<size_t>(n) * n_mels + mel] = logf(fmaxf(acc, kLogClip));
  }
}

}  // namespace

extern "C" int mqgan_log_mel(const void* wav, const void* window,
                             const void* twiddles, const void* bands,
                             const void* weights, void* out, int n_clips,
                             int frames_per_clip, int samples, int hop,
                             int n_fft, int n_mels, void* stream) {
  const int n_total = n_clips * frames_per_clip;
  const int frames = kBlockPoints / (n_fft / 2);
  const size_t smem = sizeof(float2) * 2 * kPadded;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_total + frames - 1) / frames);
  log_mel_fft_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const float2*>(twiddles), static_cast<const int*>(bands),
      static_cast<const float*>(weights), static_cast<float*>(out), n_total,
      frames_per_clip, samples, hop, n_fft, n_mels);
  return static_cast<int>(cudaGetLastError());
}
