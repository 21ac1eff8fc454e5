// Fused log-mel front end by a mixed-radix FFT: waveform -> (frames, n_mels)
// log-mel in fp32. The route of ops/stft_kernels.py for an even n_fft from 4
// to 8192 that log_mel.cu (powers of two from 256 to 4096) does not take and
// whose M = n_fft / 2 has no prime factor above 7: 1200, 1000, 800, 400 at
// 16 kHz, 480 and 960 at 48 kHz, 1764 at 44.1 kHz, 128, 8192.
// log_mel_bluestein.cu takes the other n_fft from 3 (odd, a larger prime
// factor, past 8192) up to its limit, log_mel_dft.cu what is left (n_fft 1
// and 2, n_fft past that limit). The butterflies, reflect padding, split
// and mel stage are fft_radix.cuh's, shared with log_mel_bluestein.cu.
//
// Replaces: mqgan_tpu/ops/stft_kernels.py:95 _log_mel_frames_pallas (the
// Pallas TPU kernel behind PallasMelFrontend, a DFT product on the MXU), for
// those shapes; before this kernel they took the DFT product of
// log_mel_dft.cu.
//
//   frame n = (b, t): x[j] = wav[b, reflect(t * hop + j - n_fft / 2)] * w[j]
//   X[k]      = sum_j x[j] exp(-2 pi i j k / n_fft),   k = 0 .. n_fft / 2
//   out[n, m] = log(max(sum_{k in [lo_m, hi_m)} |X[k]| * fbank[k, m], 1e-5))
//
// What bounds the function: operations, barely, as for log_mel.cu. At n_fft
// 1200 on 64 clips of 261,632 samples (55,872 frames, 80 mels) it needs a
// real FFT per frame (2.5 n_fft log2 n_fft flops), the magnitudes, the
// filterbank's nonzeros and the log: ~1.7 GFLOP, 0.03 ms at the fp32 peak;
// it moves the 67 MB waveform and 18 MB of log-mel. The DFT product it takes
// over from does 4 N n_fft F = 161 GFLOP there.
//
// Why fp32 on CUDA cores, without TF32 or bf16 tensor cores: TF32 keeps
// about three decimal digits, which in the log domain is an error of ~1e-3,
// over the 5e-4 the front end is held to against the JAX reference.
//
// Design: log_mel.cu's, generalised past powers of two. A block of 256
// threads owns `frames` consecutive frames (they may span two clips), as
// many whole frames as fit in 2048 points and at least one, the host's
// choice (ops/stft_kernels.py mixed_frames: 3 at n_fft 1200, 4 at 1000, 1
// from 4096 up; at most kMaxPoints). 2048 points a block (two buffers, 35 KB)
// were as fast as 3072 or 4096 and faster than 1024 at n_fft 1200, 1000 and
// 1764 on an H100 (chip_smoke.py phase 8's batch). The block runs:
//  0. each frame's clip offset and first sample, once per frame, into the
//     buffer that the first pass does not write;
//  1. load and the first pass: the n_fft real samples of a frame become the
//     M-point complex sequence z[n] = x[2n] + i x[2n+1], read straight from
//     the unpadded waveform (reflect padding is index arithmetic: no padded
//     copy of the batch exists) and windowed as they load; each thread takes
//     z[i + q M/r] for q < r, runs the r-point DFT in registers and writes
//     its r outputs to r i + s;
//  2. the later Stockham (autosorting) passes, radix 4, 2, 3, 5 or 7 as the
//     host's plan lists them: inputs z[i + q M/r] times W_{rp}^{qk} with
//     k = i mod p (p the length of the sub-transforms done so far), an
//     r-point DFT in registers (constant coefficients for r = 3, 5, 7: pairs
//     a_j +- a_{r-j}, so (r - 1)^2 / 2 real products a component), outputs
//     at r (i - k) + k + s p; one shared-memory buffer read, the other
//     written, one barrier between passes. A thread walks its butterflies
//     as a (frame, i / p, k) counter stepped by 256 with carries: no
//     division inside a loop. Buffers are padded by one slot per 16 points
//     (free of bank conflicts at power-of-two strides; odd strides r are
//     conflict-free on their own). Twiddles come from a float64 table of the
//     host, laid out in the order the passes read them (consecutive k,
//     consecutive entries); none is computed on the card;
//  3. the real-FFT split: X[k] = (Z[k] + conj Z[M-k]) / 2
//     + W^k (Z[k] - conj Z[M-k]) / 2i for the F = M + 1 bins, and |X[k]|,
//     written to the other buffer;
//  4. the banded mel: a thread per (frame, mel), mels of one frame on
//     neighbouring threads (the stores coalesce), the band [lo_m, hi_m) of
//     nonzero weights summed in a fixed order (no atomics, deterministic),
//     the clamp and the exact logf.
// One launch per call on the caller's stream; the kernel allocates nothing.
// Exact sqrtf and logf: the library is built without --use_fast_math.

#include <cuda_runtime.h>

#include "fft_radix.cuh"

namespace {

constexpr int kMaxPoints = 4096;  // complex FFT points per block, at most

// shared-memory slot of point e: one pad slot after every 16 points
__host__ __device__ __forceinline__ int slot(int e) { return e + (e >> 4); }

// 1. load, window and the first pass (p = 1): z[i + q M/R] -> Y[R i + s].
// info[f] = (clip offset, first sample) of frame f, or (-1, 0) past the end.
template <int R>
__device__ __forceinline__ void load_pass(const float* __restrict__ wav,
                                          const float2* __restrict__ win2,
                                          const int2* info, float2* dst, int m,
                                          int frames, int samples, int n_fft) {
  const int mr = m / R;
  int f = threadIdx.x / mr, i = threadIdx.x - f * mr;
  const int df = kThreads / mr, di = kThreads - df * mr;
  while (f < frames) {
    const int2 fi = info[f];
    float2 u[R];
    if (fi.x >= 0) {
      const float* clip = wav + fi.x;
      const int start = fi.y;
      // a frame inside its clip, 8-byte aligned: sample pairs as float2
      const bool paired = start >= 0 && start + n_fft <= samples &&
                          (reinterpret_cast<size_t>(clip + start) & 7) == 0;
      const float2* pairs = reinterpret_cast<const float2*>(clip + start);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int h = i + q * mr;  // z[h] = x[2h] + i x[2h + 1]
        const float2 w = __ldg(win2 + h);
        const float2 x = paired
            ? __ldg(pairs + h)
            : make_float2(reflected(clip, start + 2 * h, samples),
                          reflected(clip, start + 2 * h + 1, samples));
        u[q] = make_float2(x.x * w.x, x.y * w.y);
      }
    } else {
#pragma unroll
      for (int q = 0; q < R; ++q) u[q] = make_float2(0.0f, 0.0f);
    }
    dft<R>(u);
    const int o = f * m + R * i;
#pragma unroll
    for (int s = 0; s < R; ++s) dst[slot(o + s)] = u[s];
    i += di;
    f += df;
    if (i >= mr) {
      i -= mr;
      ++f;
    }
  }
}

// 2. a later pass: z[i + q M/R] * W_{Rp}^{qk} -> Y[R (i - k) + k + s p],
// i = j p + k; tw holds W_{Rp}^{qk} at (q - 1) p + k
template <int R>
__device__ __forceinline__ void fft_pass(const float2* src, float2* dst,
                                         const float2* __restrict__ tw, int m,
                                         int frames, int p) {
  const int mr = m / R;
  const int jn = mr / p;
  int f = threadIdx.x / mr;
  int j = (threadIdx.x - f * mr) / p;
  int k = threadIdx.x - f * mr - j * p;
  const int df = kThreads / mr;
  const int dj = (kThreads - df * mr) / p;
  const int dk = kThreads - df * mr - dj * p;
  while (f < frames) {
    const int row = f * m;
    const int i = j * p + k;
    float2 a[R];
    a[0] = src[slot(row + i)];
#pragma unroll
    for (int q = 1; q < R; ++q) {
      a[q] = cmul(src[slot(row + i + q * mr)], __ldg(tw + (q - 1) * p + k));
    }
    dft<R>(a);
    const int o = row + j * R * p + k;
#pragma unroll
    for (int s = 0; s < R; ++s) dst[slot(o + s * p)] = a[s];
    k += dk;
    j += dj;
    f += df;
    if (k >= p) {
      k -= p;
      ++j;
    }
    if (j >= jn) {
      j -= jn;
      ++f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
log_mel_mixed_kernel(const float* __restrict__ wav,
                     const float* __restrict__ window,
                     const int* __restrict__ plan,
                     const float2* __restrict__ tw,
                     const int* __restrict__ bands,
                     const float* __restrict__ weights,
                     float* __restrict__ out, int n_total, int frames_per_clip,
                     int samples, int hop, int n_fft, int n_mels, int n_passes,
                     int split_off, int frames) {
  extern __shared__ float2 smem[];
  const int m = n_fft / 2;
  float2* src = smem;
  float2* dst = smem + slot(frames * m);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * frames;

  // 0. per frame: (clip offset, first sample), in the buffer pass 1 skips
  int2* info = reinterpret_cast<int2*>(src);
  for (int f = tid; f < frames; f += kThreads) {
    const int n = n0 + f;
    if (n < n_total) {
      const int b = n / frames_per_clip;
      info[f] = make_int2(b * samples, (n - b * frames_per_clip) * hop - n_fft / 2);
    } else {
      info[f] = make_int2(-1, 0);
    }
  }
  __syncthreads();

  // 1. load and the first pass
  {
    const float2* win2 = reinterpret_cast<const float2*>(window);
    switch (__ldg(plan)) {
      case 2: load_pass<2>(wav, win2, info, dst, m, frames, samples, n_fft); break;
      case 3: load_pass<3>(wav, win2, info, dst, m, frames, samples, n_fft); break;
      case 4: load_pass<4>(wav, win2, info, dst, m, frames, samples, n_fft); break;
      case 5: load_pass<5>(wav, win2, info, dst, m, frames, samples, n_fft); break;
      default: load_pass<7>(wav, win2, info, dst, m, frames, samples, n_fft); break;
    }
  }
  // 2. the later passes: plan row (radix, p, twiddle offset)
  for (int pass = 1; pass < n_passes; ++pass) {
    float2* t = src; src = dst; dst = t;
    __syncthreads();
    const int r = __ldg(plan + 3 * pass);
    const int p = __ldg(plan + 3 * pass + 1);
    const float2* twp = tw + __ldg(plan + 3 * pass + 2);
    switch (r) {
      case 2: fft_pass<2>(src, dst, twp, m, frames, p); break;
      case 3: fft_pass<3>(src, dst, twp, m, frames, p); break;
      case 4: fft_pass<4>(src, dst, twp, m, frames, p); break;
      case 5: fft_pass<5>(src, dst, twp, m, frames, p); break;
      default: fft_pass<7>(src, dst, twp, m, frames, p); break;
    }
  }
  // 3. split to the F = M + 1 bins of the real FFT, and the magnitudes
  const int n_freq = m + 1;
  {
    float2* t = src; src = dst; dst = t;
    __syncthreads();
    float* mag = reinterpret_cast<float*>(dst);  // [frames][M + 1]
    int f = tid / n_freq, k = tid - f * n_freq;
    const int df = kThreads / n_freq, dk = kThreads - df * n_freq;
    while (f < frames) {
      const float2 w = __ldg(tw + split_off + k);
      const int ka = k == m ? 0 : k, kb = k == 0 ? 0 : m - k;
      const float2 a = src[slot(f * m + ka)];
      const float2 b = src[slot(f * m + kb)];
      mag[f * n_freq + k] = split_magnitude(a, b, w);
      k += dk;
      f += df;
      if (k >= n_freq) {
        k -= n_freq;
        ++f;
      }
    }
  }
  __syncthreads();
  // 4. banded mel, clamp, log: mels of one frame on neighbouring threads
  mel_log(reinterpret_cast<const float*>(dst), bands, weights, out, n0,
          min(frames, n_total - n0), n_freq, n_mels);
}

}  // namespace

extern "C" int mqgan_log_mel_mixed(const void* wav, const void* window,
                                   const void* plan, const void* twiddles,
                                   const void* bands, const void* weights,
                                   void* out, int n_clips, int frames_per_clip,
                                   int samples, int hop, int n_fft, int n_mels,
                                   int n_passes, int split_off, int frames,
                                   void* stream) {
  const int n_total = n_clips * frames_per_clip;
  const int points = frames * (n_fft / 2);
  if (frames < 1 || points > kMaxPoints) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) * 2 * slot(points);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_mixed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_total + frames - 1) / frames);
  log_mel_mixed_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const float*>(window),
      static_cast<const int*>(plan), static_cast<const float2*>(twiddles),
      static_cast<const int*>(bands), static_cast<const float*>(weights),
      static_cast<float*>(out), n_total, frames_per_clip, samples, hop, n_fft,
      n_mels, n_passes, split_off, frames);
  return static_cast<int>(cudaGetLastError());
}
