// Fused log-mel front end by Bluestein's chirp-z transform: waveform ->
// (frames, n_mels) log-mel. The route of ops/stft_kernels.py for every
// n_fft from 3 that neither FFT kernel takes (log_mel.cu: powers of two
// from 256 to 4096; log_mel_mixed.cu: even n_fft to 8192 whose n_fft / 2 has
// no prime factor above 7) and whose chirp-z length L is at most kMaxPoints
// = 6804: odd n_fft to 4535 (1201, say, framed as the JAX package frames
// them), even n_fft to 6804 whose n_fft / 2 has a prime factor above 7
// (2050 = 2 * 5^2 * 41, 1144 = 2^3 * 11 * 13, 88). log_mel_dft.cu takes
// what is left: n_fft 2, and n_fft past those limits.
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
// The chirp-z transform of an M-point DFT (M = n_fft / 2 at an even n_fft,
// the complex sequence z[n] = x[2n] + i x[2n+1] of the real-FFT split; M =
// n_fft at an odd one, the real samples): with the chirp c[n] = exp(-i pi
// (n^2 mod 2M) / M) (the host reduces n^2 in int64), nk = (n^2 + k^2 -
// (k - n)^2) / 2 gives
//   X[k] = c[k] sum_n (z[n] c[n]) conj c[k - n],
// a convolution, done as an L-point circular one through two mixed-radix
// FFTs, L >= M + K - 1 (K the outputs needed: M at an even n_fft, n_fft // 2
// + 1 at an odd one) with no prime factor above 7, chosen by the host
// (ops/stft_kernels.py bluestein_length). The filter's spectrum, conj c laid
// out circularly, FFT'd and divided by L, comes from the host in float64.
//
// What bounds the function: operations, barely, as for log_mel.cu. At n_fft
// 2050 on 64 clips of 261,632 samples (32,768 frames, 128 mels) it needs a
// real FFT per frame (2.5 n_fft log2 n_fft flops), the magnitudes, the
// filterbank's nonzeros and the log: ~2.1 GFLOP, 0.03 ms at the fp32 peak;
// it moves the 67 MB waveform and 17 MB of log-mel. The kernel does two
// L-point complex FFTs a frame instead (L = 2401 there: ~8.8 GFLOP), in
// fp64; the DFT product it takes over from does 4 N n_fft F = 276 GFLOP.
// What bounds the kernel is shared memory: its traffic, and the blocks an
// SM holds to hide its latency (one block a frame: halving the blocks an SM
// holds made it 1.9x slower on an H100), so the design keeps one buffer.
//
// Why fp64 from the premultiply to the post-multiply: in fp32 the two
// L-point FFTs and the product round more than one FFT or the plain DFT
// does, and a mel over one or two quiet bins (a few 1e-4 of its frame's
// peak mel) moves by that rounding over its own small value. On two clips of
// three sines and noise the same kernel with an fp32 stage misses the gate
// rows 4 and 4b meet, max(1e-4, the fp32 plain version's own error) from the
// float64 plain version: 5.0e-4 at n_fft 1144 against a limit of 2.4e-4;
// the fp64 stage gives 9.3e-6 (tests/test_torch_log_mel_bluestein.py
// replays both). The
// real-FFT split, the magnitudes, the mel and the log stay fp32. TF32 or
// bf16 tensor cores are further off still. The cost: 16-byte points, and
// the H100's fp64 rate is half its fp32 rate.
//
// Design: a block of 256 threads owns `frames` consecutive frames (they may
// span two clips), as many whole frames of L points as fit in 2048 and at
// least one (the host's bluestein_frames; one at n_fft 2050 and 1201), in
// ONE double2 buffer (38 KB at L = 2401, 225 KB at most): every pass is an
// in-place Cooley-Tukey pass, each butterfly writing back the points it
// read, so no second buffer is needed and an SM holds twice the blocks a
// Stockham pair of buffers allows. The forward FFT decimates in frequency
// (natural order in, mixed-radix digit-reversed order out), the inverse in
// time (digit-reversed in, natural out): the filter's spectrum is stored in
// the digit-reversed order by the host, so no permutation is ever made. Plan
// row s (the host's, radices r_1 .. r_P): radix r over sub-transforms of S =
// r N points, butterflies on points base + n' + q N, base a multiple of S,
// n' < N, twiddled by W_S^(n' q) (after the butterfly forward, before it
// inverse); the table holds W_S^n' once per pass and a thread raises it to
// the powers q in fp64. The block runs:
//  0. each frame's clip offset and first sample, once per frame;
//  1. load, premultiply and forward pass 1: a[n] = z[n] c[n] read straight
//     from the unpadded waveform (reflect padding is index arithmetic) and
//     multiplied by the host's premul table, the window and the chirp folded
//     together in float64 (even n_fft: a[n] = x[2n] P0[n] + x[2n+1] P1[n]);
//     the L - M zero inputs are never read;
//  2. forward passes 2 .. P - 1;
//  3. pass P (N = 1: r_P neighbouring points) forward, the filter product
//     and the conjugate, and pass P of the inverse, in one: the inverse FFT
//     is the forward FFT of the conjugate (one plan, one twiddle table);
//  4. inverse passes P - 1 .. 1: u = conj(L y), y the convolution, in
//     natural order;
//  5. the post-multiply and the magnitudes: even n_fft, Z[k] = c[k] conj
//     u[k] for k and M - k, cast to fp32, the real-FFT split and |X[k]|;
//     odd n_fft, |X[k]| = |u[k]| (|c[k]| = 1: no post-multiply at all);
//     written as fp32 over the frame's points past n_fft / 2 + 1, which no
//     one reads again;
//  6. the banded mel, the clamp and the exact logf (fft_radix.cuh mel_log).
// One launch per call on the caller's stream; the kernel allocates nothing.
// Exact sqrtf and logf: the library is built without --use_fast_math.

#include <cuda_runtime.h>

#include "fft_radix.cuh"

namespace {

constexpr int kMaxPoints = 14406;  // L points per block, at most (225 KB)

// a[q] *= w^q, q = 1 .. R - 1, the powers taken in fp64
template <int R>
__device__ __forceinline__ void twiddle(double2 (&a)[R], double2 w) {
  double2 wq = w;
#pragma unroll
  for (int q = 1; q < R; ++q) {
    if (q > 1) wq = cmul(wq, w);
    a[q] = cmul(a[q], wq);
  }
}

// 1. load, premultiply and forward pass 1 (S = L, N = L / R): a[n' + q N],
// a[h] = 0 for h >= m, then the butterfly and W_L^(n' q); with one pass only
// (`butterfly` false) the loaded points are stored as they are, for pass 3.
// info[f] = (clip offset, first sample) of frame f, or (-1, 0) past the end.
// premul: even n_fft, pairs (P0[h], P1[h]); odd, P[h] = w[h] c[h].
template <int R, bool kOdd>
__device__ __forceinline__ void load_pass(const float* __restrict__ wav,
                                          const double2* __restrict__ premul,
                                          const double2* __restrict__ tw,
                                          const int2* info, double2* buf, int length,
                                          int m, int frames, int samples, int n_fft,
                                          bool butterfly) {
  const int lr = length / R;
  int f = threadIdx.x / lr, i = threadIdx.x - f * lr;
  const int df = kThreads / lr, di = kThreads - df * lr;
  while (f < frames) {
    const int2 fi = info[f];
    double2 u[R];
    const float* clip = wav + max(fi.x, 0);
    const int start = fi.y;
    // a frame inside its clip, 8-byte aligned: sample pairs as float2
    const bool paired = !kOdd && start >= 0 && start + n_fft <= samples &&
                        (reinterpret_cast<size_t>(clip + start) & 7) == 0;
    const float2* pairs = reinterpret_cast<const float2*>(clip + start);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int h = i + q * lr;
      u[q] = double2{0.0, 0.0};
      if (fi.x < 0 || h >= m) continue;
      if constexpr (kOdd) {
        const double x = reflected(clip, start + h, samples);
        const double2 p = __ldg(premul + h);
        u[q] = double2{x * p.x, x * p.y};
      } else {
        const float2 x = paired
            ? __ldg(pairs + h)
            : make_float2(reflected(clip, start + 2 * h, samples),
                          reflected(clip, start + 2 * h + 1, samples));
        const double2 p0 = __ldg(premul + 2 * h), p1 = __ldg(premul + 2 * h + 1);
        const double x0 = x.x, x1 = x.y;
        u[q] = double2{fma(x1, p1.x, x0 * p0.x), fma(x1, p1.y, x0 * p0.y)};
      }
    }
    if (butterfly) {
      dft<R>(u);
      twiddle<R>(u, __ldg(tw + i));
    }
    double2* row = buf + f * length + i;
#pragma unroll
    for (int q = 0; q < R; ++q) row[q * lr] = u[q];
    i += di;
    f += df;
    if (i >= lr) {
      i -= lr;
      ++f;
    }
  }
}

// 2, 4. an in-place pass over sub-transforms of S = R N points: points
// base + n' + q N, twiddled by W_S^(n' q) = tw[n']^q after the butterfly
// (kForward, decimation in frequency) or before it (decimation in time)
template <int R, bool kForward>
__device__ __forceinline__ void pass(double2* buf, const double2* __restrict__ tw,
                                     int length, int frames, int n) {
  const int lr = length / R;
  const int jn = lr / n;  // sub-transforms a frame
  int f = threadIdx.x / lr;
  int j = (threadIdx.x - f * lr) / n;
  int k = threadIdx.x - f * lr - j * n;
  const int df = kThreads / lr;
  const int dj = (kThreads - df * lr) / n;
  const int dk = kThreads - df * lr - dj * n;
  while (f < frames) {
    double2* at = buf + f * length + j * R * n + k;
    double2 a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = at[q * n];
    const double2 w = __ldg(tw + k);
    if (!kForward) twiddle<R>(a, w);
    dft<R>(a);
    if (kForward) twiddle<R>(a, w);
#pragma unroll
    for (int q = 0; q < R; ++q) at[q * n] = a[q];
    k += dk;
    j += dj;
    f += df;
    if (k >= n) {
      k -= n;
      ++j;
    }
    if (j >= jn) {
      j -= jn;
      ++f;
    }
  }
}

// 3. pass P forward, the filter product and conjugate, pass P inverse (N =
// 1: R neighbouring points, no twiddle): conj(DFT_R(a) S) through DFT_R
template <int R>
__device__ __forceinline__ void middle_pass(double2* buf,
                                            const double2* __restrict__ spectrum,
                                            int length, int frames) {
  const int lr = length / R;
  int f = threadIdx.x / lr, i = threadIdx.x - f * lr;
  const int df = kThreads / lr, di = kThreads - df * lr;
  while (f < frames) {
    double2* at = buf + f * length + R * i;
    const double2* s = spectrum + R * i;
    double2 a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = at[q];
    dft<R>(a);
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = cconj(cmul(a[q], __ldg(s + q)));
    dft<R>(a);
#pragma unroll
    for (int q = 0; q < R; ++q) at[q] = a[q];
    i += di;
    f += df;
    if (i >= lr) {
      i -= lr;
      ++f;
    }
  }
}

template <bool kOdd>
__device__ __forceinline__ void load_first(int r, const float* wav, const double2* premul,
                                           const double2* tw, const int2* info,
                                           double2* buf, int length, int m, int frames,
                                           int samples, int n_fft, bool butterfly) {
  switch (r) {
    case 2: load_pass<2, kOdd>(wav, premul, tw, info, buf, length, m, frames, samples, n_fft, butterfly); break;
    case 3: load_pass<3, kOdd>(wav, premul, tw, info, buf, length, m, frames, samples, n_fft, butterfly); break;
    case 4: load_pass<4, kOdd>(wav, premul, tw, info, buf, length, m, frames, samples, n_fft, butterfly); break;
    case 5: load_pass<5, kOdd>(wav, premul, tw, info, buf, length, m, frames, samples, n_fft, butterfly); break;
    default: load_pass<7, kOdd>(wav, premul, tw, info, buf, length, m, frames, samples, n_fft, butterfly); break;
  }
}

template <bool kForward>
__device__ __forceinline__ void any_pass(int r, double2* buf, const double2* tw,
                                         int length, int frames, int n) {
  switch (r) {
    case 2: pass<2, kForward>(buf, tw, length, frames, n); break;
    case 3: pass<3, kForward>(buf, tw, length, frames, n); break;
    case 4: pass<4, kForward>(buf, tw, length, frames, n); break;
    case 5: pass<5, kForward>(buf, tw, length, frames, n); break;
    default: pass<7, kForward>(buf, tw, length, frames, n); break;
  }
}

// at most 64 registers a thread, so that an SM holds 4 blocks (80 unbounded:
// 3 blocks, 6-10% slower at n_fft 2050 and 1201 on an H100)
__global__ void __launch_bounds__(kThreads, 4)
log_mel_bluestein_kernel(const float* __restrict__ wav,
                         const double2* __restrict__ premul,
                         const double2* __restrict__ chirp,
                         const int* __restrict__ plan,
                         const double2* __restrict__ tw,
                         const double2* __restrict__ spectrum,
                         const float2* __restrict__ split,
                         const int* __restrict__ bands,
                         const float* __restrict__ weights,
                         float* __restrict__ out, int n_total, int frames_per_clip,
                         int samples, int hop, int n_fft, int n_mels, int length,
                         int n_passes, int frames) {
  extern __shared__ double2 buf[];
  const bool odd = n_fft & 1;
  const int m = odd ? n_fft : n_fft / 2;
  const int n_freq = n_fft / 2 + 1;  // K as well: the outputs a frame needs
  int2* info = reinterpret_cast<int2*>(buf + frames * length);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * frames;

  // 0. per frame: (clip offset, first sample)
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

  // 1-2. the forward FFT of the premultiplied frame, passes 1 .. P - 1
  const int r0 = __ldg(plan);
  if (odd) {
    load_first<true>(r0, wav, premul, tw, info, buf, length, m, frames, samples, n_fft,
                     n_passes > 1);
  } else {
    load_first<false>(r0, wav, premul, tw, info, buf, length, m, frames, samples, n_fft,
                      n_passes > 1);
  }
  for (int s = 1; s < n_passes - 1; ++s) {
    __syncthreads();
    any_pass<true>(__ldg(plan + 3 * s), buf, tw + __ldg(plan + 3 * s + 2), length,
                   frames, __ldg(plan + 3 * s + 1));
  }
  // 3. pass P both ways around the filter product
  __syncthreads();
  switch (__ldg(plan + 3 * (n_passes - 1))) {
    case 2: middle_pass<2>(buf, spectrum, length, frames); break;
    case 3: middle_pass<3>(buf, spectrum, length, frames); break;
    case 4: middle_pass<4>(buf, spectrum, length, frames); break;
    case 5: middle_pass<5>(buf, spectrum, length, frames); break;
    default: middle_pass<7>(buf, spectrum, length, frames); break;
  }
  // 4. the inverse FFT, passes P - 1 .. 1
  for (int s = n_passes - 2; s >= 0; --s) {
    __syncthreads();
    any_pass<false>(__ldg(plan + 3 * s), buf, tw + __ldg(plan + 3 * s + 2), length,
                    frames, __ldg(plan + 3 * s + 1));
  }
  // 5. the post-multiply, the real-FFT split (even n_fft), the magnitudes,
  // frame f's written as floats from its point n_fft / 2 + 1 on, which no one
  // reads again
  __syncthreads();
  {
    int f = tid / n_freq, k = tid - f * n_freq;
    const int df = kThreads / n_freq, dk = kThreads - df * n_freq;
    while (f < frames) {
      const double2* u = buf + f * length;
      float* mag = reinterpret_cast<float*>(buf + f * length + n_freq);
      if (odd) {
        const float2 x = make_float2(static_cast<float>(u[k].x), static_cast<float>(u[k].y));
        mag[k] = sqrtf(fmaf(x.x, x.x, x.y * x.y));
      } else {
        const int ka = k == m ? 0 : k, kb = k == 0 ? 0 : m - k;
        const double2 za = cmul(__ldg(chirp + ka), cconj(u[ka]));
        const double2 zb = cmul(__ldg(chirp + kb), cconj(u[kb]));
        mag[k] = split_magnitude(
            make_float2(static_cast<float>(za.x), static_cast<float>(za.y)),
            make_float2(static_cast<float>(zb.x), static_cast<float>(zb.y)),
            __ldg(split + k));
      }
      k += dk;
      f += df;
      if (k >= n_freq) {
        k -= n_freq;
        ++f;
      }
    }
  }
  __syncthreads();
  // 6. banded mel, clamp, log
  mel_log(reinterpret_cast<const float*>(buf + n_freq), bands, weights, out, n0,
          min(frames, n_total - n0), 4 * length, n_mels);
}

}  // namespace

extern "C" int mqgan_log_mel_bluestein(const void* wav, const void* premul,
                                       const void* chirp, const void* plan,
                                       const void* twiddles, const void* spectrum,
                                       const void* split, const void* bands,
                                       const void* weights, void* out, int n_clips,
                                       int frames_per_clip, int samples, int hop,
                                       int n_fft, int n_mels, int length,
                                       int n_passes, int frames, void* stream) {
  const int n_total = n_clips * frames_per_clip;
  const int points = frames * length;
  if (frames < 1 || points > kMaxPoints || n_passes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(double2) * points + sizeof(int2) * frames;
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_bluestein_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_total + frames - 1) / frames);
  log_mel_bluestein_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<const double2*>(premul),
      static_cast<const double2*>(chirp), static_cast<const int*>(plan),
      static_cast<const double2*>(twiddles), static_cast<const double2*>(spectrum),
      static_cast<const float2*>(split), static_cast<const int*>(bands),
      static_cast<const float*>(weights), static_cast<float*>(out), n_total,
      frames_per_clip, samples, hop, n_fft, n_mels, length, n_passes, frames);
  return static_cast<int>(cudaGetLastError());
}
