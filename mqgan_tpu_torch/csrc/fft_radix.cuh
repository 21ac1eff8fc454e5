// The pieces of a mixed-radix FFT in shared memory that the log-mel kernels
// log_mel_mixed.cu (fp32 Stockham passes) and log_mel_bluestein.cu (fp64
// in-place passes) share: the radix 2, 3, 4, 5 and 7 butterflies for C =
// float2 or double2, reflect padding, the real-FFT split of one bin, and the
// banded mel with its clamp and log. Odd R uses constant coefficients: pairs
// a_j +- a_{R-j}, so (R - 1)^2 / 2 real products a component.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block of both kernels
constexpr float kLogClip = 1e-5f;

// (cos, sin) of 2 pi m / r, m < r, rounded from the same decimals to each
// type
__constant__ float2 kRoot3[3] = {{1.0f, 0.0f},
                                 {-0.5f, 0.86602540378443865f},
                                 {-0.5f, -0.86602540378443865f}};
__constant__ float2 kRoot5[5] = {{1.0f, 0.0f},
                                 {0.30901699437494742f, 0.95105651629515357f},
                                 {-0.80901699437494742f, 0.58778525229247314f},
                                 {-0.80901699437494742f, -0.58778525229247314f},
                                 {0.30901699437494742f, -0.95105651629515357f}};
__constant__ float2 kRoot7[7] = {{1.0f, 0.0f},
                                 {0.62348980185873353f, 0.78183148246802981f},
                                 {-0.22252093395631440f, 0.97492791218182361f},
                                 {-0.90096886790241913f, 0.43388373911755812f},
                                 {-0.90096886790241913f, -0.43388373911755812f},
                                 {-0.22252093395631440f, -0.97492791218182361f},
                                 {0.62348980185873353f, -0.78183148246802981f}};
__constant__ double2 kRoot3d[3] = {{1.0, 0.0},
                                   {-0.5, 0.86602540378443865},
                                   {-0.5, -0.86602540378443865}};
__constant__ double2 kRoot5d[5] = {{1.0, 0.0},
                                   {0.30901699437494742, 0.95105651629515357},
                                   {-0.80901699437494742, 0.58778525229247314},
                                   {-0.80901699437494742, -0.58778525229247314},
                                   {0.30901699437494742, -0.95105651629515357}};
__constant__ double2 kRoot7d[7] = {{1.0, 0.0},
                                   {0.62348980185873353, 0.78183148246802981},
                                   {-0.22252093395631440, 0.97492791218182361},
                                   {-0.90096886790241913, 0.43388373911755812},
                                   {-0.90096886790241913, -0.43388373911755812},
                                   {-0.22252093395631440, -0.97492791218182361},
                                   {0.62348980185873353, -0.78183148246802981}};

template <int R, typename C>
__device__ __forceinline__ C root(int m) {
  if constexpr (sizeof(C) == sizeof(float2)) {
    if constexpr (R == 3) return kRoot3[m];
    else if constexpr (R == 5) return kRoot5[m];
    else return kRoot7[m];
  } else {
    if constexpr (R == 3) return kRoot3d[m];
    else if constexpr (R == 5) return kRoot5d[m];
    else return kRoot7d[m];
  }
}

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) { return C{a.x + b.x, a.y + b.y}; }
template <typename C>
__device__ __forceinline__ C csub(C a, C b) { return C{a.x - b.x, a.y - b.y}; }
template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  return C{mad(a.x, b.x, -a.y * b.y), mad(a.x, b.y, a.y * b.x)};
}
template <typename C>
__device__ __forceinline__ C cconj(C a) { return C{a.x, -a.y}; }

// in-place R-point DFT: a_s <- sum_q a_q exp(-2 pi i q s / R)
template <int R, typename C>
__device__ __forceinline__ void dft(C (&a)[R]) {
  if constexpr (R == 2) {
    const C a0 = a[0];
    a[0] = cadd(a0, a[1]);
    a[1] = csub(a0, a[1]);
  } else if constexpr (R == 4) {
    const C v0 = cadd(a[0], a[2]), v1 = csub(a[0], a[2]);
    const C v2 = cadd(a[1], a[3]), d = csub(a[1], a[3]);
    const C v3 = C{d.y, -d.x};  // -i (a1 - a3)
    a[0] = cadd(v0, v2);
    a[1] = cadd(v1, v3);
    a[2] = csub(v0, v2);
    a[3] = csub(v1, v3);
  } else {  // odd R: pairs t_j = a_j + a_{R-j}, d_j = a_j - a_{R-j}
    constexpr int H = R / 2;
    C t[H + 1], d[H + 1];
    C sum = a[0];
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      t[j] = cadd(a[j], a[R - j]);
      d[j] = csub(a[j], a[R - j]);
      sum = cadd(sum, t[j]);
    }
    C out[R];
    out[0] = sum;
#pragma unroll
    for (int s = 1; s <= H; ++s) {
      C re = a[0], im = C{0, 0};
#pragma unroll
      for (int j = 1; j <= H; ++j) {
        const C w = root<R, C>((j * s) % R);
        re = C{mad(w.x, t[j].x, re.x), mad(w.x, t[j].y, re.y)};
        im = C{mad(w.y, d[j].x, im.x), mad(w.y, d[j].y, im.y)};
      }
      out[s] = C{re.x + im.y, re.y - im.x};      // re - i im
      out[R - s] = C{re.x - im.y, re.y + im.x};  // re + i im
    }
#pragma unroll
    for (int q = 0; q < R; ++q) a[q] = out[q];
  }
}

// sample pos of a clip of `samples`, reflected at both ends (pos is within
// one reflection: the wrappers ask for samples > n_fft / 2)
__device__ __forceinline__ float reflected(const float* __restrict__ clip,
                                           int pos, int samples) {
  pos = pos < 0 ? -pos : pos;
  pos = pos >= samples ? 2 * (samples - 1) - pos : pos;
  return __ldg(clip + pos);
}

// the banded mel, the clamp and the exact logf of frames [0, last) of the
// block from mag[f * stride + k]: a thread per (frame, mel), mels of one
// frame on neighbouring threads (the stores coalesce), the band [lo, hi) of
// nonzero weights summed in a fixed order (no atomics, deterministic)
__device__ __forceinline__ void mel_log(const float* mag, const int* __restrict__ bands,
                                        const float* __restrict__ weights,
                                        float* __restrict__ out, int n0, int last,
                                        int stride, int n_mels) {
  int f = threadIdx.x / n_mels, mel = threadIdx.x - f * n_mels;
  const int df = kThreads / n_mels, dm = kThreads - df * n_mels;
  while (f < last) {
    const int lo = __ldg(bands + 3 * mel);
    const int hi = __ldg(bands + 3 * mel + 1);
    const float* w = weights + __ldg(bands + 3 * mel + 2);
    const float* row = mag + f * stride;
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = fmaf(row[k], __ldg(w + (k - lo)), acc);
    out[static_cast<size_t>(n0 + f) * n_mels + mel] = logf(fmaxf(acc, kLogClip));
    mel += dm;
    f += df;
    if (mel >= n_mels) {
      mel -= n_mels;
      ++f;
    }
  }
}

// the real-FFT split of one bin: X[k] = (Z[k] + conj Z[M-k]) / 2
// + W^k (Z[k] - conj Z[M-k]) / 2i from a = Z[k mod M], b = Z[(M - k) mod M]
// and w = W_n_fft^k; returns |X[k]|
__device__ __forceinline__ float split_magnitude(float2 a, float2 b, float2 w) {
  const float2 even = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
  const float2 odd = make_float2(0.5f * (a.y + b.y), 0.5f * (b.x - a.x));
  const float2 x = cadd(even, cmul(w, odd));
  return sqrtf(fmaf(x.x, x.x, x.y * x.y));
}

}  // namespace
