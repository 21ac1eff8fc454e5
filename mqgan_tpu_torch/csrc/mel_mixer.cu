// MelMixer2D at inference, both modes, fp32 inside.
//
// Replaces: mqgan_tpu/ops/mixer_kernels.py:_fused_mixer (the Pallas TPU
// kernel `_kernel` behind fused_mel_mixer), and the XLA elementwise pass of
// mqgan_tpu/ops/mixer_poly.py:poly_mixer_apply (the Chebyshev serving mode).
//
// Both modes start from the same front half:
//
//   s   = (k x k conv over the (T, C) plane, zero outside it) + bias
//   s   = s * valid                       (valid: t < length of the row)
//
// Exact mode (mel_mixer_kernel):
//
//   out = (A*s + B + 0.5 * sum_p w2_p * z_p * tanh(z_p)) * valid + b_out,
//         z_p = w1_p * s + b1_p
//
// Chebyshev mode (mqgan_mel_mixer_poly: five launches, no host sync):
//   1. poly_minmax_kernel: s with the conv's taps and bias rounded to the
//      storage type and s rounded to it, as the plain conv in that type
//      computes it; the batch-wide (min, max) of the masked plane, padded
//      zeros included, as one pair per block, and s itself;
//   2. poly_stats_kernel: mid and half from the pairs, as poly_mixer_apply
//      computes them;
//   3. poly_fit_nodes_kernel: g at the grid's Chebyshev nodes (exact
//      tanhf), one warp per node;
//   4. poly_fit_coef_kernel: the degree + 1 coefficients by the cosine
//      projection, one block each;
//   5. poly_eval_kernel: t = (s - mid) / half from pass 1's s, the Clenshaw
//      recurrence (two fp32 operations per degree), b_out exactly on padded
//      rows.
//
// What bounds the exact mode on the card: the SFU and FP32 issue rates, not
// bytes (one read of x, one write of out). Every output element evaluates
// z * tanh(z) P times (8.59 G evaluations per call at B=64, T=512,
// C=P=512). An SM issues one warp instruction per clock in each of its four
// partitions (128 thread instructions a clock, which the FP32 pipe can
// take whole) and its SFU returns 16 results a clock. libdevice's tanhf
// costs two MUFU (ex2, rcp) and about fifteen FP32 instructions with its
// small-argument branch; this kernel's evaluation is, with zs = 2 log2(e) z
// (w1, b1 prescaled, w2 divided by the same factor):
//
//   u  = ex2.approx.ftz(-|zs|)        = e^(-2|z|)           MUFU
//   h  = 0.5 u + 0.5                  = (1 + u) / 2           FFMA
//   r  = 1 / h                        = 2 / (1 + u)           MUFU rcp, or
//                                      linear guess + one quadratic and one
//                                      cubic Newton step     6 FFMA
//   acc += w2' |zs| (r - 1)           (tanh|z| = r - 1)       FADD FMUL FFMA
//
// plus the FFMA of zs: 2 MUFU + 5 FP32 with the SFU's reciprocal, 1 MUFU +
// 11 FP32 with the FMA pipe's. The SFU path alone would take 2/16 clock
// per evaluation per SM, the FMA path alone 12/128; a thread sends
// kSfuRows of its kRows rows through the SFU's reciprocal and the rest
// through Newton, so that neither the SFU nor the issue slots alone set the
// pace: with kSfuRows = 3 the loop issues, per evaluation, 1 MUFU.EX2,
// 0.375 MUFU.RCP, 8.75 FP32 and 0.56 other instructions (chip_smoke.py
// phase 2 prints these counts from the SASS; PERF.md gives the split's
// measurement). Weights are one broadcast 16-byte shared load (w1', b1',
// w2') per p for all kRows rows of a thread. A warp whose frames all lie
// past its clip's length skips the loop.
//
// Error budget (no --use_fast_math: tanh.approx.f32 is 2^-11 and an encode
// side error flips FSQ codes): ex2.approx is within 2^-22 relative, so
// |d r| <= 2 |d u| <= 2^-21; rcp.approx and the Newton steps (|e| <= 17^-6
// after them) are within about 2^-23 relative of 2/(1 + u); so tanh|z| = r
// - 1 is within about 2^-20.4 absolute, and z tanh z within |z| 2^-20.4,
// with no cancellation beyond that absolute bound. The prescaling adds one
// rounding of w1 and b1 (2^-24 relative each).
//
// P past kPSlice = 2048 (kStream): (w1', b1', w2') do not fit the block's
// dynamic shared memory (16 B a p), so they stream through it in slices of
// 2048 p, a barrier between slices; each output's sum over p keeps its
// order, and P <= 2048 keeps the one-slice build.
//
// What bounds the Chebyshev mode: FP32 issue (2 N operations per element,
// N = 160 in pass 5) over a read of x and a write of s in pass 1, a read of
// s and a write of out in pass 5. Pass 5 holds the N + 1 coefficients in
// shared memory and walks kRows independent recurrences per thread; reading
// s back was faster than recomputing the conv there. Both modes' convs take
// their taps as a template argument: a sliding window over registers, each
// staged value read once.

#include "common.cuh"

namespace {

constexpr int kTileC = 32;
constexpr int kRowGroups = 8;  // block (32, 8)
constexpr int kRows = 8;       // consecutive frames per thread: 64 a block
constexpr int kTileT = kRowGroups * kRows;
constexpr int kThreads = kTileC * kRowGroups;
constexpr int kMaxPad = 3;     // taps <= 7
// rows of a thread's kRows through the SFU's reciprocal, the rest through
// Newton on the FMA pipe: 3 and 4 were the fastest splits on an H100
// (PERF.md)
constexpr int kSfuRows = 3;
constexpr int kMaxCoef = 1024;
constexpr int kPSlice = 2048;  // p of (w1', b1', w2') in shared memory at once
constexpr float kTwoLog2e = 2.8853900817779268f;  // 2 / ln 2

struct Plane {
  float xs[kTileT + 2 * kMaxPad][kTileC + 2 * kMaxPad];
  float ks[(2 * kMaxPad + 1) * (2 * kMaxPad + 1)];
};

// Stage the block's (kTileT, kTileC) tile with its halo (zeros outside the
// plane) and the k x k taps in shared memory; kRoundTaps rounds the taps to
// T (the Chebyshev mode's conv runs in the storage type).
template <typename T, bool kRoundTaps>
__device__ __forceinline__ void load_plane(Plane& pl, const T* xb,
                                           const float* dwk, int t0, int c0,
                                           int t_len, int c_len, int k) {
  const int pad = k / 2;
  const int tile_h = kTileT + 2 * pad, tile_w = kTileC + 2 * pad;
  for (int r = threadIdx.y; r < tile_h; r += kRowGroups) {
    const int t = t0 + r - pad;
    const bool t_in = t >= 0 && t < t_len;
    for (int cc = threadIdx.x; cc < tile_w; cc += kTileC) {
      const int c = c0 + cc - pad;
      float v = 0.0f;
      if (t_in && c >= 0 && c < c_len) {
        v = mqgan::to_f32<T>(xb[static_cast<size_t>(t) * c_len + c]);
      }
      pl.xs[r][cc] = v;
    }
  }
  const int tid = threadIdx.y * kTileC + threadIdx.x;
  for (int i = tid; i < k * k; i += kThreads) {
    pl.ks[i] = kRoundTaps ? mqgan::round_to<T>(dwk[i]) : dwk[i];
  }
}

// The conv (no bias) at this thread's kRows consecutive frames (local rows
// kRows * threadIdx.y + r) and channel threadIdx.x, summed over (dy, dx) in
// row-major order: the K x K taps held in registers, each staged value read
// once for all the rows it reaches.
template <int K>
__device__ __forceinline__ void conv_rows(const Plane& pl, float (&s)[kRows]) {
  const int row0 = kRows * threadIdx.y;
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
  float kr[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) kr[i] = pl.ks[i];
#pragma unroll
  for (int j = 0; j < kRows + K - 1; ++j) {
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float v = pl.xs[row0 + j][threadIdx.x + dx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int dy = j - r;
        if (dy >= 0 && dy < K) s[r] = fmaf(kr[dy * K + dx], v, s[r]);
      }
    }
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1 / h for h in [0.5, 1] on the FMA pipe: the minimax linear guess
// (relative error <= 1/17), one quadratic Newton step (<= 17^-2), one
// cubic step r (1 + e + e^2) (<= 17^-6, about 2^-24.5).
__device__ __forceinline__ float rcp_newton(float h) {
  float r = fmaf(-32.0f / 17.0f, h, 48.0f / 17.0f);
  float e = fmaf(-h, r, 1.0f);
  r = fmaf(r, e, r);
  e = fmaf(-h, r, 1.0f);
  return fmaf(r, fmaf(e, e, e), r);
}

// |zs| * tanh|zs / (2 log2 e)| = 2 log2(e) * z tanh z, for zs = 2 log2(e) z.
template <bool kSfuRcp>
__device__ __forceinline__ float zs_tanh(float zs) {
  const float a = fabsf(zs);
  const float u = ex2_approx(-a);
  const float h = fmaf(0.5f, u, 0.5f);
  const float r = kSfuRcp ? rcp_approx(h) : rcp_newton(h);
  return a * (r - 1.0f);
}

// (w1, b1, w2) of p in [p0, p0 + n) into wsm[0, n), prescaled
__device__ __forceinline__ void stage_weights(float4* wsm, const float* __restrict__ w1,
                                              const float* __restrict__ b1,
                                              const float* __restrict__ w2, int p0,
                                              int n, int tid) {
  for (int i = tid; i < n; i += kThreads) {
    wsm[i] = make_float4(kTwoLog2e * w1[p0 + i], kTwoLog2e * b1[p0 + i],
                         w2[p0 + i] / kTwoLog2e, 0.0f);
  }
}

template <typename T, int K, bool kStream>
__global__ void __launch_bounds__(kThreads)
mel_mixer_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                 const float* __restrict__ dwk,
                 const float* __restrict__ consts,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, T* __restrict__ out, int t_len,
                 int c_len, int p_len) {
  __shared__ Plane pl;
  extern __shared__ float4 wsm[];  // (2 log2e w1, 2 log2e b1, w2 / 2 log2e)

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileT, c0 = blockIdx.x * kTileC;
  const int tid = threadIdx.y * kTileC + threadIdx.x;
  load_plane<T, false>(pl, x + static_cast<size_t>(b) * t_len * c_len, dwk,
                       t0, c0, t_len, c_len, K);
  // the first slice of p (kStream), or all of them
  const int p_first = kStream ? min(p_len, kPSlice) : p_len;
  stage_weights(wsm, w1, b1, w2, 0, p_first, tid);
  __syncthreads();

  const int len = lengths[b];
  const int f0 = t0 + kRows * threadIdx.y;  // this thread's first frame
  const float dw_bias = consts[0], out_bias = consts[1];
  const float a_lin = consts[2], b_lin = consts[3];

  float s[kRows], valid[kRows], acc[kRows];
  conv_rows<K>(pl, s);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    valid[r] = (f0 + r < len) ? 1.0f : 0.0f;
    s[r] = (s[r] + dw_bias) * valid[r];
    acc[r] = 0.0f;
  }

  for (int p0 = 0, pn = p_first;;) {
    if (f0 < len) {  // else all of the warp's frames are padding
#pragma unroll 2
      for (int p = 0; p < pn; ++p) {
        const float4 w = wsm[p];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float zs = fmaf(w.x, s[r], w.y);
          const float q = (r < kSfuRows) ? zs_tanh<true>(zs) : zs_tanh<false>(zs);
          acc[r] = fmaf(w.z, q, acc[r]);
        }
      }
    }
    if (!kStream) break;
    p0 += kPSlice;
    if (p0 >= p_len) break;
    pn = min(p_len - p0, kPSlice);
    __syncthreads();  // every thread is done with the previous slice
    stage_weights(wsm, w1, b1, w2, p0, pn, tid);
    __syncthreads();
  }

  const int c = c0 + threadIdx.x;
  if (c >= c_len) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (f0 + r < t_len) {
      const float o = (a_lin * s[r] + b_lin + 0.5f * acc[r]) * valid[r]
                      + out_bias;
      out[(static_cast<size_t>(b) * t_len + f0 + r) * c_len + c] =
          mqgan::from_f32<T>(o);
    }
  }
}

// The Chebyshev mode's s at this thread's kRows frames: the conv in T (the
// taps already rounded to T by load_plane, the bias consts[0] rounded
// here), rounded to T, zero on padded rows.
template <typename T, int K>
__device__ __forceinline__ void poly_front(const Plane& pl, float dw_bias,
                                           int f0, int len,
                                           float (&s)[kRows]) {
  conv_rows<K>(pl, s);
  const float bias = mqgan::round_to<T>(dw_bias);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float v = mqgan::round_to<T>(s[r] + bias);
    s[r] = (f0 + r < len) ? v : 0.0f;
  }
}

// Pass 1: the masked plane s, and its (min, max) per block over its
// in-plane elements.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
poly_minmax_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                   const float* __restrict__ dwk,
                   const float* __restrict__ consts, T* __restrict__ z,
                   float2* __restrict__ partials, int t_len, int c_len) {
  __shared__ Plane pl;
  __shared__ float2 warp_mm[kThreads / 32];

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileT, c0 = blockIdx.x * kTileC;
  load_plane<T, true>(pl, x + static_cast<size_t>(b) * t_len * c_len, dwk, t0,
                      c0, t_len, c_len, K);
  __syncthreads();

  const int f0 = t0 + kRows * threadIdx.y;
  float s[kRows];
  poly_front<T, K>(pl, consts[0], f0, lengths[b], s);
  const int c = c0 + threadIdx.x;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (f0 + r < t_len && c < c_len) {
      lo = fminf(lo, s[r]);
      hi = fmaxf(hi, s[r]);
      z[(static_cast<size_t>(b) * t_len + f0 + r) * c_len + c] =
          mqgan::from_f32<T>(s[r]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x == 0) warp_mm[threadIdx.y] = make_float2(lo, hi);
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x == 0) {
    float2 mm = warp_mm[0];
    for (int i = 1; i < kThreads / 32; ++i) {
      mm.x = fminf(mm.x, warp_mm[i].x);
      mm.y = fmaxf(mm.y, warp_mm[i].y);
    }
    partials[(blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        mm;
  }
}

// The sum of v over the block (1-D, kThreads), valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if (threadIdx.x % 32 == 0) warp_part[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) total += warp_part[i];
  }
  return total;
}

// Fit, first half (one block): pass 1's pairs reduced to the batch's
// (min, max), then half = max(0.5 (max - min), 1e-6) and mid = 0.5 (max +
// min) as poly_mixer_apply takes them, into stats.
__global__ void __launch_bounds__(kThreads)
poly_stats_kernel(const float2* __restrict__ partials, int n_part,
                  float* __restrict__ stats) {
  __shared__ float2 warp_mm[kThreads / 32];
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < n_part; i += kThreads) {
    const float2 mm = partials[i];
    lo = fminf(lo, mm.x);
    hi = fmaxf(hi, mm.y);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (threadIdx.x % 32 == 0) warp_mm[threadIdx.x / 32] = make_float2(lo, hi);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 mm = warp_mm[0];
    for (int i = 1; i < kThreads / 32; ++i) {
      mm.x = fminf(mm.x, warp_mm[i].x);
      mm.y = fmaxf(mm.y, warp_mm[i].y);
    }
    stats[0] = 0.5f * (mm.y + mm.x);
    stats[1] = fmaxf(0.5f * (mm.y - mm.x), 1e-6f);
  }
}

// Fit, second half: g(z) = sum_p w2_p aptx(w1_p z + b1_p) + b2 (exact
// tanhf, the products rounded as mixer_scalar_g rounds them) at the node
// z_j = mid + half cos((j + 0.5) pi / grid); one warp per node, the lanes
// strided over p and summed in a fixed order.
__global__ void __launch_bounds__(kThreads)
poly_fit_nodes_kernel(const float* __restrict__ stats,
                      const float* __restrict__ w1,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2,
                      const float* __restrict__ consts,
                      float* __restrict__ g_nodes, int p_len, int grid,
                      float pi_over_grid) {
  const int j = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (j >= grid) return;
  const float theta = (static_cast<float>(j) + 0.5f) * pi_over_grid;
  const float zj = __fadd_rn(stats[0], __fmul_rn(stats[1], cosf(theta)));
  float g = 0.0f;
  for (int p = lane; p < p_len; p += 32) {
    const float u = __fadd_rn(__fmul_rn(zj, w1[p]), b1[p]);
    const float a = __fmul_rn(__fmul_rn(1.0f + tanhf(u), 0.5f), u);
    g = fmaf(w2[p], a, g);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    g += __shfl_xor_sync(0xffffffffu, g, off);
  }
  if (lane == 0) g_nodes[j] = g + consts[1];
}

// Fit, last step: coef_k = (2 / grid) sum_j cos(k theta_j) g_j, coef_0
// halved; block k (1-D) sums over the nodes in a fixed order.
__global__ void __launch_bounds__(kThreads)
poly_fit_coef_kernel(const float* __restrict__ g_nodes,
                     float* __restrict__ coef, int grid, float pi_over_grid,
                     float two_over_grid) {
  __shared__ float warp_part[kThreads / 32];
  const float kf = static_cast<float>(blockIdx.x);
  float acc = 0.0f;
  for (int j = threadIdx.x; j < grid; j += kThreads) {
    const float theta = (static_cast<float>(j) + 0.5f) * pi_over_grid;
    acc = fmaf(cosf(kf * theta), g_nodes[j], acc);
  }
  const float total = block_sum(acc, warp_part);
  if (threadIdx.x == 0) {
    const float ck = two_over_grid * total;
    coef[blockIdx.x] = blockIdx.x == 0 ? ck * 0.5f : ck;
  }
}

// Pass 5: out = sum_k coef_k T_k((s - mid) / half) by Clenshaw, from pass
// 1's s, b_out on padded rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
poly_eval_kernel(const T* __restrict__ z, const int* __restrict__ lengths,
                 const float* __restrict__ consts,
                 const float* __restrict__ stats,
                 const float* __restrict__ coef, T* __restrict__ out,
                 int t_len, int c_len, int n_coef) {
  __shared__ float cs[kMaxCoef];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTileC + threadIdx.x;
  const int len = lengths[b];
  const int f0 = blockIdx.y * kTileT + kRows * threadIdx.y;
  const int c = blockIdx.x * kTileC + threadIdx.x;
  const size_t base = static_cast<size_t>(b) * t_len * c_len;
  for (int i = tid; i < n_coef; i += kThreads) cs[i] = coef[i];
  __syncthreads();

  const float mid = stats[0], half = stats[1];
  float tt[kRows], two_t[kRows], b1[kRows], b2[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float s = (f0 + r < t_len && c < c_len)
        ? mqgan::to_f32<T>(z[base + static_cast<size_t>(f0 + r) * c_len + c])
        : 0.0f;
    tt[r] = (s - mid) / half;
    two_t[r] = 2.0f * tt[r];
    b1[r] = 0.0f;
    b2[r] = 0.0f;
  }
  if (f0 < len) {  // else all of the warp's frames are padding
#pragma unroll 4
    for (int kk = n_coef - 1; kk > 0; --kk) {
      const float ck = cs[kk];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float nb = fmaf(two_t[r], b1[r], ck - b2[r]);
        b2[r] = b1[r];
        b1[r] = nb;
      }
    }
  }

  if (c >= c_len) return;
  const float b_out = consts[1];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (f0 + r < t_len) {
      const float o =
          (f0 + r < len) ? fmaf(tt[r], b1[r], cs[0] - b2[r]) : b_out;
      out[base + static_cast<size_t>(f0 + r) * c_len + c] =
          mqgan::from_f32<T>(o);
    }
  }
}

dim3 tile_grid(int b, int t, int c) {
  return dim3((c + kTileC - 1) / kTileC, (t + kTileT - 1) / kTileT, b);
}

struct ExactArgs {
  const void* x;
  const int* len;
  const float* dwk;
  const float* consts;
  const float* w1;
  const float* b1;
  const float* w2;
  void* out;
  int b, t, c, p;
};

template <typename T, int K>
int launch_exact(const ExactArgs& a, cudaStream_t s) {
  const dim3 grid = tile_grid(a.b, a.t, a.c), block(kTileC, kRowGroups);
  const auto* x = static_cast<const T*>(a.x);
  auto* out = static_cast<T*>(a.out);
  if (a.p <= kPSlice) {
    const size_t smem = static_cast<size_t>(a.p) * sizeof(float4);
    mel_mixer_kernel<T, K, false><<<grid, block, smem, s>>>(
        x, a.len, a.dwk, a.consts, a.w1, a.b1, a.w2, out, a.t, a.c, a.p);
  } else {
    const size_t smem = static_cast<size_t>(kPSlice) * sizeof(float4);
    mel_mixer_kernel<T, K, true><<<grid, block, smem, s>>>(
        x, a.len, a.dwk, a.consts, a.w1, a.b1, a.w2, out, a.t, a.c, a.p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_exact_taps(const ExactArgs& a, int k, cudaStream_t s) {
  switch (k) {
    case 1: return launch_exact<T, 1>(a, s);
    case 3: return launch_exact<T, 3>(a, s);
    case 5: return launch_exact<T, 5>(a, s);
    case 7: return launch_exact<T, 7>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct PolyArgs {
  const void* x;
  const int* len;
  const float* dwk;
  const float* consts;
  const float* w1;
  const float* b1;
  const float* w2;
  void* z;
  float2* partials;
  float* stats;
  float* g_nodes;
  float* coef;
  void* out;
  int b, t, c, p, degree, grid;
};

template <typename T, int K>
int launch_poly(const PolyArgs& a, cudaStream_t s) {
  const dim3 block(kTileC, kRowGroups);
  const dim3 tiles = tile_grid(a.b, a.t, a.c);
  const int n_part = static_cast<int>(tiles.x * tiles.y * tiles.z);
  const float pi_over_grid = static_cast<float>(3.14159265358979323846 / a.grid);
  const float two_over_grid = static_cast<float>(2.0 / a.grid);
  const T* xt = static_cast<const T*>(a.x);
  T* zt = static_cast<T*>(a.z);
  poly_minmax_kernel<T, K><<<tiles, block, 0, s>>>(
      xt, a.len, a.dwk, a.consts, zt, a.partials, a.t, a.c);
  poly_stats_kernel<<<1, kThreads, 0, s>>>(a.partials, n_part, a.stats);
  constexpr int kNodesPerBlock = kThreads / 32;
  poly_fit_nodes_kernel<<<(a.grid + kNodesPerBlock - 1) / kNodesPerBlock,
                          kThreads, 0, s>>>(a.stats, a.w1, a.b1, a.w2,
                                            a.consts, a.g_nodes, a.p, a.grid,
                                            pi_over_grid);
  poly_fit_coef_kernel<<<a.degree + 1, kThreads, 0, s>>>(
      a.g_nodes, a.coef, a.grid, pi_over_grid, two_over_grid);
  poly_eval_kernel<T><<<tiles, block, 0, s>>>(
      zt, a.len, a.consts, a.stats, a.coef, static_cast<T*>(a.out), a.t, a.c,
      a.degree + 1);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_poly_taps(const PolyArgs& a, int k, cudaStream_t s) {
  switch (k) {
    case 1: return launch_poly<T, 1>(a, s);
    case 3: return launch_poly<T, 3>(a, s);
    case 5: return launch_poly<T, 5>(a, s);
    case 7: return launch_poly<T, 7>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int mqgan_mel_mixer(const void* x, const void* lengths,
                               const void* dwk, const void* consts,
                               const void* w1, const void* b1, const void* w2,
                               void* out, int b, int t, int c, int p, int k,
                               int is_bf16, void* stream) {
  const ExactArgs a{x,
                    static_cast<const int*>(lengths),
                    static_cast<const float*>(dwk),
                    static_cast<const float*>(consts),
                    static_cast<const float*>(w1),
                    static_cast<const float*>(b1),
                    static_cast<const float*>(w2),
                    out, b, t, c, p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_exact_taps<__nv_bfloat16>(a, k, s)
                 : launch_exact_taps<float>(a, k, s);
}

// The Chebyshev mode: pass 1, the fit's three kernels and pass 5 on one
// stream. partials holds one float2 per (64 x 32) tile of the plane, stats
// 2 floats, g_nodes grid floats, coef degree + 1 floats; z a
// (b, t, c) plane in the storage type (pass 1's s).
extern "C" int mqgan_mel_mixer_poly(const void* x, const void* lengths,
                                    const void* dwk, const void* consts,
                                    const void* w1, const void* b1,
                                    const void* w2, void* z, void* partials,
                                    void* stats, void* g_nodes, void* coef,
                                    void* out, int b, int t, int c, int p,
                                    int k, int degree, int grid, int is_bf16,
                                    void* stream) {
  if (degree < 1 || degree + 1 > kMaxCoef || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PolyArgs a{x,
                   static_cast<const int*>(lengths),
                   static_cast<const float*>(dwk),
                   static_cast<const float*>(consts),
                   static_cast<const float*>(w1),
                   static_cast<const float*>(b1),
                   static_cast<const float*>(w2),
                   z,
                   static_cast<float2*>(partials),
                   static_cast<float*>(stats),
                   static_cast<float*>(g_nodes),
                   static_cast<float*>(coef),
                   out, b, t, c, p, degree, grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_poly_taps<__nv_bfloat16>(a, k, s)
                 : launch_poly_taps<float>(a, k, s);
}
