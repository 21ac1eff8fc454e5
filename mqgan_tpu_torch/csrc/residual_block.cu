// One whole ResidualBlock1D at inference, as a short sequence of launches.
//
// Replaces: mqgan_tpu/ops/block_kernels.py:_fused_block (the Pallas TPU
// kernel `_kernel` / `_shifted_conv` behind fused_residual_block).
//
//   res = x, or (x . Wp + bp) when channels change          [GEMM, k = 1]
//   h   = aptx(round(conv1(x) + b1) * valid)                [GEMM + epilogue]
//   causal:     out = aptx(round(round(conv2(h) + b2) + res) * valid)
//   non-causal: z = round(conv2(h) + b2)                     [GEMM]
//               CBAM channel gate from masked max/mean of z over T
//               per-frame max/mean over C of y = z * gate_c * valid
//               7-tap time gate, then
//               out = aptx(((y * gate_t + z) * valid + res) * valid)
//
// Values are rounded to the compute dtype at the points where the TPU
// kernel rounds them; accumulation is fp32 throughout.
//
// What bounds it on the card: operations. The two k-tap convolutions are
// GEMMs of (B*T) x (k*Cin) by (k*Cin) x Cout: 1.16 TFLOP over the six blocks
// of a flagship round trip (B=64, T=512), against a few hundred MB moved.
//
// What the design does about it: the TPU kernel keeps a whole (T, C) slab
// per batch row on chip; at T=512, C=768 in bf16 that is 768 KB, more than
// a Hopper block's 227 KB of shared memory. So each conv is a tiled
// implicit GEMM over all B*T rows: the A tile is gathered straight from x
// with the time shift t + j - lo applied on load (zeros only outside
// [0, T) -- padded frames of x are read as they are, like the reference),
// so no im2col copy exists. bf16 runs on the tensor cores (conv_gemm_mma:
// mma.sync m16n8k16 on ldmatrix fragments, fp32 accumulators in registers,
// a 128 x 128 x 64 block tile fed by a 3-stage cp.async ring whose
// zero-fill does the padding), fp32 on a 64 x 64 SIMT tile. The mask,
// bias, APTx and residual add run in the GEMM epilogue, straight from the
// accumulators, so h and the causal output are written once. The CBAM
// chain is three small memory-bound passes (a per-(b, c) reduction over
// valid T, the tiny MLP, a per-frame reduction over C) and one elementwise
// tail pass.
//
// The split launch (mqgan_residual_block_begin / _finish) runs a non-causal
// block whose CBAM statistics are pooled over several windows of one clip
// (sequence-parallel serving): `begin` runs the conv GEMMs and the same
// pool kernel over a per-row frame range [lo, hi), writing the partial max
// and sum in fp32; the caller reduces the windows' partials (sum, max) and
// `finish` takes the reduced statistics with the frame counts and runs the
// gate MLP, the SAM statistics (window-local: the halos cover its taps)
// and the tail. With the range [0, length) and no reduction it computes
// what the unsplit launch does, in the same order.

#include "common.cuh"
#include "mma.cuh"

namespace {

using mqgan::aptx;
using mqgan::bf16;
using mqgan::cp_async16;
using mqgan::cp_async_commit;
using mqgan::cp_async_wait;
using mqgan::lane_a;
using mqgan::lane_bt;
using mqgan::ldsm4;
using mqgan::ldsm4_t;
using mqgan::mma_bf16;
using mqgan::pack_bf16;
using mqgan::from_f32;
using mqgan::round_to;
using mqgan::to_f32;

enum Epilogue { kPlain = 0, kConv1 = 1, kTail = 2 };

struct ConvArgs {
  const void* x;       // (B, T, Cin)
  const void* w;       // (K * Cin, Cout)
  const float* bias;   // (Cout,)
  const void* res;     // (B, T, Cout), kTail only
  const int* lengths;  // (B,)
  const float* act;    // (2,) beta, gamma; kConv1 / kTail only
  void* out;           // (B, T, Cout)
  int b, t, cin, cout, k, lo, epi;
};

// the value stored at (m, n) before its rounding to T: acc + bias, and for
// kConv1 / kTail rounded where the TPU kernel rounds, the residual added,
// masked by the row's `valid` and put through APTx
template <typename T>
__device__ __forceinline__ float epilogue(int epi, float acc, float bias, float valid,
                                          float res, float beta, float gamma) {
  const float v = acc + bias;
  if (epi == kPlain) return v;
  float s = round_to<T>(v);
  if (epi == kTail) s = round_to<T>(s + res);
  s = round_to<T>(s * valid);
  return aptx<T>(s, beta, gamma);
}

// 1 where frame m of its clip is below the clip's length, else 0
__device__ __forceinline__ float row_valid(const ConvArgs& a, int m) {
  const int bi = m / a.t;
  return m - bi * a.t < a.lengths[bi] ? 1.0f : 0.0f;
}

template <typename T>
__device__ __forceinline__ void epilogue_store(const ConvArgs& a, float acc,
                                               int m, int n, float beta,
                                               float gamma) {
  const size_t o = static_cast<size_t>(m) * a.cout + n;
  const float valid = a.epi == kPlain ? 1.0f : row_valid(a, m);
  const float res = a.epi == kTail ? to_f32<T>(static_cast<const T*>(a.res)[o]) : 0.0f;
  static_cast<T*>(a.out)[o] =
      from_f32<T>(epilogue<T>(a.epi, acc, a.bias[n], valid, res, beta, gamma));
}

template <typename T>
__device__ __forceinline__ void act_params(const ConvArgs& a, float* beta,
                                           float* gamma) {
  *beta = 0.0f;
  *gamma = 0.0f;
  if (a.epi != kPlain) {
    *beta = round_to<T>(a.act[0]);
    *gamma = round_to<T>(a.act[1]);
  }
}

// ---- fp32: SIMT tiled implicit GEMM, 64 x 64 x 16, 4 x 4 per thread ----
constexpr int kSM = 64, kSN = 64, kSK = 16;

__device__ __forceinline__ float load_a_f32(const ConvArgs& a, int m, int kx,
                                            int m_total, int k_total) {
  if (m >= m_total || kx >= k_total) return 0.0f;
  const int j = kx / a.cin, i = kx - j * a.cin;
  const int bi = m / a.t, ti = m - bi * a.t, ts = ti + j - a.lo;
  if (ts < 0 || ts >= a.t) return 0.0f;
  return static_cast<const float*>(a.x)[(static_cast<size_t>(bi) * a.t + ts)
                                        * a.cin + i];
}

__global__ void __launch_bounds__(256) conv_gemm_simt(ConvArgs a) {
  __shared__ float as[kSK][kSM + 4];
  __shared__ float bs[kSK][kSN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kSM, n0 = blockIdx.x * kSN;
  const int m_total = a.b * a.t, k_total = a.k * a.cin;
  const float* w = static_cast<const float*>(a.w);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k_total; k0 += kSK) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = tid + r * 256;
      const int arow = e / kSK, akk = e - arow * kSK;
      as[akk][arow] = load_a_f32(a, m0 + arow, k0 + akk, m_total, k_total);
      const int brow = e / kSN, bcol = e - brow * kSN;
      const int kx = k0 + brow, n = n0 + bcol;
      bs[brow][bcol] = (kx < k_total && n < a.cout)
                           ? w[static_cast<size_t>(kx) * a.cout + n]
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float beta, gamma;
  act_params<float>(a, &beta, &gamma);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < m_total && n < a.cout) {
        epilogue_store<float>(a, acc[i][j], m, n, beta, gamma);
      }
    }
  }
}

// ---- bf16: mma.sync implicit GEMM, 128 x 128 x 64 block tile ----
// 8 warps as 2 (M) x 4 (N), each a 64 x 32 tile: per 16-deep step 4
// ldmatrix.x4 of A, 2 ldmatrix.x4.trans of B (W is stored (k * Cin, Cout),
// so the B tile is [k][n]) and 16 mma.sync, into 64 fp32 accumulators a
// thread; the fragments of the next step are read while this one
// multiplies. A and B arrive through a 3-stage cp.async ring (35,840 B a
// stage, 2 blocks an SM), 16 bytes a copy, one barrier a k-step; A is
// gathered with the time shift and its zero-fill covers t + j - lo outside
// [0, T) (so a shifted row never reads the neighbouring clip), rows m >= M
// and k >= K. Needs Cin % 8 == 0 and Cout % 8 == 0 and 16-byte aligned x
// and w, so an 8-wide chunk of K never straddles two taps (the wrapper
// checks). On an H100 this tile was the fastest for the six blocks of a
// flagship round trip among 32-deep steps with 3-5 stages, 2 x 2 warps of
// 64 x 64, and 128 x 256 or 256 x 128 tiles.
constexpr int kBM = 128, kBN = 128, kBK = 64, kGemmStages = 3;
constexpr int kWarpsM = 2, kWarpsN = 4, kGemmThreads = 32 * kWarpsM * kWarpsN;
constexpr int kGemmBlocksPerSM = 2;  // launch bound: registers for this many
constexpr int kWM = kBM / kWarpsM, kWN = kBN / kWarpsN;
constexpr int kMI = kWM / 16, kNJ = kWN / 16;  // A fragments, B fragment pairs
constexpr int kALd = kBK + 8;  // bf16 elements per A row: ldmatrix rows
constexpr int kBLd = kBN + 8;  // 16 bytes apart modulo 128, no bank conflict
constexpr int kStageElems = kBM * kALd + kBK * kBLd;
constexpr size_t kGemmSmem = kGemmStages * kStageElems * sizeof(bf16);
// copies per thread and stage; every copy of a thread has the same column
constexpr int kACopies = kBM * kBK / 8 / kGemmThreads, kBCopies = kBK * kBN / 8 / kGemmThreads;
static_assert(kGemmThreads % (kBK / 8) == 0 && kGemmThreads % (kBN / 8) == 0 &&
                  kACopies * kGemmThreads * 8 == kBM * kBK &&
                  kBCopies * kGemmThreads * 8 == kBK * kBN,
              "whole copies per thread");

__global__ void __launch_bounds__(kGemmThreads, kGemmBlocksPerSM) conv_gemm_mma(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int m_total = a.b * a.t, k_total = a.k * a.cin;
  const bf16* x = static_cast<const bf16*>(a.x);
  const bf16* w = static_cast<const bf16*>(a.w);

  // this thread's copies: A rows a_row + r * kAStride at column a_col of
  // each k-step, with their frame and clip; B rows b_row + r * kBStride at
  // column b_col
  constexpr int kAStride = kGemmThreads / (kBK / 8), kBStride = kGemmThreads / (kBN / 8);
  const int a_row = tid / (kBK / 8), a_col = (tid % (kBK / 8)) * 8;
  const int b_row = tid / (kBN / 8), b_col = (tid % (kBN / 8)) * 8;
  int a_t[kACopies];
  const bf16* a_clip[kACopies];
#pragma unroll
  for (int r = 0; r < kACopies; ++r) {
    const int m = m0 + a_row + r * kAStride, bi = m / a.t;
    a_t[r] = m < m_total ? m - bi * a.t : -(1 << 30);  // rows >= M: never in
    a_clip[r] = x + static_cast<size_t>(bi) * a.t * a.cin;
  }
  const bool b_in_n = n0 + b_col < a.cout;
  // the tap j and channel i of column k0 + a_col for the next k-step loaded
  int next_k0 = 0, tap = a_col / a.cin, chan = a_col - tap * a.cin;

  auto load_stage = [&](int slot) {
    bf16* as = ring + slot * kStageElems;
    bf16* bs = as + kBM * kALd;
    const bool k_in = next_k0 + a_col < k_total;
#pragma unroll
    for (int r = 0; r < kACopies; ++r) {
      const int ts = a_t[r] + tap - a.lo;
      const bool in = k_in && ts >= 0 && ts < a.t;
      const bf16* src = in ? a_clip[r] + static_cast<size_t>(ts) * a.cin + chan : x;
      cp_async16(as + (a_row + r * kAStride) * kALd + a_col, src, in);
    }
#pragma unroll
    for (int r = 0; r < kBCopies; ++r) {
      const int kr = b_row + r * kBStride, kx = next_k0 + kr;
      const bool in = b_in_n && kx < k_total;
      const bf16* src = in ? w + static_cast<size_t>(kx) * a.cout + n0 + b_col : w;
      cp_async16(bs + kr * kBLd + b_col, src, in);
    }
    next_k0 += kBK;
    for (chan += kBK; chan >= a.cin; chan -= a.cin) ++tap;
  };

  const int n_k = (k_total + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kGemmStages - 1; ++s) {
    if (s < n_k) load_stage(s);
    cp_async_commit();
  }
  const int off_a = (wm * kWM) * kALd + lane_a(lane, kALd);
  const int off_b = kBM * kALd + wn * kWN + lane_bt(lane, kBLd);
  float acc[kMI][2 * kNJ][4] = {};  // [m tile of 16][n tile of 8][C fragment]

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kGemmStages - 2>();
    __syncthreads();  // step kt is in for every thread; step kt - 1's slot is free
    if (kt + kGemmStages - 1 < n_k) load_stage((kt + kGemmStages - 1) % kGemmStages);
    cp_async_commit();
    const bf16* stage = ring + (kt % kGemmStages) * kStageElems;
    // fragments of 16-deep step kk + 1 are read while step kk multiplies
    uint32_t af[2][kMI][4], bf[2][kNJ][4];
    auto load_frags = [&](int kk, int buf) {
#pragma unroll
      for (int i = 0; i < kMI; ++i) ldsm4(af[buf][i], stage + off_a + 16 * i * kALd + 16 * kk);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj)
        ldsm4_t(bf[buf][jj], stage + off_b + 16 * kk * kBLd + 16 * jj);
    };
    load_frags(0, 0);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if (kk + 1 < kBK / 16) load_frags(kk + 1, (kk + 1) % 2);
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
#pragma unroll
        for (int i = 0; i < kMI; ++i) {
          mma_bf16(acc[i][2 * jj], af[kk % 2][i], bf[kk % 2][jj][0], bf[kk % 2][jj][1]);
          mma_bf16(acc[i][2 * jj + 1], af[kk % 2][i], bf[kk % 2][jj][2], bf[kk % 2][jj][3]);
        }
      }
    }
  }

  // the epilogue from the C fragments: this lane owns columns n, n + 1 of
  // rows g and g + 8 of each 16-row tile; bf16x2 residual reads and stores
  float beta, gamma;
  act_params<bf16>(a, &beta, &gamma);
  const int g = lane / 4, c = lane % 4;
  const bf16* res = static_cast<const bf16*>(a.res);
  bf16* out = static_cast<bf16*>(a.out);
  int col[2 * kNJ];
  float bias_lo[2 * kNJ], bias_hi[2 * kNJ];
#pragma unroll
  for (int jn = 0; jn < 2 * kNJ; ++jn) {
    col[jn] = n0 + wn * kWN + 8 * jn + 2 * c;  // even, so n + 1 < Cout too
    const bool in = col[jn] < a.cout;
    bias_lo[jn] = in ? a.bias[col[jn]] : 0.0f;
    bias_hi[jn] = in ? a.bias[col[jn] + 1] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * kWM + 16 * i + g + 8 * half;
      if (m >= m_total) continue;
      const float valid = a.epi == kPlain ? 1.0f : row_valid(a, m);
      const size_t row = static_cast<size_t>(m) * a.cout;
#pragma unroll
      for (int jn = 0; jn < 2 * kNJ; ++jn) {
        if (col[jn] >= a.cout) continue;
        float2 r = make_float2(0.0f, 0.0f);
        if (a.epi == kTail) {
          r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(res + row + col[jn]));
        }
        *reinterpret_cast<uint32_t*>(out + row + col[jn]) = pack_bf16(
            epilogue<bf16>(a.epi, acc[i][jn][2 * half], bias_lo[jn], valid, r.x, beta,
                           gamma),
            epilogue<bf16>(a.epi, acc[i][jn][2 * half + 1], bias_hi[jn], valid, r.y,
                           beta, gamma));
      }
    }
  }
}

// ---- CBAM ----
// Per (b, c): max and mean of z over the row's valid frames [0, length);
// or, with `lo` and `hi` (the split launch), max and sum over the frames
// [lo[b], hi[b]). Block (64, 4): 64 channels, 4 frame lanes; the max starts
// at the reference's -1e30 fill.
template <typename T>
__global__ void __launch_bounds__(256)
cbam_channel_stats(const T* __restrict__ z, const int* __restrict__ lengths,
                   const int* __restrict__ lo, const int* __restrict__ hi,
                   float* __restrict__ pooled, int t_len, int c_len) {
  __shared__ float smx[4][64], ssum[4][64];
  const int b = blockIdx.y, c = blockIdx.x * 64 + threadIdx.x;
  const int first = lo != nullptr ? max(lo[b], 0) : 0;
  const int end = min(lo != nullptr ? hi[b] : lengths[b], t_len);
  float mx = round_to<T>(-1e30f), sum = 0.0f;
  if (c < c_len) {
    for (int t = first + threadIdx.y; t < end; t += 4) {
      const float v = to_f32<T>(z[(static_cast<size_t>(b) * t_len + t) * c_len + c]);
      mx = fmaxf(mx, v);
      sum += v;
    }
  }
  smx[threadIdx.y][threadIdx.x] = mx;
  ssum[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < c_len) {
    for (int r = 1; r < 4; ++r) {
      mx = fmaxf(mx, smx[r][threadIdx.x]);
      sum += ssum[r][threadIdx.x];
    }
    float* pb = pooled + static_cast<size_t>(b) * 2 * c_len;
    pb[c] = mx;
    pb[c_len + c] = lo != nullptr ? sum : sum / fmaxf(static_cast<float>(lengths[b]), 1.0f);
  }
}

// Per b: hidden = relu(pooled . cw1 + cb1) for the max and the mean rows,
// gate_c = sigmoid(sum over both rows of hidden . cw2 + cb2). Operands in
// the compute dtype, accumulation in fp32. With `counts` (the split
// launch) the second row of `pooled` is a sum, and its mean is the sum
// over max(count, 1).
template <typename T>
__global__ void __launch_bounds__(256)
cbam_channel_gate(const float* __restrict__ pooled, const float* __restrict__ counts,
                  const T* __restrict__ cw1, const float* __restrict__ cb1,
                  const T* __restrict__ cw2, const float* __restrict__ cb2,
                  T* __restrict__ gate, int c_len, int h_len) {
  extern __shared__ float sm[];
  float* p = sm;               // (2, C)
  float* hid = sm + 2 * c_len;  // (2, H)
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * c_len; i += blockDim.x) {
    float v = pooled[static_cast<size_t>(b) * 2 * c_len + i];
    if (counts != nullptr && i >= c_len) v = v / fmaxf(counts[b], 1.0f);
    p[i] = round_to<T>(v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * h_len; i += blockDim.x) {
    const int r = i / h_len, hh = i - r * h_len;
    float acc = 0.0f;
    for (int c = 0; c < c_len; ++c) {
      acc = fmaf(p[r * c_len + c],
                 to_f32<T>(cw1[static_cast<size_t>(c) * h_len + hh]), acc);
    }
    hid[i] = round_to<T>(fmaxf(acc + cb1[hh], 0.0f));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
    float o0 = 0.0f, o1 = 0.0f;
    for (int hh = 0; hh < h_len; ++hh) {
      const float wv = to_f32<T>(cw2[static_cast<size_t>(hh) * c_len + c]);
      o0 = fmaf(hid[hh], wv, o0);
      o1 = fmaf(hid[h_len + hh], wv, o1);
    }
    o0 += cb2[c];
    o1 += cb2[c];
    gate[static_cast<size_t>(b) * c_len + c] = from_f32<T>(mqgan::sigmoid(o0 + o1));
  }
}

// One warp per frame: max and mean over C of y = z * gate_c * valid.
template <typename T>
__global__ void __launch_bounds__(256)
sam_stats(const T* __restrict__ z, const T* __restrict__ gate,
          const int* __restrict__ lengths, float* __restrict__ stats,
          int rows, int t_len, int c_len) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / t_len, t = row - b * t_len;
  const float valid = t < lengths[b] ? 1.0f : 0.0f;
  const T* zr = z + static_cast<size_t>(row) * c_len;
  const T* g = gate + static_cast<size_t>(b) * c_len;
  float mx = __int_as_float(0xff800000), sum = 0.0f;  // -inf
  for (int c = lane; c < c_len; c += 32) {
    const float y = round_to<T>(
        round_to<T>(to_f32<T>(zr[c]) * to_f32<T>(g[c])) * valid);
    mx = fmaxf(mx, y);
    sum += y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    stats[2 * static_cast<size_t>(row)] = mx * valid;
    stats[2 * static_cast<size_t>(row) + 1] = sum / c_len * valid;
  }
}

// One block per frame: the sam_k-tap time gate (logits zero-padded outside
// [0, T), -1e4 at padded frames), then the tail
// out = aptx(((y * gate_t + z) * valid + res) * valid).
template <typename T>
__global__ void __launch_bounds__(256)
cbam_tail(const T* __restrict__ z, const T* __restrict__ gate,
          const float* __restrict__ stats, const float* __restrict__ sam_w,
          int sam_k, const T* __restrict__ res,
          const int* __restrict__ lengths, const float* __restrict__ act,
          T* __restrict__ out, int t_len, int c_len) {
  const int row = blockIdx.x;
  const int b = row / t_len, t = row - b * t_len;
  const bool is_valid = t < lengths[b];
  const float valid = is_valid ? 1.0f : 0.0f;
  const int pad = sam_k / 2;
  float logits = 0.0f;
  for (int j = 0; j < sam_k; ++j) {
    const int ts = t + j - pad;
    float mxv = 0.0f, avv = 0.0f;
    if (ts >= 0 && ts < t_len) {
      const size_t o = 2 * (static_cast<size_t>(b) * t_len + ts);
      mxv = stats[o];
      avv = stats[o + 1];
    }
    logits = logits + sam_w[2 * j] * mxv + sam_w[2 * j + 1] * avv;
  }
  if (!is_valid) logits = -1e4f;
  const float gate_t = round_to<T>(mqgan::sigmoid(logits) * valid);
  const float beta = round_to<T>(act[0]), gamma = round_to<T>(act[1]);
  const T* g = gate + static_cast<size_t>(b) * c_len;
  for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
    const size_t o = static_cast<size_t>(row) * c_len + c;
    const float zv = to_f32<T>(z[o]);
    const float y = round_to<T>(round_to<T>(zv * to_f32<T>(g[c])) * valid);
    const float zz = round_to<T>(round_to<T>(round_to<T>(y * gate_t) + zv)
                                 * valid);
    const float s = round_to<T>(round_to<T>(zz + to_f32<T>(res[o])) * valid);
    out[o] = from_f32<T>(aptx<T>(s, beta, gamma));
  }
}

template <typename T>
int run_pool(const void* z, const int* lengths, const int* lo, const int* hi,
             float* pooled, int b, int t, int c, cudaStream_t s) {
  cbam_channel_stats<T><<<dim3((c + 63) / 64, b), dim3(64, 4), 0, s>>>(
      static_cast<const T*>(z), lengths, lo, hi, pooled, t, c);
  return static_cast<int>(cudaGetLastError());
}

// the gate MLP, the SAM statistics and the tail, from the pooled (B, 2, C)
// statistics (a mean row, or with `counts` a sum row)
template <typename T>
int run_gate_tail(const void* z, const int* lengths, const float* act,
                  const void* cw1, const float* cb1, const void* cw2,
                  const float* cb2, const float* sam_w, const void* res,
                  const float* pooled, const float* counts, void* gate,
                  float* stats, void* out, int b, int t, int c, int h,
                  int sam_k, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  T* gt = static_cast<T*>(gate);
  const size_t smem = (2 * static_cast<size_t>(c) + 2 * h) * sizeof(float);
  cbam_channel_gate<T><<<b, 256, smem, s>>>(
      pooled, counts, static_cast<const T*>(cw1), cb1,
      static_cast<const T*>(cw2), cb2, gt, c, h);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int rows = b * t;
  sam_stats<T><<<(rows + 7) / 8, 256, 0, s>>>(zt, gt, lengths, stats, rows,
                                               t, c);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  cbam_tail<T><<<rows, 256, 0, s>>>(zt, gt, stats, sam_w, sam_k,
                                    static_cast<const T*>(res), lengths, act,
                                    static_cast<T*>(out), t, c);
  return static_cast<int>(cudaGetLastError());
}

// One k-tap conv GEMM with its epilogue: the mma.sync kernel in bf16, the
// SIMT one in fp32.
int conv_launch(const ConvArgs& a, int is_bf16, cudaStream_t s) {
  const int m = a.b * a.t;
  if (is_bf16) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_gemm_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kGemmSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    conv_gemm_mma<<<dim3((a.cout + kBN - 1) / kBN, (m + kBM - 1) / kBM),
                    kGemmThreads, kGemmSmem, s>>>(a);
  } else {
    conv_gemm_simt<<<dim3((a.cout + kSN - 1) / kSN, (m + kSM - 1) / kSM), 256,
                     0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// The block's GEMMs: the projection into `res` when channels change, conv1
// into `h`, conv2 into `z` (non-causal, plain epilogue) or, causal, with
// the tail epilogue into `out`.
int run_convs(const void* x, const int* len, const float* act, const void* w1,
              const void* b1, const void* w2, const void* b2, const void* pw,
              const void* pb, void* h, void* z, void* res, void* out, int b,
              int t, int cin, int cout, int k, int causal, int is_bf16,
              cudaStream_t s) {
  const int lo = causal ? k - 1 : k / 2;
  auto conv = [&](const void* in, const void* w, const void* bias, int c_in,
                  int taps, int pad_lo, int epi, const void* r,
                  void* dst) -> int {
    const ConvArgs a{in, w, static_cast<const float*>(bias), r, len, act, dst,
                     b, t, c_in, cout, taps, pad_lo, epi};
    return conv_launch(a, is_bf16, s);
  };
  int err;
  const void* residual = x;
  if (pw != nullptr) {
    if ((err = conv(x, pw, pb, cin, 1, 0, kPlain, nullptr, res))) return err;
    residual = res;
  }
  if ((err = conv(x, w1, b1, cin, k, lo, kConv1, nullptr, h))) return err;
  if (causal) return conv(h, w2, b2, cout, k, lo, kTail, residual, out);
  return conv(h, w2, b2, cout, k, lo, kPlain, nullptr, z);
}

}  // namespace

extern "C" int mqgan_residual_block(
    const void* x, const void* lengths, const void* act, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* pw,
    const void* pb, const void* cw1, const void* cb1, const void* cw2,
    const void* cb2, const void* sam_w, void* h, void* z, void* res,
    void* pooled, void* gate_c, void* sam_stats_buf, void* out, int b, int t,
    int cin, int cout, int k, int hid, int sam_k, int causal, int is_bf16,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* actf = static_cast<const float*>(act);
  int err = run_convs(x, len, actf, w1, b1, w2, b2, pw, pb, h, z, res, out, b,
                      t, cin, cout, k, causal, is_bf16, s);
  if (err || causal) return err;
  const void* residual = pw != nullptr ? res : x;
  float* pooledf = static_cast<float*>(pooled);
  const float* cb1f = static_cast<const float*>(cb1);
  const float* cb2f = static_cast<const float*>(cb2);
  const float* samf = static_cast<const float*>(sam_w);
  float* statsf = static_cast<float*>(sam_stats_buf);
  if (is_bf16) {
    if ((err = run_pool<bf16>(z, len, nullptr, nullptr, pooledf, b, t, cout, s))) return err;
    return run_gate_tail<bf16>(z, len, actf, cw1, cb1f, cw2, cb2f, samf, residual,
                               pooledf, nullptr, gate_c, statsf, out, b, t, cout,
                               hid, sam_k, s);
  }
  if ((err = run_pool<float>(z, len, nullptr, nullptr, pooledf, b, t, cout, s))) return err;
  return run_gate_tail<float>(z, len, actf, cw1, cb1f, cw2, cb2f, samf, residual,
                              pooledf, nullptr, gate_c, statsf, out, b, t, cout,
                              hid, sam_k, s);
}

// The split launch of a non-causal block, first part: the conv GEMMs (the
// projection into `res`, conv1 into `h`, conv2 into `z`), then per (b, c)
// the max (row 0 of `partial`, (B, 2, C) fp32) and the sum (row 1) of z
// over the frames [stats_lo[b], stats_hi[b]).
extern "C" int mqgan_residual_block_begin(
    const void* x, const void* lengths, const void* act, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* pw,
    const void* pb, const void* stats_lo, const void* stats_hi, void* h,
    void* z, void* res, void* partial, int b, int t, int cin, int cout, int k,
    int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  int err = run_convs(x, len, static_cast<const float*>(act), w1, b1, w2, b2,
                      pw, pb, h, z, res, nullptr, b, t, cin, cout, k, 0,
                      is_bf16, s);
  if (err) return err;
  const int* lo = static_cast<const int*>(stats_lo);
  const int* hi = static_cast<const int*>(stats_hi);
  float* pf = static_cast<float*>(partial);
  return is_bf16 ? run_pool<bf16>(z, len, lo, hi, pf, b, t, cout, s)
                 : run_pool<float>(z, len, lo, hi, pf, b, t, cout, s);
}

// The split launch, second part: from the reduced statistics `pooled`
// ((B, 2, C) fp32: the max over all windows, then the sum) and `counts`
// ((B,) fp32: the frames those sums cover), the gate MLP, the SAM
// statistics and the tail into `out`. `residual` is x, or the projection
// `begin` wrote.
extern "C" int mqgan_residual_block_finish(
    const void* z, const void* residual, const void* lengths, const void* act,
    const void* cw1, const void* cb1, const void* cw2, const void* cb2,
    const void* sam_w, const void* pooled, const void* counts, void* gate_c,
    void* sam_stats_buf, void* out, int b, int t, int cout, int hid,
    int sam_k, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* actf = static_cast<const float*>(act);
  const float* cb1f = static_cast<const float*>(cb1);
  const float* cb2f = static_cast<const float*>(cb2);
  const float* samf = static_cast<const float*>(sam_w);
  const float* pf = static_cast<const float*>(pooled);
  const float* cf = static_cast<const float*>(counts);
  float* statsf = static_cast<float*>(sam_stats_buf);
  if (is_bf16) {
    return run_gate_tail<bf16>(z, len, actf, cw1, cb1f, cw2, cb2f, samf, residual,
                               pf, cf, gate_c, statsf, out, b, t, cout, hid,
                               sam_k, s);
  }
  return run_gate_tail<float>(z, len, actf, cw1, cb1f, cw2, cb2f, samf, residual,
                              pf, cf, gate_c, statsf, out, b, t, cout, hid,
                              sam_k, s);
}
