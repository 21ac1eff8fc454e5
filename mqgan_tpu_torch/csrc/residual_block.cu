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
// so no im2col copy exists; bf16 runs on the tensor cores (WMMA 16x16x16,
// fp32 accumulators, a 128 x 64 block tile), fp32 on a 64 x 64 SIMT tile.
// The mask, bias, APTx and residual add run in the GEMM epilogue, so h and
// the causal output are written once. The CBAM chain is three small
// memory-bound passes (a per-(b, c) reduction over valid T, the tiny MLP,
// a per-frame reduction over C) and one elementwise tail pass.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mqgan::aptx;
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

template <typename T>
__device__ __forceinline__ void epilogue_store(const ConvArgs& a, float acc,
                                               int m, int n, float beta,
                                               float gamma) {
  T* out = static_cast<T*>(a.out);
  const size_t o = static_cast<size_t>(m) * a.cout + n;
  const float v = acc + a.bias[n];
  if (a.epi == kPlain) {
    out[o] = from_f32<T>(v);
    return;
  }
  const int bi = m / a.t, ti = m - bi * a.t;
  const float valid = ti < a.lengths[bi] ? 1.0f : 0.0f;
  float s = round_to<T>(v);
  if (a.epi == kTail) {
    s = round_to<T>(s + to_f32<T>(static_cast<const T*>(a.res)[o]));
  }
  s = round_to<T>(s * valid);
  out[o] = from_f32<T>(aptx<T>(s, beta, gamma));
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

// ---- bf16: WMMA tensor-core implicit GEMM, 128 x 64 x 32 block tile ----
// 8 warps as 4 (M) x 2 (N), each a 32 x 32 tile of 2 x 2 16x16 fragments.
// Needs Cin % 8 == 0 and Cout % 8 == 0 and 16-byte aligned x and w, so an
// 8-wide chunk of K never straddles two taps (the wrapper checks).
constexpr int kWM = 128, kWN = 64, kWK = 32;
constexpr int kALd = kWK + 8;  // bf16 elements per staged A row
constexpr int kBLd = kWN + 8;
constexpr int kCLd = kWN + 4;  // fp32 elements per staged C row
constexpr int kSmemAB = (kWM * kALd + kWK * kBLd) * 2;
constexpr int kSmemC = kWM * kCLd * 4;
constexpr int kSmem = kSmemC > kSmemAB ? kSmemC : kSmemAB;

__global__ void __launch_bounds__(256) conv_gemm_wmma(ConvArgs a) {
  __shared__ __align__(128) unsigned char smem[kSmem];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs = as + kWM * kALd;
  float* cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * kWM, n0 = blockIdx.x * kWN;
  const int m_total = a.b * a.t, k_total = a.k * a.cin;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < k_total; k0 += kWK) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // A: 128 x 32 = 512 chunks of 8
      const int chunk = tid + r * 256;
      const int row = chunk / 4, kc = (chunk % 4) * 8;
      const int m = m0 + row, kx = k0 + kc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < m_total && kx < k_total) {
        const int j = kx / a.cin, i = kx - j * a.cin;
        const int bi = m / a.t, ti = m - bi * a.t, ts = ti + j - a.lo;
        if (ts >= 0 && ts < a.t) {
          v = *reinterpret_cast<const uint4*>(
              x + (static_cast<size_t>(bi) * a.t + ts) * a.cin + i);
        }
      }
      *reinterpret_cast<uint4*>(as + row * kALd + kc) = v;
    }
    {  // B: 32 x 64 = 256 chunks of 8
      const int row = tid / 8, nc = (tid % 8) * 8;
      const int kx = k0 + row, n = n0 + nc;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kx < k_total && n < a.cout) {
        v = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(kx) * a.cout + n);
      }
      *reinterpret_cast<uint4*>(bs + row * kBLd + nc) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kALd + kk,
                               kALd);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(fb[j], bs + kk * kBLd + wn * 32 + j * 16,
                               kBLd);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kCLd + wn * 32 + j * 16,
                              acc[i][j], kCLd, wmma::mem_row_major);
  __syncthreads();

  float beta, gamma;
  act_params<__nv_bfloat16>(a, &beta, &gamma);
  for (int e = tid; e < kWM * kWN; e += 256) {
    const int row = e / kWN, col = e - row * kWN;
    const int m = m0 + row, n = n0 + col;
    if (m < m_total && n < a.cout) {
      epilogue_store<__nv_bfloat16>(a, cs[row * kCLd + col], m, n, beta,
                                    gamma);
    }
  }
}

// ---- CBAM ----
// Per (b, c): max and mean of z over the row's valid frames. Block (64, 4):
// 64 channels, 4 frame lanes; the max starts at the reference's -1e30 fill.
template <typename T>
__global__ void __launch_bounds__(256)
cbam_channel_stats(const T* __restrict__ z, const int* __restrict__ lengths,
                   float* __restrict__ pooled, int t_len, int c_len) {
  __shared__ float smx[4][64], ssum[4][64];
  const int b = blockIdx.y, c = blockIdx.x * 64 + threadIdx.x;
  const int len = min(lengths[b], t_len);
  float mx = round_to<T>(-1e30f), sum = 0.0f;
  if (c < c_len) {
    for (int t = threadIdx.y; t < len; t += 4) {
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
    pb[c_len + c] = sum / fmaxf(static_cast<float>(lengths[b]), 1.0f);
  }
}

// Per b: hidden = relu(pooled . cw1 + cb1) for the max and the mean rows,
// gate_c = sigmoid(sum over both rows of hidden . cw2 + cb2). Operands in
// the compute dtype, accumulation in fp32.
template <typename T>
__global__ void __launch_bounds__(256)
cbam_channel_gate(const float* __restrict__ pooled, const T* __restrict__ cw1,
                  const float* __restrict__ cb1, const T* __restrict__ cw2,
                  const float* __restrict__ cb2, T* __restrict__ gate,
                  int c_len, int h_len) {
  extern __shared__ float sm[];
  float* p = sm;               // (2, C)
  float* hid = sm + 2 * c_len;  // (2, H)
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * c_len; i += blockDim.x) {
    p[i] = round_to<T>(pooled[static_cast<size_t>(b) * 2 * c_len + i]);
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
int run_cbam(const void* z, const int* lengths, const float* act,
             const void* cw1, const float* cb1, const void* cw2,
             const float* cb2, const float* sam_w, const void* res,
             float* pooled, void* gate, float* stats, void* out, int b, int t,
             int c, int h, int sam_k, cudaStream_t s) {
  const T* zt = static_cast<const T*>(z);
  T* gt = static_cast<T*>(gate);
  cbam_channel_stats<T><<<dim3((c + 63) / 64, b), dim3(64, 4), 0, s>>>(
      zt, lengths, pooled, t, c);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const size_t smem = (2 * static_cast<size_t>(c) + 2 * h) * sizeof(float);
  cbam_channel_gate<T><<<b, 256, smem, s>>>(
      pooled, static_cast<const T*>(cw1), cb1, static_cast<const T*>(cw2),
      cb2, gt, c, h);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const int rows = b * t;
  sam_stats<T><<<(rows + 7) / 8, 256, 0, s>>>(zt, gt, lengths, stats, rows,
                                               t, c);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  cbam_tail<T><<<rows, 256, 0, s>>>(zt, gt, stats, sam_w, sam_k,
                                    static_cast<const T*>(res), lengths, act,
                                    static_cast<T*>(out), t, c);
  return static_cast<int>(cudaGetLastError());
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
  const int lo = causal ? k - 1 : k / 2;
  const int m = b * t;

  auto conv = [&](const void* in, const void* w, const void* bias, int c_in,
                  int taps, int pad_lo, int epi, const void* r,
                  void* dst) -> int {
    ConvArgs a{in, w, static_cast<const float*>(bias), r, len, actf, dst,
               b, t, c_in, cout, taps, pad_lo, epi};
    if (is_bf16) {
      conv_gemm_wmma<<<dim3((cout + kWN - 1) / kWN, (m + kWM - 1) / kWM), 256,
                       0, s>>>(a);
    } else {
      conv_gemm_simt<<<dim3((cout + kSN - 1) / kSN, (m + kSM - 1) / kSM), 256,
                       0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
  };

  int err;
  const void* residual = x;
  if (pw != nullptr) {
    if ((err = conv(x, pw, pb, cin, 1, 0, kPlain, nullptr, res))) return err;
    residual = res;
  }
  if ((err = conv(x, w1, b1, cin, k, lo, kConv1, nullptr, h))) return err;
  if (causal) return conv(h, w2, b2, cout, k, lo, kTail, residual, out);
  if ((err = conv(h, w2, b2, cout, k, lo, kPlain, nullptr, z))) return err;
  const float* cb1f = static_cast<const float*>(cb1);
  const float* cb2f = static_cast<const float*>(cb2);
  const float* samf = static_cast<const float*>(sam_w);
  float* pooledf = static_cast<float*>(pooled);
  float* statsf = static_cast<float*>(sam_stats_buf);
  if (is_bf16) {
    return run_cbam<__nv_bfloat16>(z, len, actf, cw1, cb1f, cw2, cb2f, samf,
                                   residual, pooledf, gate_c, statsf, out, b,
                                   t, cout, hid, sam_k, s);
  }
  return run_cbam<float>(z, len, actf, cw1, cb1f, cw2, cb2f, samf, residual,
                         pooledf, gate_c, statsf, out, b, t, cout, hid, sam_k,
                         s);
}
