// Causal flash attention for training: a forward kernel that saves the
// softmax statistics, and the two backward kernels (dK/dV and dQ).
//
// Replaces: the Pallas TPU flash attention that
// mqgan_tpu/models/token_transformer.py:_attend_flash calls from JAX's
// library (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_impl, _flash_attention_bwd_dkv, _flash_attention_bwd_dq).
//
//   S   = Q K^T * scale, causal (key <= query) and key < T
//   lse = logsumexp_k S                       (B, H, T) fp32
//   O   = softmax(S) V                        rounded to the input dtype
//   D   = rowsum(dO * O)                      fp32, in the dQ kernel's prologue
//   P   = exp(S - lse);  dS = P * (dO V^T - D)
//   dV  = P^T dO;  dK = dS^T Q * scale;  dQ = dS K * scale
//
// Layout: q, k, v, o, do, dq, dk, dv are (B, T, H, D) as the module holds
// them (row (b, t) of head h starts at ((b * T + t) * H + h) * D); there is
// no transpose and no pad to a tile multiple. Rows past T are read as zeros
// and never written, so any T >= 1 works.
//
// What bounds it on the card: operations. At the flagship layer call (B=8,
// H=8, T=2047, D=64) the forward needs 4 * B * H * D * T(T+1)/2 = 34 GFLOP
// of products against 67 MB of q, k, v and o; the backward of the function
// 86 GFLOP. The backward split into a dK/dV kernel and a dQ kernel recomputes
// S and dP in both (7 products instead of 5), as JAX's split does, so that
// no kernel needs atomics: every output tile is owned by one block, and the
// result is deterministic.
//
// What the design does about it: one block per (b, h, 64-row tile); key
// tiles above the diagonal are skipped, so the causal mask costs half the
// work and is applied only where it can bite. bf16 products run on the
// tensor cores (WMMA 16x16x16, fp32 accumulators) over tiles staged in
// shared memory; the scores, the online softmax and all statistics are
// fp32; P and dS are rounded to bf16 before their products (the naive path
// also casts the probabilities to v's dtype before P V). fp32 inputs run the
// same algorithm on a SIMT tile (4x4 outputs per thread, no TF32: it would
// miss the 1e-4 gate). This is the simple, right version: no cp.async/TMA
// pipeline, no wgmma, the accumulators live in shared memory.

#include <mma.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mqgan::from_f32;
using mqgan::to_f32;

constexpr int kThreads = 256;  // 8 warps

// rows of a query / key tile: 64, except fp32 at D=128, whose dK/dV block
// would not fit in shared memory at 64 rows
template <typename T, int D>
constexpr int tile_rows() {
  return (sizeof(T) == 4 && D == 128) ? 32 : 64;
}

// padded leading dimensions (in elements) of the shared-memory tiles: keep
// 16x16 fragment pointers 32-byte aligned and spread the banks
template <typename T>
constexpr int ld_of(int n) { return n + 8; }
constexpr int ldf_of(int n) { return n + 4; }

constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// c (M x N fp32, ldc) = [c +] op(a) . op(b); op(a) is M x K: a[i * lda + k],
// or a[k * lda + i] when TA; op(b) is K x N: b[k * ldb + j], or
// b[j * ldb + k] when TB. All in shared memory; the caller synchronises.
template <typename T, bool TA, bool TB, int M, int N, int K>
__device__ __forceinline__ void tile_mm(float* c, int ldc, const T* a, int lda,
                                        const T* b, int ldb, bool accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    const int warp = threadIdx.x / 32;
    constexpr int kBlocksN = N / 16, kBlocks = (M / 16) * kBlocksN;
    for (int blk = warp; blk < kBlocks; blk += kThreads / 32) {
      const int mi = blk / kBlocksN, ni = blk - mi * kBlocksN;
      float* cp = c + mi * 16 * ldc + ni * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (accumulate) {
        wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < K; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
        const T* ap = TA ? a + kk * lda + mi * 16 : a + mi * 16 * lda + kk;
        const T* bp = TB ? b + ni * 16 * ldb + kk : b + kk * ldb + ni * 16;
        wmma::load_matrix_sync(fa, ap, lda);
        wmma::load_matrix_sync(fb, bp, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
    }
  } else {
    // fp32 SIMT: each thread owns 4 x 4 outputs, rows ty + i * M/4 and
    // columns tx + j * N/4 of one sub-block
    constexpr int kCols = N / 4, kTiles = (M / 4) * kCols;
    for (int u = threadIdx.x; u < kTiles; u += kThreads) {
      const int ty = u / kCols, tx = u - ty * kCols;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = accumulate ? c[(ty + i * (M / 4)) * ldc + tx + j * kCols]
                                 : 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < K; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + i * (M / 4);
          av[i] = TA ? a[kk * lda + r] : a[r * lda + kk];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + j * kCols;
          bv[j] = TB ? b[col * ldb + kk] : b[kk * ldb + col];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[(ty + i * (M / 4)) * ldc + tx + j * kCols] = acc[i][j];
    }
  }
}

// rows [row0, row0 + R) of head h of a (B, T, H, D) tensor into a shared
// tile (R x D, leading dim ld), 16 bytes per load; rows >= T become zeros
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          int b, int h, int row0, int t_len,
                                          int n_heads) {
  constexpr int kVec = 16 / sizeof(T), kChunks = D / kVec;
  for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
    const int r = e / kChunks, ch = e - r * kChunks, t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < t_len) {
      const size_t off =
          ((static_cast<size_t>(b) * t_len + t) * n_heads + h) * D + ch * kVec;
      val = *reinterpret_cast<const uint4*>(src + off);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + ch * kVec) = val;
  }
}

// a (R x D) fp32 shared tile times `mul`, rounded to T, into rows
// [row0, row0 + R) of head h (rows >= T are not written)
template <typename T, int D, int R>
__device__ __forceinline__ void store_rows(T* dst, const float* src, int ld,
                                           float mul, int b, int h, int row0,
                                           int t_len, int n_heads) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, d = e - r * D, t = row0 + r;
    if (t < t_len) {
      dst[((static_cast<size_t>(b) * t_len + t) * n_heads + h) * D + d] =
          from_f32<T>(src[r * ld + d] * mul);
    }
  }
}

// reduce over the `width` consecutive lanes that share a row
template <int kWidth>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
template <int kWidth>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- forward
template <typename T, int D>
struct FwdSmem {
  static constexpr int R = tile_rows<T, D>(), LD = ld_of<T>(D),
                       LDS = ldf_of(R), LDP = ld_of<T>(R), LDO = ldf_of(D);
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * R * LD);
  static constexpr size_t v = k + align128(sizeof(T) * R * LD);
  static constexpr size_t s = v + align128(sizeof(T) * R * LD);
  static constexpr size_t p = s + align128(sizeof(float) * R * LDS);
  static constexpr size_t o = p + align128(sizeof(T) * R * LDP);
  static constexpr size_t bytes = o + align128(sizeof(float) * R * LDO);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int t_len, int n_heads, float scale) {
  using L = FwdSmem<T, D>;
  constexpr int R = L::R, kWidth = kThreads / R, kPer = R / kWidth;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);

  const int n_tiles = (t_len + R - 1) / R;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * R;
  const int row = threadIdx.x / kWidth, part = threadIdx.x % kWidth;

  load_rows<T, D, R>(qs, L::LD, q, b, h, q0, t_len, n_heads);
  for (int e = threadIdx.x; e < R * D; e += kThreads)
    os[(e / D) * L::LDO + e % D] = 0.0f;
  float m = -INFINITY, l = 0.0f;  // this row's running max and sum

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows<T, D, R>(ks, L::LD, k, b, h, k0, t_len, n_heads);
    load_rows<T, D, R>(vs, L::LD, v, b, h, k0, t_len, n_heads);
    __syncthreads();
    tile_mm<T, false, true, R, R, D>(ss, L::LDS, qs, L::LD, ks, L::LD, false);
    __syncthreads();
    // online softmax of this row, kWidth threads per row, kPer columns each
    const int qi = q0 + row;
    float sv[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = part + j * kWidth, ki = k0 + col;
      float s = ss[row * L::LDS + col] * scale;
      if (kt == qt && (ki > qi || ki >= t_len)) s = -INFINITY;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, group_max<kWidth>(mx));  // finite: key 0
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float p = expf(sv[j] - m_new);
      sum += p;
      ps[row * L::LDP + part + j * kWidth] = from_f32<T>(p);
    }
    l = l * alpha + group_sum<kWidth>(sum);
    m = m_new;
    for (int d = part; d < D; d += kWidth) os[row * L::LDO + d] *= alpha;
    __syncthreads();
    tile_mm<T, false, false, R, D, R>(os, L::LDO, ps, L::LDP, vs, L::LD, true);
  }
  __syncthreads();
  // normalise in place, then write O and lse
  const float inv_l = 1.0f / l;
  for (int d = part; d < D; d += kWidth) os[row * L::LDO + d] *= inv_l;
  if (part == 0 && q0 + row < t_len)
    lse[(static_cast<size_t>(b) * n_heads + h) * t_len + q0 + row] = m + logf(l);
  __syncthreads();
  store_rows<T, D, R>(o, os, L::LDO, 1.0f, b, h, q0, t_len, n_heads);
}

// --------------------------------------------------------------- backward
// The two kernels share the recomputation of one (query tile, key tile)
// pair: S = Q K^T and dP = dO V^T into fp32 tiles, then
//   P = exp(S * scale - lse) where key <= query < T (else 0),
//   dS = P * (dP - delta); P and dS rounded to T into their own tiles.
template <typename T, int D>
struct BwdSmem {
  static constexpr int R = tile_rows<T, D>(), LD = ld_of<T>(D),
                       LDS = ldf_of(R), LDP = ld_of<T>(R), LDA = ldf_of(D);
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * R * LD);
  static constexpr size_t v = k + align128(sizeof(T) * R * LD);
  static constexpr size_t dout = v + align128(sizeof(T) * R * LD);
  static constexpr size_t s = dout + align128(sizeof(T) * R * LD);
  static constexpr size_t dp = s + align128(sizeof(float) * R * LDS);
  static constexpr size_t p = dp + align128(sizeof(float) * R * LDS);
  static constexpr size_t ds = p + align128(sizeof(T) * R * LDP);
  static constexpr size_t acc0 = ds + align128(sizeof(T) * R * LDP);
  static constexpr size_t acc1 = acc0 + align128(sizeof(float) * R * LDA);
  static constexpr size_t stats = acc1 + align128(sizeof(float) * R * LDA);
  // dQ needs one accumulator, dK/dV two
  static constexpr size_t bytes_dq = acc1 + align128(2 * sizeof(float) * R);
  static constexpr size_t bytes_dkv = stats + align128(2 * sizeof(float) * R);
};

template <typename T, int D>
__device__ __forceinline__ void probs_and_dscores(
    const float* ss, const float* dps, T* ps, T* dss, const float* lse_s,
    const float* delta_s, int q0, int k0, int t_len, float scale) {
  using L = BwdSmem<T, D>;
  constexpr int R = L::R;
  for (int e = threadIdx.x; e < R * R; e += kThreads) {
    const int r = e / R, col = e - r * R, qi = q0 + r, ki = k0 + col;
    float p = 0.0f;
    if (ki <= qi && qi < t_len) p = expf(ss[r * L::LDS + col] * scale - lse_s[r]);
    const float ds = p * (dps[r * L::LDS + col] - delta_s[r]);
    ps[r * L::LDP + col] = from_f32<T>(p);
    dss[r * L::LDP + col] = from_f32<T>(ds);
  }
}

// dQ, one block per (b, h, query tile); key tiles 0 .. diagonal. Its
// prologue computes delta = rowsum(dO * O) for the dK/dV kernel too.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ o,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, T* __restrict__ dq, int t_len,
                 int n_heads, float scale) {
  using L = BwdSmem<T, D>;
  constexpr int R = L::R, kWidth = kThreads / R;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  T* dos = reinterpret_cast<T*>(smem + L::dout);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  T* dss = reinterpret_cast<T*>(smem + L::ds);
  float* dqs = reinterpret_cast<float*>(smem + L::acc0);
  float* lse_s = reinterpret_cast<float*>(smem + L::acc1);
  float* delta_s = lse_s + R;

  const int n_tiles = (t_len + R - 1) / R;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * R;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  load_rows<T, D, R>(qs, L::LD, q, b, h, q0, t_len, n_heads);
  load_rows<T, D, R>(dos, L::LD, dout, b, h, q0, t_len, n_heads);
  for (int e = threadIdx.x; e < R * D; e += kThreads)
    dqs[(e / D) * L::LDA + e % D] = 0.0f;
  {
    const int row = threadIdx.x / kWidth, part = threadIdx.x % kWidth;
    const int qi = q0 + row;
    float acc = 0.0f;
    if (qi < t_len) {
      const size_t base = ((static_cast<size_t>(b) * t_len + qi) * n_heads + h) * D;
      for (int d = part; d < D; d += kWidth)
        acc += to_f32<T>(dout[base + d]) * to_f32<T>(o[base + d]);
    }
    acc = group_sum<kWidth>(acc);
    if (part == 0) {
      delta_s[row] = acc;
      lse_s[row] = qi < t_len ? lse[stat0 + qi] : 0.0f;
      if (qi < t_len) delta[stat0 + qi] = acc;
    }
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_rows<T, D, R>(ks, L::LD, k, b, h, k0, t_len, n_heads);
    load_rows<T, D, R>(vs, L::LD, v, b, h, k0, t_len, n_heads);
    __syncthreads();
    tile_mm<T, false, true, R, R, D>(ss, L::LDS, qs, L::LD, ks, L::LD, false);
    tile_mm<T, false, true, R, R, D>(dps, L::LDS, dos, L::LD, vs, L::LD, false);
    __syncthreads();
    probs_and_dscores<T, D>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<T, false, false, R, D, R>(dqs, L::LDA, dss, L::LDP, ks, L::LD, true);
  }
  __syncthreads();
  store_rows<T, D, R>(dq, dqs, L::LDA, scale, b, h, q0, t_len, n_heads);
}

// dK and dV, one block per (b, h, key tile); query tiles diagonal .. end.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int t_len,
                  int n_heads, float scale) {
  using L = BwdSmem<T, D>;
  constexpr int R = L::R;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q);
  T* ks = reinterpret_cast<T*>(smem + L::k);
  T* vs = reinterpret_cast<T*>(smem + L::v);
  T* dos = reinterpret_cast<T*>(smem + L::dout);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* dps = reinterpret_cast<float*>(smem + L::dp);
  T* ps = reinterpret_cast<T*>(smem + L::p);
  T* dss = reinterpret_cast<T*>(smem + L::ds);
  float* dks = reinterpret_cast<float*>(smem + L::acc0);
  float* dvs = reinterpret_cast<float*>(smem + L::acc1);
  float* lse_s = reinterpret_cast<float*>(smem + L::stats);
  float* delta_s = lse_s + R;

  const int n_tiles = (t_len + R - 1) / R;
  const int kt = blockIdx.x;  // the longest column of query tiles first
  const int h = blockIdx.y, b = blockIdx.z, k0 = kt * R;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  load_rows<T, D, R>(ks, L::LD, k, b, h, k0, t_len, n_heads);
  load_rows<T, D, R>(vs, L::LD, v, b, h, k0, t_len, n_heads);
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    dks[(e / D) * L::LDA + e % D] = 0.0f;
    dvs[(e / D) * L::LDA + e % D] = 0.0f;
  }

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_rows<T, D, R>(qs, L::LD, q, b, h, q0, t_len, n_heads);
    load_rows<T, D, R>(dos, L::LD, dout, b, h, q0, t_len, n_heads);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const bool in = q0 + r < t_len;
      lse_s[r] = in ? lse[stat0 + q0 + r] : 0.0f;
      delta_s[r] = in ? delta[stat0 + q0 + r] : 0.0f;
    }
    __syncthreads();
    tile_mm<T, false, true, R, R, D>(ss, L::LDS, qs, L::LD, ks, L::LD, false);
    tile_mm<T, false, true, R, R, D>(dps, L::LDS, dos, L::LD, vs, L::LD, false);
    __syncthreads();
    probs_and_dscores<T, D>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<T, true, false, R, D, R>(dvs, L::LDA, ps, L::LDP, dos, L::LD, true);
    tile_mm<T, true, false, R, D, R>(dks, L::LDA, dss, L::LDP, qs, L::LD, true);
  }
  __syncthreads();
  store_rows<T, D, R>(dk, dks, L::LDA, scale, b, h, k0, t_len, n_heads);
  store_rows<T, D, R>(dv, dvs, L::LDA, 1.0f, b, h, k0, t_len, n_heads);
}

struct Shape {
  int b, t, h, d;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                Shape s, float scale, cudaStream_t st) {
  constexpr int R = tile_rows<T, D>();
  constexpr size_t smem = FwdSmem<T, D>::bytes;
  auto kernel = flash_fwd<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t + R - 1) / R, s.h, s.b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s.t, s.h, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   Shape s, float scale, cudaStream_t st) {
  constexpr int R = tile_rows<T, D>();
  constexpr size_t smem = BwdSmem<T, D>::bytes_dq;
  auto kernel = flash_bwd_dq<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t + R - 1) / R, s.h, s.b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), s.t, s.h, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, Shape s, float scale, cudaStream_t st) {
  constexpr int R = tile_rows<T, D>();
  constexpr size_t smem = BwdSmem<T, D>::bytes_dkv;
  auto kernel = flash_bwd_dkv<T, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.t + R - 1) / R, s.h, s.b);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), s.t, s.h, scale);
  return cudaGetLastError();
}

// dispatch on the head size and the dtype; other sizes are refused (the
// wrapper raises first, naming the supported sizes)
#define MQGAN_FLASH_DISPATCH(FN, ...)                                          \
  switch (s.d) {                                                               \
    case 32:                                                                   \
      return is_bf16 ? FN<__nv_bfloat16, 32>(__VA_ARGS__)                      \
                     : FN<float, 32>(__VA_ARGS__);                             \
    case 64:                                                                   \
      return is_bf16 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)                      \
                     : FN<float, 64>(__VA_ARGS__);                             \
    case 128:                                                                  \
      return is_bf16 ? FN<__nv_bfloat16, 128>(__VA_ARGS__)                     \
                     : FN<float, 128>(__VA_ARGS__);                            \
    default:                                                                   \
      return cudaErrorInvalidValue;                                            \
  }

}  // namespace

extern "C" int mqgan_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int b, int t, int h, int d,
                               int is_bf16, float scale, void* stream) {
  const Shape s{b, t, h, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  MQGAN_FLASH_DISPATCH(fwd, q, k, v, o, lse_f, s, scale, st)
}

extern "C" int mqgan_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  int b, int t, int h, int d, int is_bf16,
                                  float scale, void* stream) {
  const Shape s{b, t, h, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  MQGAN_FLASH_DISPATCH(bwd_dq, q, k, v, o, dout, lse_f, delta_f, dq, s, scale, st)
}

extern "C" int mqgan_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dk, void* dv,
                                   int b, int t, int h, int d, int is_bf16,
                                   float scale, void* stream) {
  const Shape s{b, t, h, d};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  MQGAN_FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse_f, delta_f, dk, dv, s, scale, st)
}
