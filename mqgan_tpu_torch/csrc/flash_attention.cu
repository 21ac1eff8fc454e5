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
// 86 GFLOP.
//
// Forward (flash_fwd, bf16 and fp32) and the fp32 backward: one block of 8
// warps per (b, h, 64-row tile); key tiles above the diagonal are skipped,
// so the causal mask costs half the work and is applied only where it can
// bite. bf16 products of the forward run on WMMA 16x16x16 over tiles staged
// in shared memory, with fp32 scores, online softmax and statistics; P is
// rounded to bf16 before P V (the naive path also casts the probabilities
// to v's dtype). fp32 inputs run the same algorithm on a SIMT tile (4x4
// outputs per thread, no TF32: it would miss the 1e-4 gate), accumulators
// in shared memory.
//
// bf16 backward (flash_bwd_dq_mma, flash_bwd_dkv_mma), the training path.
// They replace _flash_attention_bwd_dq and _flash_attention_bwd_dkv; 7
// products of the causal pairs (S and dP recomputed in both, then dQ; dV
// and dK), 120 GFLOP at the flagship call, bound by operations. The design
// keeps every intermediate out of shared memory:
//   - one block of 4 warps per (b, h, 64-row tile), each warp owning 16
//     rows (query rows for dQ, key rows for dK/dV), longest loops first;
//   - every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate) on
//     fragments read by ldmatrix; the accumulators (dQ, or dK and dV) stay
//     in registers for the whole loop;
//   - S, dP, P and dS live in registers only: the C fragments of the score
//     products are exponentiated (exp2f of one FMA: scale and lse come
//     premultiplied by log2 e), masked, rounded to bf16 and repacked in
//     place as the A fragments of the next product (FA2's trick). The
//     dK/dV kernel computes the transposed scores S^T = K Q^T, so P^T and
//     dS^T come out with the key rows it owns, and lse and D are indexed by
//     column;
//   - the streamed tiles (K, V for dQ; Q, dO, lse, D for dK/dV) arrive
//     through a two-stage cp.async ring, so the next tile is in flight
//     while the tensor cores work on this one; one barrier per tile;
//   - the mask runs only on the diagonal tile and the ragged last tile;
//   - the output goes to bf16 through the warp's own rows of a shared tile
//     and leaves in 16-byte stores.
// At D <= 64 each warp also holds its A rows (K and V, or Q and dO) in
// registers; at D = 128 they are re-read from shared memory at each step,
// and the dK/dV kernel takes 32 query columns per pass, so that the two
// 16 x 128 fp32 accumulators fit.
//
// Why two kernels: one fused backward needs fp32 atomics into dQ (or dK/dV),
// whose result depends on the order of the adds and changes from run to
// run. As in JAX's split, every output tile is owned by one block and
// written once, so dq, dk and dv are bit-identical from run to run; the
// price is the recomputed S and dP (7 products instead of 5).

#include <mma.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;
using mqgan::from_f32;

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

// ---------------------------------------------------- backward, fp32 SIMT
// The two kernels share the recomputation of one (query tile, key tile)
// pair: S = Q K^T and dP = dO V^T into fp32 tiles, then
//   P = exp(S * scale - lse) where key <= query < T (else 0),
//   dS = P * (dP - delta), into their own tiles.
template <int D>
struct BwdSmem {
  using T = float;
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

template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const float* ss, const float* dps, float* ps, float* dss, const float* lse_s,
    const float* delta_s, int q0, int k0, int t_len, float scale) {
  using L = BwdSmem<D>;
  constexpr int R = L::R;
  for (int e = threadIdx.x; e < R * R; e += kThreads) {
    const int r = e / R, col = e - r * R, qi = q0 + r, ki = k0 + col;
    float p = 0.0f;
    if (ki <= qi && qi < t_len) p = expf(ss[r * L::LDS + col] * scale - lse_s[r]);
    ps[r * L::LDP + col] = p;
    dss[r * L::LDP + col] = p * (dps[r * L::LDS + col] - delta_s[r]);
  }
}

// dQ, one block per (b, h, query tile); key tiles 0 .. diagonal. Its
// prologue computes delta = rowsum(dO * O) for the dK/dV kernel too.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ o,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      float* __restrict__ delta, float* __restrict__ dq, int t_len,
                      int n_heads, float scale) {
  using T = float;
  using L = BwdSmem<D>;
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
      for (int d = part; d < D; d += kWidth) acc += dout[base + d] * o[base + d];
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
    probs_and_dscores<D>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<T, false, false, R, D, R>(dqs, L::LDA, dss, L::LDP, ks, L::LD, true);
  }
  __syncthreads();
  store_rows<T, D, R>(dq, dqs, L::LDA, scale, b, h, q0, t_len, n_heads);
}

// dK and dV, one block per (b, h, key tile); query tiles diagonal .. end.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int t_len,
                       int n_heads, float scale) {
  using T = float;
  using L = BwdSmem<D>;
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
    probs_and_dscores<D>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<T, true, false, R, D, R>(dvs, L::LDA, ps, L::LDP, dos, L::LD, true);
    tile_mm<T, true, false, R, D, R>(dks, L::LDA, dss, L::LDP, qs, L::LD, true);
  }
  __syncthreads();
  store_rows<T, D, R>(dk, dks, L::LDA, scale, b, h, k0, t_len, n_heads);
  store_rows<T, D, R>(dv, dvs, L::LDA, 1.0f, b, h, k0, t_len, n_heads);
}

// ------------------------------------------ backward, bf16 (tensor cores)
// Fragment layouts of mma.sync m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and c = lane % 4, each register two bf16
// (the lower column or row in the lower half) or one fp32:
//   A (16 x 16, row): a0 (g, 2c..2c+1)   a1 (g+8, 2c..)   a2 (g, 2c+8..)   a3 (g+8, 2c+8..)
//   B (16 x 8, col):  b0 (k 2c..2c+1, n g)                b1 (k 2c+8.., n g)
//   C (16 x 8):       c0, c1 (g, 2c, 2c+1)                c2, c3 (g+8, 2c, 2c+1)
// So the C fragments of two adjacent 8-column tiles, packed in pairs, are
// the A fragment of one 16-deep step. One ldmatrix.x4 reads an A fragment,
// or the B fragments of two 8-column tiles: from a tile stored [n][k]
// directly, from one stored [k][n] with .trans.

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // rows of a tile, 16 per warp
constexpr int kStages = 2;                // depth of the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
static_assert(kMmaThreads == 2 * kMmaRows, "one thread per lse / delta entry");

template <int D>
struct MmaSmem {
  // rows 16 bytes apart modulo 128: ldmatrix's 8 row reads hit 8 bank groups
  static constexpr int LD = D + 8;
  static constexpr int tile = kMmaRows * LD;  // bf16 elements of one tile
  static constexpr size_t tiles = (2 + 2 * kStages) * sizeof(bf16) * tile;
  // dQ: Q, dO, then kStages x (K, V);
  // dK/dV: K, V, kStages x (Q, dO), then kStages x (lse, delta) in fp32
  static constexpr size_t bytes_dq = tiles;
  static constexpr size_t bytes_dkv = tiles + kStages * 2 * kMmaRows * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes from global to shared memory; with !in nothing
// is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b on the tensor cores, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the lower half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of 16-deep step kk from the C fragments of 8-column tiles
// 2 kk and 2 kk + 1, rounded to bf16
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// this lane's ldmatrix.x4 offsets (elements) into a tile of leading dim ld:
// an A fragment at [m][k]; B fragments of n tiles n0, n0 + 8 stored [n][k];
// the same stored [k][n] (.trans)
__device__ __forceinline__ int lane_a(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int lane_b(int lane, int ld) {
  return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int lane_bt(int lane, int ld) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + (lane >> 4) * 8;
}

// rows [row0, row0 + 64) of head h of a (B, T, H, D) bf16 tensor into a
// shared tile (leading dim D + 8), 16 bytes per cp.async; rows >= T are
// zero-filled. The caller commits the group.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int b,
                                                int h, int row0, int t_len,
                                                int n_heads) {
  constexpr int LD = MmaSmem<D>::LD, kChunks = D / 8;
  static_assert(kMmaRows * kChunks % kMmaThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kMmaRows * kChunks / kMmaThreads; ++i) {
    const int e = threadIdx.x + i * kMmaThreads;
    const int r = e / kChunks, ch = e % kChunks, t = row0 + r;
    const bool in = t < t_len;
    const bf16* from =
        in ? src + ((static_cast<size_t>(b) * t_len + t) * n_heads + h) * D + ch * 8
           : src;
    cp_async16(dst + r * LD + ch * 8, from, in);
  }
}

// a warp's 16 x D fp32 accumulator (C fragments) times `mul`, rounded to
// bf16 into its 16 rows of a shared tile, then out to rows [row0, row0 + 16)
// of head h in 16-byte stores (rows >= T are not written)
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, bf16* stage,
                                            const float (&acc)[D / 8][4], float mul,
                                            int b, int h, int row0, int t_len,
                                            int n_heads, int lane) {
  constexpr int LD = MmaSmem<D>::LD, kChunks = D / 8;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * c) =
        pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * c) =
        pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * kChunks / 32; ++i) {
    const int e = lane + 32 * i, r = e / kChunks, ch = e % kChunks, t = row0 + r;
    if (t < t_len) {
      *reinterpret_cast<uint4*>(
          dst + ((static_cast<size_t>(b) * t_len + t) * n_heads + h) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + ch * 8);
    }
  }
}

// sum of the products of 8 bf16 pairs, in fp32
__device__ __forceinline__ float dot8(uint4 x, uint4 y) {
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&y);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(a[i]), w = __bfloat1622float2(b[i]);
    s = fmaf(u.x, w.x, s);
    s = fmaf(u.y, w.y, s);
  }
  return s;
}

// dQ, one block per (b, h, query tile), longest rows first; key tiles 0 ..
// diagonal stream through the ring. Warp w owns query rows 16w .. 16w + 15:
//   S = Q_w K^T, dP = dO_w V^T (16 x 64, registers), P = exp(S * scale -
//   lse), dS = P (dP - delta), dQ_w += dS K (dS as the A operand, K via
//   ldmatrix.trans). Its prologue writes delta = rowsum(dO * O).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ delta, bf16* __restrict__ dq, int t_len,
                     int n_heads, float scale) {
  using L = MmaSmem<D>;
  constexpr int LD = L::LD, kSteps = D / 16;
  constexpr bool kHold = D <= 64;  // Q_w and dO_w fragments in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::tile;
  bf16* ring = dos + L::tile;  // stage s: K at ring + 2 s tiles, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (t_len + kMmaRows - 1) / kMmaRows;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * kMmaRows;
  const int row_w = q0 + 16 * warp;  // this warp's first query row
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  auto load_stage = [&](int kt) {
    bf16* ks = ring + 2 * (kt % kStages) * L::tile;
    load_tile_async<D>(ks, k, b, h, kt * kMmaRows, t_len, n_heads);
    load_tile_async<D>(ks + L::tile, v, b, h, kt * kMmaRows, t_len, n_heads);
  };
  load_tile_async<D>(qs, q, b, h, q0, t_len, n_heads);
  load_tile_async<D>(dos, dout, b, h, q0, t_len, n_heads);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s <= qt) load_stage(s);
    cp_async_commit();
  }

  // delta of the warp's rows, two lanes per row, while the tiles load
  float dsum = 0.0f;
  {
    const int t = row_w + lane / 2;
    if (t < t_len) {
      const size_t base = ((static_cast<size_t>(b) * t_len + t) * n_heads + h) * D +
                          (lane & 1) * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        dsum += dot8(*reinterpret_cast<const uint4*>(dout + base + 8 * i),
                     *reinterpret_cast<const uint4*>(o + base + 8 * i));
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if ((lane & 1) == 0 && t < t_len) delta[stat0 + t] = dsum;
  }
  // the statistics of this lane's rows g and g + 8
  const int qi_lo = row_w + g, qi_hi = qi_lo + 8;
  const float dl_lo = __shfl_sync(0xffffffffu, dsum, 2 * g);
  const float dl_hi = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
  // P = exp(S * scale - lse) = exp2(S * scale log2 e - lse log2 e)
  const float scale2 = scale * kLog2e;
  const float lse_lo = qi_lo < t_len ? lse[stat0 + qi_lo] * kLog2e : 0.0f;
  const float lse_hi = qi_hi < t_len ? lse[stat0 + qi_hi] * kLog2e : 0.0f;

  const bf16* qw = qs + 16 * warp * LD + lane_a(lane, LD);
  const bf16* dow = dos + 16 * warp * LD + lane_a(lane, LD);
  const int off_b = lane_b(lane, LD), off_bt = lane_bt(lane, LD);
  uint32_t qf[kHold ? kSteps : 1][4], of[kHold ? kSteps : 1][4];
  float acc[D / 8][4] = {};

  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in for every thread; tile kt - 1's slot is free
    if (kt + kStages - 1 <= qt) load_stage(kt + kStages - 1);
    cp_async_commit();
    if (kHold && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < (kHold ? kSteps : 0); ++kk) {
        ldsm4(qf[kk], qw + 16 * kk);
        ldsm4(of[kk], dow + 16 * kk);
      }
    }
    const bf16* ks = ring + 2 * (kt % kStages) * L::tile;
    const bf16* vs = ks + L::tile;

    float sc[kMmaRows / 8][4] = {}, dp[kMmaRows / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4], oa[4];
      if constexpr (kHold) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i] = qf[kk][i];
          oa[i] = of[kk][i];
        }
      } else {
        ldsm4(qa, qw + 16 * kk);
        ldsm4(oa, dow + 16 * kk);
      }
#pragma unroll
      for (int j = 0; j < kMmaRows / 16; ++j) {
        uint32_t fb[4];
        ldsm4(fb, ks + 16 * j * LD + 16 * kk + off_b);
        mma_bf16(sc[2 * j], qa, fb[0], fb[1]);
        mma_bf16(sc[2 * j + 1], qa, fb[2], fb[3]);
        ldsm4(fb, vs + 16 * j * LD + 16 * kk + off_b);
        mma_bf16(dp[2 * j], oa, fb[0], fb[1]);
        mma_bf16(dp[2 * j + 1], oa, fb[2], fb[3]);
      }
    }
    // P, then dS in place of S; keys above the diagonal only on its tile
    const bool diag = kt == qt;
    const int k0 = kt * kMmaRows;
#pragma unroll
    for (int j = 0; j < kMmaRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int key = k0 + 8 * j + 2 * c + (e & 1);
        float p = exp2f(fmaf(sc[j][e], scale2, -(lo ? lse_lo : lse_hi)));
        if (diag && key > (lo ? qi_lo : qi_hi)) p = 0.0f;
        sc[j][e] = p * (dp[j][e] - (lo ? dl_lo : dl_hi));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kMmaRows / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t fb[4];
        ldsm4_t(fb, ks + 16 * kk * LD + 16 * j + off_bt);
        mma_bf16(acc[2 * j], sa, fb[0], fb[1]);
        mma_bf16(acc[2 * j + 1], sa, fb[2], fb[3]);
      }
    }
  }
  __syncthreads();
  store_strip<D>(dq, qs + 16 * warp * LD, acc, scale, b, h, row_w, t_len, n_heads,
                 lane);
}

// dK and dV, one block per (b, h, key tile), the longest column first; query
// tiles diagonal .. end stream through the ring with their lse and delta.
// Warp w owns key rows 16w .. 16w + 15 and works on the transposed scores:
//   S^T = K_w Q^T, dP^T = V_w dO^T (16 x kCols, registers; Q and dO stored
//   row by row are already the col-major B operands), P^T = exp(S^T * scale
//   - lse[query]), dS^T = P^T (dP^T - delta[query]), dV_w += P^T dO,
//   dK_w += dS^T Q (dO and Q via ldmatrix.trans).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
                      int n_heads, float scale) {
  using L = MmaSmem<D>;
  constexpr int LD = L::LD, kSteps = D / 16;
  constexpr bool kHold = D <= 64;           // K_w and V_w fragments in registers
  constexpr int kCols = D <= 64 ? 64 : 32;  // query columns per pass
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + L::tile;
  bf16* ring = vs + L::tile;  // stage s: Q at ring + 2 s tiles, dO after it
  float* stats = reinterpret_cast<float*>(ring + 2 * kStages * L::tile);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (t_len + kMmaRows - 1) / kMmaRows;
  const int kt = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, k0 = kt * kMmaRows;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  // stage s holds Q, dO, and lse then delta (the first 64 threads copy lse)
  auto load_stage = [&](int qt) {
    const int s = (qt - kt) % kStages, q0 = qt * kMmaRows;
    bf16* qs = ring + 2 * s * L::tile;
    load_tile_async<D>(qs, q, b, h, q0, t_len, n_heads);
    load_tile_async<D>(qs + L::tile, dout, b, h, q0, t_len, n_heads);
    const int r = threadIdx.x % kMmaRows;
    const float* src = threadIdx.x < kMmaRows ? lse : delta;
    const bool in = q0 + r < t_len;
    cp_async4(stats + 2 * s * kMmaRows + threadIdx.x, in ? src + stat0 + q0 + r : src,
              in);
  };
  load_tile_async<D>(ks, k, b, h, k0, t_len, n_heads);
  load_tile_async<D>(vs, v, b, h, k0, t_len, n_heads);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (kt + s < n_tiles) load_stage(kt + s);
    cp_async_commit();
  }

  const bf16* kw = ks + 16 * warp * LD + lane_a(lane, LD);
  const bf16* vw = vs + 16 * warp * LD + lane_a(lane, LD);
  const int off_b = lane_b(lane, LD), off_bt = lane_bt(lane, LD);
  const int key_lo = k0 + 16 * warp + g;  // the key of c0, c1; c2, c3 at + 8
  const float scale2 = scale * kLog2e;     // P^T = exp2(S^T scale2 - lse log2 e)
  uint32_t kf[kHold ? kSteps : 1][4], vf[kHold ? kSteps : 1][4];
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};

  for (int qt = kt; qt < n_tiles; ++qt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile qt is in for every thread; tile qt - 1's slot is free
    if (qt + kStages - 1 < n_tiles) load_stage(qt + kStages - 1);
    cp_async_commit();
    if (kHold && qt == kt) {
#pragma unroll
      for (int kk = 0; kk < (kHold ? kSteps : 0); ++kk) {
        ldsm4(kf[kk], kw + 16 * kk);
        ldsm4(vf[kk], vw + 16 * kk);
      }
    }
    const int s = (qt - kt) % kStages, q0 = qt * kMmaRows;
    const bf16* qs = ring + 2 * s * L::tile;
    const bf16* dos = qs + L::tile;
    const float* lse_s = stats + 2 * s * kMmaRows;
    const float* dl_s = lse_s + kMmaRows;
    const bool masked = qt == kt || q0 + kMmaRows > t_len;

#pragma unroll
    for (int c0 = 0; c0 < kMmaRows; c0 += kCols) {
      float st[kCols / 8][4] = {}, dpt[kCols / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kHold) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kk][i];
            va[i] = vf[kk][i];
          }
        } else {
          ldsm4(ka, kw + 16 * kk);
          ldsm4(va, vw + 16 * kk);
        }
#pragma unroll
        for (int j = 0; j < kCols / 16; ++j) {
          uint32_t fb[4];
          ldsm4(fb, qs + (c0 + 16 * j) * LD + 16 * kk + off_b);
          mma_bf16(st[2 * j], ka, fb[0], fb[1]);
          mma_bf16(st[2 * j + 1], ka, fb[2], fb[3]);
          ldsm4(fb, dos + (c0 + 16 * j) * LD + 16 * kk + off_b);
          mma_bf16(dpt[2 * j], va, fb[0], fb[1]);
          mma_bf16(dpt[2 * j + 1], va, fb[2], fb[3]);
        }
      }
      // P^T, then dS^T in place of dP^T; the mask on the diagonal and last tiles
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * c + (e & 1), query = q0 + col;
          float p = exp2f(fmaf(st[j][e], scale2, -lse_s[col] * kLog2e));
          if (masked && (key_lo + 8 * (e >> 1) > query || query >= t_len)) p = 0.0f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl_s[col]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
        c_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) {
          uint32_t fb[4];
          ldsm4_t(fb, dos + (c0 + 16 * kk) * LD + 16 * j + off_bt);
          mma_bf16(dv_acc[2 * j], pa, fb[0], fb[1]);
          mma_bf16(dv_acc[2 * j + 1], pa, fb[2], fb[3]);
          ldsm4_t(fb, qs + (c0 + 16 * kk) * LD + 16 * j + off_bt);
          mma_bf16(dk_acc[2 * j], sa, fb[0], fb[1]);
          mma_bf16(dk_acc[2 * j + 1], sa, fb[2], fb[3]);
        }
      }
    }
  }
  __syncthreads();
  store_strip<D>(dk, ks + 16 * warp * LD, dk_acc, scale, b, h, k0 + 16 * warp, t_len,
                 n_heads, lane);
  store_strip<D>(dv, vs + 16 * warp * LD, dv_acc, 1.0f, b, h, k0 + 16 * warp, t_len,
                 n_heads, lane);
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = MmaSmem<D>::bytes_dq;
    auto kernel = flash_bwd_dq_mma<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kMmaRows - 1) / kMmaRows, s.h, s.b);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), s.t,
        s.h, scale);
  } else {
    constexpr int R = tile_rows<T, D>();
    constexpr size_t smem = BwdSmem<D>::bytes_dq;
    auto kernel = flash_bwd_dq_simt<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + R - 1) / R, s.h, s.b);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), s.t, s.h, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, Shape s, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = MmaSmem<D>::bytes_dkv;
    auto kernel = flash_bwd_dkv_mma<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kMmaRows - 1) / kMmaRows, s.h, s.b);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.t, s.h, scale);
  } else {
    constexpr int R = tile_rows<T, D>();
    constexpr size_t smem = BwdSmem<D>::bytes_dkv;
    auto kernel = flash_bwd_dkv_simt<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + R - 1) / R, s.h, s.b);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), s.t, s.h, scale);
  }
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
