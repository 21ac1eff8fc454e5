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
// Layout: q, k, v, o, do, dq, dk, dv are (B, T, H, d) as the module holds
// them (row (b, t) of head h starts at ((b * T + t) * H + h) * d); there is
// no transpose and no pad to a tile multiple. Rows past T are read as zeros
// and never written, so any T >= 1 works.
//
// Head sizes: every d from 1 to 128 and d = 256 here; the larger multiples
// of 128 (the rest of what JAX's TPU kernel takes: below 128, or a multiple
// of 128) run the D-chunked kernels of flash_attention_chunked.cu. The tiles hold D
// columns, d rounded up to 32, 64, 96, 128 or 256 (one instantiation
// each); the loads zero-fill the columns past d, which changes no score
// and leaves the output's extra columns 0, and those are never stored. The
// scale is the caller's (d^-0.5 of the true d). When a row's d columns and
// every pointer are 16-byte aligned, rows move in 16-byte copies; otherwise
// in the widest copies that d and the pointers allow (8, 4 or 2 bytes, or
// one element; `Head`).
// At D = 256 a block of the bf16 kernels owns half the output columns (DO =
// 128) and recomputes the scores over all 256: the fp32 accumulators of a
// warp's 16 x 256 output (two of them in dK/dV) do not fit its registers.
//
// What bounds it on the card: operations. At the flagship layer call (B=8,
// H=8, T=2047, D=64) the forward needs 4 * B * H * D * T(T+1)/2 = 34 GFLOP
// of products against 67 MB of q, k, v and o; the backward of the function
// 86 GFLOP.
//
// fp32 (flash_fwd_simt and the *_simt backward): one block of 8 warps per
// (b, h, 64-row tile); key tiles above the diagonal are skipped, so the
// causal mask costs half the work and is applied only where it can bite; a
// SIMT tile (4x4 outputs per thread, no TF32: it would miss the 1e-4 gate),
// scores and accumulators in shared memory.
//
// bf16 forward (flash_fwd_mma), FA2's forward: the 2 products of the causal
// pairs, 34 GFLOP at the flagship call. One block of 4 warps per (b, h,
// 64-row query tile), the longest rows of all heads first; warp w owns
// query rows 16w .. 16w + 15 and keeps them in registers throughout:
//   - S = Q_w K^T (16 x 64) is mma.sync C fragments; the online softmax
//     runs on them in base 2 (scale * log2 e folded in, exp2f), the row max
//     over the 4 lanes of a row by shuffles, each lane's share of the row
//     sum in a register until the end;
//   - alpha = exp2(m_old - m_new) rescales the fp32 O accumulator (16 x D,
//     registers); P, rounded to bf16 as the plain path rounds it to v's
//     dtype, is repacked in place as the A fragments of P V (V stored
//     [key][d] is the [k][n] operand, read with ldmatrix.trans);
//   - K and V stream through the cp.async ring below, one barrier a tile;
//   - O leaves scaled by 1/l in 16-byte stores, lse = m ln 2 + log l.
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

//
// This header holds the kernels and their host launchers, templated on the
// tiles' D and, for bf16, on kAny: false for a head that fills its tiles in
// 16-byte copies (d == D, the common case, with no code for other
// layouts), true for any other (and for every head at D = 256). flash_attention.cu holds the C entry
// points and instantiates D = 32, 64 and 128; flash_attention_wide.cu,
// flash_attention_any.cu and flash_attention_any_wide.cu the rest (the
// MQGAN_FLASH_*_SIZES lists), so that nvcc builds the four in parallel.

#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace mqgan_flash {

using mqgan::bf16;
using mqgan::c_to_a;
using mqgan::cp_async16;
using mqgan::cp_async4;
using mqgan::cp_async8;
using mqgan::cp_async_commit;
using mqgan::cp_async_wait;
using mqgan::lane_a;
using mqgan::lane_b;
using mqgan::lane_bt;
using mqgan::ldsm4;
using mqgan::ldsm4_t;
using mqgan::mma_bf16;
using mqgan::pack_bf16;

constexpr int kThreads = 256;  // 8 warps of the fp32 SIMT kernels
constexpr size_t kMaxSmem = 232448;  // an H100 block's shared memory, bytes

// how the kernels read a (B, T, H, d) row: its d columns in copies of vec
// elements (vec divides d, every pointer is vec-aligned); `wide` when the
// copies are 16 bytes, the fast path
struct Head {
  int d, vec;
  template <typename T>
  __device__ __forceinline__ bool wide() const {
    return vec * static_cast<int>(sizeof(T)) == 16;
  }
};

// output columns a bf16 block owns: all D, or half of D = 256
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D > 128 ? 128 : D;
}

// rows of a query / key tile of the fp32 kernels: 64 up to D=64, 32 past
// it (at 64 rows the dK/dV block of D=128 would not fit in shared memory)
template <int D>
constexpr int tile_rows() {
  return D <= 64 ? 64 : 32;
}

// padded leading dimensions (in elements) of the fp32 shared-memory tiles:
// spread the banks
constexpr int ld_of(int n) { return n + 8; }
constexpr int ldf_of(int n) { return n + 4; }

constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// c (M x N, ldc) = [c +] op(a) . op(b) in fp32 on the SIMT cores; op(a) is
// M x K: a[i * lda + k], or a[k * lda + i] when TA; op(b) is K x N:
// b[k * ldb + j], or b[j * ldb + k] when TB. All in shared memory; the
// caller synchronises. Each thread owns 4 x 4 outputs, rows ty + i * M/4
// and columns tx + j * N/4 of one sub-block.
template <bool TA, bool TB, int M, int N, int K>
__device__ __forceinline__ void tile_mm(float* c, int ldc, const float* a, int lda,
                                        const float* b, int ldb, bool accumulate) {
  constexpr int kCols = N / 4, kTiles = (M / 4) * kCols;
  for (int u = threadIdx.x; u < kTiles; u += kThreads) {
    const int ty = u / kCols, tx = u - ty * kCols;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? c[(ty + i * (M / 4)) * ldc + tx + j * kCols] : 0.0f;
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
      for (int j = 0; j < 4; ++j) c[(ty + i * (M / 4)) * ldc + tx + j * kCols] = acc[i][j];
  }
}

// the offset of row t of head h of a (B, T, H, d) tensor
__device__ __forceinline__ size_t row_at(int b, int t, int h, int t_len, int n_heads,
                                         int d) {
  return ((static_cast<size_t>(b) * t_len + t) * n_heads + h) * d;
}

// rows [row0, row0 + R) of head h of a (B, T, H, d) fp32 tensor into a
// shared tile (R x D, leading dim ld), 16 bytes per load when the head is
// wide, else one element; rows >= T and columns >= d become zeros
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int b,
                                          int h, int row0, int t_len, int n_heads,
                                          Head hd) {
  if (hd.wide<float>()) {
    constexpr int kChunks = D / 4;
    for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e - r * kChunks, t = row0 + r;
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t < t_len && ch * 4 < hd.d) {
        val = *reinterpret_cast<const float4*>(
            src + row_at(b, t, h, t_len, n_heads, hd.d) + ch * 4);
      }
      *reinterpret_cast<float4*>(dst + r * ld + ch * 4) = val;
    }
    return;
  }
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, col = e - r * D, t = row0 + r;
    dst[r * ld + col] = t < t_len && col < hd.d
                            ? src[row_at(b, t, h, t_len, n_heads, hd.d) + col]
                            : 0.0f;
  }
}

// a (R x D) shared tile times `mul` into rows [row0, row0 + R) of head h
// (rows >= T and columns >= d are not written)
template <int D, int R>
__device__ __forceinline__ void store_rows(float* dst, const float* src, int ld, float mul,
                                           int b, int h, int row0, int t_len,
                                           int n_heads, Head hd) {
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    const int r = e / D, col = e - r * D, t = row0 + r;
    if (t < t_len && col < hd.d) {
      dst[row_at(b, t, h, t_len, n_heads, hd.d) + col] = src[r * ld + col] * mul;
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

// ----------------------------------------------------- forward, fp32 SIMT
template <int D>
struct FwdSmem {
  static constexpr int R = tile_rows<D>(), LD = ld_of(D), LDS = ldf_of(R), LDP = ld_of(R),
                       LDO = ldf_of(D);
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(float) * R * LD);
  static constexpr size_t v = k + align128(sizeof(float) * R * LD);
  static constexpr size_t s = v + align128(sizeof(float) * R * LD);
  static constexpr size_t p = s + align128(sizeof(float) * R * LDS);
  static constexpr size_t o = p + align128(sizeof(float) * R * LDP);
  static constexpr size_t bytes = o + align128(sizeof(float) * R * LDO);
  static_assert(bytes <= kMaxSmem, "the forward tiles fit a block");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int t_len, int n_heads, float scale,
                   Head hd) {
  using L = FwdSmem<D>;
  constexpr int R = L::R, kWidth = kThreads / R, kPer = R / kWidth;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q);
  float* ks = reinterpret_cast<float*>(smem + L::k);
  float* vs = reinterpret_cast<float*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* os = reinterpret_cast<float*>(smem + L::o);

  const int n_tiles = (t_len + R - 1) / R;
  const int qt = n_tiles - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, q0 = qt * R;
  const int row = threadIdx.x / kWidth, part = threadIdx.x % kWidth;

  load_rows<D, R>(qs, L::LD, q, b, h, q0, t_len, n_heads, hd);
  for (int e = threadIdx.x; e < R * D; e += kThreads) os[(e / D) * L::LDO + e % D] = 0.0f;
  float m = -INFINITY, l = 0.0f;  // this row's running max and sum

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * R;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_rows<D, R>(ks, L::LD, k, b, h, k0, t_len, n_heads, hd);
    load_rows<D, R>(vs, L::LD, v, b, h, k0, t_len, n_heads, hd);
    __syncthreads();
    tile_mm<false, true, R, R, D>(ss, L::LDS, qs, L::LD, ks, L::LD, false);
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
      ps[row * L::LDP + part + j * kWidth] = p;
    }
    l = l * alpha + group_sum<kWidth>(sum);
    m = m_new;
    for (int d = part; d < D; d += kWidth) os[row * L::LDO + d] *= alpha;
    __syncthreads();
    tile_mm<false, false, R, D, R>(os, L::LDO, ps, L::LDP, vs, L::LD, true);
  }
  __syncthreads();
  // normalise in place, then write O and lse
  const float inv_l = 1.0f / l;
  for (int d = part; d < D; d += kWidth) os[row * L::LDO + d] *= inv_l;
  if (part == 0 && q0 + row < t_len)
    lse[(static_cast<size_t>(b) * n_heads + h) * t_len + q0 + row] = m + logf(l);
  __syncthreads();
  store_rows<D, R>(o, os, L::LDO, 1.0f, b, h, q0, t_len, n_heads, hd);
}

// ---------------------------------------------------- backward, fp32 SIMT
// The two kernels share the recomputation of one (query tile, key tile)
// pair: S = Q K^T and dP = dO V^T into fp32 tiles, then
//   P = exp(S * scale - lse) where key <= query < T (else 0),
//   dS = P * (dP - delta), into their own tiles.
template <int D>
struct BwdSmem {
  using T = float;
  static constexpr int R = tile_rows<D>(), LD = ld_of(D),
                       LDS = ldf_of(R), LDP = ld_of(R), LDA = ldf_of(D);
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
  static_assert(bytes_dkv <= kMaxSmem, "the dK/dV tiles fit a block");
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
                      int n_heads, float scale, Head hd) {
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

  load_rows<D, R>(qs, L::LD, q, b, h, q0, t_len, n_heads, hd);
  load_rows<D, R>(dos, L::LD, dout, b, h, q0, t_len, n_heads, hd);
  for (int e = threadIdx.x; e < R * D; e += kThreads)
    dqs[(e / D) * L::LDA + e % D] = 0.0f;
  {
    const int row = threadIdx.x / kWidth, part = threadIdx.x % kWidth;
    const int qi = q0 + row;
    float acc = 0.0f;
    if (qi < t_len) {
      const size_t base = row_at(b, qi, h, t_len, n_heads, hd.d);
      for (int d = part; d < hd.d; d += kWidth) acc += dout[base + d] * o[base + d];
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
    load_rows<D, R>(ks, L::LD, k, b, h, k0, t_len, n_heads, hd);
    load_rows<D, R>(vs, L::LD, v, b, h, k0, t_len, n_heads, hd);
    __syncthreads();
    tile_mm<false, true, R, R, D>(ss, L::LDS, qs, L::LD, ks, L::LD, false);
    tile_mm<false, true, R, R, D>(dps, L::LDS, dos, L::LD, vs, L::LD, false);
    __syncthreads();
    probs_and_dscores<D>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<false, false, R, D, R>(dqs, L::LDA, dss, L::LDP, ks, L::LD, true);
  }
  __syncthreads();
  store_rows<D, R>(dq, dqs, L::LDA, scale, b, h, q0, t_len, n_heads, hd);
}

// dK and dV, one block per (b, h, key tile); query tiles diagonal .. end.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int t_len,
                       int n_heads, float scale, Head hd) {
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

  load_rows<D, R>(ks, L::LD, k, b, h, k0, t_len, n_heads, hd);
  load_rows<D, R>(vs, L::LD, v, b, h, k0, t_len, n_heads, hd);
  for (int e = threadIdx.x; e < R * D; e += kThreads) {
    dks[(e / D) * L::LDA + e % D] = 0.0f;
    dvs[(e / D) * L::LDA + e % D] = 0.0f;
  }

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * R;
    __syncthreads();
    load_rows<D, R>(qs, L::LD, q, b, h, q0, t_len, n_heads, hd);
    load_rows<D, R>(dos, L::LD, dout, b, h, q0, t_len, n_heads, hd);
    for (int r = threadIdx.x; r < R; r += kThreads) {
      const bool in = q0 + r < t_len;
      lse_s[r] = in ? lse[stat0 + q0 + r] : 0.0f;
      delta_s[r] = in ? delta[stat0 + q0 + r] : 0.0f;
    }
    __syncthreads();
    tile_mm<false, true, R, R, D>(ss, L::LDS, qs, L::LD, ks, L::LD, false);
    tile_mm<false, true, R, R, D>(dps, L::LDS, dos, L::LD, vs, L::LD, false);
    __syncthreads();
    probs_and_dscores<D>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<true, false, R, D, R>(dvs, L::LDA, ps, L::LDP, dos, L::LD, true);
    tile_mm<true, false, R, D, R>(dks, L::LDA, dss, L::LDP, qs, L::LD, true);
  }
  __syncthreads();
  store_rows<D, R>(dk, dks, L::LDA, scale, b, h, k0, t_len, n_heads, hd);
  store_rows<D, R>(dv, dvs, L::LDA, 1.0f, b, h, k0, t_len, n_heads, hd);
}

// ------------------------------------------------- bf16 (tensor cores)
// mma.sync m16n8k16 on ldmatrix fragments; the helpers and the fragment
// layouts are in mma.cuh.

constexpr int kMmaWarps = 4, kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // rows of a tile, 16 per warp
constexpr int kStages = 2;                // depth of the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
constexpr float kLn2 = 0.6931471805599453f;     // and back: x = x log2 e * ln 2
static_assert(kMmaThreads == 2 * kMmaRows, "one thread per lse / delta entry");

template <int D>
struct MmaSmem {
  // rows 16 bytes apart modulo 128: ldmatrix's 8 row reads hit 8 bank groups
  static constexpr int LD = D + 8;
  static constexpr int tile = kMmaRows * LD;  // bf16 elements of one tile
  static constexpr size_t tiles = (2 + 2 * kStages) * sizeof(bf16) * tile;
  // forward: Q, then kStages x (K, V);
  // dQ: Q, dO, then kStages x (K, V);
  // dK/dV: K, V, kStages x (Q, dO), then kStages x (lse, delta) in fp32
  static constexpr size_t bytes_fwd = tiles - sizeof(bf16) * tile;
  static constexpr size_t bytes_dq = tiles;
  static constexpr size_t bytes_dkv = tiles + kStages * 2 * kMmaRows * sizeof(float);
  static_assert(bytes_dkv <= kMaxSmem, "the dK/dV tiles fit a block");
};

// rows [row0, row0 + 64) of head h of a (B, T, H, d) bf16 tensor into a
// shared tile (leading dim D + 8) by cp.async. !kAny: d == D in 16-byte
// copies, the stride known at compile time. kAny: 16-byte copies when the
// head is wide, else copies of hd.vec elements (8, 4 or 2 bytes; one
// element by a plain load and store). Rows >= T and columns >= d are
// zero-filled. The caller commits the group.
template <int D, bool kAny>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int b,
                                                int h, int row0, int t_len,
                                                int n_heads, Head hd) {
  constexpr int LD = MmaSmem<D>::LD, kChunks = D / 8;
  static_assert(kMmaRows * kChunks % kMmaThreads == 0, "whole chunks per thread");
  if constexpr (!kAny) {
#pragma unroll
    for (int i = 0; i < kMmaRows * kChunks / kMmaThreads; ++i) {
      const int e = threadIdx.x + i * kMmaThreads;
      const int r = e / kChunks, ch = e % kChunks, t = row0 + r;
      const bool in = t < t_len;
      const bf16* from = in ? src + row_at(b, t, h, t_len, n_heads, D) + ch * 8 : src;
      cp_async16(dst + r * LD + ch * 8, from, in);
    }
    return;
  }
  if (hd.wide<bf16>()) {
#pragma unroll
    for (int i = 0; i < kMmaRows * kChunks / kMmaThreads; ++i) {
      const int e = threadIdx.x + i * kMmaThreads;
      const int r = e / kChunks, ch = e % kChunks, t = row0 + r;
      const bool in = t < t_len && ch * 8 < hd.d;
      const bf16* from = in ? src + row_at(b, t, h, t_len, n_heads, hd.d) + ch * 8 : src;
      cp_async16(dst + r * LD + ch * 8, from, in);
    }
    return;
  }
  const int per = D / hd.vec;  // copies a row; vec (1, 2, 4 or 8) divides D
  for (int e = threadIdx.x; e < kMmaRows * per; e += kMmaThreads) {
    const int r = e / per, col = (e - r * per) * hd.vec, t = row0 + r;
    const bool in = t < t_len && col < hd.d;  // then all vec columns are < d
    const bf16* from = in ? src + row_at(b, t, h, t_len, n_heads, hd.d) + col : src;
    bf16* to = dst + r * LD + col;
    switch (hd.vec) {
      case 8: cp_async16(to, from, in); break;
      case 4: cp_async8(to, from, in); break;
      case 2: cp_async4(to, from, in); break;
      default: *to = in ? *from : __float2bfloat16(0.0f);
    }
  }
}

// a warp's 16 x DO fp32 accumulator (C fragments) times `mul`, rounded to
// bf16 into its 16 rows of a shared tile, then out to columns [col0, col0 +
// DO) of rows [row0, row0 + 16) of head h: in 16-byte stores (!kAny: d ==
// D, the stride known at compile time; kAny: when the head is wide), else
// an element at a time (rows >= T and columns >= d are not written)
template <int D, int DO, bool kAny>
__device__ __forceinline__ void store_strip(bf16* dst, bf16* stage,
                                            const float (&acc)[DO / 8][4], float mul,
                                            int b, int h, int row0, int t_len,
                                            int n_heads, int lane, Head hd, int col0) {
  constexpr int LD = MmaSmem<D>::LD, kChunks = DO / 8;
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * LD + 8 * j + 2 * c) =
        pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + 8 * j + 2 * c) =
        pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
  __syncwarp();
  if constexpr (!kAny) {
#pragma unroll
    for (int i = 0; i < 16 * kChunks / 32; ++i) {
      const int e = lane + 32 * i, r = e / kChunks, ch = e % kChunks, t = row0 + r;
      if (t < t_len) {
        *reinterpret_cast<uint4*>(dst + row_at(b, t, h, t_len, n_heads, D) + col0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(stage + r * LD + ch * 8);
      }
    }
    return;
  }
  if (hd.wide<bf16>()) {
#pragma unroll
    for (int i = 0; i < 16 * kChunks / 32; ++i) {
      const int e = lane + 32 * i, r = e / kChunks, ch = e % kChunks, t = row0 + r;
      if (t < t_len && col0 + ch * 8 < hd.d) {
        *reinterpret_cast<uint4*>(dst + row_at(b, t, h, t_len, n_heads, hd.d) + col0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(stage + r * LD + ch * 8);
      }
    }
    return;
  }
  for (int e = lane; e < 16 * DO; e += 32) {
    const int r = e / DO, col = e % DO, t = row0 + r;
    if (t < t_len && col0 + col < hd.d) {
      dst[row_at(b, t, h, t_len, n_heads, hd.d) + col0 + col] = stage[r * LD + col];
    }
  }
}

// Forward, one block per (b, h, query tile); key tiles 0 .. diagonal stream
// through the ring. The tile is the grid's slowest dimension, counted from
// the last: the longest rows of every head start first and the short ones
// fill the tail (faster on an H100 at B=8 H=8 T=2047 D=64 than
// longest-first within each head only). Warp w owns query rows 16w ..
// 16w + 15: S = Q_w K^T (16 x 64, registers) scaled to base-2 units, the
// online softmax on its C fragments, O_w = O_w alpha + P V (P as the A
// operand, V via ldmatrix.trans); at the end O_w / l and lse = m ln 2 +
// log l, the natural-log statistic the backward kernels read. At D = 256
// the block owns output columns [col0, col0 + 128) of its heads' pair of
// blocks (blockIdx.x = head * 2 + half); both halves write the same lse,
// the first half stores it.
template <int D, bool kAny>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int t_len, int n_heads, float scale,
                  Head hd) {
  using L = MmaSmem<D>;
  constexpr int LD = L::LD, kSteps = D / 16, DO = out_cols<D>(), kSplit = D / DO;
  constexpr bool kHold = D <= 64;  // Q_w fragments in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ring = qs + L::tile;  // stage s: K at ring + 2 s tiles, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (t_len + kMmaRows - 1) / kMmaRows;
  const int qt = n_tiles - 1 - blockIdx.z;
  // a head's blocks, one a half of D = 256's output columns
  const int h = kSplit == 1 ? blockIdx.x : blockIdx.x / kSplit;
  const int col0 = kSplit == 1 ? 0 : blockIdx.x % kSplit * DO;
  const int b = blockIdx.y, q0 = qt * kMmaRows;
  const int row_w = q0 + 16 * warp;  // this warp's first query row

  auto load_stage = [&](int kt) {
    bf16* ks = ring + 2 * (kt % kStages) * L::tile;
    load_tile_async<D, kAny>(ks, k, b, h, kt * kMmaRows, t_len, n_heads, hd);
    load_tile_async<D, kAny>(ks + L::tile, v, b, h, kt * kMmaRows, t_len, n_heads, hd);
  };
  load_tile_async<D, kAny>(qs, q, b, h, q0, t_len, n_heads, hd);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s <= qt) load_stage(s);
    cp_async_commit();
  }

  const int qi_lo = row_w + g, qi_hi = qi_lo + 8;  // the rows of c0, c1 and c2, c3
  const float scale2 = scale * kLog2e;             // exp(S scale) = exp2(S scale2)
  const bf16* qw = qs + 16 * warp * LD + lane_a(lane, LD);
  const int off_b = lane_b(lane, LD), off_bt = lane_bt(lane, LD);
  uint32_t qf[kHold ? kSteps : 1][4];
  float acc[DO / 8][4] = {};
  // per row: the running max in base-2 units, and this lane's share of the
  // running sum (its 16 columns of each tile), reduced over the quad at the end
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;

  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt is in for every thread; tile kt - 1's slot is free
    if (kt + kStages - 1 <= qt) load_stage(kt + kStages - 1);
    cp_async_commit();
    if (kHold && kt == 0) {
#pragma unroll
      for (int kk = 0; kk < (kHold ? kSteps : 0); ++kk) ldsm4(qf[kk], qw + 16 * kk);
    }
    const bf16* ks = ring + 2 * (kt % kStages) * L::tile;
    const bf16* vs = ks + L::tile;

    float sc[kMmaRows / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t qa[4];
      if constexpr (kHold) {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qf[kk][i];
      } else {
        ldsm4(qa, qw + 16 * kk);
      }
#pragma unroll
      for (int j = 0; j < kMmaRows / 16; ++j) {
        uint32_t fb[4];
        ldsm4(fb, ks + 16 * j * LD + 16 * kk + off_b);
        mma_bf16(sc[2 * j], qa, fb[0], fb[1]);
        mma_bf16(sc[2 * j + 1], qa, fb[2], fb[3]);
      }
    }
    // base-2 scores; keys above the diagonal only on its tile (there key >
    // query also covers every key >= T of a row < T); the tile's row max
    const bool diag = kt == qt;
    const int k0 = kt * kMmaRows;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMmaRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const int key = k0 + 8 * j + 2 * c + (e & 1);
        float s2 = sc[j][e] * scale2;
        if (diag && key > (lo ? qi_lo : qi_hi)) s2 = -INFINITY;
        sc[j][e] = s2;
        if (lo) {
          mx_lo = fmaxf(mx_lo, s2);
        } else {
          mx_hi = fmaxf(mx_hi, s2);
        }
      }
    }
    // finite: key k0 <= query on every tile
    const float mn_lo = fmaxf(m_lo, group_max<4>(mx_lo));
    const float mn_hi = fmaxf(m_hi, group_max<4>(mx_hi));
    const float alpha_lo = exp2f(m_lo - mn_lo), alpha_hi = exp2f(m_hi - mn_hi);  // 0 first
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int j = 0; j < DO / 8; ++j) {
      acc[j][0] *= alpha_lo;
      acc[j][1] *= alpha_lo;
      acc[j][2] *= alpha_hi;
      acc[j][3] *= alpha_hi;
    }
#pragma unroll
    for (int j = 0; j < kMmaRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float p = exp2f(sc[j][e] - (lo ? m_lo : m_hi));
        sc[j][e] = p;
        if (lo) {
          l_lo += p;
        } else {
          l_hi += p;
        }
      }
    }
    // O_w += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < kMmaRows / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < DO / 16; ++j) {
        uint32_t fb[4];
        ldsm4_t(fb, vs + 16 * kk * LD + col0 + 16 * j + off_bt);
        mma_bf16(acc[2 * j], pa, fb[0], fb[1]);
        mma_bf16(acc[2 * j + 1], pa, fb[2], fb[3]);
      }
    }
  }
  l_lo = group_sum<4>(l_lo);
  l_hi = group_sum<4>(l_hi);
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    acc[j][0] *= inv_lo;
    acc[j][1] *= inv_lo;
    acc[j][2] *= inv_hi;
    acc[j][3] *= inv_hi;
  }
  if (c == 0 && col0 == 0) {
    const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;
    if (qi_lo < t_len) lse[stat0 + qi_lo] = m_lo * kLn2 + logf(l_lo);
    if (qi_hi < t_len) lse[stat0 + qi_hi] = m_hi * kLn2 + logf(l_hi);
  }
  __syncthreads();
  store_strip<D, DO, kAny>(o, qs + 16 * warp * LD, acc, 1.0f, b, h, row_w, t_len, n_heads,
                     lane, hd, col0);
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
//   ldmatrix.trans). Its prologue writes delta = rowsum(dO * O). At D =
//   256 the block owns dQ's columns [col0, col0 + 128) (blockIdx.y = head *
//   2 + half); the first half writes delta.
template <int D, bool kAny>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ o,
                     const bf16* __restrict__ dout, const float* __restrict__ lse,
                     float* __restrict__ delta, bf16* __restrict__ dq, int t_len,
                     int n_heads, float scale, Head hd) {
  using L = MmaSmem<D>;
  constexpr int LD = L::LD, kSteps = D / 16, DO = out_cols<D>(), kSplit = D / DO;
  constexpr bool kHold = D <= 64;  // Q_w and dO_w fragments in registers
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + L::tile;
  bf16* ring = dos + L::tile;  // stage s: K at ring + 2 s tiles, V after it

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (t_len + kMmaRows - 1) / kMmaRows;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = kSplit == 1 ? blockIdx.y : blockIdx.y / kSplit;
  const int col0 = kSplit == 1 ? 0 : blockIdx.y % kSplit * DO;
  const int b = blockIdx.z, q0 = qt * kMmaRows;
  const int row_w = q0 + 16 * warp;  // this warp's first query row
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  auto load_stage = [&](int kt) {
    bf16* ks = ring + 2 * (kt % kStages) * L::tile;
    load_tile_async<D, kAny>(ks, k, b, h, kt * kMmaRows, t_len, n_heads, hd);
    load_tile_async<D, kAny>(ks + L::tile, v, b, h, kt * kMmaRows, t_len, n_heads, hd);
  };
  load_tile_async<D, kAny>(qs, q, b, h, q0, t_len, n_heads, hd);
  load_tile_async<D, kAny>(dos, dout, b, h, q0, t_len, n_heads, hd);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s <= qt) load_stage(s);
    cp_async_commit();
  }

  // delta of the warp's rows, two lanes per row (a half row each, !kAny;
  // else alternate 16-byte chunks when the head is wide, else alternate
  // columns), while the tiles load
  float dsum = 0.0f;
  {
    const int t = row_w + lane / 2;
    if (!kAny && t < t_len) {
      const size_t base = row_at(b, t, h, t_len, n_heads, D) + (lane & 1) * (D / 2);
#pragma unroll
      for (int i = 0; i < D / 16; ++i)
        dsum += dot8(*reinterpret_cast<const uint4*>(dout + base + 8 * i),
                     *reinterpret_cast<const uint4*>(o + base + 8 * i));
    } else if (kAny && t < t_len && hd.wide<bf16>()) {
      const size_t base = row_at(b, t, h, t_len, n_heads, hd.d);
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const int col = 8 * (2 * i + (lane & 1));
        if (col < hd.d)
          dsum += dot8(*reinterpret_cast<const uint4*>(dout + base + col),
                       *reinterpret_cast<const uint4*>(o + base + col));
      }
    } else if (kAny && t < t_len) {
      const size_t base = row_at(b, t, h, t_len, n_heads, hd.d);
      for (int i = lane & 1; i < hd.d; i += 2)
        dsum = fmaf(__bfloat162float(dout[base + i]), __bfloat162float(o[base + i]), dsum);
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if ((lane & 1) == 0 && t < t_len && col0 == 0) delta[stat0 + t] = dsum;
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
  float acc[DO / 8][4] = {};

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
      for (int j = 0; j < DO / 16; ++j) {
        uint32_t fb[4];
        ldsm4_t(fb, ks + 16 * kk * LD + col0 + 16 * j + off_bt);
        mma_bf16(acc[2 * j], sa, fb[0], fb[1]);
        mma_bf16(acc[2 * j + 1], sa, fb[2], fb[3]);
      }
    }
  }
  __syncthreads();
  store_strip<D, DO, kAny>(dq, qs + 16 * warp * LD, acc, scale, b, h, row_w, t_len, n_heads,
                     lane, hd, col0);
}

// dK and dV, one block per (b, h, key tile), the longest column first; query
// tiles diagonal .. end stream through the ring with their lse and delta.
// Warp w owns key rows 16w .. 16w + 15 and works on the transposed scores:
//   S^T = K_w Q^T, dP^T = V_w dO^T (16 x kCols, registers; Q and dO stored
//   row by row are already the col-major B operands), P^T = exp(S^T * scale
//   - lse[query]), dS^T = P^T (dP^T - delta[query]), dV_w += P^T dO,
//   dK_w += dS^T Q (dO and Q via ldmatrix.trans). At D = 256 the block owns
//   dK's and dV's columns [col0, col0 + 128) (blockIdx.y = head * 2 + half).
template <int D, bool kAny>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
                      int n_heads, float scale, Head hd) {
  using L = MmaSmem<D>;
  constexpr int LD = L::LD, kSteps = D / 16, DO = out_cols<D>(), kSplit = D / DO;
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
  const int h = kSplit == 1 ? blockIdx.y : blockIdx.y / kSplit;
  const int col0 = kSplit == 1 ? 0 : blockIdx.y % kSplit * DO;
  const int b = blockIdx.z, k0 = kt * kMmaRows;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  // stage s holds Q, dO, and lse then delta (the first 64 threads copy lse)
  auto load_stage = [&](int qt) {
    const int s = (qt - kt) % kStages, q0 = qt * kMmaRows;
    bf16* qs = ring + 2 * s * L::tile;
    load_tile_async<D, kAny>(qs, q, b, h, q0, t_len, n_heads, hd);
    load_tile_async<D, kAny>(qs + L::tile, dout, b, h, q0, t_len, n_heads, hd);
    const int r = threadIdx.x % kMmaRows;
    const float* src = threadIdx.x < kMmaRows ? lse : delta;
    const bool in = q0 + r < t_len;
    cp_async4(stats + 2 * s * kMmaRows + threadIdx.x, in ? src + stat0 + q0 + r : src,
              in);
  };
  load_tile_async<D, kAny>(ks, k, b, h, k0, t_len, n_heads, hd);
  load_tile_async<D, kAny>(vs, v, b, h, k0, t_len, n_heads, hd);
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
  float dk_acc[DO / 8][4] = {}, dv_acc[DO / 8][4] = {};

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
        for (int j = 0; j < DO / 16; ++j) {
          uint32_t fb[4];
          ldsm4_t(fb, dos + (c0 + 16 * kk) * LD + col0 + 16 * j + off_bt);
          mma_bf16(dv_acc[2 * j], pa, fb[0], fb[1]);
          mma_bf16(dv_acc[2 * j + 1], pa, fb[2], fb[3]);
          ldsm4_t(fb, qs + (c0 + 16 * kk) * LD + col0 + 16 * j + off_bt);
          mma_bf16(dk_acc[2 * j], sa, fb[0], fb[1]);
          mma_bf16(dk_acc[2 * j + 1], sa, fb[2], fb[3]);
        }
      }
    }
  }
  __syncthreads();
  store_strip<D, DO, kAny>(dk, ks + 16 * warp * LD, dk_acc, scale, b, h, k0 + 16 * warp,
                     t_len, n_heads, lane, hd, col0);
  store_strip<D, DO, kAny>(dv, vs + 16 * warp * LD, dv_acc, 1.0f, b, h, k0 + 16 * warp,
                     t_len, n_heads, lane, hd, col0);
}

struct Shape {
  int b, t, h;
  Head hd;
};

// head sizes past 256 that are multiples of 128: the D-chunked kernels of
// flash_attention_chunked.cu (one code path for every such D)
inline bool chunked_head(int d) { return d > 256 && d % 128 == 0; }
cudaError_t fwd_chunked(const void* q, const void* k, const void* v, void* o, float* lse,
                        Shape s, float scale, int is_bf16, cudaStream_t st);
cudaError_t bwd_dq_chunked(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq,
                           Shape s, float scale, int is_bf16, cudaStream_t st);
cudaError_t bwd_dkv_chunked(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            Shape s, float scale, int is_bf16, cudaStream_t st);

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// blocks along the heads' grid dimension of a bf16 kernel: a head's output
// columns are split D / DO ways
template <int D>
constexpr int head_blocks(int n_heads) {
  return n_heads * (D / out_cols<D>());
}

// kAny: the bf16 kernels for any head (kAny of the kernels); the fp32
// kernels take any head either way and are launched with kAny true
template <typename T, int D, bool kAny>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                Shape s, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = MmaSmem<D>::bytes_fwd;
    auto kernel = flash_fwd_mma<D, kAny>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    // tiles last: a launch error past 65,535 tiles (T > 4,194,240)
    const dim3 grid(head_blocks<D>(s.h), s.b, (s.t + kMmaRows - 1) / kMmaRows);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s.t, s.h, scale, s.hd);
  } else {
    constexpr int R = tile_rows<D>();
    constexpr size_t smem = FwdSmem<D>::bytes;
    auto kernel = flash_fwd_simt<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + R - 1) / R, s.h, s.b);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, s.t, s.h, scale, s.hd);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kAny>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq,
                   Shape s, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = MmaSmem<D>::bytes_dq;
    auto kernel = flash_bwd_dq_mma<D, kAny>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kMmaRows - 1) / kMmaRows, head_blocks<D>(s.h), s.b);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), s.t,
        s.h, scale, s.hd);
  } else {
    constexpr int R = tile_rows<D>();
    constexpr size_t smem = BwdSmem<D>::bytes_dq;
    auto kernel = flash_bwd_dq_simt<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + R - 1) / R, s.h, s.b);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta,
        static_cast<T*>(dq), s.t, s.h, scale, s.hd);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool kAny>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, Shape s, float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr size_t smem = MmaSmem<D>::bytes_dkv;
    auto kernel = flash_bwd_dkv_mma<D, kAny>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kMmaRows - 1) / kMmaRows, head_blocks<D>(s.h), s.b);
    kernel<<<grid, kMmaThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.t, s.h, scale, s.hd);
  } else {
    constexpr int R = tile_rows<D>();
    constexpr size_t smem = BwdSmem<D>::bytes_dkv;
    auto kernel = flash_bwd_dkv_simt<D>;
    cudaError_t err = prepare(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + R - 1) / R, s.h, s.b);
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
        static_cast<T*>(dv), s.t, s.h, scale, s.hd);
  }
  return cudaGetLastError();
}

// the explicit instantiations of one (T, D, kAny): PREFIX is extern where
// they are declared, empty where they are defined
#define MQGAN_FLASH_SIZE(PREFIX, T, D, ANY)                                      \
  PREFIX template cudaError_t fwd<T, D, ANY>(const void*, const void*,          \
                                             const void*, void*, float*, Shape, \
                                             float, cudaStream_t);              \
  PREFIX template cudaError_t bwd_dq<T, D, ANY>(const void*, const void*,       \
                                                const void*, const void*,       \
                                                const void*, const float*,      \
                                                float*, void*, Shape, float,    \
                                                cudaStream_t);                  \
  PREFIX template cudaError_t bwd_dkv<T, D, ANY>(const void*, const void*,      \
                                                 const void*, const void*,      \
                                                 const float*, const float*,    \
                                                 void*, void*, Shape, float,    \
                                                 cudaStream_t);
// what each translation unit beside flash_attention.cu (which instantiates
// D = 32, 64, 128 of heads that fill their tiles, and of fp32) builds:
// flash_attention_wide.cu the same at D = 96 and, fp32 only, 256,
// flash_attention_any.cu the bf16 kernels for any head at D = 32, 64, 128,
// flash_attention_any_wide.cu those at D = 96 and 256
#define MQGAN_FLASH_WIDE_SIZES(PREFIX)                                           \
  MQGAN_FLASH_SIZE(PREFIX, float, 96, true)                                      \
  MQGAN_FLASH_SIZE(PREFIX, __nv_bfloat16, 96, false)                             \
  MQGAN_FLASH_SIZE(PREFIX, float, 256, true)
#define MQGAN_FLASH_ANY_SIZES(PREFIX)                                            \
  MQGAN_FLASH_SIZE(PREFIX, __nv_bfloat16, 32, true)                              \
  MQGAN_FLASH_SIZE(PREFIX, __nv_bfloat16, 64, true)                              \
  MQGAN_FLASH_SIZE(PREFIX, __nv_bfloat16, 128, true)
#define MQGAN_FLASH_ANY_WIDE_SIZES(PREFIX)                                       \
  MQGAN_FLASH_SIZE(PREFIX, __nv_bfloat16, 96, true)                              \
  MQGAN_FLASH_SIZE(PREFIX, __nv_bfloat16, 256, true)

}  // namespace mqgan_flash
