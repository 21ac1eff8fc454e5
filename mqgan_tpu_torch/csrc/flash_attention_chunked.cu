// Causal flash attention at head sizes past 256 that are multiples of 128
// (384, 512, ...): the forward and the two backward kernels, fp32 and bf16,
// one code path for every such D (D is a runtime argument).
//
// Replaces: the same Pallas TPU kernels as flash_attention.cuh (JAX's
// _flash_attention_impl, _flash_attention_bwd_dkv, _flash_attention_bwd_dq),
// at the head sizes JAX's kernel takes past 256 (any multiple of 128).
//
// What bounds it: operations, as at every D (flash_attention.cuh). What the
// design does about D: the whole-D tiles of flash_attention.cuh hold a block
// of 64 rows x D columns of several operands in shared memory and a 16 x D
// fp32 accumulator a warp in registers, neither of which fits past D = 256.
// Here a block owns 128 output columns (G = D / 128 column groups; the
// heads' grid dimension is head * G + group) and the products over D -- the
// score tile S = Q K^T and, in the backward, dP = dO V^T -- are summed over
// D in 128-column chunks streamed through shared memory:
//   - bf16: mma.sync m16n8k16 on ldmatrix fragments, a two-stage cp.async
//     ring of chunk tiles (the next chunk in flight while this one
//     multiplies), one barrier a chunk; S and dP accumulate in registers
//     across the chunks, then the online softmax (forward) or P and dS
//     (backward) run on them as in flash_attention.cuh;
//   - fp32: the SIMT tiles of flash_attention.cuh at D = 128, the chunk's
//     products accumulated into the shared score tiles.
// Shared memory does not depend on D. The forward sums S over the chunks in
// order 0 .. G-1 in every group, so the groups agree on lse; the backward
// takes the chunks in the order group + 1, ..., group (mod G), so that the
// last chunk in the stage is the group's own columns of K (dQ += dS K) or of
// Q and dO (dK += dS^T Q, dV += P^T dO), used where they lie. The dK/dV
// kernels stream 32-row query tiles, so that S^T and dP^T (16 x 32 a warp)
// and the two 16 x 128 accumulators fit a thread's registers.
//
// Every output tile is owned by one block and written once: the results are
// bit-identical from run to run. The rows past T and the causal mask are
// handled as in flash_attention.cuh. The grid bounds a launch: H * D / 128 <=
// 65,535 and B <= 65,535 (and, bf16 forward, T <= 4,194,240).

#include "flash_attention.cuh"

namespace mqgan_flash {

namespace {

constexpr int kCh = 128;  // columns of a chunk and of an output group
using MS = MmaSmem<kCh>;  // bf16 tiles of 64 rows x kCh, leading dim kCh + 8
constexpr int kLd = MS::LD;
constexpr int kTile = MS::tile;
constexpr int kQRows = 32;  // query rows of a dK/dV step (bf16)

// rows [row0, row0 + rows) of head h, columns [0, kCh) of `src` (already
// offset to the chunk's first column), into a shared tile of leading dim kLd
// by cp.async in copies of hd.vec elements (16 bytes when the head is wide);
// rows >= T are zero-filled. d is a multiple of kCh, so every column is in.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int b, int h,
                                           int row0, int rows, int t_len, int n_heads,
                                           Head hd) {
  const int per = kCh / hd.vec;  // copies a row
  for (int e = threadIdx.x; e < rows * per; e += kMmaThreads) {
    const int r = e / per, col = (e - r * per) * hd.vec, t = row0 + r;
    const bool in = t < t_len;
    const bf16* from = in ? src + row_at(b, t, h, t_len, n_heads, hd.d) + col : src;
    bf16* to = dst + r * kLd + col;
    switch (hd.vec) {
      case 8: cp_async16(to, from, in); break;
      case 4: cp_async8(to, from, in); break;
      case 2: cp_async4(to, from, in); break;
      default: *to = in ? *from : __float2bfloat16(0.0f);
    }
  }
}

// sc (16 x 8 * NT, C fragments) += A_w . B^T over one 128-column chunk: A_w
// the warp's 16 rows of a shared tile (ldmatrix offsets in aw), B the first
// 16 * NT / 2 rows of another stored row by row ([n][k])
template <int NT>
__device__ __forceinline__ void chunk_mm(float (&sc)[NT][4], const bf16* aw, const bf16* bs,
                                         int off_b) {
#pragma unroll
  for (int kk = 0; kk < kCh / 16; ++kk) {
    uint32_t qa[4];
    ldsm4(qa, aw + 16 * kk);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t fb[4];
      ldsm4(fb, bs + 16 * j * kLd + 16 * kk + off_b);
      mma_bf16(sc[2 * j], qa, fb[0], fb[1]);
      mma_bf16(sc[2 * j + 1], qa, fb[2], fb[3]);
    }
  }
}

// ---------------------------------------------------------- bf16 forward
// One block per (b, head * G + group, 64-row query tile), the longest rows
// first (the tile counted from the last in blockIdx.z, as flash_fwd_mma).
// A key tile takes G + 1 steps of the ring: chunks 0 .. G-1 of Q and K (S
// accumulates), then the key tile's V columns [col0, col0 + 128) (the
// online softmax and O += P V). Two tiles a stage keep the ring at 70 KB,
// so that three blocks share an SM.
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_chunked(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int t_len, int n_heads, float scale,
                          Head hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // stage s: Q (or V) at 2 s tiles, K after
  const int n_groups = hd.d / kCh, per_tile = n_groups + 1;  // steps a key tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (t_len + kMmaRows - 1) / kMmaRows;
  const int qt = n_tiles - 1 - blockIdx.z;
  const int h = blockIdx.x / n_groups, grp = blockIdx.x % n_groups, col0 = grp * kCh;
  const int b = blockIdx.y, q0 = qt * kMmaRows;
  const int row_w = q0 + 16 * warp;
  const int steps = (qt + 1) * per_tile;

  auto load_step = [&](int i) {
    const int kt = i / per_tile, ch = i % per_tile;
    bf16* qs = ring + 2 * (i % 2) * kTile;
    if (ch == n_groups) {
      load_chunk(qs, v + col0, b, h, kt * kMmaRows, kMmaRows, t_len, n_heads, hd);
      return;
    }
    load_chunk(qs, q + ch * kCh, b, h, q0, kMmaRows, t_len, n_heads, hd);
    load_chunk(qs + kTile, k + ch * kCh, b, h, kt * kMmaRows, kMmaRows, t_len, n_heads, hd);
  };
  load_step(0);
  cp_async_commit();

  const int qi_lo = row_w + g, qi_hi = qi_lo + 8;
  const float scale2 = scale * kLog2e;
  const int off_a = 16 * warp * kLd + lane_a(lane, kLd);
  const int off_b = lane_b(lane, kLd), off_bt = lane_bt(lane, kLd);
  float acc[kCh / 8][4] = {};
  float sc[kMmaRows / 8][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();  // step i is in for every thread; step i - 1's stage is free
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    const int kt = i / per_tile, ch = i % per_tile;
    const bf16* qs = ring + 2 * (i % 2) * kTile;
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < kMmaRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    }
    if (ch < n_groups) {
      chunk_mm(sc, qs + off_a, qs + kTile, off_b);
      continue;
    }
    const bf16* vs = qs;  // the key tile's V columns

    // the key tile's scores are whole: the online softmax, then O += P V
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
    const float mn_lo = fmaxf(m_lo, group_max<4>(mx_lo));
    const float mn_hi = fmaxf(m_hi, group_max<4>(mx_hi));
    const float alpha_lo = exp2f(m_lo - mn_lo), alpha_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= alpha_lo;
    l_hi *= alpha_hi;
#pragma unroll
    for (int j = 0; j < kCh / 8; ++j) {
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
#pragma unroll
    for (int kk = 0; kk < kMmaRows / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kCh / 16; ++j) {
        uint32_t fb[4];
        ldsm4_t(fb, vs + 16 * kk * kLd + 16 * j + off_bt);
        mma_bf16(acc[2 * j], pa, fb[0], fb[1]);
        mma_bf16(acc[2 * j + 1], pa, fb[2], fb[3]);
      }
    }
  }
  l_lo = group_sum<4>(l_lo);
  l_hi = group_sum<4>(l_hi);
  const float inv_lo = 1.0f / l_lo, inv_hi = 1.0f / l_hi;
#pragma unroll
  for (int j = 0; j < kCh / 8; ++j) {
    acc[j][0] *= inv_lo;
    acc[j][1] *= inv_lo;
    acc[j][2] *= inv_hi;
    acc[j][3] *= inv_hi;
  }
  if (c == 0 && grp == 0) {
    const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;
    if (qi_lo < t_len) lse[stat0 + qi_lo] = m_lo * kLn2 + logf(l_lo);
    if (qi_hi < t_len) lse[stat0 + qi_hi] = m_hi * kLn2 + logf(l_hi);
  }
  __syncthreads();
  store_strip<kCh, kCh, true>(o, ring + 16 * warp * kLd, acc, 1.0f, b, h, row_w, t_len,
                              n_heads, lane, hd, col0);
}

// delta = rowsum(dO * O) of row t over all d columns, this lane's half
// (alternate 16-byte chunks, or alternate columns): the caller adds the pair
__device__ __forceinline__ float delta_half(const bf16* dout, const bf16* o, int b, int t,
                                            int h, int t_len, int n_heads, Head hd,
                                            int lane) {
  float dsum = 0.0f;
  if (t >= t_len) return dsum;
  const size_t base = row_at(b, t, h, t_len, n_heads, hd.d);
  if (hd.wide<bf16>()) {
    for (int col = 8 * (lane & 1); col < hd.d; col += 16)
      dsum += dot8(*reinterpret_cast<const uint4*>(dout + base + col),
                   *reinterpret_cast<const uint4*>(o + base + col));
  } else {
    for (int i = lane & 1; i < hd.d; i += 2)
      dsum = fmaf(__bfloat162float(dout[base + i]), __bfloat162float(o[base + i]), dsum);
  }
  return dsum;
}

// --------------------------------------------------------------- bf16 dQ
// One block per (64-row query tile, head * G + group, b), longest rows
// first. A key tile takes 2 G steps of two tiles each: for chunk c in the
// order group + 1, ..., group (mod G), first dO's and V's columns of c (dP
// accumulates), then Q's and K's (S accumulates); at the last step (the
// group's own columns of K in the stage) P, dS and dQ_w += dS K. Two tiles
// a stage keep the ring at 70 KB, so that two blocks share an SM. Its
// prologue writes delta (group 0).
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_chunked(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ o,
                             const bf16* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dq, int t_len,
                             int n_heads, float scale, Head hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  // stage s at 2 s tiles: dO's or Q's chunk, then V's or K's
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int n_groups = hd.d / kCh, per_tile = 2 * n_groups;  // steps a key tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int n_tiles = (t_len + kMmaRows - 1) / kMmaRows;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y / n_groups, grp = blockIdx.y % n_groups, col0 = grp * kCh;
  const int b = blockIdx.z, q0 = qt * kMmaRows;
  const int row_w = q0 + 16 * warp;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;
  const int steps = (qt + 1) * per_tile;

  auto load_step = [&](int i) {
    const int kt = i / per_tile, j = i % per_tile;
    const int ch = (grp + 1 + j / 2) % n_groups;
    const bool scores = j % 2;  // Q and K (S), else dO and V (dP)
    bf16* st = ring + 2 * (i % 2) * kTile;
    load_chunk(st, (scores ? q : dout) + ch * kCh, b, h, q0, kMmaRows, t_len, n_heads, hd);
    load_chunk(st + kTile, (scores ? k : v) + ch * kCh, b, h, kt * kMmaRows, kMmaRows, t_len,
               n_heads, hd);
  };
  load_step(0);
  cp_async_commit();

  float dsum = delta_half(dout, o, b, row_w + lane / 2, h, t_len, n_heads, hd, lane);
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  {
    const int t = row_w + lane / 2;
    if ((lane & 1) == 0 && t < t_len && grp == 0) delta[stat0 + t] = dsum;
  }
  const int qi_lo = row_w + g, qi_hi = qi_lo + 8;
  const float dl_lo = __shfl_sync(0xffffffffu, dsum, 2 * g);
  const float dl_hi = __shfl_sync(0xffffffffu, dsum, 2 * g + 16);
  const float scale2 = scale * kLog2e;
  const float lse_lo = qi_lo < t_len ? lse[stat0 + qi_lo] * kLog2e : 0.0f;
  const float lse_hi = qi_hi < t_len ? lse[stat0 + qi_hi] * kLog2e : 0.0f;
  const int off_a = 16 * warp * kLd + lane_a(lane, kLd);
  const int off_b = lane_b(lane, kLd), off_bt = lane_bt(lane, kLd);
  float acc[kCh / 8][4] = {};
  float sc[kMmaRows / 8][4], dp[kMmaRows / 8][4];

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    const bf16* st = ring + 2 * (i % 2) * kTile;
    const int step = i % per_tile;
    if (step == 0) {
#pragma unroll
      for (int j = 0; j < kMmaRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.0f;
    }
    if (step % 2) {
      chunk_mm(sc, st + off_a, st + kTile, off_b);
    } else {
      chunk_mm(dp, st + off_a, st + kTile, off_b);
    }
    if (step != per_tile - 1) continue;

    const int kt = i / per_tile, k0 = kt * kMmaRows;
    const bool diag = kt == qt;
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
    const bf16* ks = st + kTile;  // the group's columns of K
#pragma unroll
    for (int kk = 0; kk < kMmaRows / 16; ++kk) {
      uint32_t sa[4];
      c_to_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kCh / 16; ++j) {
        uint32_t fb[4];
        ldsm4_t(fb, ks + 16 * kk * kLd + 16 * j + off_bt);
        mma_bf16(acc[2 * j], sa, fb[0], fb[1]);
        mma_bf16(acc[2 * j + 1], sa, fb[2], fb[3]);
      }
    }
  }
  __syncthreads();
  store_strip<kCh, kCh, true>(dq, ring + 16 * warp * kLd, acc, scale, b, h, row_w, t_len,
                              n_heads, lane, hd, col0);
}

// ------------------------------------------------------------ bf16 dK/dV
// One block per (64-row key tile, head * G + group, b); warp w owns key
// rows 16w .. 16w + 15. Step i: 32-row query tile i / G (from the key
// tile's first row on), chunk (group + 1 + i % G) mod G of K, V, Q and dO,
// with the query tile's lse and delta; S^T = K_w Q^T and dP^T = V_w dO^T
// (16 x 32, registers) accumulate over the chunks; at the last chunk (the
// group's own columns of Q and dO) P^T, dS^T, dV_w += P^T dO, dK_w += dS^T Q.
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_chunked(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv, int t_len,
                              int n_heads, float scale, Head hd) {
  // stage s: K, V (64 rows each), Q, dO (32 rows each), then lse and delta
  constexpr int kStage = 3 * kTile;  // bf16 elements a stage
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* stats = reinterpret_cast<float*>(ring + 2 * kStage);  // 2 x (lse, delta) x 32
  const int n_groups = hd.d / kCh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int kt = blockIdx.x;
  const int h = blockIdx.y / n_groups, grp = blockIdx.y % n_groups, col0 = grp * kCh;
  const int b = blockIdx.z, k0 = kt * kMmaRows;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;
  const int qt0 = k0 / kQRows, n_qt = (t_len + kQRows - 1) / kQRows;
  const int steps = (n_qt - qt0) * n_groups;

  auto load_step = [&](int i) {
    const int q0 = (qt0 + i / n_groups) * kQRows;
    const int ch = (grp + 1 + i % n_groups) % n_groups;
    bf16* st = ring + (i % 2) * kStage;
    load_chunk(st, k + ch * kCh, b, h, k0, kMmaRows, t_len, n_heads, hd);
    load_chunk(st + kTile, v + ch * kCh, b, h, k0, kMmaRows, t_len, n_heads, hd);
    load_chunk(st + 2 * kTile, q + ch * kCh, b, h, q0, kQRows, t_len, n_heads, hd);
    load_chunk(st + 2 * kTile + kQRows * kLd, dout + ch * kCh, b, h, q0, kQRows, t_len,
               n_heads, hd);
    if (threadIdx.x < 2 * kQRows) {
      const int r = threadIdx.x % kQRows;
      const float* src = threadIdx.x < kQRows ? lse : delta;
      const bool in = q0 + r < t_len;
      cp_async4(stats + (i % 2) * 2 * kQRows + threadIdx.x, in ? src + stat0 + q0 + r : src,
                in);
    }
  };
  if (steps > 0) load_step(0);
  cp_async_commit();

  const int off_a = 16 * warp * kLd + lane_a(lane, kLd);
  const int off_b = lane_b(lane, kLd), off_bt = lane_bt(lane, kLd);
  const int key_lo = k0 + 16 * warp + g;
  const float scale2 = scale * kLog2e;
  float dk_acc[kCh / 8][4] = {}, dv_acc[kCh / 8][4] = {};
  float st_[kQRows / 8][4], dpt[kQRows / 8][4];

  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    const bf16* st = ring + (i % 2) * kStage;
    const bf16* qs = st + 2 * kTile;
    const bf16* dos = qs + kQRows * kLd;
    if (i % n_groups == 0) {
#pragma unroll
      for (int j = 0; j < kQRows / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st_[j][e] = dpt[j][e] = 0.0f;
    }
    chunk_mm(st_, st + off_a, qs, off_b);
    chunk_mm(dpt, st + kTile + off_a, dos, off_b);
    if (i % n_groups != n_groups - 1) continue;

    const int q0 = (qt0 + i / n_groups) * kQRows;
    const float* lse_s = stats + (i % 2) * 2 * kQRows;
    const float* dl_s = lse_s + kQRows;
    const bool masked = q0 < k0 + kMmaRows || q0 + kQRows > t_len;
#pragma unroll
    for (int j = 0; j < kQRows / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1), query = q0 + col;
        float p = exp2f(fmaf(st_[j][e], scale2, -lse_s[col] * kLog2e));
        if (masked && (key_lo + 8 * (e >> 1) > query || query >= t_len)) p = 0.0f;
        st_[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl_s[col]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kQRows / 16; ++kk) {
      uint32_t pa[4], sa[4];
      c_to_a(pa, st_[2 * kk], st_[2 * kk + 1]);
      c_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < kCh / 16; ++j) {
        uint32_t fb[4];
        ldsm4_t(fb, dos + 16 * kk * kLd + 16 * j + off_bt);
        mma_bf16(dv_acc[2 * j], pa, fb[0], fb[1]);
        mma_bf16(dv_acc[2 * j + 1], pa, fb[2], fb[3]);
        ldsm4_t(fb, qs + 16 * kk * kLd + 16 * j + off_bt);
        mma_bf16(dk_acc[2 * j], sa, fb[0], fb[1]);
        mma_bf16(dk_acc[2 * j + 1], sa, fb[2], fb[3]);
      }
    }
  }
  __syncthreads();
  store_strip<kCh, kCh, true>(dk, ring + 16 * warp * kLd, dk_acc, scale, b, h, k0 + 16 * warp,
                              t_len, n_heads, lane, hd, col0);
  store_strip<kCh, kCh, true>(dv, ring + kTile + 16 * warp * kLd, dv_acc, 1.0f, b, h,
                              k0 + 16 * warp, t_len, n_heads, lane, hd, col0);
}

// ---------------------------------------------------------- fp32 (SIMT)
// The tiles of flash_fwd_simt / the fp32 backward at D = 128 (32 rows), the
// score products accumulated over the chunks. Grid (32-row tiles, head * G
// + group, b).
using FS = FwdSmem<kCh>;
using BS = BwdSmem<kCh>;
constexpr int kR = FS::R;
static_assert(kR == BS::R, "one row count for the fp32 chunked kernels");

__global__ void __launch_bounds__(kThreads)
    flash_fwd_simt_chunked(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int t_len, int n_heads, float scale,
                           Head hd) {
  constexpr int kWidth = kThreads / kR, kPer = kR / kWidth;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + FS::q);
  float* ks = reinterpret_cast<float*>(smem + FS::k);
  float* vs = reinterpret_cast<float*>(smem + FS::v);
  float* ss = reinterpret_cast<float*>(smem + FS::s);
  float* ps = reinterpret_cast<float*>(smem + FS::p);
  float* os = reinterpret_cast<float*>(smem + FS::o);
  const int n_groups = hd.d / kCh;
  const int n_tiles = (t_len + kR - 1) / kR;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y / n_groups, grp = blockIdx.y % n_groups, col0 = grp * kCh;
  const int b = blockIdx.z, q0 = qt * kR;
  const int row = threadIdx.x / kWidth, part = threadIdx.x % kWidth;

  for (int e = threadIdx.x; e < kR * kCh; e += kThreads) os[(e / kCh) * FS::LDO + e % kCh] = 0.0f;
  float m = -INFINITY, l = 0.0f;
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kR;
    for (int ch = 0; ch < n_groups; ++ch) {
      __syncthreads();  // the previous chunk (and tile's V and P) are consumed
      load_rows<kCh, kR>(qs, FS::LD, q + ch * kCh, b, h, q0, t_len, n_heads, hd);
      load_rows<kCh, kR>(ks, FS::LD, k + ch * kCh, b, h, k0, t_len, n_heads, hd);
      if (ch == n_groups - 1) load_rows<kCh, kR>(vs, FS::LD, v + col0, b, h, k0, t_len, n_heads, hd);
      __syncthreads();
      tile_mm<false, true, kR, kR, kCh>(ss, FS::LDS, qs, FS::LD, ks, FS::LD, ch > 0);
    }
    __syncthreads();
    const int qi = q0 + row;
    float sv[kPer];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = part + j * kWidth, ki = k0 + col;
      float s = ss[row * FS::LDS + col] * scale;
      if (kt == qt && (ki > qi || ki >= t_len)) s = -INFINITY;
      sv[j] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m, group_max<kWidth>(mx));
    const float alpha = expf(m - m_new);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const float p = expf(sv[j] - m_new);
      sum += p;
      ps[row * FS::LDP + part + j * kWidth] = p;
    }
    l = l * alpha + group_sum<kWidth>(sum);
    m = m_new;
    for (int d = part; d < kCh; d += kWidth) os[row * FS::LDO + d] *= alpha;
    __syncthreads();
    tile_mm<false, false, kR, kCh, kR>(os, FS::LDO, ps, FS::LDP, vs, FS::LD, true);
  }
  __syncthreads();
  const float inv_l = 1.0f / l;
  for (int d = part; d < kCh; d += kWidth) os[row * FS::LDO + d] *= inv_l;
  if (part == 0 && grp == 0 && q0 + row < t_len)
    lse[(static_cast<size_t>(b) * n_heads + h) * t_len + q0 + row] = m + logf(l);
  __syncthreads();
  store_rows<kCh, kR>(o + col0, os, FS::LDO, 1.0f, b, h, q0, t_len, n_heads, hd);
}

// S and dP of one (query tile, key tile) pair summed over the chunks, in
// the order group + 1, ..., group (mod G): the tiles of the last chunk (the
// group's columns) stay in qs, ks, vs and dos
__device__ __forceinline__ void chunked_scores(float* ss, float* dps, float* qs, float* ks,
                                               float* vs, float* dos, const float* q,
                                               const float* k, const float* v,
                                               const float* dout, int b, int h, int q0,
                                               int k0, int grp, int t_len, int n_heads,
                                               Head hd) {
  const int n_groups = hd.d / kCh;
  for (int i = 0; i < n_groups; ++i) {
    const int ch = (grp + 1 + i) % n_groups;
    __syncthreads();  // the previous chunk's tiles are consumed
    load_rows<kCh, kR>(qs, BS::LD, q + ch * kCh, b, h, q0, t_len, n_heads, hd);
    load_rows<kCh, kR>(dos, BS::LD, dout + ch * kCh, b, h, q0, t_len, n_heads, hd);
    load_rows<kCh, kR>(ks, BS::LD, k + ch * kCh, b, h, k0, t_len, n_heads, hd);
    load_rows<kCh, kR>(vs, BS::LD, v + ch * kCh, b, h, k0, t_len, n_heads, hd);
    __syncthreads();
    tile_mm<false, true, kR, kR, kCh>(ss, BS::LDS, qs, BS::LD, ks, BS::LD, i > 0);
    tile_mm<false, true, kR, kR, kCh>(dps, BS::LDS, dos, BS::LD, vs, BS::LD, i > 0);
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_simt_chunked(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ o,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ delta, float* __restrict__ dq, int t_len,
                              int n_heads, float scale, Head hd) {
  constexpr int kWidth = kThreads / kR;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + BS::q);
  float* ks = reinterpret_cast<float*>(smem + BS::k);
  float* vs = reinterpret_cast<float*>(smem + BS::v);
  float* dos = reinterpret_cast<float*>(smem + BS::dout);
  float* ss = reinterpret_cast<float*>(smem + BS::s);
  float* dps = reinterpret_cast<float*>(smem + BS::dp);
  float* ps = reinterpret_cast<float*>(smem + BS::p);
  float* dss = reinterpret_cast<float*>(smem + BS::ds);
  float* dqs = reinterpret_cast<float*>(smem + BS::acc0);
  float* lse_s = reinterpret_cast<float*>(smem + BS::acc1);
  float* delta_s = lse_s + kR;
  const int n_groups = hd.d / kCh;
  const int n_tiles = (t_len + kR - 1) / kR;
  const int qt = n_tiles - 1 - blockIdx.x;
  const int h = blockIdx.y / n_groups, grp = blockIdx.y % n_groups, col0 = grp * kCh;
  const int b = blockIdx.z, q0 = qt * kR;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  for (int e = threadIdx.x; e < kR * kCh; e += kThreads) dqs[(e / kCh) * BS::LDA + e % kCh] = 0.0f;
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
      if (qi < t_len && grp == 0) delta[stat0 + qi] = acc;
    }
  }
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kR;
    chunked_scores(ss, dps, qs, ks, vs, dos, q, k, v, dout, b, h, q0, k0, grp, t_len, n_heads,
                   hd);
    __syncthreads();
    probs_and_dscores<kCh>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<false, false, kR, kCh, kR>(dqs, BS::LDA, dss, BS::LDP, ks, BS::LD, true);
  }
  __syncthreads();
  store_rows<kCh, kR>(dq + col0, dqs, BS::LDA, scale, b, h, q0, t_len, n_heads, hd);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_simt_chunked(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv, int t_len,
                               int n_heads, float scale, Head hd) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + BS::q);
  float* ks = reinterpret_cast<float*>(smem + BS::k);
  float* vs = reinterpret_cast<float*>(smem + BS::v);
  float* dos = reinterpret_cast<float*>(smem + BS::dout);
  float* ss = reinterpret_cast<float*>(smem + BS::s);
  float* dps = reinterpret_cast<float*>(smem + BS::dp);
  float* ps = reinterpret_cast<float*>(smem + BS::p);
  float* dss = reinterpret_cast<float*>(smem + BS::ds);
  float* dks = reinterpret_cast<float*>(smem + BS::acc0);
  float* dvs = reinterpret_cast<float*>(smem + BS::acc1);
  float* lse_s = reinterpret_cast<float*>(smem + BS::stats);
  float* delta_s = lse_s + kR;
  const int n_groups = hd.d / kCh;
  const int n_tiles = (t_len + kR - 1) / kR;
  const int kt = blockIdx.x;
  const int h = blockIdx.y / n_groups, grp = blockIdx.y % n_groups, col0 = grp * kCh;
  const int b = blockIdx.z, k0 = kt * kR;
  const size_t stat0 = (static_cast<size_t>(b) * n_heads + h) * t_len;

  for (int e = threadIdx.x; e < kR * kCh; e += kThreads) {
    dks[(e / kCh) * BS::LDA + e % kCh] = 0.0f;
    dvs[(e / kCh) * BS::LDA + e % kCh] = 0.0f;
  }
  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kR;
    for (int r = threadIdx.x; r < kR; r += kThreads) {
      const bool in = q0 + r < t_len;
      lse_s[r] = in ? lse[stat0 + q0 + r] : 0.0f;
      delta_s[r] = in ? delta[stat0 + q0 + r] : 0.0f;
    }
    chunked_scores(ss, dps, qs, ks, vs, dos, q, k, v, dout, b, h, q0, k0, grp, t_len, n_heads,
                   hd);
    __syncthreads();
    probs_and_dscores<kCh>(ss, dps, ps, dss, lse_s, delta_s, q0, k0, t_len, scale);
    __syncthreads();
    tile_mm<true, false, kR, kCh, kR>(dvs, BS::LDA, ps, BS::LDP, dos, BS::LD, true);
    tile_mm<true, false, kR, kCh, kR>(dks, BS::LDA, dss, BS::LDP, qs, BS::LD, true);
    __syncthreads();  // lse_s, delta_s and the tiles are read out
  }
  __syncthreads();
  store_rows<kCh, kR>(dk + col0, dks, BS::LDA, scale, b, h, k0, t_len, n_heads, hd);
  store_rows<kCh, kR>(dv + col0, dvs, BS::LDA, 1.0f, b, h, k0, t_len, n_heads, hd);
}

constexpr size_t kFwdMmaSmem = 4 * sizeof(bf16) * kTile;  // 2 x (Q and K, or V)
constexpr size_t kDqMmaSmem = 4 * sizeof(bf16) * kTile;   // 2 x (Q or dO, K or V)
constexpr size_t kDkvMmaSmem = 6 * sizeof(bf16) * kTile + 2 * 2 * kQRows * sizeof(float);
static_assert(kDqMmaSmem <= kMaxSmem && kDkvMmaSmem <= kMaxSmem, "the stages fit a block");

}  // namespace

cudaError_t fwd_chunked(const void* q, const void* k, const void* v, void* o, float* lse,
                        Shape s, float scale, int is_bf16, cudaStream_t st) {
  const int heads = s.h * (s.hd.d / kCh);
  if (is_bf16) {
    cudaError_t err = prepare(flash_fwd_mma_chunked, kFwdMmaSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(heads, s.b, (s.t + kMmaRows - 1) / kMmaRows);
    flash_fwd_mma_chunked<<<grid, kMmaThreads, kFwdMmaSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, s.t, s.h, scale, s.hd);
  } else {
    cudaError_t err = prepare(flash_fwd_simt_chunked, FS::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kR - 1) / kR, heads, s.b);
    flash_fwd_simt_chunked<<<grid, kThreads, FS::bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, s.t, s.h, scale, s.hd);
  }
  return cudaGetLastError();
}

cudaError_t bwd_dq_chunked(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, const float* lse, float* delta, void* dq,
                           Shape s, float scale, int is_bf16, cudaStream_t st) {
  const int heads = s.h * (s.hd.d / kCh);
  if (is_bf16) {
    cudaError_t err = prepare(flash_bwd_dq_mma_chunked, kDqMmaSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kMmaRows - 1) / kMmaRows, heads, s.b);
    flash_bwd_dq_mma_chunked<<<grid, kMmaThreads, kDqMmaSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
        static_cast<bf16*>(dq), s.t, s.h, scale, s.hd);
  } else {
    cudaError_t err = prepare(flash_bwd_dq_simt_chunked, BS::bytes_dq);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kR - 1) / kR, heads, s.b);
    flash_bwd_dq_simt_chunked<<<grid, kThreads, BS::bytes_dq, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(o),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), s.t, s.h, scale,
        s.hd);
  }
  return cudaGetLastError();
}

cudaError_t bwd_dkv_chunked(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            Shape s, float scale, int is_bf16, cudaStream_t st) {
  const int heads = s.h * (s.hd.d / kCh);
  if (is_bf16) {
    cudaError_t err = prepare(flash_bwd_dkv_mma_chunked, kDkvMmaSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kMmaRows - 1) / kMmaRows, heads, s.b);
    flash_bwd_dkv_mma_chunked<<<grid, kMmaThreads, kDkvMmaSmem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), s.t, s.h, scale, s.hd);
  } else {
    cudaError_t err = prepare(flash_bwd_dkv_simt_chunked, BS::bytes_dkv);
    if (err != cudaSuccess) return err;
    const dim3 grid((s.t + kR - 1) / kR, heads, s.b);
    flash_bwd_dkv_simt_chunked<<<grid, kThreads, BS::bytes_dkv, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), s.t, s.h, scale, s.hd);
  }
  return cudaGetLastError();
}

}  // namespace mqgan_flash
