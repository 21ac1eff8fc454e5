// Fused FSQ encode head: h (N, C) -> packed int32 FSQ index per row.
//
// Replaces: mqgan_tpu/ops/fsq_kernels.py:_fsq_encode_pallas (the Pallas TPU
// kernel `_kernel` behind FSQEncodeHead).
//
//   z = h . W + b (fp32, d code dims), bounded = tanh(z + shift) * half_l
//   - offset, q = round half to even (rintf), idx = sum((q + half_w) * basis)
//
// What bounds it on the card: bytes. It reads h once (N*C values; 50 MB in
// bf16 at the flagship N = 64 * 512, C = 768) and does 2d flops per value,
// far below the H100's ratio of flops to bytes. The design is a streaming
// pass that keeps h's bytes moving at close to the memory rate:
//
// - A persistent grid: as many blocks as fit on the SMs at once, each
//   staging W once and grid-striding over groups of R consecutive rows, one
//   group per warp at a time.
// - 16-byte loads: lane l reads vectors l, l + 32, ... (8 bf16 or 4 fp32
//   channels each) of each of the group's R rows, one vector of each row a
//   step, so the lane->channel assignment is fixed: vector v covers
//   channels v*VEC .. v*VEC + VEC - 1. (VEC = 1, scalar loads, when C is
//   not a multiple of 16 bytes' worth of elements or h is not 16-byte
//   aligned.)
// - Loads ahead of use: a lane issues kUnroll = 3 vectors of each of the
//   group's R = 2 rows (at the flagship's C = 768 in bf16, the whole
//   group: 6 loads of 16 bytes a lane, 3 KB a warp) before the first
//   product, and __launch_bounds__ keeps the registers to 4 blocks of 8
//   warps per SM.
//   These constants came from timing variants of this kernel on the card
//   (2, 4 and 8 rows; 1 to 4 vectors ahead; 1 to 4 blocks per SM); 8 rows
//   were the slowest.
// - W in shared memory as float4s laid out [element e of a vector][quad q of
//   dims][vector v], so the 32 lanes of a warp read 32 consecutive float4s
//   (no bank conflict), and each float4 serves all R rows of the group.
// - d as a template parameter: R x DP accumulators in registers (DP = d
//   rounded up to a power of two; the padding dims stay 0), no per-dim
//   guard.
// - A transposing butterfly reduction of the R*DP = M partials: each xor
//   shuffle step halves the live values a lane carries (the lane with the
//   step's bit set keeps the upper half), so after log2(M) steps lane L holds
//   value bitrev(L mod M) summed over M lanes, and log2(32 / M) plain xor
//   steps finish the sum: M - 1 + log2(32 / M) shuffles for R rows, where
//   one warp per row spent 5d. Then bound/round runs on M lanes at once
//   (one (row, dim) each; the other lanes hold copies), and the pack is
//   log2(DP) shuffles over the lanes of a row.
//
// Past 8 code dims (fsq_head_groups_kernel): the packed index is a sum over dims, so it
// splits into groups of 8. The kernel runs the D = 8 machinery once per
// group g over W's columns [8g, 8g + 8) (the dims past d are zero columns
// and add nothing), W's group staged in shared memory in turn (so shared
// memory is bounded by a group, not by d), and each row's index is the
// groups' partial sums added in group order, in fp32, by the lane that
// stores it (a lane owns the same rows in every group: the grid stride does
// not depend on g). Below a codebook of 2^24 every partial sum is an exact
// integer, so the index equals the plain version's whatever the order; past
// it the sum can round, in either. Both kernels run one device function,
// fsq_group, per group; d <= 8 is one group of all its D dims, with D a
// template parameter as before.
//
// Rounding as the reference: the multiply and the subtract are separate
// (__fmul_rn / __fsub_rn, no contraction into an FMA), rintf rounds halves
// to even like torch.round / jnp.round, tanhf is the exact one. The dot
// products are summed in another order than the plain version's, so an
// index may differ where the pre-round value lies at a rounding midpoint.

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxD = 8;
constexpr int kWarps = 8;     // warps per block
constexpr int kMaxRows = 2;   // rows a warp reduces together, at most
constexpr int kUnroll = 3;    // vectors per lane loaded before use
constexpr int kMinBlocks = 4; // blocks per SM the registers must allow

template <int D>
struct Shape {
  static constexpr int DP = D <= 1 ? 1 : D <= 2 ? 2 : D <= 4 ? 4 : 8;
  static constexpr int R = 32 / DP < kMaxRows ? 32 / DP : kMaxRows;  // rows
  static constexpr int M = R * DP;  // partials per lane
  static constexpr int kLogM = M == 2 ? 1 : M == 4 ? 2 : M == 8 ? 3 : M == 16 ? 4 : 5;
  static constexpr int Q = (D + 3) / 4;                // float4s of W per channel
};

// VEC consecutive elements of h as loaded: one 16-byte vector (8 bf16 or 4
// fp32), or one element when VEC = 1. Kept raw until use, so that a step's
// loads in flight cost 4 registers a row.
template <typename T, int VEC>
struct Raw {
  uint4 u;
};
template <typename T>
struct Raw<T, 1> {
  T u;
};

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> load_raw(const T* p, bool ok) {
  Raw<T, VEC> out;
  if constexpr (VEC == 1) {
    out.u = ok ? p[0] : T(0.0f);
  } else {
    // read once: streamed, evict first (ld.global.cs)
    out.u = ok ? __ldcs(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
  }
  return out;
}

__device__ __forceinline__ unsigned word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Element e (compile time) of a raw vector, as fp32.
template <typename T, int VEC>
__device__ __forceinline__ float elem(const Raw<T, VEC>& x, int e) {
  if constexpr (VEC == 1) {
    return mqgan::to_f32<T>(x.u);
  } else if constexpr (sizeof(T) == 2) {  // bf16: the high half of a float
    const unsigned w = word(x.u, e >> 1);
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    return __uint_as_float(word(x.u, e));
  }
}

template <typename T, int VEC, int R>
__device__ __forceinline__ void load_step(const T* __restrict__ h, int n, int c,
                                          int nvec, int row0, int v,
                                          Raw<T, VEC> (&x)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    x[r] = load_raw<T, VEC>(
        h + static_cast<size_t>(row0 + r) * c + static_cast<size_t>(v) * VEC,
        row0 + r < n && v < nvec);
  }
}

// One group of up to D code dims: W's columns [d0, d0 + dg) of a (c, dd) W
// staged in ws (zero past dg), then each of this warp's rows of the grid
// stride reduced against them. emit(row, term) takes a row's partial index
// over the group, on the lane that stores it (a lane owns the same rows in
// every group: the grid stride does not depend on the group).
template <typename T, int D, int VEC, typename Emit>
__device__ __forceinline__ void fsq_group(const T* __restrict__ h, const float* __restrict__ w,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ consts, float4* ws,
                                          int n, int c, int dd, int d0, int dg, Emit emit) {
  using S = Shape<D>;
  constexpr int DP = S::DP, R = S::R, M = S::M, Q = S::Q, kLogM = S::kLogM;
  const int nvec = c / VEC;

  // W (c, dd) -> ws[(e * Q + q) * nvec + v] = dims d0 + 4q..4q+3 of channel
  // v * VEC + e (0 past the group's dims)
  // four float4s a thread in flight at a time: W comes from L2 once a block
  for (int i0 = threadIdx.x; i0 < c * Q; i0 += 4 * blockDim.x) {
    float f[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = i0 + t * blockDim.x;
      const int ch = i / Q, q = i - ch * Q;  // Q is 1 or 2: a shift
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * q + k;
        f[t][k] = (i < c * Q && j < dg) ? w[ch * dd + d0 + j] : 0.0f;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = i0 + t * blockDim.x;
      if (i < c * Q) {
        const int ch = i / Q, q = i - ch * Q;
        const int v = ch / VEC, e = ch - v * VEC;
        ws[(e * Q + q) * nvec + v] = make_float4(f[t][0], f[t][1], f[t][2], f[t][3]);
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int groups = (n + R - 1) / R;
  const int iters = (nvec + 31) >> 5;  // vectors per lane, warp-uniform
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < groups;
       g += stride) {
    const int row0 = g * R;
    float acc[M];
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] = 0.0f;

    // kUnroll vectors of each of the R rows are loaded before any is used
    for (int base = 0; base < iters; base += kUnroll) {
      Raw<T, VEC> x[kUnroll][R];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_step<T, VEC, R>(h, n, c, nvec, row0, (base + u) * 32 + lane, x[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int v = (base + u) * 32 + lane;
        if (v < nvec) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
#pragma unroll
            for (int q = 0; q < Q; ++q) {
              const float4 wv = ws[(e * Q + q) * nvec + v];
              const float wq[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int j = 4 * q + k;
                if (j < D) {  // compile time
#pragma unroll
                  for (int r = 0; r < R; ++r) {
                    acc[r * DP + j] = fmaf(elem<T, VEC>(x[u][r], e), wq[k],
                                           acc[r * DP + j]);
                  }
                }
              }
            }
          }
        }
      }
    }

    // transposing butterfly: step s halves the live values
#pragma unroll
    for (int s = 0; s < kLogM; ++s) {
      const bool upper = (lane >> s) & 1;
      const int half = M >> (s + 1);
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? acc[i] : acc[i + half];
        const float keep = upper ? acc[i + half] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, 1 << s);
      }
    }
#pragma unroll
    for (int off = M; off < 32; off <<= 1) {
      acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
    }

    // lane L holds value k = bitrev(L mod M) = r * DP + j
    int k = 0;
#pragma unroll
    for (int b = 0; b < kLogM; ++b) k |= ((lane >> b) & 1) << (kLogM - 1 - b);
    const int r = k / DP, j = k - r * DP;
    float term = 0.0f;
    if (j < dg) {
      const int jd = d0 + j;
      const float half_l = consts[jd], offset = consts[dd + jd];
      const float shift = consts[2 * dd + jd], half_w = consts[3 * dd + jd];
      const float basis = consts[4 * dd + jd];
      const float z = acc[0] + bias[jd];
      // separate multiply and subtract, as the reference rounds them
      const float bounded = __fsub_rn(__fmul_rn(tanhf(z + shift), half_l),
                                      offset);
      term = (rintf(bounded) + half_w) * basis;
    }
    // the pack: the DP lanes of row r differ in lane bits log2(R) ..
#pragma unroll
    for (int off = R; off < M; off <<= 1) {
      term += __shfl_xor_sync(0xffffffffu, term, off);
    }
    if (lane < R && row0 + r < n) emit(row0 + r, term);
  }
}

// d <= 8: one group of all D dims
template <typename T, int D, int VEC>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
fsq_head_kernel(const T* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ consts, int* __restrict__ idx,
                int n, int c) {
  extern __shared__ float4 ws[];
  fsq_group<T, D, VEC>(h, w, bias, consts, ws, n, c, D, 0, D,
                       [idx](int row, float term) { idx[row] = static_cast<int>(term); });
}

// Any d past 8: groups of D = 8 code dims (d_all of them), the groups'
// partial indices added in group order; the sum so far waits in idx as fp32
// bits until the last group
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
fsq_head_groups_kernel(const T* __restrict__ h, const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ consts, int* __restrict__ idx,
                       int n, int c, int d_all) {
  extern __shared__ float4 ws[];
  const int n_groups = (d_all + kMaxD - 1) / kMaxD;
  float* part = reinterpret_cast<float*>(idx);
  for (int grp = 0; grp < n_groups; ++grp) {
    if (grp > 0) __syncthreads();  // the previous group's W is read out
    const bool first = grp == 0, last = grp + 1 == n_groups;
    fsq_group<T, kMaxD, VEC>(h, w, bias, consts, ws, n, c, d_all, kMaxD * grp,
                             min(kMaxD, d_all - kMaxD * grp),
                             [=](int row, float term) {
                               const float total = first ? term : part[row] + term;
                               if (last) {
                                 idx[row] = static_cast<int>(total);
                               } else {
                                 part[row] = total;
                               }
                             });
  }
}

int sm_count() {
  static const int count = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return count;
}

// kGroups: fsq_head_groups_kernel over d dims in groups of D = 8
template <typename T, int D, int VEC, bool kGroups = false>
int launch(const T* h, const float* w, const float* bias, const float* consts,
           int* idx, int n, int c, int d, cudaStream_t s) {
  auto kernel = [] {
    if constexpr (kGroups) {
      return fsq_head_groups_kernel<T, VEC>;
    } else {
      return fsq_head_kernel<T, D, VEC>;
    }
  }();
  const size_t smem = static_cast<size_t>(c) * Shape<D>::Q * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  // blocks resident per SM, asked once per instantiation and W size
  static std::atomic<long long> cached{-1};
  long long packed = cached.load(std::memory_order_relaxed);
  int per_sm = 0;
  if ((packed >> 32) == static_cast<long long>(smem)) {
    per_sm = static_cast<int>(packed & 0xffffffff);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32,
                                                  smem);
    cached.store((static_cast<long long>(smem) << 32) | per_sm,
                 std::memory_order_relaxed);
  }
  const int groups = (n + Shape<D>::R - 1) / Shape<D>::R;
  const int needed = (groups + kWarps - 1) / kWarps;
  const int resident = (per_sm > 0 ? per_sm : 1) * sm_count();
  const int grid = needed < resident ? needed : resident;
  if constexpr (kGroups) {
    kernel<<<grid, kWarps * 32, smem, s>>>(h, w, bias, consts, idx, n, c, d);
  } else {
    kernel<<<grid, kWarps * 32, smem, s>>>(h, w, bias, consts, idx, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool kGroups = false>
int launch_vec(const void* h, const float* w, const float* bias,
               const float* consts, int* idx, int n, int c, int d, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* hp = static_cast<const T*>(h);
  if (c % kVec == 0 && reinterpret_cast<uintptr_t>(hp) % 16 == 0) {
    return launch<T, D, kVec, kGroups>(hp, w, bias, consts, idx, n, c, d, s);
  }
  return launch<T, D, 1, kGroups>(hp, w, bias, consts, idx, n, c, d, s);
}

template <typename T>
int launch_d(const void* h, const float* w, const float* bias,
             const float* consts, int* idx, int n, int c, int d,
             cudaStream_t s) {
  switch (d) {
    case 1: return launch_vec<T, 1>(h, w, bias, consts, idx, n, c, d, s);
    case 2: return launch_vec<T, 2>(h, w, bias, consts, idx, n, c, d, s);
    case 3: return launch_vec<T, 3>(h, w, bias, consts, idx, n, c, d, s);
    case 4: return launch_vec<T, 4>(h, w, bias, consts, idx, n, c, d, s);
    case 5: return launch_vec<T, 5>(h, w, bias, consts, idx, n, c, d, s);
    case 6: return launch_vec<T, 6>(h, w, bias, consts, idx, n, c, d, s);
    case 7: return launch_vec<T, 7>(h, w, bias, consts, idx, n, c, d, s);
    case 8: return launch_vec<T, 8>(h, w, bias, consts, idx, n, c, d, s);
    default: return launch_vec<T, kMaxD, true>(h, w, bias, consts, idx, n, c, d, s);
  }
}

}  // namespace

extern "C" int mqgan_fsq_head(const void* h, int h_is_bf16, const void* w,
                              const void* bias, const void* consts, void* idx,
                              int n, int c, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const float* cf = static_cast<const float*>(consts);
  int* out = static_cast<int*>(idx);
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (h_is_bf16) {
    return launch_d<__nv_bfloat16>(h, wf, bf, cf, out, n, c, d, s);
  }
  return launch_d<float>(h, wf, bf, cf, out, n, c, d, s);
}
