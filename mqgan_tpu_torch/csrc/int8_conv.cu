// The int8 refiner conv: a 3x3 SAME conv of per-tensor quantized
// activations and per-output-channel quantized weights, int32 accumulation,
// rescaled to the compute dtype. NHWC activations (the refiner's
// (B, C, T, F) tensors in channels-last memory), weights (Cout, 3, 3, Cin).
//
// Replaces: no Pallas kernel. The JAX package's int8 refiner
// (mqgan_tpu/nn/unet.py:_int8_conv) hands XLA a conv with int8 operands and
// an int32 accumulator; PyTorch has no int8 conv on CUDA, so the port has
// this one.
//
//   sx  = max(max|x|, 1e-8) / 127                 fp32, a device scalar
//   xq  = clamp(rint(x / sx), -127, 127)          int8 (IEEE division, half to even)
//   acc = conv3x3_same(xq, wq)                    int32
//   y   = acc * (sx * sw[n]) + bias[n]            fp32, multiply then add, then
//                                                 rounded to the compute dtype
//
// One C call, four operations on the stream, no host synchronisation:
//  1. a memset of the max word;
//  2. absmax_kernel: max|x| over the tensor, 16-byte loads, one atomicMax per
//     block on the float's bits (non-negative floats order as their bits);
//  3. quantize_kernel: xq elementwise (the same NHWC index as x);
//  4. conv_kernel: an implicit GEMM on the tensor cores' int8 path,
//     mma.sync m16n8k32 s8.s8.s32, M = B*H*W output pixels, N = Cout,
//     K = 9*Cin. A block computes a 128 x 128 tile with 8 warps (2 x 4
//     warps of 64 x 32), stepping over the 9 taps x Cin in 64-channel
//     slices; a 4-deep cp.async ring of slices in shared memory (the
//     activation rows of a slice gathered at the tap's (h + dh, w + dw),
//     zero-filled outside the image and past Cin), ldmatrix loads the
//     fragments from rows padded to 80 bytes.
//
// What bounds it on the card: at the refiner's wide levels, operations
// (2 * M * N * K int8 ops against 1,979 TOP/s); at the narrow ones the
// bytes of x and y. The design is a simple correct tensor-core kernel:
// no wgmma, no TMA, no fused activation (later work).
//
// With `accumulators` set, the conv writes the raw int32 sums in place of y
// (the check that the kernel's codes and sums equal the plain version's).

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kThreads = 256;
// bytes per shared-memory row: 64 + 16 padding, so that the 8 rows an
// ldmatrix phase reads fall in distinct 16-byte bank groups
constexpr int kLd = 80;
constexpr int kStages = 4;  // cp.async ring of 64-channel slices
constexpr int kStageBytes = (kBM + kBN) * kLd;
constexpr int kSmemBytes = kStages * kStageBytes;  // 80 KB: 2 blocks an SM
constexpr int kReduceThreads = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes of T: VEC elements
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    absmax_kernel(const T* __restrict__ x, long long n_vec,
                  unsigned* __restrict__ amax) {
  constexpr int V = Vec<T>::kN;
  float m = 0.0f;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(mqgan::to_f32<T>(v[j])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kReduceThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kReduceThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax, __float_as_uint(m));
  }
}

__device__ __forceinline__ float act_scale(const unsigned* amax) {
  return __fdiv_rn(fmaxf(__uint_as_float(*amax), 1e-8f), 127.0f);
}

__device__ __forceinline__ int8_t quantize(float v, float sx) {
  const float q = rintf(__fdiv_rn(v, sx));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.0f), 127.0f));
}

template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    quantize_kernel(const T* __restrict__ x, long long n_vec,
                    const unsigned* __restrict__ amax, int8_t* __restrict__ xq) {
  constexpr int V = Vec<T>::kN;
  const float sx = act_scale(amax);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_vec;
       i += (long long)gridDim.x * blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    const T* v = reinterpret_cast<const T*>(&raw);
    uint32_t packed[V / 4];
#pragma unroll
    for (int w = 0; w < V / 4; ++w) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t q = quantize(mqgan::to_f32<T>(v[4 * w + j]), sx);
        word |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * j);
      }
      packed[w] = word;
    }
    if constexpr (V == 8) {
      reinterpret_cast<uint2*>(xq)[i] = make_uint2(packed[0], packed[1]);
    } else {
      reinterpret_cast<uint32_t*>(xq)[i] = packed[0];
    }
  }
}

// OutT: the compute dtype (y) or int32_t (the raw sums)
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    conv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                const float* __restrict__ sw, const float* __restrict__ bias,
                const unsigned* __restrict__ amax, OutT* __restrict__ out,
                int B, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 64 x 32
  const long long M = (long long)B * H * W;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // the tile row this thread loads (activation pixel m0 + r, weight row
  // n0 + r) and its 32-byte half of the slice
  const int r = tid & (kBM - 1), half = (tid >> 7) * 32;
  const long long m = m0 + r;
  const bool row_in = m < M;
  int b = 0, h = 0, w = 0;
  if (row_in) {
    w = static_cast<int>(m % W);
    const long long bh = m / W;
    h = static_cast<int>(bh % H);
    b = static_cast<int>(bh / H);
  }
  const int nb = n0 + r;
  const int slices = (Cin + kBK - 1) / kBK;
  const int steps = 9 * slices;

  auto load = [&](int s, int buf) {
    int8_t* as = smem + buf * kStageBytes;
    int8_t* bs = as + kBM * kLd;
    const int tap = s / slices, c0 = (s % slices) * kBK + half;
    const int hh = h + tap / 3 - 1, ww = w + tap % 3 - 1;
    const bool inside = row_in && hh >= 0 && hh < H && ww >= 0 && ww < W;
    const int8_t* src = xq + (((long long)b * H + hh) * W + ww) * Cin;
    const int8_t* wsrc = wq + ((long long)nb * 9 + tap) * Cin;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = c0 + 16 * j;
      const bool in = inside && c < Cin;
      mqgan::cp_async16(as + r * kLd + half + 16 * j, in ? src + c : xq, in);
      const bool win = nb < Cout && c < Cin;
      mqgan::cp_async16(bs + r * kLd + half + 16 * j, win ? wsrc + c : wq, win);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  // ldmatrix reads the int8 tiles as b16: a 16 x 32-byte A fragment or the
  // B fragments of two 8-column tiles have the layouts of mma.sync
  // m16n8k16's b16 fragments (mma.cuh)
  constexpr int kLdH = kLd / 2;
  const int a_off = mqgan::lane_a(lane, kLdH), b_off = mqgan::lane_b(lane, kLdH);
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s);
    mqgan::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    // slice s has landed, and every warp is done with slice s - 1, whose
    // buffer the next load refills
    mqgan::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < steps) load(s + kStages - 1, (s + kStages - 1) % kStages);
    mqgan::cp_async_commit();
    const auto* as = reinterpret_cast<const mqgan::bf16*>(smem + (s % kStages) * kStageBytes);
    const auto* bs = as + kBM * kLdH;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {  // 32 bytes = 16 b16 a k step
      uint32_t a[4][4], bq[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mqgan::ldsm4(a[i], as + (wm * 64 + i * 16) * kLdH + kk * 16 + a_off);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mqgan::ldsm4(bq[j], bs + (wn * 32 + j * 16) * kLdH + kk * 16 + b_off);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], a[i], bq[j >> 1][(j & 1) * 2], bq[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  // epilogue: C fragment (g, 2tq..2tq+1) and (g + 8, ...) of each 16 x 8 tile
  const int g = lane >> 2, tq = lane & 3;
  float sx = 0.0f;
  if constexpr (!std::is_same_v<OutT, int32_t>) sx = act_scale(amax);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + j * 8 + tq * 2 + e;
      if (n >= Cout) continue;
      float scale = 0.0f, bn = 0.0f;
      if constexpr (!std::is_same_v<OutT, int32_t>) {
        scale = __fmul_rn(sx, sw[n]);
        bn = bias[n];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long row = m0 + wm * 64 + i * 16 + g + hr * 8;
          if (row >= M) continue;
          const int v = acc[i][j][hr * 2 + e];
          if constexpr (std::is_same_v<OutT, int32_t>) {
            out[row * Cout + n] = v;
          } else {
            const float y = __fadd_rn(__fmul_rn(__int2float_rn(v), scale), bn);
            out[row * Cout + n] = mqgan::from_f32<OutT>(y);
          }
        }
      }
    }
  }
}

// the conv's 80 KB of dynamic shared memory, allowed once per device
template <typename OutT>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || done[dev]) return err;
  err = cudaFuncSetAttribute(conv_kernel<OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  done[dev] = err == cudaSuccess;
  return err;
}

int reduce_blocks(long long n_vec) {
  const long long want = (n_vec + kReduceThreads - 1) / kReduceThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

template <typename T>
int run(const void* x, const void* wq, const void* sw, const void* bias,
        void* amax, void* xq, void* out, int B, int H, int W, int Cin, int Cout,
        int accumulators, cudaStream_t st) {
  const long long n_vec = (long long)B * H * W * Cin / Vec<T>::kN;
  const int blocks = reduce_blocks(n_vec);
  auto* amax_u = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<T><<<blocks, kReduceThreads, 0, st>>>(static_cast<const T*>(x),
                                                       n_vec, amax_u);
  quantize_kernel<T><<<blocks, kReduceThreads, 0, st>>>(
      static_cast<const T*>(x), n_vec, amax_u, static_cast<int8_t*>(xq));
  const long long M = (long long)B * H * W;
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  const auto* xq8 = static_cast<const int8_t*>(xq);
  const auto* wq8 = static_cast<const int8_t*>(wq);
  const auto* swf = static_cast<const float*>(sw);
  const auto* bf = static_cast<const float*>(bias);
  if (accumulators) {
    if ((err = allow_smem<int32_t>()) != cudaSuccess) return static_cast<int>(err);
    conv_kernel<int32_t><<<grid, kThreads, kSmemBytes, st>>>(
        xq8, wq8, swf, bf, amax_u, static_cast<int32_t*>(out), B, H, W, Cin, Cout);
  } else {
    if ((err = allow_smem<T>()) != cudaSuccess) return static_cast<int>(err);
    conv_kernel<T><<<grid, kThreads, kSmemBytes, st>>>(
        xq8, wq8, swf, bf, amax_u, static_cast<T*>(out), B, H, W, Cin, Cout);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, H, W, Cin) in the compute dtype, wq (Cout, 3, 3, Cin) int8, sw and
// bias (Cout,) fp32, amax one 4-byte scratch word, xq (B, H, W, Cin) int8
// scratch, out (B, H, W, Cout) in the compute dtype (int32 with
// accumulators). Cin % 16 == 0 and 16-byte aligned x, xq and wq (checked by
// the wrapper).
extern "C" int mqgan_int8_conv(const void* x, const void* wq, const void* sw,
                               const void* bias, void* amax, void* xq, void* out,
                               int B, int H, int W, int Cin, int Cout, int is_bf16,
                               int accumulators, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<__nv_bfloat16>(x, wq, sw, bias, amax, xq, out, B, H, W, Cin, Cout,
                              accumulators, st);
  return run<float>(x, wq, sw, bias, amax, xq, out, B, H, W, Cin, Cout,
                    accumulators, st);
}
