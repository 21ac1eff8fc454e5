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
//  4. conv_kernel: an implicit GEMM on Hopper's warpgroup tensor-core path,
//     M = B*H*W output pixels, N = Cout, K = 9*Cin.
//
// What bounds it at the refiner's shapes: at the wide levels (Cin, Cout of
// 256..768 at H = T/8, T/4) the operations, 2 * M * N * K int8 ops against
// 1,979 TOP/s; at the narrow ones (Cout = 64, Cin = 64 or 192 at H = T) the
// bytes: x read twice by the two passes, xq written and read, y written.
//
// The conv's design, against what held back the first version (an mma.sync
// kernel with a 128 x 128 tile and cp.async gathers):
//  - the tensor cores are fed by wgmma.mma_async m64nNk32 s8.s8.s32, both
//    operands from shared memory, K-major, in the 128-byte swizzle (BK = 128
//    bytes of Cin a slice) or the 64-byte one (BK = 64, where Cin % 128 != 0);
//  - a block tile is 128 pixels (two consumer warpgroups of 64 rows) by BN
//    output channels, BN fitted to Cout by the wrapper's plan
//    (ops/int8_conv.py int8_tile_plan: 32, 64, 128 or 256), so that no N tile
//    multiplies mostly zero weight rows;
//  - the 128 pixels are a box_w x box_h rectangle of one image. TMA loads it
//    for each of the 9 taps as a 4-D box (BK, box_w, box_h, 1) of xq (Cin,
//    W, H, B) at (c0, w0 + dw - 1, h0 + dh - 1, b): the out-of-bounds zero
//    fill gives the SAME padding, the ragged image edges and the channels
//    past Cin, with no per-row address or predicate. The weights' slice is a
//    3-D box (BK, 1, BN) of wq (Cin, 9, Cout). One producer thread keeps a
//    ring of `stages` slices in flight (mbarrier full/empty pairs), so each
//    slice feeds BK / 32 wgmma per warpgroup with no block-wide barrier;
//  - the tensor maps are encoded on the host at each call
//    (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint: the
//    library does not link libcuda) and passed as __grid_constant__
//    parameters, so a CUDA-graph capture records them like any argument;
//  - blocks are persistent: one per SM walks the tile list, N tiles of an M
//    tile adjacent in it (they read the same xq from L2), M tiles in w, h, b
//    order (neighbours share their halos in L2). The producer loads the next
//    tile's slices while the consumers run the epilogue;
//  - the epilogue keeps the arithmetic of the plain version: fp32 y =
//    __fadd_rn(__fmul_rn(float(acc), __fmul_rn(sx, sw[n])), bias[n]),
//    rounded once to the compute dtype. Each warpgroup stages 32 columns of
//    its 64 rows in padded shared memory, then writes 16-byte coalesced
//    stores, masking pixels outside the image;
//  - the max and quantize passes stay separate 16-byte grid-stride passes.
// A fused activation or max epilogue would change the op's function, and is
// left to later work.
//
// With `accumulators` set, the conv writes the raw int32 sums in place of y
// (the check that the kernel's codes and sums equal the plain version's).
//
// Any Cin and Cout. TMA needs 16-byte global strides, so xq and wq hold Cin
// padded with zero codes to Cp, the next multiple of 16: the quantize pass
// writes xq so, and wq comes so from ops/int8_conv.py quantize_weights. The
// zero codes add nothing, so the int32 sums are those at the true Cin. The
// max and quantize passes load x in 16-byte vectors where Cp == Cin and x is
// 16-byte aligned, else an element at a time. Below Cout = 64 the tile may be BN = 32
// (wgmma N = 32). The epilogue stores only the columns below Cout: in
// 16-byte runs where Cout is a multiple of 8, else an element at a time.

#include <cuda.h>  // CUtensorMap and its enums; no libcuda symbol is linked
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;        // pixels a tile: two consumer warpgroups of 64 rows
constexpr int kThreads = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int kMaxStages = 8;
constexpr int kChunk = 32;      // epilogue columns staged at once
constexpr int kStageLd = kChunk + 8;  // staging row in 4-byte words: conflict-free stores
constexpr int kStagingBytes = 2 * 64 * kStageLd * 4;
constexpr int kBarrierBytes = 2 * kMaxStages * 8;
constexpr int kAlign = 1024;    // the 128-byte swizzle repeats every 1024 bytes
constexpr int kSmemMax = 232448;
constexpr int kReduceThreads = 256;

// 16 bytes of T: VEC elements
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
};

// max|x| over n elements: 16-byte loads over the first n_vec vectors, one
// element at a time past them (the caller passes n_vec = 0 where x is not
// 16-byte aligned)
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    absmax_kernel(const T* __restrict__ x, long long n_vec, long long n,
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
  for (long long i = n_vec * V + blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    m = fmaxf(m, fabsf(mqgan::to_f32<T>(x[i])));
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

// xq with Cin padded to cp (a multiple of 16) by zero codes: each thread
// writes 4 bytes of one pixel's row
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    quantize_padded_kernel(const T* __restrict__ x, long long words, int cin, int cp,
                           const unsigned* __restrict__ amax, int8_t* __restrict__ xq) {
  const float sx = act_scale(amax);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < words;
       i += (long long)gridDim.x * blockDim.x) {
    const long long pix = 4 * i / cp;
    const int c0 = static_cast<int>(4 * i - pix * cp);
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < cin) {
        const int8_t q = quantize(mqgan::to_f32<T>(x[pix * cin + c0 + j]), sx);
        word |= static_cast<uint32_t>(static_cast<uint8_t>(q)) << (8 * j);
      }
    }
    reinterpret_cast<uint32_t*>(xq)[i] = word;
  }
}

// ---- Hopper primitives (PTX) ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// spin until the phase of the given parity has completed; a wait of some
// 20 s (a lost arrival) traps, so that a fault fails the launch instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity)) {
    if (clock64() - start > 40'000'000'000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The shared-memory matrix descriptor of a K-major tile whose rows are BK
// bytes in the BK-byte swizzle (128 -> layout 1, 64 -> layout 2): 8-row core
// groups 8 * BK bytes apart (SBO), LBO unused (1), base offset 0 (the tiles
// start on the swizzle's repeat).
template <int BK>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = BK == 128 ? 1 : 2;
  constexpr uint64_t sbo = (8 * BK) >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (sbo << 32) |
         (layout << 62);
}

// D (64 x N, int32) += A (64 x 32 int8, K-major) * B (N x 32 int8, K-major)^T,
// accumulate = 0 overwrites D. Thread t of the warpgroup holds D[i] at row
// 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (t % 4)
// + i % 2.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the tile grid of one call (ops/int8_conv.py int8_tile_plan computes it)
struct Shape {
  int B, H, W, Cin, Cout;
  int box_w, box_h;               // a tile's pixels: box_w x box_h, box_w * box_h = 128
  int tiles_w, tiles_h, tiles_n;  // tiles along W, H and Cout
  long long tiles;                // B * tiles_h * tiles_w * tiles_n
  int slices;                     // ceil(Cp / BK), Cp = Cin padded to 16 where it is not
  int stages;                     // slices in the shared-memory ring
  int mode;                       // 0: fp32 y, 1: bf16 y, 2: the int32 sums
  int runs;                       // 1: Cout % 8 == 0, 16-byte stores; 0: one element
};

struct Tile {
  int b, h0, w0, n0;
};

// tile t: N tiles innermost, then w, h, b (as int8_tile_plan's tile())
__device__ __forceinline__ Tile tile_at(const Shape& s, long long t, int bn) {
  Tile o;
  const long long m = t / s.tiles_n;
  o.n0 = static_cast<int>(t % s.tiles_n) * bn;
  o.w0 = static_cast<int>(m % s.tiles_w) * s.box_w;
  const long long mh = m / s.tiles_w;
  o.h0 = static_cast<int>(mh % s.tiles_h) * s.box_h;
  o.b = static_cast<int>(mh / s.tiles_h);
  return o;
}

template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(__grid_constant__ const CUtensorMap x_map,
                __grid_constant__ const CUtensorMap w_map, const float* __restrict__ sw,
                const float* __restrict__ bias, const unsigned* __restrict__ amax,
                void* __restrict__ out, const Shape s) {
  constexpr int kA = kBM * BK, kB = BN * BK;  // bytes of a slice of each operand
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
  const uint32_t a_ring = base, b_ring = base + s.stages * kA;
  uint32_t* staging =
      reinterpret_cast<uint32_t*>(smem_raw + (base - raw) + s.stages * (kA + kB));
  const uint32_t full = base + s.stages * (kA + kB) + kStagingBytes;
  const uint32_t empty = full + 8 * kMaxStages;
  const int tid = threadIdx.x, wg = tid / 128;
  const int steps = 9 * s.slices;

  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's expect_tx, then TMA's bytes
      mbar_init(empty + 8 * i, 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
        const Tile tl = tile_at(s, t, BN);
        for (int k = 0; k < steps; ++k) {
          const int c0 = (k / 9) * BK, tap = k % 9;
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, kA + kB);
          tma_load_4d(a_ring + stage * kA, &x_map, full + 8 * stage, c0,
                      tl.w0 + tap % 3 - 1, tl.h0 + tap / 3 - 1, tl.b);
          tma_load_3d(b_ring + stage * kB, &w_map, full + 8 * stage, c0, tap, tl.n0);
          if (++stage == s.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup cw owns the tile's rows 64 cw .. 64 cw + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1, ct = tid - 128 * wg;
    const int warp = ct / 32, lane = ct % 32;
    const float sx = s.mode == 2 ? 0.0f : act_scale(amax);
    uint32_t* stg = staging + cw * 64 * kStageLd;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      const Tile tl = tile_at(s, t, BN);
      int prev = 0;
      for (int k = 0; k < steps; ++k) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = a_ring + stage * kA + cw * 64 * BK;
        const uint32_t b = b_ring + stage * kB;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8<BN>(acc, smem_desc<BK>(a + 32 * kk), smem_desc<BK>(b + 32 * kk),
                       (k | kk) != 0);
        wgmma_commit();
        fence_operands(acc);
        if (k > 0) {
          // the previous slice's products are done: its buffer goes back
          wgmma_wait<1>();
          fence_operands(acc);
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == s.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // epilogue, kChunk columns at a time: fragments -> padded staging rows
      // -> 16-byte stores of whole pixels' channel runs
#pragma unroll
      for (int c = 0; c < BN / kChunk; ++c) {
        named_sync(1 + cw, 128);  // the previous chunk has been read out
#pragma unroll
        for (int jj = 0; jj < kChunk / 8; ++jj) {
          const int j = c * (kChunk / 8) + jj;
          const int col = 8 * jj + 2 * (lane % 4);
          const int n = tl.n0 + 8 * j + 2 * (lane % 4);
          float scale[2] = {0.0f, 0.0f}, bn[2] = {0.0f, 0.0f};
          if (s.mode != 2) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n + e < s.Cout) {
                scale[e] = __fmul_rn(sx, sw[n + e]);
                bn[e] = bias[n + e];
              }
            }
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = 16 * warp + lane / 4 + 8 * hr;
            uint32_t v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int a = acc[4 * j + 2 * hr + e];
              v[e] = s.mode == 2 ? static_cast<uint32_t>(a)
                                 : __float_as_uint(__fadd_rn(
                                       __fmul_rn(__int2float_rn(a), scale[e]), bn[e]));
            }
            *reinterpret_cast<uint2*>(stg + row * kStageLd + col) = make_uint2(v[0], v[1]);
          }
        }
        named_sync(1 + cw, 128);
        if (s.mode == 1) {
          // bf16: a thread rounds 8 values into one 16-byte store
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int row = 32 * p + ct / 4, piece = ct % 4;
            const int r = 64 * cw + row;
            const int h = tl.h0 + r / s.box_w, w = tl.w0 + r % s.box_w;
            const int n = tl.n0 + c * kChunk + 8 * piece;
            if (h < s.H && w < s.W && n < s.Cout) {
              const uint32_t* src = stg + row * kStageLd + 8 * piece;
              const long long pix = (static_cast<long long>(tl.b) * s.H + h) * s.W + w;
              if (!s.runs) {
                for (int e = 0; e < 8 && n + e < s.Cout; ++e) {
                  static_cast<__nv_bfloat16*>(out)[pix * s.Cout + n + e] =
                      __float2bfloat16(__uint_as_float(src[e]));
                }
                continue;
              }
              const uint4 lo = *reinterpret_cast<const uint4*>(src);
              const uint4 hi = *reinterpret_cast<const uint4*>(src + 4);
              const uint32_t f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
              uint32_t packed[4];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const __nv_bfloat162 two = __floats2bfloat162_rn(
                    __uint_as_float(f[2 * q]), __uint_as_float(f[2 * q + 1]));
                packed[q] = *reinterpret_cast<const uint32_t*>(&two);
              }
              *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + pix * s.Cout + n) =
                  make_uint4(packed[0], packed[1], packed[2], packed[3]);
            }
          }
        } else {
          // fp32 y or int32 sums: 4 words a thread
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int row = 16 * p + ct / 8, piece = ct % 8;
            const int r = 64 * cw + row;
            const int h = tl.h0 + r / s.box_w, w = tl.w0 + r % s.box_w;
            const int n = tl.n0 + c * kChunk + 4 * piece;
            if (h < s.H && w < s.W && n < s.Cout) {
              const long long pix = (static_cast<long long>(tl.b) * s.H + h) * s.W + w;
              const uint32_t* src = stg + row * kStageLd + 4 * piece;
              if (!s.runs) {
                for (int e = 0; e < 4 && n + e < s.Cout; ++e)
                  static_cast<uint32_t*>(out)[pix * s.Cout + n + e] = src[e];
                continue;
              }
              *reinterpret_cast<uint4*>(static_cast<uint32_t*>(out) + pix * s.Cout + n) =
                  *reinterpret_cast<const uint4*>(src);
            }
          }
        }
      }
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// xq (Cp, W, H, B) boxes of (BK, box_w, box_h, 1) and wq (Cp, 9, Cout)
// boxes of (BK, 1, BN), int8 as bytes, zero fill out of bounds
cudaError_t encode_maps(CUtensorMap* x_map, CUtensorMap* w_map, const void* xq,
                        const void* wq, const Shape& s, int cp, int bn, int bk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swizzle =
      bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t cin = static_cast<cuuint64_t>(cp);
  const cuuint64_t x_dims[4] = {cin, static_cast<cuuint64_t>(s.W),
                                static_cast<cuuint64_t>(s.H), static_cast<cuuint64_t>(s.B)};
  const cuuint64_t x_strides[3] = {cin, cin * s.W, cin * s.W * s.H};
  const cuuint32_t x_box[4] = {static_cast<cuuint32_t>(bk), static_cast<cuuint32_t>(s.box_w),
                               static_cast<cuuint32_t>(s.box_h), 1};
  CUresult r = encode(x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(xq), x_dims,
                      x_strides, x_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t w_dims[3] = {cin, 9, static_cast<cuuint64_t>(s.Cout)};
  const cuuint64_t w_strides[2] = {cin, 9 * cin};
  const cuuint32_t w_box[3] = {static_cast<cuuint32_t>(bk), 1, static_cast<cuuint32_t>(bn)};
  r = encode(w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wq), w_dims,
             w_strides, w_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// per device: the SM count, and whether each instantiation may take the
// full shared memory
struct DeviceInfo {
  int sms = 0;
  bool smem_set[8] = {};
};

cudaError_t device_info(DeviceInfo** info) {
  static DeviceInfo devices[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (devices[dev].sms == 0) {
    err = cudaDeviceGetAttribute(&devices[dev].sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *info = &devices[dev];
  return cudaSuccess;
}

template <int BN, int BK>
cudaError_t launch_conv(int variant, const CUtensorMap& x_map, const CUtensorMap& w_map,
                        const float* sw, const float* bias, const unsigned* amax, void* out,
                        const Shape& s, int smem, cudaStream_t st) {
  DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  if (!info->smem_set[variant]) {
    err = cudaFuncSetAttribute(conv_kernel<BN, BK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    info->smem_set[variant] = true;
  }
  const long long blocks = s.tiles < info->sms ? s.tiles : info->sms;
  conv_kernel<BN, BK><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      x_map, w_map, sw, bias, amax, out, s);
  return cudaSuccess;
}

template <int BK>
cudaError_t launch_by_bn(int bn, const CUtensorMap& x_map, const CUtensorMap& w_map,
                         const float* sw, const float* bias, const unsigned* amax, void* out,
                         const Shape& s, int smem, cudaStream_t st) {
  const int v = BK == 128 ? 4 : 0;  // an index per instantiation
  switch (bn) {
    case 32: return launch_conv<32, BK>(v + 3, x_map, w_map, sw, bias, amax, out, s, smem, st);
    case 64: return launch_conv<64, BK>(v, x_map, w_map, sw, bias, amax, out, s, smem, st);
    case 128: return launch_conv<128, BK>(v + 1, x_map, w_map, sw, bias, amax, out, s, smem, st);
    case 256: return launch_conv<256, BK>(v + 2, x_map, w_map, sw, bias, amax, out, s, smem, st);
    default: return cudaErrorInvalidValue;
  }
}

int reduce_blocks(long long n_vec) {
  const long long want = (n_vec + kReduceThreads - 1) / kReduceThreads;
  return static_cast<int>(want < 132 * 16 ? (want > 0 ? want : 1) : 132 * 16);
}

// the max and the quantize pass: 16-byte vectors where xq's rows are x's
// (cp == cin) and x is 16-byte aligned, else one element at a time, xq
// padded to cp
template <typename T>
cudaError_t passes(const void* x, void* amax, void* xq, long long pixels, int cin, int cp,
                   cudaStream_t st) {
  const long long n = pixels * cin;
  const bool vec = cp == cin && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long long n_vec = vec ? n / Vec<T>::kN : 0;
  const int blocks = reduce_blocks(vec ? n_vec : (n + Vec<T>::kN - 1) / Vec<T>::kN);
  auto* amax_u = static_cast<unsigned*>(amax);
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  absmax_kernel<T><<<blocks, kReduceThreads, 0, st>>>(static_cast<const T*>(x), n_vec, n,
                                                       amax_u);
  if (vec) {
    quantize_kernel<T><<<blocks, kReduceThreads, 0, st>>>(static_cast<const T*>(x), n_vec,
                                                           amax_u, static_cast<int8_t*>(xq));
  } else {
    quantize_padded_kernel<T><<<blocks, kReduceThreads, 0, st>>>(
        static_cast<const T*>(x), pixels * cp / 4, cin, cp, amax_u,
        static_cast<int8_t*>(xq));
  }
  return cudaSuccess;
}

}  // namespace

// x (B, H, W, Cin) in the compute dtype, wq (Cout, 3, 3, Cp) int8 (Cin
// padded with zero codes to Cp, Cin rounded up to 16; 16-byte aligned), sw
// and bias (Cout,) fp32, amax one 4-byte scratch word, xq (B, H, W, Cp) int8
// scratch, out (B, H, W, Cout) in the compute dtype (int32 with
// accumulators). The tile plan (bn, bk, stages, box_w, box_h, smem_bytes)
// comes from ops/int8_conv.py int8_tile_plan, which also checks the shapes.
extern "C" int mqgan_int8_conv(const void* x, const void* wq, const void* sw,
                               const void* bias, void* amax, void* xq, void* out, int B,
                               int H, int W, int Cin, int Cout, int is_bf16,
                               int accumulators, int bn, int bk, int stages, int box_w,
                               int box_h, int smem_bytes, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int need = stages * (kBM + bn) * bk + kStagingBytes + kBarrierBytes + kAlign;
  const int cp = (Cin + 15) / 16 * 16;
  if (box_w <= 0 || box_h <= 0 || box_w * box_h != kBM || stages < 2 ||
      stages > kMaxStages || smem_bytes < need || smem_bytes > kSmemMax || Cin < 1 ||
      Cout < 1 || reinterpret_cast<uintptr_t>(wq) % 16 != 0 || (bk != 64 && bk != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.B = B;
  s.H = H;
  s.W = W;
  s.Cin = Cin;
  s.Cout = Cout;
  s.box_w = box_w;
  s.box_h = box_h;
  s.tiles_w = (W + box_w - 1) / box_w;
  s.tiles_h = (H + box_h - 1) / box_h;
  s.tiles_n = (Cout + bn - 1) / bn;
  s.tiles = static_cast<long long>(B) * s.tiles_h * s.tiles_w * s.tiles_n;
  s.slices = (cp + bk - 1) / bk;
  s.stages = stages;
  s.mode = accumulators ? 2 : (is_bf16 ? 1 : 0);
  s.runs = Cout % 8 == 0;

  const long long pixels = static_cast<long long>(B) * H * W;
  cudaError_t err = is_bf16 ? passes<__nv_bfloat16>(x, amax, xq, pixels, Cin, cp, st)
                            : passes<float>(x, amax, xq, pixels, Cin, cp, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap x_map, w_map;
  err = encode_maps(&x_map, &w_map, xq, wq, s, cp, bn, bk);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* swf = static_cast<const float*>(sw);
  const auto* bf = static_cast<const float*>(bias);
  const auto* amax_u = static_cast<const unsigned*>(amax);
  err = bk == 128 ? launch_by_bn<128>(bn, x_map, w_map, swf, bf, amax_u, out, s,
                                     smem_bytes, st)
                  : launch_by_bn<64>(bn, x_map, w_map, swf, bf, amax_u, out, s,
                                     smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
