// Tensor-core and async-copy helpers shared by the bf16 kernels
// (flash_attention.cuh, residual_block.cu): cp.async into shared memory,
// ldmatrix, mma.sync m16n8k16 (bf16 in, fp32 accumulate) and the
// per-lane offsets of their fragments.
//
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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace mqgan {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 8, or 4) bytes from global to shared memory; with !in
// nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 8 : 0));
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

}  // namespace mqgan
