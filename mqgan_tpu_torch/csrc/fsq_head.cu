// Fused FSQ encode head: h (N, C) -> packed int32 FSQ index per row.
//
// Replaces: mqgan_tpu/ops/fsq_kernels.py:_fsq_encode_pallas (the Pallas TPU
// kernel `_kernel` behind FSQEncodeHead).
//
//   z = h . W + b (fp32, d = 4 code dims), bounded = tanh(z + shift) * half_l
//   - offset, q = round half to even (rintf), idx = sum((q + half_w) * basis)
//
// What bounds it on the card: bytes. It reads h once (B*T*C values; 50 MB
// in bf16 at the flagship B=64, T=512, C=768) and does 8 flops per value,
// far below the H100's ratio of flops to bytes.
//
// What the design does about it: one warp per row streams the row with
// consecutive lanes on consecutive addresses, keeps W (C x d fp32, 12 KB at
// the flagship) in shared memory transposed so that the lanes read
// consecutive banks, reduces the d dot products with warp shuffles, and
// writes one int per row. Nothing but h and the indices touches device
// memory. The TPU kernel's 128-lane padding of d has no counterpart here.
// rintf rounds halves to even like jnp.round/torch.round (roundf would round
// them away from zero); tanhf is the exact one.

#include "common.cuh"

namespace {

constexpr int kMaxD = 8;
constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fsq_head_kernel(const T* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ consts, int* __restrict__ idx,
                int n, int c, int d) {
  extern __shared__ float ws[];  // (d, c): W transposed
  for (int i = threadIdx.x; i < c * d; i += blockDim.x) {
    const int ci = i / d, di = i - ci * d;
    ws[di * c + ci] = w[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together

  float acc[kMaxD];
#pragma unroll
  for (int j = 0; j < kMaxD; ++j) acc[j] = 0.0f;
  const T* hr = h + static_cast<size_t>(row) * c;
  for (int ci = lane; ci < c; ci += 32) {
    const float hv = mqgan::to_f32<T>(hr[ci]);
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      if (j < d) acc[j] = fmaf(hv, ws[j * c + ci], acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxD; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
  }
  if (lane == 0) {
    float total = 0.0f;
    for (int j = 0; j < d; ++j) {
      const float half_l = consts[j], offset = consts[d + j];
      const float shift = consts[2 * d + j], half_w = consts[3 * d + j];
      const float basis = consts[4 * d + j];
      const float z = acc[j] + bias[j];
      // separate multiply and subtract, as the reference rounds them
      const float bounded = __fsub_rn(__fmul_rn(tanhf(z + shift), half_l),
                                      offset);
      const float q = rintf(bounded);
      total += (q + half_w) * basis;
    }
    idx[row] = static_cast<int>(total);
  }
}

}  // namespace

extern "C" int mqgan_fsq_head(const void* h, int h_is_bf16, const void* w,
                              const void* bias, const void* consts, void* idx,
                              int n, int c, int d, void* stream) {
  const dim3 block(kWarps * 32);
  const dim3 grid((n + kWarps - 1) / kWarps);
  const size_t smem = static_cast<size_t>(c) * d * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const float* cf = static_cast<const float*>(consts);
  int* out = static_cast<int*>(idx);
  if (h_is_bf16) {
    fsq_head_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(h), wf, bf, cf, out, n, c, d);
  } else {
    fsq_head_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(h), wf, bf, cf, out, n, c, d);
  }
  return static_cast<int>(cudaGetLastError());
}
