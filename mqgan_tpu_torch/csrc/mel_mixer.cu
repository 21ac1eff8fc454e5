// Fused MelMixer2D at inference, fp32 inside.
//
// Replaces: mqgan_tpu/ops/mixer_kernels.py:_fused_mixer (the Pallas TPU
// kernel `_kernel` behind fused_mel_mixer).
//
//   s   = (k x k conv over the (T, C) plane, zero outside it) + bias
//   s   = s * valid                       (valid: t < length of the row)
//   out = (A*s + B + 0.5 * sum_p w2_p * z_p * tanh(z_p)) * valid + b_out,
//         z_p = w1_p * s + b1_p
//
// What bounds it on the card: operations. Every output element evaluates
// P exact tanhf (P = 512 at the flagship: 8.6 G tanh per call at B=64,
// T=512, C=512) plus a few fp32 multiply-adds each, on the CUDA cores; the
// bytes moved are one read of x and one write of out.
//
// What the design does about it: the (B, T, C, P) hidden never exists. A
// block owns a 32-frame x 32-channel tile; it stages the tile with its
// (k/2)-wide halo in shared memory (zeros outside the plane), and w1, b1,
// w2 in shared memory, where every thread of a warp reads the same word (a
// broadcast). Each thread keeps four independent output frames in flight
// so the tanh chains overlap. Rows past a clip's length skip nothing in
// the loop but come out exactly as b_out, as the reference's do. Exact
// tanhf only; this file must not be built with --use_fast_math: an encode
// side error flips FSQ codes.

#include "common.cuh"

namespace {

constexpr int kTileC = 32;
constexpr int kTileT = 32;
constexpr int kRowsPerThread = 4;  // block (32, 8): 8 * 4 = 32 frames
constexpr int kMaxPad = 3;         // taps <= 7

template <typename T>
__global__ void __launch_bounds__(256)
mel_mixer_kernel(const T* __restrict__ x, const int* __restrict__ lengths,
                 const float* __restrict__ dwk,
                 const float* __restrict__ consts,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, T* __restrict__ out, int t_len,
                 int c_len, int p_len, int k) {
  __shared__ float xs[kTileT + 2 * kMaxPad][kTileC + 2 * kMaxPad];
  __shared__ float ks[(2 * kMaxPad + 1) * (2 * kMaxPad + 1)];
  extern __shared__ float wsm[];  // w1 | b1 | w2, p_len each

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTileT, c0 = blockIdx.x * kTileC;
  const int pad = k / 2;
  const int tid = threadIdx.y * kTileC + threadIdx.x;
  const int tile_h = kTileT + 2 * pad, tile_w = kTileC + 2 * pad;
  const T* xb = x + static_cast<size_t>(b) * t_len * c_len;
  for (int i = tid; i < tile_h * tile_w; i += 256) {
    const int r = i / tile_w, cc = i - r * tile_w;
    const int t = t0 + r - pad, c = c0 + cc - pad;
    float v = 0.0f;
    if (t >= 0 && t < t_len && c >= 0 && c < c_len) {
      v = mqgan::to_f32<T>(xb[static_cast<size_t>(t) * c_len + c]);
    }
    xs[r][cc] = v;
  }
  for (int i = tid; i < k * k; i += 256) ks[i] = dwk[i];
  for (int i = tid; i < p_len; i += 256) {
    wsm[i] = w1[i];
    wsm[p_len + i] = b1[i];
    wsm[2 * p_len + i] = w2[i];
  }
  __syncthreads();

  const int len = lengths[b];
  const float dw_bias = consts[0], out_bias = consts[1];
  const float a_lin = consts[2], b_lin = consts[3];

  float s[kRowsPerThread], valid[kRowsPerThread], acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int lr = threadIdx.y + 8 * r;
    float v = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      for (int dx = 0; dx < k; ++dx) {
        v = v + ks[dy * k + dx] * xs[lr + dy][threadIdx.x + dx];
      }
    }
    valid[r] = (t0 + lr < len) ? 1.0f : 0.0f;
    s[r] = (v + dw_bias) * valid[r];
    acc[r] = 0.0f;
  }

  const float* sw1 = wsm;
  const float* sb1 = wsm + p_len;
  const float* sw2 = wsm + 2 * p_len;
#pragma unroll 2
  for (int p = 0; p < p_len; ++p) {
    const float wa = sw1[p], wb = sb1[p], wc = sw2[p];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float z = wa * s[r] + wb;
      acc[r] = acc[r] + wc * (z * tanhf(z));
    }
  }

  const int c = c0 + threadIdx.x;
  if (c >= c_len) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int t = t0 + threadIdx.y + 8 * r;
    if (t < t_len) {
      const float o = (a_lin * s[r] + b_lin + 0.5f * acc[r]) * valid[r]
                      + out_bias;
      out[(static_cast<size_t>(b) * t_len + t) * c_len + c] =
          mqgan::from_f32<T>(o);
    }
  }
}

}  // namespace

extern "C" int mqgan_mel_mixer(const void* x, const void* lengths,
                               const void* dwk, const void* consts,
                               const void* w1, const void* b1, const void* w2,
                               void* out, int b, int t, int c, int p, int k,
                               int is_bf16, void* stream) {
  const dim3 block(kTileC, 256 / kTileC);
  const dim3 grid((c + kTileC - 1) / kTileC, (t + kTileT - 1) / kTileT, b);
  const size_t smem = 3 * static_cast<size_t>(p) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* kf = static_cast<const float*>(dwk);
  const float* cf = static_cast<const float*>(consts);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  if (is_bf16) {
    mel_mixer_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), len, kf, cf, w1f, b1f, w2f,
        static_cast<__nv_bfloat16*>(out), t, c, p, k);
  } else {
    mel_mixer_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(x), len, kf, cf, w1f, b1f, w2f,
        static_cast<float*>(out), t, c, p, k);
  }
  return static_cast<int>(cudaGetLastError());
}
