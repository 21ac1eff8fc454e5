// Shared device helpers for the port's kernels: conversions between the
// storage type (float or __nv_bfloat16) and fp32, rounding to the storage
// type, and the APTx activation evaluated op by op in the storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mqgan {

template <typename T>
__device__ __forceinline__ float to_f32(T v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);

template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// v rounded to T and back: identity for float, bf16 rounding for bf16.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

// (1 + tanh(beta * z)) * (gamma * z), rounding to T after every op, as the
// reference evaluates it in the compute dtype. beta and gamma are already
// in T. Exact tanhf: no approximate transcendental anywhere.
template <typename T>
__device__ __forceinline__ float aptx(float z, float beta, float gamma) {
  float th = round_to<T>(tanhf(round_to<T>(beta * z)));
  return round_to<T>(1.0f + th) * round_to<T>(gamma * z);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace mqgan
