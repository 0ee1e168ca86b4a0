// Shared helpers for the port's hand-written kernels: float conversion of
// the two element types the kernels take (fp32 and bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as torch's .to(bfloat16)
}

// dtype codes shared with the Python wrappers (ops/_build.py).
enum DType : int { kF32 = 0, kBF16 = 1 };
