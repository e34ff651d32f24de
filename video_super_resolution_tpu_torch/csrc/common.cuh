// Shared helpers of the port's CUDA kernels: f32 <-> storage-type casts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace vsr {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
// round to nearest even, as torch's f32 -> bf16 cast
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace vsr
