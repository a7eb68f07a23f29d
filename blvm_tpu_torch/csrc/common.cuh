// Shared helpers of the port's CUDA kernels (plain C interface, no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blvm {

// dtype codes the Python wrappers pass: 0 = float32, 1 = bfloat16
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// 1 / (1 + exp(-x)), the form PyTorch's elementwise float sigmoid uses.
__device__ __forceinline__ float sigmoidf(float x) { return 1.0f / (1.0f + expf(-x)); }

// Stable softplus, log(1 + e^x) = max(x, 0) + log1p(e^-|x|): jax.nn.softplus (logaddexp(x, 0)).
__device__ __forceinline__ float softplusf(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

}  // namespace blvm
