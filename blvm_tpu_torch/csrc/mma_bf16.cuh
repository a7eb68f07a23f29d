// Warp-level bf16 tensor-core helpers shared by the residual-GLU kernels (forward and backward):
// mma.sync m16n8k16 (bf16 in, f32 accumulate), cp.async copies (also used by K1's f32 tiled path and
// K12) and the SFU's tanh.
#pragma once

#include "common.cuh"

namespace blvm {

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// 16-byte asynchronous copy global -> shared; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 16 : 0));
}
// the same for f32 (16 bytes: four floats, 16-byte aligned)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// tanh on the SFU's tanh.approx.f32 (max relative error ~2^-11). The bf16 paths round their
// results to bf16 (2^-9 relative) right after, so the approximation stays below that rounding;
// the precise tanhf / expf and IEEE division cost ~60 instructions a pair.
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// sigmoid(b) = 0.5 tanh(b / 2) + 0.5
__device__ __forceinline__ float sigmoid_approx(float b) { return fmaf(0.5f, tanh_approx(0.5f * b), 0.5f); }
// the gated activation tanh(a) * sigmoid(b)
__device__ __forceinline__ float gate(float a, float b) { return tanh_approx(a) * sigmoid_approx(b); }

}  // namespace blvm
