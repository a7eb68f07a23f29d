// Register-tiled f32 FMA products shared by the residual-GLU kernels' f32 paths at STCN's width (the
// forward's tiled path in residual_glu.cu and both passes of residual_glu_bwd.cu's): a thread owns RM rows
// x 4 output units and takes 4 k steps as RM broadcast 16-byte row loads and one 16-byte weight load a k
// (two with a second weight block), so that FMA issue, not shared-memory loads, bounds the product.
#pragma once

#include "common.cuh"

namespace blvm {
namespace fma_tile {

__device__ __forceinline__ float lane4(const float4& v, int j) { return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w; }

// acc[i][j] (+ acc2[i][j]) += sum over one staged chunk's KC rows k of a[row r0 + i][k0 + k] w[k][u0 + j] (and
// w[k][OFF2 + u0 + j]); a is row-major with row stride lda, w the staged chunk with row stride WCOLS
template <int KC, int RM, int WCOLS, int OFF2, bool TWO>
__device__ __forceinline__ void chunk(const float* a, int lda, int k0, const float* w, int r0, int u0,
                                      float (&acc)[RM][4], float (&acc2)[RM][4]) {
#pragma unroll
  for (int kk = 0; kk < KC; kk += 4) {
    float4 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = *reinterpret_cast<const float4*>(a + (r0 + i) * lda + k0 + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b1 = *reinterpret_cast<const float4*>(w + (kk + j) * WCOLS + u0);
      float4 b2 = b1;
      if (TWO) b2 = *reinterpret_cast<const float4*>(w + (kk + j) * WCOLS + OFF2 + u0);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float x = lane4(av[i], j);
        acc[i][0] = fmaf(x, b1.x, acc[i][0]);
        acc[i][1] = fmaf(x, b1.y, acc[i][1]);
        acc[i][2] = fmaf(x, b1.z, acc[i][2]);
        acc[i][3] = fmaf(x, b1.w, acc[i][3]);
        if (TWO) {
          acc2[i][0] = fmaf(x, b2.x, acc2[i][0]);
          acc2[i][1] = fmaf(x, b2.y, acc2[i][1]);
          acc2[i][2] = fmaf(x, b2.z, acc2[i][2]);
          acc2[i][3] = fmaf(x, b2.w, acc2[i][3]);
        }
      }
    }
  }
}

}  // namespace fma_tile
}  // namespace blvm
