// The residual-GLU block's bf16 tensor-core tile of K1's tensor-core path (residual_glu.cu): the shared-memory layout,
// the staging of a block's weights and one warp's products for 16 rows of a tile; the kernel writes its epilogue from
// the [r | s] accumulators. (The fused stack, wavenet_stack.cu, runs the same products, in the same k order, on the
// warpgroup tile of wgmma_bf16.cuh.)
//
// The gate is one GEMM of [x[t] | x[t+d]] (TT x 2C) with the four tap/branch kernels laid side by side (2C x 2 half);
// tanh * sigmoid runs on the accumulator fragments (on the SFU's tanh.approx) and the gated activation is repacked in
// registers as the A operand of the [r | s] GEMM, so it never leaves registers (rounded to bf16 there, as the bf16
// reference rounds it). Weights are staged into shared memory transposed to [n][k] with 8 elements of padding per
// row so that the fragment loads hit 32 distinct banks. Each of the 8 warps owns 16 rows of a 128-row tile.
#pragma once

#include "mma_bf16.cuh"

namespace blvm {
namespace glu_mma {

constexpr int WARPS = 8;
constexpr int TT = 16 * WARPS;  // rows per tile

template <int C, int HALF, int RS>
struct Cfg {
  static_assert(C % 16 == 0 && HALF % 32 == 0 && RS % 8 == 0 && RS > C, "mma path widths");
  static constexpr int KG = 2 * C, KG_PAD = KG + 8, KR_PAD = HALF + 8, C_PAD = C + 8;
  static constexpr int NTG = 2 * HALF / 8, NTH = HALF / 8, NTR = RS / 8, NTO = C / 8;
  static constexpr int X_TILE = TT * C_PAD;  // one staged x tile (x[t] or x[t+d]) in elements
  // weights + two buffers of (x[t], x[t+d]): the next tile's rows load while this one computes
  static constexpr size_t smem = sizeof(__nv_bfloat16) * ((size_t)2 * HALF * KG_PAD + RS * KR_PAD + 4 * X_TILE);
};

// A block's weights into shared memory: wg [2 HALF][KG_PAD] (gate columns n < HALF the tanh branch, n >= HALF the
// sigmoid branch; rows k < C tap 0) and wr [RS][KR_PAD], both n-major, from w_t, w_s (2, C, HALF) and w_rs (HALF, RS)
// row-major. 16-byte loads of 8 consecutive n, unrolled so that several are in flight, each scattered into 8 rows of
// the [n][k] layout. Neighbouring lanes take neighbouring k (KG and HALF are multiples of 32), so each 2-byte store of
// a warp covers 64 contiguous bytes of one [n] row: no bank conflicts. The caller synchronizes the CTA after it.
template <int C, int HALF, int RS>
__device__ __forceinline__ void stage_weights(__nv_bfloat16* wg, __nv_bfloat16* wr, const __nv_bfloat16* w_t,
                                              const __nv_bfloat16* w_s, const __nv_bfloat16* w_rs) {
  using K = Cfg<C, HALF, RS>;
  constexpr int NG = HALF / 8, NR = RS / 8;  // 8-column groups of a gate branch / of [r | s]
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * NG * K::KG; i += WARPS * 32) {
    const int k = i % K::KG, group = i / K::KG, branch = group / NG, n = (group - branch * NG) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(branch ? w_s : w_t) + k * NG + n / 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int u = 0; u < 8; ++u) wg[(branch * HALF + n + u) * K::KG_PAD + k] = e[u];
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < NR * HALF; i += WARPS * 32) {
    const int k = i % HALF, n = (i / HALF) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w_rs) + k * NR + n / 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int u = 0; u < 8; ++u) wr[(n + u) * K::KR_PAD + k] = e[u];
  }
}

// One warp's 16 rows (r0 ...) of a tile: both GEMMs and the gate. xo, xc: the tile's x[t] and x[t+d] rows
// [TT][C_PAD]. acc2 gets the [r | s] product without its bias: lane (g, q) holds in acc2[j] the columns j 8 + 2 q
// and + 1 of rows r0 + g (elements 0, 1) and r0 + g + 8 (2, 3). Reads only the warp's own rows of xo and xc.
template <int C, int HALF, int RS>
__device__ __forceinline__ void warp_products(const __nv_bfloat16* wg, const __nv_bfloat16* wr, const __nv_bfloat16* xo,
                                              const __nv_bfloat16* xc, const __nv_bfloat16* __restrict__ b_t,
                                              const __nv_bfloat16* __restrict__ b_s, int r0, int g, int q,
                                              float (&acc2)[RS / 8][4]) {
  using K = Cfg<C, HALF, RS>;
  float acc[K::NTG][4];
#pragma unroll
  for (int j = 0; j < K::NTG; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < K::KG / 16; ++ks) {
    const __nv_bfloat16* xa = (ks < C / 16 ? xo : xc) + (r0 + g) * K::C_PAD + (ks % (C / 16)) * 16 + 2 * q;
    const uint32_t a0 = ld32(xa), a1 = ld32(xa + 8 * K::C_PAD), a2 = ld32(xa + 8), a3 = ld32(xa + 8 * K::C_PAD + 8);
    uint32_t bf[K::NTG][2];  // all of this k-step's B fragments first: the loads overlap
#pragma unroll
    for (int j = 0; j < K::NTG; ++j) {
      const __nv_bfloat16* wb = wg + (j * 8 + g) * K::KG_PAD + ks * 16 + 2 * q;
      bf[j][0] = ld32(wb);
      bf[j][1] = ld32(wb + 8);
    }
#pragma unroll
    for (int j = 0; j < K::NTG; ++j) mma_bf16(acc[j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
  }

  // gated activation, repacked as A fragments (16 x 16 per k-step) of the [r | s] GEMM
  uint32_t act[HALF / 16][4];
#pragma unroll
  for (int j = 0; j < K::NTH; ++j) {
    const int col = j * 8 + 2 * q;
    const float bt0 = __bfloat162float(b_t[col]), bt1 = __bfloat162float(b_t[col + 1]);
    const float bs0 = __bfloat162float(b_s[col]), bs1 = __bfloat162float(b_s[col + 1]);
    constexpr int js = K::NTH;  // the sigmoid branch's tile of the same columns is j + NTH
    act[j / 2][(j % 2) * 2 + 0] = pack(gate(acc[j][0] + bt0, acc[j + js][0] + bs0),
                                       gate(acc[j][1] + bt1, acc[j + js][1] + bs1));
    act[j / 2][(j % 2) * 2 + 1] = pack(gate(acc[j][2] + bt0, acc[j + js][2] + bs0),
                                       gate(acc[j][3] + bt1, acc[j + js][3] + bs1));
  }

#pragma unroll
  for (int j = 0; j < K::NTR; ++j) acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) {
    uint32_t bf[K::NTR][2];
#pragma unroll
    for (int j = 0; j < K::NTR; ++j) {
      const __nv_bfloat16* wb = wr + (j * 8 + g) * K::KR_PAD + kk * 16 + 2 * q;
      bf[j][0] = ld32(wb);
      bf[j][1] = ld32(wb + 8);
    }
#pragma unroll
    for (int j = 0; j < K::NTR; ++j) mma_bf16(acc2[j], act[kk][0], act[kk][1], act[kk][2], act[kk][3], bf[j][0], bf[j][1]);
  }
}

}  // namespace glu_mma
}  // namespace blvm
