// The DMoL sampler's per-frame routine, shared by K3 (csrc/dmol_sample.cu, a batch of frames) and K4
// (csrc/wavenet_decode.cu, one generated frame a sequence), so the two draw the same numbers from the
// same key and compute the same sample from them.
//
// For a frame with M components (logit, loc, log_scale) and y_dim 1:
//
//   u_m  = cat_low + cat_scale * U_m           (U_m in [0, 1): U[eps, 1 - eps], eps = 1e-5)
//   k    = argmax_m(logit_m - log(-log(u_m)))  (Gumbel-max component pick, first index on ties)
//   v    = logistic_low + logistic_scale * U_M  (U[eps, 1 - eps], eps = 1e-8)
//   sample = clamp(loc_k + exp(log_scale_k) (log v - log(1 - v)), -1, 1)
//   mode   = loc_{argmax_m logit_m}
//
// The M + 1 uniforms U come from the caller or from a Philox4x32-10 counter-based generator keyed by
// a device int64[2] seed = (key, offset) that the wrapper draws from the caller's torch.Generator (no
// host sync). The counter of frame row `row` at step `step` is (row, row >> 32, block of four
// uniforms, offset + step): a generation draws its seed once and steps by the frame index, so every
// frame gets fresh numbers and K3 and K4 agree on them. U = (bits >> 8) 2^-24, 24 random bits as
// torch.rand takes them. Numerics: the same f32 ops in the same order as the plain version
// (ops/variational.py, precise logf / expf, no contraction), so fed the same uniforms both give the
// same numbers.
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace blvm {

constexpr int DMOL_MAX_M = 32;

// Philox4x32-10 (Salmon et al., SC'11): ten rounds of the 4x32 S-box with the Weyl key schedule.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float unit(uint32_t bits) { return (float)(bits >> 8) * (1.0f / 16777216.0f); }

// The affine maps of the uniforms, f32 constants from the wrapper, rounded as the plain version's
// Python floats are: U[low, low + scale) from U in [0, 1).
struct UniformMaps {
  float cat_low, cat_scale, logistic_low, logistic_scale;
};

// U[0 .. M] of frame row `row` from the Philox stream of `seed` at `step`.
__device__ __forceinline__ void philox_uniforms(const int64_t* seed, int64_t step, int64_t row, int M,
                                                float (&U)[DMOL_MAX_M + 1]) {
  const uint64_t key = (uint64_t)seed[0], offset = (uint64_t)seed[1] + (uint64_t)step;
  const uint2 k = make_uint2((uint32_t)key, (uint32_t)(key >> 32));
#pragma unroll
  for (int blk = 0; blk < (DMOL_MAX_M + 1 + 3) / 4; ++blk) {
    if (4 * blk > M) break;  // uniforms 0 .. M are needed
    const uint4 r = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)(row >> 32), (uint32_t)blk, (uint32_t)offset), k);
    U[4 * blk] = unit(r.x);
    if (4 * blk + 1 <= DMOL_MAX_M) U[4 * blk + 1] = unit(r.y);
    if (4 * blk + 2 <= DMOL_MAX_M) U[4 * blk + 2] = unit(r.z);
    if (4 * blk + 3 <= DMOL_MAX_M) U[4 * blk + 3] = unit(r.w);
  }
}

// The sample of one frame from its M logits, locs and log-scales (lg, lc, ls), the categorical
// uniforms U[0 .. M) and the logistic uniform u_logistic; the mode goes to *mode.
__device__ __forceinline__ float dmol_sample_frame(const float* lg, const float* lc, const float* ls, int M,
                                                   const float (&U)[DMOL_MAX_M + 1], float u_logistic,
                                                   const UniformMaps& maps, float* mode) {
  int pick = 0, best = 0;
  float pick_v = -CUDART_INF_F, best_v = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < DMOL_MAX_M; ++m) {
    if (m >= M) continue;
    const float u = __fadd_rn(__fmul_rn(maps.cat_scale, U[m]), maps.cat_low);
    const float v = __fadd_rn(lg[m], -logf(-logf(u)));
    if (v > pick_v || m == 0) pick_v = v, pick = m;
    if (lg[m] > best_v || m == 0) best_v = lg[m], best = m;
  }
  const float u = __fadd_rn(__fmul_rn(maps.logistic_scale, u_logistic), maps.logistic_low);
  const float x = __fadd_rn(lc[pick], __fmul_rn(expf(ls[pick]), __fadd_rn(logf(u), -logf(__fadd_rn(1.0f, -u)))));
  *mode = lc[best];
  return fminf(fmaxf(x, -1.0f), 1.0f);
}

}  // namespace blvm
