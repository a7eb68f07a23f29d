// K3: DMoL sampler and mode, one thread per frame, for Hopper (sm_90a).
//
// Replaces the TPU path blvm_tpu/ops/variational.py rsample_discretized_logistic_mixture (:149)
// and blvm_tpu/modules/distributions.py DiscretizedLogisticMixtureDense.mode, which XLA ran as
// a chain of elementwise ops, a gather and two argmaxes. For a frame with M components
// (logit, loc, log_scale) and y_dim 1:
//
//   u_m  = cat_low + cat_scale * U_m           (U_m in [0, 1): U[eps, 1 - eps], eps = 1e-5)
//   k    = argmax_m(logit_m - log(-log(u_m)))  (Gumbel-max component pick, first index on ties)
//   v    = logistic_low + logistic_scale * U_M  (U[eps, 1 - eps], eps = 1e-8)
//   sample = clamp(loc_k + exp(log_scale_k) (log v - log(1 - v)), -1, 1)
//   mode   = loc_{argmax_m logit_m}
//
// The M + 1 uniforms U come either from the caller (u_cat (N, M), u_log (N,): the comparison with
// the plain version, which is fed the same numbers) or from a Philox4x32-10 counter-based
// generator in the kernel, keyed by a 64-bit seed the wrapper draws from the caller's
// torch.Generator into a device tensor (no host sync); the counter is (frame, block of four
// uniforms, offset). U = (bits >> 8) 2^-24, 24 random bits as torch.rand takes them.
//
// Bound: each frame reads 3M floats of the head's output (120 B at M = 10) and writes 8 B: at
// 128k frames ~16 MB, ~5 us of HBM time. The kernel reads the head's strided slices in place
// and keeps a frame in registers. Numerics: the same f32 ops in the same order as the plain
// version (precise logf / expf, no contraction), so fed the same uniforms both give the same
// numbers.

#include <math_constants.h>

#include "common.cuh"

namespace blvm {
namespace {

constexpr int MAX_M = 32;
constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS)
dmol_sample_kernel(const float* __restrict__ logits, const float* __restrict__ locs,
                   const float* __restrict__ log_scales, const float* __restrict__ u_cat,
                   const float* __restrict__ u_log, const int64_t* __restrict__ seed, float* __restrict__ sample,
                   float* __restrict__ mode, int64_t N, int M, int64_t logit_stride, int64_t loc_stride,
                   int64_t scale_stride, float cat_low, float cat_scale, float logistic_low, float logistic_scale) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  const float* lg = logits + row * logit_stride;
  const float* lc = locs + row * loc_stride;
  const float* ls = log_scales + row * scale_stride;

  float U[MAX_M + 1];
  if (seed != nullptr) {
    const uint64_t key = (uint64_t)seed[0], offset = (uint64_t)seed[1];
    const uint2 k = make_uint2((uint32_t)key, (uint32_t)(key >> 32));
#pragma unroll
    for (int blk = 0; blk < (MAX_M + 1 + 3) / 4; ++blk) {
      if (4 * blk > M) break;  // uniforms 0 .. M are needed
      const uint4 r = philox4x32_10(make_uint4((uint32_t)row, (uint32_t)(row >> 32), (uint32_t)blk, (uint32_t)offset), k);
      U[4 * blk] = unit(r.x);
      if (4 * blk + 1 <= MAX_M) U[4 * blk + 1] = unit(r.y);
      if (4 * blk + 2 <= MAX_M) U[4 * blk + 2] = unit(r.z);
      if (4 * blk + 3 <= MAX_M) U[4 * blk + 3] = unit(r.w);
    }
  } else {
#pragma unroll
    for (int m = 0; m < MAX_M; ++m)
      if (m < M) U[m] = u_cat[row * M + m];
  }
  const float u_logistic = seed != nullptr ? U[M] : u_log[row];

  int pick = 0, best = 0;
  float pick_v = -CUDART_INF_F, best_v = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    if (m >= M) continue;
    const float u = __fadd_rn(__fmul_rn(cat_scale, U[m]), cat_low);
    const float v = __fadd_rn(lg[m], -logf(-logf(u)));
    if (v > pick_v || m == 0) pick_v = v, pick = m;
    if (lg[m] > best_v || m == 0) best_v = lg[m], best = m;
  }
  const float u = __fadd_rn(__fmul_rn(logistic_scale, u_logistic), logistic_low);
  const float x = __fadd_rn(lc[pick], __fmul_rn(expf(ls[pick]), __fadd_rn(logf(u), -logf(__fadd_rn(1.0f, -u)))));
  sample[row] = fminf(fmaxf(x, -1.0f), 1.0f);
  mode[row] = lc[best];
}

}  // namespace
}  // namespace blvm

// seed: a device int64[2] (key, offset) for the in-kernel generator, or null with u_cat (N, M) and
// u_log (N,) supplied. sample and mode: (N,) f32. The affine maps of the uniforms come from the
// wrapper as f32 constants, rounded as the plain version's Python floats are.
extern "C" int blvm_dmol_sample(const void* logits, const void* locs, const void* log_scales, const void* u_cat,
                                const void* u_log, const void* seed, void* sample, void* mode, int64_t N, int M,
                                int64_t logit_stride, int64_t loc_stride, int64_t scale_stride, float cat_low,
                                float cat_scale, float logistic_low, float logistic_scale, void* stream) {
  using namespace blvm;
  if (N < 1 || M < 1 || M > MAX_M || (seed == nullptr && (u_cat == nullptr || u_log == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dmol_sample_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(locs), static_cast<const float*>(log_scales),
      static_cast<const float*>(u_cat), static_cast<const float*>(u_log), static_cast<const int64_t*>(seed),
      static_cast<float*>(sample), static_cast<float*>(mode), N, M, logit_stride, loc_stride, scale_stride, cat_low,
      cat_scale, logistic_low, logistic_scale);
  return (int)cudaGetLastError();
}
