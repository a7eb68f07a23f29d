// K3: DMoL sampler and mode, one thread per frame, for Hopper (sm_90a).
//
// Replaces the TPU path blvm_tpu/ops/variational.py rsample_discretized_logistic_mixture (:149)
// and blvm_tpu/modules/distributions.py DiscretizedLogisticMixtureDense.mode, which XLA ran as
// a chain of elementwise ops, a gather and two argmaxes. The per-frame routine, its formulas and
// its Philox stream are in dmol_sample.cuh, shared with K4 (the Fast-WaveNet decode step).
//
// The M + 1 uniforms of a frame come either from the caller (u_cat (N, M), u_log (N,): the
// comparison with the plain version, which is fed the same numbers) or from the Philox stream of
// `seed` at `step`, with the frame's row as the counter: a forward draws a fresh seed and samples at
// step 0; a generation draws its seed once and samples frame f at step f.
//
// Bound: each frame reads 3M floats of the head's output (120 B at M = 10) and writes 8 B: at
// 128k frames ~16 MB, ~5 us of HBM time. The kernel reads the head's strided slices in place
// and keeps a frame in registers.

#include "dmol_sample.cuh"

namespace blvm {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dmol_sample_kernel(const float* __restrict__ logits, const float* __restrict__ locs,
                   const float* __restrict__ log_scales, const float* __restrict__ u_cat,
                   const float* __restrict__ u_log, const int64_t* __restrict__ seed, int64_t step,
                   float* __restrict__ sample, float* __restrict__ mode, int64_t N, int M, int64_t logit_stride,
                   int64_t loc_stride, int64_t scale_stride, UniformMaps maps) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;

  float U[DMOL_MAX_M + 1];
  float u_logistic;
  if (seed != nullptr) {
    philox_uniforms(seed, step, row, M, U);
    u_logistic = U[M];
  } else {
#pragma unroll
    for (int m = 0; m < DMOL_MAX_M; ++m)
      if (m < M) U[m] = u_cat[row * M + m];
    u_logistic = u_log[row];
  }
  sample[row] = dmol_sample_frame(logits + row * logit_stride, locs + row * loc_stride,
                                  log_scales + row * scale_stride, M, U, u_logistic, maps, mode + row);
}

}  // namespace
}  // namespace blvm

// seed: a device int64[2] (key, offset) for the in-kernel generator, whose counter steps by `step`,
// or null with u_cat (N, M) and u_log (N,) supplied. sample and mode: (N,) f32. The affine maps of
// the uniforms come from the wrapper as f32 constants, rounded as the plain version's Python floats are.
extern "C" int blvm_dmol_sample(const void* logits, const void* locs, const void* log_scales, const void* u_cat,
                                const void* u_log, const void* seed, int64_t step, void* sample, void* mode,
                                int64_t N, int M, int64_t logit_stride, int64_t loc_stride, int64_t scale_stride,
                                float cat_low, float cat_scale, float logistic_low, float logistic_scale,
                                void* stream) {
  using namespace blvm;
  if (N < 1 || M < 1 || M > DMOL_MAX_M || (seed == nullptr && (u_cat == nullptr || u_log == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dmol_sample_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(locs), static_cast<const float*>(log_scales),
      static_cast<const float*>(u_cat), static_cast<const float*>(u_log), static_cast<const int64_t*>(seed), step,
      static_cast<float*>(sample), static_cast<float*>(mode), N, M, logit_stride, loc_stride, scale_stride,
      UniformMaps{cat_low, cat_scale, logistic_low, logistic_scale});
  return (int)cudaGetLastError();
}
