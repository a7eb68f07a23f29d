// K2: per-frame discretized mixture-of-logistics (DMoL) log-mass, forward, for Hopper (sm_90a).
//
// Replaces the TPU path blvm_tpu/ops/likelihoods.py discretized_logistic_mixture_ll +
// _dmol_elementwise (an XLA lowering shaped by hand): for each frame with target y in [-1, 1]
// and M components (logit, loc, log_scale),
//
//   lp_m = PixelCNN++ ladder of log P(bin of y | loc_m, log_scale_m)   (lowest bin, highest bin,
//          log(clip(cdf_delta, 1e-10)) when cdf_delta > 1e-5, else midpoint pdf - log(num_bins/2))
//   out  = logsumexp_m(lp_m + log_softmax(logits)_m)
//
// What bounds it on an H100: each frame reads (1 + 3M) floats (124 B at M = 10) and writes 4 B
// for ~40 transcendental ops per component, so at 128k frames it moves ~16 MB: a few
// microseconds of HBM time, memory- and latency-bound. The plain PyTorch version runs the
// ladder as ~30 separate elementwise kernels over (frames, M) f32 tensors, each reading and
// writing device memory. This kernel keeps every intermediate of a frame in one thread's
// registers and reads the head's output where it lies: logits and locs are strided views of
// the Dense output, so the wrapper passes row strides instead of copying.
//
// Numerics follow the JAX reference op by op in f32 (no fast-math): the same thresholds, the
// same clip, the stable softplus of jax.nn.softplus, log-softmax and logsumexp each as
// max-shifted sums. __fmul_rn / __fadd_rn keep nvcc from contracting the ladder's products and
// sums into FMAs, so each step rounds where the elementwise reference rounds.

#include <math_constants.h>

#include "common.cuh"

namespace blvm {
namespace {

constexpr int MAX_M = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dmol_log_prob_kernel(const float* __restrict__ y, const float* __restrict__ logits, const float* __restrict__ locs,
                     const float* __restrict__ log_scales, float* __restrict__ out, int64_t N, int M,
                     int64_t y_stride, int64_t logit_stride, int64_t loc_stride, int64_t scale_stride,
                     int num_bins) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  const float yv = y[row * y_stride];
  const float* lg = logits + row * logit_stride;
  const float* lc = locs + row * loc_stride;
  const float* ls = log_scales + row * scale_stride;

  // constants in double, rounded once to f32, as the reference's Python floats are
  const float half_bin = (float)(1.0 / (num_bins - 1));
  const float low_edge = (float)(2.0 / num_bins - 1.0);
  const float high_edge = (float)(1.0 - 2.0 / num_bins);
  const float log_half_bins = (float)log(num_bins / 2.0);
  const bool lowest = yv < low_edge, highest = yv > high_edge;

  // log-softmax normaliser of the mixture logits
  float lmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m)
    if (m < M) lmax = fmaxf(lmax, lg[m]);
  float lsum = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m)
    if (m < M) lsum += expf(__fadd_rn(lg[m], -lmax));
  const float log_norm = logf(lsum);

  float lp[MAX_M];
  float pmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    if (m >= M) continue;
    const float log_scale = ls[m];
    const float centered = __fadd_rn(yv, -lc[m]);
    const float inv_stdv = expf(-log_scale);
    const float plus_in = __fmul_rn(inv_stdv, __fadd_rn(centered, half_bin));
    const float minus_in = __fmul_rn(inv_stdv, __fadd_rn(centered, -half_bin));
    const float cdf_delta = __fadd_rn(sigmoidf(plus_in), -sigmoidf(minus_in));
    float v;
    if (highest) {
      v = -softplusf(minus_in);  // log(1 - CDF(y - half bin))
    } else if (lowest) {
      v = __fadd_rn(plus_in, -softplusf(plus_in));  // log CDF(y + half bin)
    } else if (cdf_delta > 1e-5f) {
      v = logf(fmaxf(cdf_delta, 1e-10f));
    } else {
      const float mid_in = __fmul_rn(inv_stdv, centered);
      const float log_pdf_mid = __fadd_rn(__fadd_rn(mid_in, -log_scale), -__fmul_rn(2.0f, softplusf(mid_in)));
      v = __fadd_rn(log_pdf_mid, -log_half_bins);
    }
    // + log_softmax(logits)_m, computed as (logit - max) - log(sum exp(logit - max))
    lp[m] = __fadd_rn(v, __fadd_rn(__fadd_rn(lg[m], -lmax), -log_norm));
    pmax = fmaxf(pmax, lp[m]);
  }
  float psum = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m)
    if (m < M) psum += expf(__fadd_rn(lp[m], -pmax));
  out[row] = __fadd_rn(pmax, logf(psum));
}

}  // namespace
}  // namespace blvm

extern "C" int blvm_dmol_log_prob(const void* y, const void* logits, const void* locs, const void* log_scales,
                                  void* out, int64_t N, int M, int64_t y_stride, int64_t logit_stride,
                                  int64_t loc_stride, int64_t scale_stride, int num_bins, void* stream) {
  using namespace blvm;
  if (N < 1 || M < 1 || M > MAX_M || num_bins < 2) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dmol_log_prob_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(logits), static_cast<const float*>(locs),
      static_cast<const float*>(log_scales), static_cast<float*>(out), N, M, y_stride, logit_stride, loc_stride,
      scale_stride, num_bins);
  return (int)cudaGetLastError();
}
