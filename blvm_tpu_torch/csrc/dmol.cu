// K2: per-frame discretized mixture-of-logistics (DMoL) log-mass, forward and backward, for Hopper
// (sm_90a).
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

// Backward (dmol_log_prob_bwd_kernel): one thread per frame recomputes the components' log-masses
// lp_m (ladder branch, log-softmax) and the responsibilities w_m = exp(lp_m - out); with g the
// gradient of the frame's output,
//   d logit_m = g (w_m - softmax(logits)_m)
//   d loc_m, d log_scale_m = g w_m (d lp_m / d loc_m, d lp_m / d log_scale_m) on the branch of the
//   ladder the forward chose (what autograd of the where-ladder gives: the other branches get 0).
// y gets no gradient (the model detaches its targets). Bound: it reads what the forward reads
// plus g and writes 3M floats a frame (248 bytes at M = 10, ~32 MB at 128k frames, ~10 us of HBM
// time); all intermediates stay in registers. The same rounding discipline as the forward.

#include <math_constants.h>

#include "common.cuh"

namespace blvm {
namespace {

constexpr int MAX_M = 32;
constexpr int THREADS = 256;

// One frame: returns its log-mass and leaves each component's lp_m (ladder value + log-softmax
// weight) in lp, and the log-softmax's lmax and log_norm; with kGrad also the derivatives of each
// component's ladder value by its loc and its log-scale, on the branch of the ladder it takes.
template <bool kGrad>
__device__ __forceinline__ float frame_log_prob(float yv, const float* lg, const float* lc, const float* ls, int M,
                                                int num_bins, float (&lp)[MAX_M], float (&dloc)[MAX_M],
                                                float (&dscale)[MAX_M], float& lmax, float& log_norm) {
  // constants in double, rounded once to f32, as the reference's Python floats are
  const float half_bin = (float)(1.0 / (num_bins - 1));
  const float low_edge = (float)(2.0 / num_bins - 1.0);
  const float high_edge = (float)(1.0 - 2.0 / num_bins);
  const float log_half_bins = (float)log(num_bins / 2.0);
  const bool lowest = yv < low_edge, highest = yv > high_edge;

  // log-softmax normaliser of the mixture logits
  lmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m)
    if (m < M) lmax = fmaxf(lmax, lg[m]);
  float lsum = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m)
    if (m < M) lsum += expf(__fadd_rn(lg[m], -lmax));
  log_norm = logf(lsum);

  float pmax = -CUDART_INF_F;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    if (m >= M) continue;
    const float log_scale = ls[m];
    const float centered = __fadd_rn(yv, -lc[m]);
    const float inv_stdv = expf(-log_scale);
    const float plus_in = __fmul_rn(inv_stdv, __fadd_rn(centered, half_bin));
    const float minus_in = __fmul_rn(inv_stdv, __fadd_rn(centered, -half_bin));
    const float sig_plus = sigmoidf(plus_in), sig_minus = sigmoidf(minus_in);
    const float cdf_delta = __fadd_rn(sig_plus, -sig_minus);
    float v;
    // derivatives: d plus_in / d loc = -1/s and d plus_in / d log_scale = -plus_in (minus_in alike)
    if (highest) {  // log(1 - CDF(y - half bin)) = -softplus(minus_in)
      v = -softplusf(minus_in);
      if (kGrad) dloc[m] = sig_minus * inv_stdv, dscale[m] = sig_minus * minus_in;
    } else if (lowest) {  // log CDF(y + half bin) = plus_in - softplus(plus_in)
      v = __fadd_rn(plus_in, -softplusf(plus_in));
      if (kGrad) dloc[m] = -(1.f - sig_plus) * inv_stdv, dscale[m] = -(1.f - sig_plus) * plus_in;
    } else if (cdf_delta > 1e-5f) {  // log(cdf_delta)
      v = logf(fmaxf(cdf_delta, 1e-10f));
      if (kGrad) {
        const float dp = sig_plus * (1.f - sig_plus), dm = sig_minus * (1.f - sig_minus);
        dloc[m] = inv_stdv * (dm - dp) / cdf_delta;
        dscale[m] = (minus_in * dm - plus_in * dp) / cdf_delta;
      }
    } else {  // midpoint pdf: mid_in - log_scale - 2 softplus(mid_in) - log(num_bins / 2)
      const float mid_in = __fmul_rn(inv_stdv, centered);
      const float log_pdf_mid = __fadd_rn(__fadd_rn(mid_in, -log_scale), -__fmul_rn(2.0f, softplusf(mid_in)));
      v = __fadd_rn(log_pdf_mid, -log_half_bins);
      if (kGrad) {
        const float dv = 1.f - 2.f * sigmoidf(mid_in);
        dloc[m] = -dv * inv_stdv, dscale[m] = -dv * mid_in - 1.f;
      }
    }
    // + log_softmax(logits)_m, computed as (logit - max) - log(sum exp(logit - max))
    lp[m] = __fadd_rn(v, __fadd_rn(__fadd_rn(lg[m], -lmax), -log_norm));
    pmax = fmaxf(pmax, lp[m]);
  }
  float psum = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_M; ++m)
    if (m < M) psum += expf(__fadd_rn(lp[m], -pmax));
  return __fadd_rn(pmax, logf(psum));
}

__global__ void __launch_bounds__(THREADS)
dmol_log_prob_kernel(const float* __restrict__ y, const float* __restrict__ logits, const float* __restrict__ locs,
                     const float* __restrict__ log_scales, float* __restrict__ out, int64_t N, int M,
                     int64_t y_stride, int64_t logit_stride, int64_t loc_stride, int64_t scale_stride,
                     int num_bins) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  float lp[MAX_M], unused[MAX_M], lmax, log_norm;
  out[row] = frame_log_prob<false>(y[row * y_stride], logits + row * logit_stride, locs + row * loc_stride,
                                   log_scales + row * scale_stride, M, num_bins, lp, unused, unused, lmax, log_norm);
}

__global__ void __launch_bounds__(THREADS)
dmol_log_prob_bwd_kernel(const float* __restrict__ y, const float* __restrict__ logits,
                         const float* __restrict__ locs, const float* __restrict__ log_scales,
                         const float* __restrict__ g, float* __restrict__ d_logits, float* __restrict__ d_locs,
                         float* __restrict__ d_log_scales, int64_t N, int M, int64_t y_stride, int64_t logit_stride,
                         int64_t loc_stride, int64_t scale_stride, int num_bins) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= N) return;
  const float* lg = logits + row * logit_stride;
  float lp[MAX_M], dloc[MAX_M], dscale[MAX_M], lmax, log_norm;
  const float out = frame_log_prob<true>(y[row * y_stride], lg, locs + row * loc_stride, log_scales + row * scale_stride,
                                         M, num_bins, lp, dloc, dscale, lmax, log_norm);
  const float gv = g[row];
#pragma unroll
  for (int m = 0; m < MAX_M; ++m) {
    if (m >= M) continue;
    const float w = expf(__fadd_rn(lp[m], -out));                          // responsibility
    const float p = expf(__fadd_rn(__fadd_rn(lg[m], -lmax), -log_norm));  // softmax(logits)_m
    d_logits[row * M + m] = gv * (w - p);
    d_locs[row * M + m] = gv * w * dloc[m];
    d_log_scales[row * M + m] = gv * w * dscale[m];
  }
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

// d_logits, d_locs, d_log_scales: (N, M) contiguous; g: (N,) contiguous.
extern "C" int blvm_dmol_log_prob_bwd(const void* y, const void* logits, const void* locs, const void* log_scales,
                                      const void* g, void* d_logits, void* d_locs, void* d_log_scales, int64_t N,
                                      int M, int64_t y_stride, int64_t logit_stride, int64_t loc_stride,
                                      int64_t scale_stride, int num_bins, void* stream) {
  using namespace blvm;
  if (N < 1 || M < 1 || M > MAX_M || num_bins < 2) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (N + THREADS - 1) / THREADS;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dmol_log_prob_bwd_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(logits), static_cast<const float*>(locs),
      static_cast<const float*>(log_scales), static_cast<const float*>(g), static_cast<float*>(d_logits),
      static_cast<float*>(d_locs), static_cast<float*>(d_log_scales), N, M, y_stride, logit_stride, loc_stride,
      scale_stride, num_bins);
  return (int)cudaGetLastError();
}
