// K9: the SRNN's latent chain over all T' steps of a sequence batch, f32, on sm_90a.
//
// Replaces the lax.scan body of blvm_tpu/models/srnn.py _SRNNStep.__call__ (:68-96) and, in its prior mode,
// _SRNNStep.prior_step (:98-108), ungated and without phi_z (the SRNNAudio driver's model). Per step t, for a
// row of the batch (R = r_dim, H = h_dim, Z = z_dim; every MLP layer a Dense and a LeakyReLU of slope 0.01):
//   prior:     p = MLP3([d_t, z_{t-1}]);  (mu_p, raw_p) = p W_ph + b_ph;  sd_p = softplus(beta raw_p) / beta + eps_sd
//   posterior: q = MLP3([a_t, z_{t-1}]);  (mu_q, raw_q) = q W_qh + b_qh;  mu_q += mu_p under residual_posterior
//   z_t = mu_q + sd_q e_t   (prior mode: z_t = mu_p + sd_p e_t, or mu_p under use_mode)
// The d and a parts of the first layers (and their biases) do not depend on z: the wrapper computes
// xp = d W_p0[:R] + b_p0 and xq = a W_q0[:R] + b_q0 for all B T' rows as two cuBLAS GEMMs before the
// launch, and the chain keeps only the z rows of the two first kernels. Tensors are batch-first and
// contiguous: xp, xq (B, T', H); z0 (B, Z); e (B, T', Z); outputs z, mu/sd of both heads (B, T', Z).
//
// What bounds it. At the test pass's shape (B = 6, T' = 1125, H = Z = 256) a row-step does ~0.66M
// multiply-adds in the chain (~8.9 GFLOP in all, ~0.13 ms at 67 TFLOP/s) with ~2.6 MB of weights read
// once a launch. But the step is four dependent products (the first layers' z rows, two H x H layers,
// the heads), each only B rows deep: the latency of a product and of the barrier after it sets the pace.
//
// The design is K8's (vrnn_common.cuh): one persistent cooperative launch for all T' steps, one CTA an
// SM, each CTA owning whole output units of every stage and keeping their weight columns in shared
// memory for the whole launch (~20 KB a CTA here). The 2.6 MB would fit a 16-CTA cluster too, but the
// cluster would run the chain on 16 SMs at 8x the columns a CTA; one CTA an SM keeps a stage's product
// short and shares its machinery with K7 and K8. Prior and posterior run side by side in every stage:
//   1: prior and posterior L1 (z rows + xp / xq)    2-3: prior and posterior L2, L3
//   4: both heads, sd, the residual mean, z
// A stage stages its input rows from L2 into shared memory, each warp reduces whole columns, the CTA
// finishes and stores its units, and a grid-wide barrier orders the stages. Given a trace buffer, the
// first CTA adds up the SM cycles of each stage's phases (inputs in, products, finish and store,
// barrier), as K8's does. No tensor cores: the JAX step is f32.
//
// In save mode (inference mode in a train step's forward) it also writes, for every row-step, what K9-bwd
// (srnn_chain_bwd.cu) reads: save (B, T', 6H + 2Z) = the pre-activations of the prior's and the posterior's
// L1, L2, L3 (in the order p1, q1, p2, q2, p3, q3) and both heads' raw sd (prior, posterior); the outputs
// are the same bits as without it.

#include "vrnn_common.cuh"

namespace blvm {
namespace srnn {

using vrnn::BC;
using vrnn::NPHASES;
using vrnn::NT;

constexpr int NWEIGHTS = 14;  // prior 7, posterior 7 (see blvm_srnn_chain)
constexpr int NSTAGES = 4;  // the trace holds NSTAGES x NPHASES sums, then the loop's cycles and nanoseconds

struct Params {
  const float* w[NWEIGHTS];
  const float* xp;
  const float* xq;   // null in prior mode
  const float* z0;
  const float* eps;  // null in prior mode under use_mode
  float* z;
  float* q_mu;  // null in prior mode
  float* q_sd;
  float* p_mu;
  float* p_sd;
  float* act;  // B x 6H: prior L1, posterior L1, prior L2, posterior L2, prior L3, posterior L3 of one step
  float* save;  // null, or (B, T, 6H + 2Z): the same layers' pre-activations and both raw sd of every step
  unsigned int* barrier;
  long long* trace;  // null, or the trace's sums: SM cycles of each (stage, phase) as CTA 0 sees them, the totals
  int B, T, H, Z;
  int inference, residual, use_mode;
  float sd_beta, sd_eps;
};

__device__ __forceinline__ float leaky_relu(float v) { return v >= 0.0f ? v : __fmul_rn(0.01f, v); }

__global__ void __launch_bounds__(NT, 1) srnn_chain_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, Z = p.Z;
  const int hlo = vrnn::part_lo(H, cta, NB), nh = vrnn::part_lo(H, cta + 1, NB) - hlo;
  const int zlo = vrnn::part_lo(Z, cta, NB), nz = vrnn::part_lo(Z, cta + 1, NB) - zlo;
  const int nq = p.inference ? nh : 0;  // posterior units: none in prior mode
  const int nqz = p.inference ? nz : 0;

  vrnn::Stage st[NSTAGES];  // the stages' column segments, in the order their columns lie in shared memory
  const float* const* w = p.w;
  st[0].K = Z;  // the first layers' z rows; their biases are in xp and xq
  st[0].nseg = 2;
  st[0].seg[0] = vrnn::make_seg(w[0], nullptr, H, hlo, nh, 0);
  st[0].seg[1] = vrnn::make_seg(w[7], nullptr, H, hlo, nq, 0);
  for (int l = 1; l < 3; ++l) {  // prior and posterior L2, L3
    st[l].K = H;
    st[l].nseg = 2;
    st[l].seg[0] = vrnn::make_seg(w[2 * l - 1], w[2 * l], H, hlo, nh, 0);
    st[l].seg[1] = vrnn::make_seg(w[6 + 2 * l], w[7 + 2 * l], H, hlo, nq, 1);
  }
  st[3].K = H;  // heads: mu and sd columns of latent units [zlo, zlo + nz)
  st[3].nseg = 4;
  st[3].seg[0] = vrnn::make_seg(w[5], w[6], 2 * Z, zlo, nz, 0);
  st[3].seg[1] = vrnn::make_seg(w[5], w[6], 2 * Z, Z + zlo, nz, 0);
  st[3].seg[2] = vrnn::make_seg(w[12], w[13], 2 * Z, zlo, nqz, 1);
  st[3].seg[3] = vrnn::make_seg(w[12], w[13], 2 * Z, Z + zlo, nqz, 1);

  // shared memory: every stage's weight columns and biases, the input rows, the products, the side inputs
  float* cursor = smem;
  int max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    st[s].ncols = 0;
    for (int i = 0; i < st[s].nseg; ++i) st[s].ncols += st[s].seg[i].n;
    st[s].ws = cursor;
    cursor += (size_t)st[s].ncols * st[s].K;
    max_cols = max(max_cols, st[s].ncols);
  }
  for (int s = 0; s < NSTAGES; ++s) {
    st[s].bs = cursor;
    cursor += st[s].ncols;
  }
  float* act = cursor;  // 2 regions of BC x max(H, Z)
  cursor += 2 * BC * max(H, Z);
  float* res = cursor;  // max_cols x BC
  cursor += max_cols * BC;
  float* side = cursor;  // a stage's other inputs for its units: xp and xq, or e (BC x 2 max(nh, nz))

  for (int s = 0; s < NSTAGES; ++s) {  // a thread copies rows k of a segment's few columns, all loads first
    int first = 0;
    const int K = st[s].K;
    for (int i = 0; i < st[s].nseg; ++i) {
      const vrnn::Seg& sg = st[s].seg[i];
      float* ws = st[s].ws + (size_t)first * K;
      for (int j0 = 0; j0 < sg.n; j0 += 4) {
        for (int k = tid; k < K; k += NT) {
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = j0 + j < sg.n ? __ldg(sg.w + (int64_t)k * sg.ld + sg.col0 + j0 + j) : 0.0f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j0 + j < sg.n) ws[(size_t)(j0 + j) * K + k] = v[j];
        }
      }
      for (int j = tid; j < sg.n; j += NT) st[s].bs[first + j] = sg.b ? __ldg(sg.b + sg.col0 + j) : 0.0f;
      first += sg.n;
    }
  }
  __syncthreads();

  const int64_t ars = (int64_t)6 * H;  // the activations' row stride
  const int64_t sw = (int64_t)6 * H + 2 * Z;  // the save buffer's width a row-step
  float* const pin[3] = {p.act, p.act + 2 * H, p.act + 4 * H};
  float* const qin[3] = {p.act + H, p.act + 3 * H, p.act + 5 * H};
  unsigned int target = 0;
  long long* const trace = cta == 0 && tid == 0 ? p.trace : nullptr;
  const long long ns_begin = trace ? vrnn::now_ns() : 0, cycles_begin = trace ? clock64() : 0;
  long long mark = cycles_begin;
  auto tick = [&](int stage, int phase) {  // after a CTA barrier: the phase's cycles as CTA 0 sees them
    if (trace) {
      const long long t_ = clock64();
      trace[stage * NPHASES + phase] += t_ - mark;
      mark = t_;
    }
  };

  for (int t = 0; t < T; ++t) {
    // z entering step t: z0, or the sample of step t - 1
    const float* z_in = t == 0 ? p.z0 : p.z + (int64_t)(t - 1) * Z;
    const int64_t z_stride = t == 0 ? Z : (int64_t)T * Z;

    // stage 1: prior and posterior L1 from the z rows and the hoisted xp, xq
    {
      const vrnn::Stage& s0 = st[0];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv[2] = {0.0f, 0.0f};  // xp and xq of one (row, unit), issued first
        if (tid < BC * nh && b0 + tid / nh < B) {
          const int64_t o = ((int64_t)(b0 + tid / nh) * T + t) * H + hlo + tid % nh;
          sv[0] = __ldg(p.xp + o);
          if (p.inference) sv[1] = __ldg(p.xq + o);
        }
        vrnn::load_stage(act, z_in, nullptr, z_stride, Z, b0, B);
        if (tid < BC * nh) {
          side[tid] = sv[0];
          side[BC * nh + tid] = sv[1];
        }
        __syncthreads();
        tick(0, 0);
        vrnn::stage_products(s0, act, res);
        __syncthreads();
        tick(0, 1);
        for (int idx = tid; idx < s0.ncols * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const float pre = res[c * BC + b] + (c < nh ? side[b * nh + c] : side[BC * nh + b * nh + c - nh]);
          const int field = c < nh ? hlo + c : H + hlo + c - nh;  // p1 or q1: act's and save's offset
          __stcg(p.act + (int64_t)row * ars + field, leaky_relu(pre));
          if (p.save) __stcs(p.save + ((int64_t)row * T + t) * sw + field, pre);
        }
        __syncthreads();
        tick(0, 2);
      }
      vrnn::grid_sync(p.barrier, target);
      tick(0, 3);
    }

    // stages 2-3: prior and posterior L2, L3
    for (int l = 1; l < 3; ++l) {
      const vrnn::Stage& sl = st[l];
      for (int b0 = 0; b0 < B; b0 += BC) {
        vrnn::load_stage(act, pin[l - 1], p.inference ? qin[l - 1] : nullptr, ars, H, b0, B);
        __syncthreads();
        tick(l, 0);
        vrnn::stage_products(sl, act, res);
        __syncthreads();
        tick(l, 1);
        for (int idx = tid; idx < sl.ncols * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const float pre = res[c * BC + b] + sl.bs[c];
          const int field = 2 * l * H + (c < nh ? hlo + c : H + hlo + c - nh);
          __stcg(p.act + (int64_t)row * ars + field, leaky_relu(pre));
          if (p.save) __stcs(p.save + ((int64_t)row * T + t) * sw + field, pre);
        }
        __syncthreads();
        tick(l, 2);
      }
      vrnn::grid_sync(p.barrier, target);
      tick(l, 3);
    }

    // stage 4: the heads, sd, z
    {
      const vrnn::Stage& s3 = st[3];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv = 0.0f;  // e of one (row, latent unit), issued first
        if (p.eps && tid < BC * nz && b0 + tid / nz < B)
          sv = __ldg(p.eps + ((int64_t)(b0 + tid / nz) * T + t) * Z + zlo + tid % nz);
        vrnn::load_stage(act, pin[2], p.inference ? qin[2] : nullptr, ars, H, b0, B);
        if (tid < BC * nz) side[tid] = sv;
        __syncthreads();
        tick(3, 0);
        vrnn::stage_products(s3, act, res);
        __syncthreads();
        tick(3, 1);
        for (int idx = tid; idx < nz * BC; idx += NT) {
          const int j = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const int64_t o = ((int64_t)row * T + t) * Z + zlo + j;
          const float mu_p = res[j * BC + b] + s3.bs[j];
          const float raw_p = res[(nz + j) * BC + b] + s3.bs[nz + j];
          const float sd_p = vrnn::softplus_sd(raw_p, p.sd_beta, p.sd_eps);
          float zv;
          if (p.inference) {
            float mu_q = res[(2 * nz + j) * BC + b] + s3.bs[2 * nz + j];
            const float raw_q = res[(3 * nz + j) * BC + b] + s3.bs[3 * nz + j];
            const float sd_q = vrnn::softplus_sd(raw_q, p.sd_beta, p.sd_eps);
            if (p.save) {
              float* raw = p.save + ((int64_t)row * T + t) * sw + 6 * H + zlo + j;
              __stcs(raw, raw_p);
              __stcs(raw + Z, raw_q);
            }
            if (p.residual) mu_q = mu_q + mu_p;
            zv = __fadd_rn(mu_q, __fmul_rn(sd_q, side[b * nz + j]));
            __stcg(p.q_mu + o, mu_q);
            __stcg(p.q_sd + o, sd_q);
          } else {
            zv = p.use_mode ? mu_p : __fadd_rn(mu_p, __fmul_rn(sd_p, side[b * nz + j]));
          }
          __stcg(p.p_mu + o, mu_p);
          __stcg(p.p_sd + o, sd_p);
          __stcg(p.z + o, zv);
        }
        __syncthreads();
        tick(3, 2);
      }
      vrnn::grid_sync(p.barrier, target);
      tick(3, 3);
    }
  }
  if (trace) {
    trace[NSTAGES * NPHASES] += clock64() - cycles_begin;
    trace[NSTAGES * NPHASES + 1] += vrnn::now_ns() - ns_begin;
  }
}

// shared memory of a CTA when each stage's units are cut into NB parts (the largest part)
size_t smem_bytes(int NB, int H, int Z) {
  const size_t mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB;
  const size_t cols[NSTAGES] = {2 * mh, 2 * mh, 2 * mh, 4 * mz};
  const size_t K[NSTAGES] = {(size_t)Z, (size_t)H, (size_t)H, (size_t)H};
  size_t floats = 0, max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    floats += cols[s] * K[s] + cols[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
  }
  floats += (size_t)2 * BC * (H > Z ? H : Z) + max_cols * BC + (size_t)2 * BC * (mh > mz ? mh : mz);
  return floats * sizeof(float);
}

}  // namespace srnn
}  // namespace blvm

// K9. weights: 14 device pointers in this order: the prior's first kernel's z rows (Z, H) (of (R + Z, H)),
// W1 (H, H), b1, W2, b2 and its head W (H, 2Z), b; the posterior's the same. xp, xq (B, T, H): the d and a
// parts of the first layers with their biases (xq null in prior mode); z0 (B, Z); eps (B, T, Z), null in
// prior mode under use_mode. outputs: 5 device pointers z, q_mu, q_sd, p_mu, p_sd (B, T, Z); q_mu and q_sd
// null in prior mode. act: 6 B H floats of scratch; save: null, or (B, T, 6H + 2Z) in inference mode (see
// Params); barrier: one uint32 (zeroed here); trace: null, or 18 int64 sums the kernel adds to (the SM
// cycles of each stage's four phases as CTA 0 sees them, then the loop's cycles and nanoseconds). The grid is one CTA an SM, or one a unit where a layer has fewer units
// than the card has SMs. Returns a cudaError_t: cudaErrorInvalidValue for shapes it does not take (more
// than NT / BC units of an MLP layer or of the latent a CTA: each thread fetches at most one of a stage's
// side inputs), cudaErrorCooperativeLaunchTooLarge when the grid's weights cannot all be resident.
extern "C" int blvm_srnn_chain(const void* const* weights, const void* xp, const void* xq, const void* z0,
                               const void* eps, void* const* outputs, void* act, void* save, void* barrier,
                               void* trace, int B, int T, int H, int Z, int inference, int residual, int use_mode,
                               float sd_beta, float sd_eps, void* stream) {
  using namespace blvm::srnn;
  if (B < 1 || T < 1 || H < 1 || Z < 1 || (inference && (!xq || !eps || !outputs[1] || !outputs[2])) ||
      (!inference && !use_mode && !eps) || (save && !inference))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static blvm::vrnn::LaunchCache cache;
  cudaError_t err = blvm::vrnn::query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = H > Z ? H : Z;
  const int NB = cache.sms < units ? cache.sms : units;
  if ((H + NB - 1) / NB > NT / BC || (Z + NB - 1) / NB > NT / BC) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(NB, H, Z);
  err = blvm::vrnn::prepare_cooperative(cache, (const void*)srnn_chain_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < NWEIGHTS; ++i) p.w[i] = w[i];
  p.xp = static_cast<const float*>(xp);
  p.xq = static_cast<const float*>(xq);
  p.z0 = static_cast<const float*>(z0);
  p.eps = static_cast<const float*>(eps);
  float* const* o = reinterpret_cast<float* const*>(outputs);
  p.z = o[0];
  p.q_mu = o[1];
  p.q_sd = o[2];
  p.p_mu = o[3];
  p.p_sd = o[4];
  p.act = static_cast<float*>(act);
  p.save = static_cast<float*>(save);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.T = T;
  p.H = H;
  p.Z = Z;
  p.inference = inference;
  p.residual = residual;
  p.use_mode = use_mode;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)srnn_chain_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
