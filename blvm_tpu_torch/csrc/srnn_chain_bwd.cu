// K9-bwd: the SRNN latent chain's backward through all T' steps of a sequence batch, f32, on sm_90a.
//
// Replaces the autodiff backward of the nn.scan over blvm_tpu/models/srnn.py _SRNNStep.__call__ (:68-96)
// that the JAX train step computes (inference mode, ungated, without phi_z: the SRNNAudio driver's model).
// From what K9 saved (srnn_chain.cu, save mode: the six MLP layers' pre-activations, both heads' raw sd),
// the noise e and the gradients of its five outputs (z, q_mu, q_sd, p_mu, p_sd; each may be absent), it runs
// the chain from step T' - 1 to 0. Per step t, for a row of the batch, with dz the gradient of z_t that step
// t + 1's first layers send back (zero at the last step):
//   1 (latent units): dz = d pre1_p(t+1) W_p0[z]^T + d pre1_q(t+1) W_q0[z]^T (+ the incoming dz);
//     d q_mu = dz + d q_mu_out;  d q_sd = dz e + d q_sd_out;  d q_raw = d q_sd sigmoid(beta raw_q)
//     d p_mu = d p_mu_out (+ d q_mu under residual_posterior);  d p_raw = d p_sd_out sigmoid(beta raw_p)
//   2: d pre3 = (d head W_h^T) f'(pre3)    3: d pre2 = (d pre3 W_2^T) f'(pre2)    4: d pre1 = (d pre2 W_1^T) f'(pre1)
// for the prior and the posterior side by side, f the LeakyReLU of slope 0.01 with f'(v) = 1 for v >= 0, as
// jax.nn.leaky_relu's gradient has it (at a fresh init the prior's first pre-activation is exactly 0 in every
// unit at t = 0). d pre1_p and d pre1_q are the gradients of the hoisted xp and xq. After step 0, stage 1's
// product once more gives d z0. It writes every step's pre-activation gradients, which the wrapper turns
// into the 14 kernel weights' gradients with cuBLAS (sums over B T' rows), and d z0.
//
// What bounds it. At the SRNN train step's shape (B = 19, T' ~ 1000, H = Z = 256) the chain's products are
// 2 x 2 (Z H + 2 H^2 + 2 H Z) multiply-adds a row-step, ~24.9 GFLOP (~0.37 ms at 67 TFLOP/s); but the step
// is four dependent products, each only B rows deep: the latency of a product and of the barrier after it
// sets the pace, as in K9.
//
// The design is K8-bwd's (vrnn_cell_bwd.cu) on K9's grid (vrnn_common.cuh): one persistent cooperative
// launch, one CTA an SM. A backward product sums over a layer's outputs, so each CTA owns whole *input*
// units of every stage and keeps those rows of W resident in shared memory (~20 KB a CTA here): latent units
// for stage 1 (rows of both first kernels' z parts), H units for stages 2-4 (rows of the heads, of W_2, of
// W_1). A stage stages its input rows (8 a pass) from L2, each warp reduces whole rows, the CTA finishes its
// (unit, row) pairs with side inputs fetched before the products, and a grid barrier ends the stage: four
// stages and four barriers a step, as K9's forward. Given a trace buffer, the first CTA adds up the SM
// cycles of each stage's phases (inputs in, products, finish and store, barrier). No tensor cores: the JAX
// step is f32.

#include "vrnn_common.cuh"

namespace blvm {
namespace srnn_bwd {

using namespace blvm::vrnn;

constexpr int NW14 = 14;  // K9's kernel weights (see blvm_srnn_chain)
constexpr int NSTAGES = 4;  // the trace holds NSTAGES x NPHASES sums, then the loop's cycles and nanoseconds
constexpr int NSIDE = 8;  // side inputs of a (unit, row) pair a stage fetches before its products

struct Params {
  const float* w[NW14];
  const float* eps;   // (B, T, Z)
  const float* save;  // (B, T, 6H + 2Z): K9's save mode
  const float* g[5];  // gradients of z, q_mu, q_sd, p_mu, p_sd (B, T, Z); null for zero
  float* dpre;        // (B, T, 4Z + 6H): see blvm_srnn_chain_bwd
  float* dz0;         // (B, Z)
  unsigned int* barrier;
  long long* trace;
  int B, T, H, Z, residual;
  float sd_beta;
};

__device__ __forceinline__ float leaky_slope(float d, float pre) { return pre >= 0.0f ? d : 0.01f * d; }

__global__ void __launch_bounds__(NT, 1) srnn_chain_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, Z = p.Z;
  const int hlo = part_lo(H, cta, NB), nh = part_lo(H, cta + 1, NB) - hlo;
  const int zlo = part_lo(Z, cta, NB), nz = part_lo(Z, cta + 1, NB) - zlo;
  // the save buffer's fields and the gradient buffer's (blvm_srnn_chain_bwd)
  const int64_t SW = (int64_t)6 * H + 2 * Z, DW = (int64_t)4 * Z + 6 * H;
  const int S_RAWP = 6 * H, S_RAWQ = 6 * H + Z;
  const int D_HP = 0, D_HQ = 2 * Z, D_P3 = 4 * Z, D_P1 = 4 * Z + 4 * H, D_Q1 = D_P1 + H;

  // the stages' rows of W: input units of each layer
  Stage st[NSTAGES];
  const float* const* w = p.w;
  st[0].K = H;  // 1: both first kernels' z rows (Z, H), latent units
  st[0].nseg = 2;
  st[0].seg[0] = make_seg(w[0], nullptr, H, zlo, nz, 0);
  st[0].seg[1] = make_seg(w[7], nullptr, H, zlo, nz, 1);
  st[1].K = 2 * Z;  // 2: the heads (H, 2Z)
  st[1].nseg = 2;
  st[1].seg[0] = make_seg(w[5], nullptr, 2 * Z, hlo, nh, 0);
  st[1].seg[1] = make_seg(w[12], nullptr, 2 * Z, hlo, nh, 1);
  for (int l = 0; l < 2; ++l) {  // 3-4: W_2, then W_1 (H, H)
    st[2 + l].K = H;
    st[2 + l].nseg = 2;
    st[2 + l].seg[0] = make_seg(w[3 - 2 * l], nullptr, H, hlo, nh, 0);
    st[2 + l].seg[1] = make_seg(w[10 - 2 * l], nullptr, H, hlo, nh, 1);
  }

  float* cursor = smem;
  int max_cols = 0, max_k = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    st[s].ncols = 0;
    for (int i = 0; i < st[s].nseg; ++i) st[s].ncols += st[s].seg[i].n;
    st[s].ws = cursor;
    st[s].bs = nullptr;
    cursor += (size_t)st[s].ncols * st[s].K;
    max_cols = max(max_cols, st[s].ncols);
    max_k = max(max_k, st[s].K);
  }
  float* act = cursor;  // 2 regions of BC x max K
  cursor += 2 * BC * max_k;
  float* res = cursor;  // max_cols x BC

  for (int s = 0; s < NSTAGES; ++s) {  // rows of W, coalesced along the row
    int first = 0;
    const int K = st[s].K;
    for (int i = 0; i < st[s].nseg; ++i) {
      const Seg& sg = st[s].seg[i];
      float* ws = st[s].ws + (size_t)first * K;
      for (int j = 0; j < sg.n; ++j)
        for (int k = tid; k < K; k += NT) ws[(size_t)j * K + k] = __ldg(sg.w + (int64_t)(sg.col0 + j) * sg.ld + k);
      first += sg.n;
    }
  }
  __syncthreads();

  unsigned int target = 0;
  long long* const trace = cta == 0 && tid == 0 ? p.trace : nullptr;
  const long long ns_begin = trace ? now_ns() : 0, cycles_begin = trace ? clock64() : 0;
  long long mark = cycles_begin;
  auto tick = [&](int stage, int phase) {  // after a CTA barrier: the phase's cycles as CTA 0 sees them
    if (trace) {
      const long long t_ = clock64();
      trace[stage * NPHASES + phase] += t_ - mark;
      mark = t_;
    }
  };

  const int64_t srs = (int64_t)T * SW, drs = (int64_t)T * DW;  // row strides of the save and gradient buffers
  // step t's stages; t = -1 runs stage 1's product alone, on step 0's d pre1, into d z0
  for (int t = T - 1; t >= -1; --t) {
    for (int s = 0; s < NSTAGES; ++s) {
      if (t < 0 && s > 0) break;
      const Stage& S = st[s];
      const bool products = s > 0 || t + 1 < T;  // stage 1 of the last step has no dz to receive
      const int64_t tin = s == 0 ? t + 1 : t;    // the step whose gradients the stage stages
      const float* dp_in = p.dpre + tin * DW;
      const float* src0;
      const float* src1;
      switch (s) {
        case 0: src0 = dp_in + D_P1; src1 = dp_in + D_Q1; break;
        case 1: src0 = dp_in + D_HP; src1 = dp_in + D_HQ; break;
        default: src0 = dp_in + D_P3 + 2 * (s - 2) * H; src1 = src0 + H; break;  // d pre3, then d pre2
      }
      const int nfin = s == 0 ? nz : S.ncols;  // stage 1 finishes latent units, the others both nets' H units
      for (int b0 = 0; b0 < B; b0 += BC) {
        float side[2][NSIDE];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = tid + i * NT, c = q / BC, row = b0 + q % BC;
#pragma unroll
          for (int j = 0; j < NSIDE; ++j) side[i][j] = 0.0f;
          if (c >= nfin || row >= B || t < 0) continue;
          const int64_t st_ = (int64_t)row * T + t;  // (row, step)
          const float* sv = p.save + row * srs + (int64_t)t * SW;
          if (s == 0) {
            const int64_t o = st_ * Z + zlo + c;
#pragma unroll
            for (int j = 0; j < 5; ++j) side[i][j] = ldg_or0(p.g[j], o);
            side[i][5] = __ldg(p.eps + o);
            side[i][6] = __ldg(sv + S_RAWP + zlo + c);
            side[i][7] = __ldg(sv + S_RAWQ + zlo + c);
          } else {  // the pre-activation of the layer below: p3, p2, p1 (q after p)
            side[i][0] = __ldg(sv + 2 * (3 - s) * H + (c < nh ? hlo + c : H + hlo + c - nh));
          }
        }
        if (products) {
          load_stage(act, src0, src1, drs, S.K, b0, B);
          __syncthreads();
          tick(s, 0);
          stage_products(S, act, res);
          __syncthreads();
          tick(s, 1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = tid + i * NT, c = q / BC, b = q % BC, row = b0 + b;
          if (c >= nfin || row >= B) continue;
          if (t < 0) {  // d z0
            p.dz0[(int64_t)row * Z + zlo + c] = res[c * BC + b] + res[(nz + c) * BC + b];
            continue;
          }
          float* d = p.dpre + row * drs + (int64_t)t * DW;
          if (s == 0) {
            const int j = zlo + c;
            const float carried = products ? res[c * BC + b] + res[(nz + c) * BC + b] : 0.0f;
            const float dz = carried + side[i][0];
            const float dmu_q = dz + side[i][1];
            const float dsd_q = dz * side[i][5] + side[i][2];
            const float dmu_p = p.residual ? side[i][3] + dmu_q : side[i][3];
            __stcg(d + D_HP + j, dmu_p);
            __stcg(d + D_HP + Z + j, side[i][4] * softplus_slope(side[i][6], p.sd_beta));
            __stcg(d + D_HQ + j, dmu_q);
            __stcg(d + D_HQ + Z + j, dsd_q * softplus_slope(side[i][7], p.sd_beta));
          } else {  // d pre3, d pre2, d pre1 of the prior's units, then the posterior's
            const int field = D_P3 + 2 * (s - 1) * H + (c < nh ? hlo + c : H + hlo + c - nh);
            __stcg(d + field, leaky_slope(res[c * BC + b], side[i][0]));
          }
        }
        __syncthreads();
        tick(s, 2);
      }
      if (t >= 0) {
        grid_sync(p.barrier, target);
        tick(s, 3);
      }
    }
  }
  if (trace) {
    trace[NSTAGES * NPHASES] += clock64() - cycles_begin;
    trace[NSTAGES * NPHASES + 1] += now_ns() - ns_begin;
  }
}

// shared memory of a CTA when each stage's units are cut into NB parts (the largest part)
size_t smem_bytes(int NB, int H, int Z) {
  const size_t mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB;
  const size_t cols[NSTAGES] = {2 * mz, 2 * mh, 2 * mh, 2 * mh};
  const size_t K[NSTAGES] = {(size_t)H, (size_t)2 * Z, (size_t)H, (size_t)H};
  size_t floats = 0, max_cols = 0, max_k = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    floats += cols[s] * K[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
    max_k = K[s] > max_k ? K[s] : max_k;
  }
  floats += 2 * BC * max_k + max_cols * BC;
  return floats * sizeof(float);
}

}  // namespace srnn_bwd
}  // namespace blvm

// K9-bwd. weights: K9's 14 device pointers (blvm_srnn_chain; the biases are not read). eps (B, T, Z); save:
// K9's (B, T, 6H + 2Z) save buffer; grads: 5 device pointers, the gradients of K9's z, q_mu, q_sd, p_mu,
// p_sd (B, T, Z), each null for zero. dpre (B, T, 4Z + 6H), every step's pre-activation gradients: the prior
// head, the posterior head (2Z each: mu, raw sd), prior L3, posterior L3, prior L2, posterior L2, prior L1
// (also d xp), posterior L1 (also d xq) (H each). dz0 (B, Z). barrier: one uint32 (zeroed here); trace:
// null, or 18 int64 sums (the SM cycles of each of the 4 stages' four phases as CTA 0 sees them, then the
// loop's cycles and nanoseconds). The grid is K9's. Returns a cudaError_t: cudaErrorInvalidValue for
// shapes it does not take (more than NT / BC units of an MLP layer or 2 NT / BC latent units a CTA: each
// thread finishes at most two (unit, row) pairs of a pass), cudaErrorCooperativeLaunchTooLarge when the
// grid's weights cannot all be resident.
extern "C" int blvm_srnn_chain_bwd(const void* const* weights, const void* eps, const void* save,
                                   const void* const* grads, void* dpre, void* dz0, void* barrier, void* trace, int B,
                                   int T, int H, int Z, int residual, float sd_beta, void* stream) {
  using namespace blvm::vrnn;
  using namespace blvm::srnn_bwd;
  if (B < 1 || T < 1 || H < 1 || Z < 1 || !eps || !save || !dpre || !dz0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static LaunchCache cache;
  cudaError_t err = query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = H > Z ? H : Z;
  const int NB = cache.sms < units ? cache.sms : units;
  if (2 * ((H + NB - 1) / NB) > 2 * NT / BC || (Z + NB - 1) / NB > 2 * NT / BC) return (int)cudaErrorInvalidValue;
  const size_t smem = blvm::srnn_bwd::smem_bytes(NB, H, Z);
  err = prepare_cooperative(cache, (const void*)srnn_chain_bwd_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < NW14; ++i) p.w[i] = w[i];
  const float* const* g = reinterpret_cast<const float* const*>(grads);
  for (int i = 0; i < 5; ++i) p.g[i] = g[i];
  p.eps = static_cast<const float*>(eps);
  p.save = static_cast<const float*>(save);
  p.dpre = static_cast<float*>(dpre);
  p.dz0 = static_cast<float*>(dz0);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.T = T;
  p.H = H;
  p.Z = Z;
  p.residual = residual;
  p.sd_beta = sd_beta;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)srnn_chain_bwd_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
