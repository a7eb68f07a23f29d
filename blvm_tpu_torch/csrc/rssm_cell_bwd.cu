// K10-bwd: the backward through time of a CW-VAE level's RSSM cell chain (K10, rssm_cell.cu), f32, on sm_90a.
//
// Replaces the autodiff backward of the nn.scan over blvm_tpu/modules/rssm.py RSSMCell.__call__ (:46-62) in
// blvm_tpu/models/clockwork_vae/clockwork_vae.py CWVAE._run_level (:123-160) that the JAX train step computes
// (inference mode, the only mode a train step differentiates). From what K10 saved in its save mode (a, the GRU's
// r, u, n and h W_hn + b_hn, the six MLP layers' post-ReLU values, both heads' pre-activations), its h output,
// h0, the noise e and the gradients of its six outputs (z, h, q_mu, q_sd, p_mu, p_sd; each may be absent), it runs
// the chain from step T' - 1 to 0. Per step t, for a row of the batch, with dz and dh the gradients of z_t and h_t
// that step t + 1 sends back (zero at the last step and where step t + 1 starts from a reset):
//   1 (latent units): dz = d pre_a(t+1) Wg_z^T + dz_out; d q_mu = dz + d q_mu_out; d q_sd = dz e + d q_sd_out;
//     through the precision-weighted combination (or the residual posterior's mean) to both heads' mu and sd, plus
//     d p_mu_out and d p_sd_out; d raw = d sd sigmoid(beta raw) (softplus's slope, 0.5 at 0 as JAX's)
//   2: d pre3 = (d head W_h^T) [pre3 > 0]    3: d pre2 = (d pre3 W_2^T) [pre2 > 0]    4: d pre1 = (d pre2 W_1^T) [...]
//     for the prior and the posterior side by side (d pre1 of the posterior is d xq)
//   5 (GRU units): dh = d p1 W_p0^T + d q1 W_q0[h]^T + dh_out + dh (carried); the GRU's elementwise backward in
//     torch gate order (r multiplies h W_hn + b_hn): d gi = (dr', du', dn') and d gh = (dr', du', dn' r), and dh u
//   6: d pre_a = (d gi W_ih^T) [a > 0] (d xg); the carry dh(t-1) = dh u + d gh W_hh^T (zero at a reset step)
// and, after step 0, stage 1's product once more gives d z0 and the carry d h0. It writes every step's
// pre-activation gradients, which the wrapper turns into the 20 kernel weights' gradients with cuBLAS (sums over
// B T' rows), and d z0, d h0.
//
// What bounds it. At the CW-VAE train step's shape (B = 5, T' ~ 800, H = 192, Z = 128) the chain's products are
// the forward's, 12 H^2 + 5 H Z multiply-adds a row-step (~3.9 GFLOP a launch, ~0.06 ms at 67 TFLOP/s), over
// ~2.3 MB of weights; but each step is six dependent products only B rows deep: the latency of a product and of
// the grid barrier after it sets the pace, as in K8-bwd and K9-bwd.
//
// The design is K8-bwd's (vrnn_cell_bwd.cu) on K10's grid (vrnn_common.cuh): one persistent cooperative launch,
// one CTA an SM. A backward product sums over a layer's outputs, so each CTA owns whole *input* units of every
// stage and keeps those rows of W resident in shared memory: latent units for stage 1 (rows of Wg_z), H units for
// stages 2-6 (rows of the heads, of W_2, W_1, of the first layers' h rows, of W_ih and W_hh). A CTA owns the same
// GRU units in stages 5 and 6, so their dh u and carried dh stay in its shared memory from one step to the next.
// A stage stages its input rows (8 a pass) from L2, each warp reduces whole rows, the CTA finishes its (unit,
// row) pairs with side inputs fetched before the products, and a grid barrier ends the stage: six stages and six
// barriers a step. No atomics; no tensor cores: the JAX step is f32.

#include "vrnn_common.cuh"

namespace blvm {
namespace rssm_bwd {

using namespace blvm::vrnn;

constexpr int NW20 = 20;    // K10's kernel weights (see blvm_rssm_chain)
constexpr int NSTAGES = 6;
constexpr int NSIDE = 10;   // side inputs of a (unit, row) pair a stage fetches before its products

struct Params {
  const float* w[NW20];
  const float* eps;     // (B, T, Z)
  const float* save;    // (B, T, 11H + 4Z): K10's save mode
  const float* h_out;   // K10's h (B, T, H): h_{t-1}
  const float* h0;      // (B, H)
  const int* resets;    // null, or (T,): 1 where step t starts from zero z and h
  const float* g[6];    // gradients of z, h, q_mu, q_sd, p_mu, p_sd; null for zero
  float* dpre;          // (B, T, 13H + 4Z): see blvm_rssm_chain_bwd
  float* dz0;           // (B, Z)
  float* dh0;           // (B, H)
  unsigned int* barrier;
  int B, T, H, Z, residual, precision;
  float sd_beta, sd_eps;
};

__global__ void __launch_bounds__(NT, 1) rssm_chain_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, Z = p.Z;
  const int hlo = part_lo(H, cta, NB), nh = part_lo(H, cta + 1, NB) - hlo;
  const int zlo = part_lo(Z, cta, NB), nz = part_lo(Z, cta + 1, NB) - zlo;
  // the save buffer's fields (rssm_cell.cu SAVE_*) and the gradient buffer's (blvm_rssm_chain_bwd)
  const int64_t SW = (int64_t)11 * H + 4 * Z, DW = (int64_t)13 * H + 4 * Z;
  const int S_A = 0, S_R = H, S_U = 2 * H, S_N = 3 * H, S_GHN = 4 * H, S_HEADS = 11 * H;
  const int D_HP = 0, D_HQ = 2 * Z, D_P3 = 4 * Z, D_P1 = 4 * Z + 4 * H, D_GI = 4 * Z + 6 * H, D_GH = D_GI + 3 * H;
  const int D_A = D_GH + 3 * H;

  // the stages' rows of W: input units of each layer
  Stage st[NSTAGES];
  const float* const* w = p.w;
  st[0].K = H;  // 1: Wg_z (Z, H), latent units
  st[0].nseg = 1;
  st[0].seg[0] = make_seg(w[0], nullptr, H, zlo, nz, 0);
  st[1].K = 2 * Z;  // 2: the heads (H, 2Z)
  st[1].nseg = 2;
  st[1].seg[0] = make_seg(w[11], nullptr, 2 * Z, hlo, nh, 0);
  st[1].seg[1] = make_seg(w[18], nullptr, 2 * Z, hlo, nh, 1);
  const int prior_rows[3] = {9, 7, 5}, posterior_rows[3] = {16, 14, 13};
  for (int l = 0; l < 3; ++l) {  // 3-5: W_2, W_1, then the first layers' h rows (H, H)
    st[2 + l].K = H;
    st[2 + l].nseg = 2;
    st[2 + l].seg[0] = make_seg(w[prior_rows[l]], nullptr, H, hlo, nh, 0);
    st[2 + l].seg[1] = make_seg(w[posterior_rows[l]], nullptr, H, hlo, nh, 1);
  }
  st[5].K = 3 * H;  // 6: W_ih against d gi, W_hh against d gh (H, 3H)
  st[5].nseg = 2;
  st[5].seg[0] = make_seg(w[1], nullptr, 3 * H, hlo, nh, 0);
  st[5].seg[1] = make_seg(w[3], nullptr, 3 * H, hlo, nh, 1);

  // shared memory: every stage's weight rows, the input rows, the products, the GRU units' carries
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
  cursor += max_cols * BC;
  float* dh_c = cursor;  // B x nh: the carried dh of this CTA's GRU units, from stage 6 to the previous step's 5
  cursor += B * nh;
  float* dhu = cursor;  // B x nh: dh u, from stage 5 to stage 6

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
  for (int i = tid; i < B * nh; i += NT) dh_c[i] = 0.0f;
  __syncthreads();

  unsigned int target = 0;
  const int64_t srs = (int64_t)T * SW, drs = (int64_t)T * DW;  // row strides of the save and gradient buffers
  // step t's stages; t = -1 runs stage 1's product alone, on step 0's d pre_a, into d z0, and stores d h0
  for (int t = T - 1; t >= -1; --t) {
    const bool reset_next = t + 1 < T && p.resets && p.resets[t + 1];  // step t + 1 started from zeros
    const bool reset_here = t >= 0 && p.resets && p.resets[t];
    for (int s = 0; s < NSTAGES; ++s) {
      if (t < 0 && s > 0) break;
      const Stage& S = st[s];
      // stage 1 of the last step and of a step whose successor started from zeros receives no dz
      const bool products = s > 0 || (t + 1 < T && !reset_next);
      const int64_t tin = s == 0 ? t + 1 : t;  // the step whose gradients the stage stages
      const float* dp_in = p.dpre + tin * DW;
      const float* src0;
      const float* src1 = nullptr;
      switch (s) {
        case 0: src0 = dp_in + D_A; break;
        case 1: src0 = dp_in + D_HP; src1 = dp_in + D_HQ; break;
        case 5: src0 = dp_in + D_GI; src1 = dp_in + D_GH; break;
        default: src0 = dp_in + D_P3 + 2 * (s - 2) * H; src1 = src0 + H; break;  // d pre3, d pre2, d pre1
      }
      // the pairs a stage finishes: 1 its latent units, 2-4 both nets' H units, 5-6 its GRU units
      const int nfin = s == 0 ? nz : s >= 4 ? nh : S.ncols;
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
            side[i][0] = ldg_or0(p.g[0], o);
#pragma unroll
            for (int j = 1; j < 5; ++j) side[i][j] = ldg_or0(p.g[j + 1], o);  // q_mu, q_sd, p_mu, p_sd
            side[i][5] = __ldg(p.eps + o);
#pragma unroll
            for (int j = 0; j < 4; ++j) side[i][6 + j] = __ldg(sv + S_HEADS + j * Z + zlo + c);  // mu_p .. raw_q
          } else if (s < 4) {  // the post-ReLU value of the layer below: p3, p2, p1 (q after p)
            side[i][0] = __ldg(sv + (2 * (3 - s) + 5 + (c < nh ? 0 : 1)) * H + hlo + (c < nh ? c : c - nh));
          } else if (s == 4) {
            const int unit = hlo + c;
            side[i][0] = ldg_or0(p.g[1], st_ * H + unit);
            side[i][1] = __ldg(sv + S_R + unit);
            side[i][2] = __ldg(sv + S_U + unit);
            side[i][3] = __ldg(sv + S_N + unit);
            side[i][4] = __ldg(sv + S_GHN + unit);
            side[i][5] = reset_here ? 0.0f
                         : t == 0   ? __ldg(p.h0 + (int64_t)row * H + unit)
                                    : __ldg(p.h_out + (st_ - 1) * H + unit);
          } else {
            side[i][0] = __ldg(sv + S_A + hlo + c);
          }
        }
        if (products) {
          load_stage(act, src0, src1, drs, S.K, b0, B);
          __syncthreads();
          stage_products(S, act, res);
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = tid + i * NT, c = q / BC, b = q % BC, row = b0 + b;
          if (c >= nfin || row >= B) continue;
          if (t < 0) {  // d z0 (none when step 0 started from a reset)
            const bool reset0 = p.resets && p.resets[0];
            p.dz0[(int64_t)row * Z + zlo + c] = reset0 ? 0.0f : res[c * BC + b];
            continue;
          }
          float* d = p.dpre + row * drs + (int64_t)t * DW;
          const float* sd_ = side[i];
          if (s == 0) {
            const int j = zlo + c;
            const float dz = (products ? res[c * BC + b] : 0.0f) + sd_[0];
            const float dmu_q = dz + sd_[1], dsd_q = dz * sd_[5] + sd_[2];
            const float mu_p = sd_[6], raw_p = sd_[7], mu_q0 = sd_[8], raw_q = sd_[9];
            float dmu_q0 = dmu_q, dsd_q0 = dsd_q, dmu_p = sd_[3], dsd_p = sd_[4];
            if (p.residual) {
              dmu_p += dmu_q;
            } else if (p.precision) {  // the backward of blvm_tpu/ops/variational.py:65-72
              const float sd_q0 = softplus_sd(raw_q, p.sd_beta, p.sd_eps);
              const float sd_p = softplus_sd(raw_p, p.sd_beta, p.sd_eps);
              const float pr_q = 1.0f / (sd_q0 * sd_q0), pr_p = 1.0f / (sd_p * sd_p);
              const float va = 1.0f / (pr_q + pr_p);
              const float dnum = dmu_q * va;
              const float dva = dmu_q * (mu_q0 * pr_q + mu_p * pr_p) + dsd_q * 0.5f / sqrtf(va);
              const float dsum = -dva * va * va;
              const float dpr_q = dnum * mu_q0 + dsum, dpr_p = dnum * mu_p + dsum;
              dmu_q0 = dnum * pr_q;
              dmu_p += dnum * pr_p;
              dsd_q0 = -2.0f * dpr_q * pr_q / sd_q0;
              dsd_p += -2.0f * dpr_p * pr_p / sd_p;
            }
            __stcg(d + D_HP + j, dmu_p);
            __stcg(d + D_HP + Z + j, dsd_p * softplus_slope(raw_p, p.sd_beta));
            __stcg(d + D_HQ + j, dmu_q0);
            __stcg(d + D_HQ + Z + j, dsd_q0 * softplus_slope(raw_q, p.sd_beta));
          } else if (s < 4) {  // d pre3, d pre2, d pre1 of the prior's units, then the posterior's
            const int field = D_P3 + 2 * (s - 1) * H + (c < nh ? hlo + c : H + hlo + c - nh);
            __stcg(d + field, sd_[0] > 0.0f ? res[c * BC + b] : 0.0f);
          } else if (s == 4) {  // dh, then the GRU's elementwise backward
            const int unit = hlo + c;
            const float dh = res[c * BC + b] + res[(nh + c) * BC + b] + sd_[0] + dh_c[row * nh + c];
            const float r = sd_[1], u = sd_[2], n = sd_[3], ghn = sd_[4], hp = sd_[5];
            const float dn = dh * (1.0f - u), du = dh * (hp - n);
            dhu[row * nh + c] = dh * u;
            const float dan = dn * (1.0f - n * n);
            const float dar = dan * ghn * r * (1.0f - r);
            const float dau = du * u * (1.0f - u);
            __stcg(d + D_GI + unit, dar);
            __stcg(d + D_GI + H + unit, dau);
            __stcg(d + D_GI + 2 * H + unit, dan);
            __stcg(d + D_GH + unit, dar);
            __stcg(d + D_GH + H + unit, dau);
            __stcg(d + D_GH + 2 * H + unit, dan * r);
          } else {  // d pre_a, and the dh carried into step t - 1
            __stcg(d + D_A + hlo + c, sd_[0] > 0.0f ? res[c * BC + b] : 0.0f);
            dh_c[row * nh + c] = reset_here ? 0.0f : dhu[row * nh + c] + res[(nh + c) * BC + b];
          }
        }
        __syncthreads();
      }
      if (t >= 0) grid_sync(p.barrier, target);
    }
  }
  for (int i = tid; i < B * nh; i += NT) p.dh0[(int64_t)(i / nh) * H + hlo + i % nh] = dh_c[i];
}

// shared memory of a CTA when each stage's units are cut into NB parts (the largest part)
size_t smem_bytes(int NB, int B, int H, int Z) {
  const size_t mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB;
  const size_t cols[NSTAGES] = {mz, 2 * mh, 2 * mh, 2 * mh, 2 * mh, 2 * mh};
  const size_t K[NSTAGES] = {(size_t)H, (size_t)2 * Z, (size_t)H, (size_t)H, (size_t)H, (size_t)3 * H};
  size_t floats = 0, max_cols = 0, max_k = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    floats += cols[s] * K[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
    max_k = K[s] > max_k ? K[s] : max_k;
  }
  floats += 2 * BC * max_k + max_cols * BC + 2 * (size_t)B * mh;
  return floats * sizeof(float);
}

}  // namespace rssm_bwd
}  // namespace blvm

// K10-bwd. weights: K10's 20 device pointers (blvm_rssm_chain; the biases are not read). eps (B, T, Z); save: K10's
// (B, T, 11H + 4Z) save buffer; h: K10's h output (B, T, H); h0 (B, H); resets: null or T int32, as K10 was given;
// grads: 6 device pointers, the gradients of K10's z (B, T, Z), h (B, T, H), q_mu, q_sd, p_mu, p_sd (B, T, Z), each
// null for zero. dpre (B, T, 13H + 4Z), every step's pre-activation gradients: the prior head, the posterior head
// (2Z each: mu, raw sd; the posterior's mu before the combination with the prior), prior L3, posterior L3, prior
// L2, posterior L2, prior L1, posterior L1 (also d xq) (H each), d gi (3H), d gh (3H, its n part r d n'), d pre_a
// (H, also d xg). dz0 (B, Z), dh0 (B, H). barrier: one uint32 (zeroed here). The grid is K10's. Returns a
// cudaError_t: cudaErrorInvalidValue for shapes it does not take (more than NT / BC units of a layer or 2 NT / BC
// latent units a CTA: each thread finishes at most two (unit, row) pairs of a pass),
// cudaErrorCooperativeLaunchTooLarge when the grid's weights cannot all be resident.
extern "C" int blvm_rssm_chain_bwd(const void* const* weights, const void* eps, const void* save, const void* h,
                                   const void* h0, const void* resets, const void* const* grads, void* dpre, void* dz0,
                                   void* dh0, void* barrier, int B, int T, int H, int Z, int residual, int precision,
                                   float sd_beta, float sd_eps, void* stream) {
  using namespace blvm::vrnn;
  using namespace blvm::rssm_bwd;
  if (B < 1 || T < 1 || H < 1 || Z < 1 || !eps || !save || !h || !h0 || !dpre || !dz0 || !dh0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static LaunchCache cache;
  cudaError_t err = query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = H > Z ? H : Z;
  const int NB = cache.sms < units ? cache.sms : units;
  if (2 * ((H + NB - 1) / NB) > 2 * NT / BC || (Z + NB - 1) / NB > 2 * NT / BC) return (int)cudaErrorInvalidValue;
  const size_t smem = blvm::rssm_bwd::smem_bytes(NB, B, H, Z);
  err = prepare_cooperative(cache, (const void*)rssm_chain_bwd_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < NW20; ++i) p.w[i] = w[i];
  const float* const* g = reinterpret_cast<const float* const*>(grads);
  for (int i = 0; i < 6; ++i) p.g[i] = g[i];
  p.eps = static_cast<const float*>(eps);
  p.save = static_cast<const float*>(save);
  p.h_out = static_cast<const float*>(h);
  p.h0 = static_cast<const float*>(h0);
  p.resets = static_cast<const int*>(resets);
  p.dpre = static_cast<float*>(dpre);
  p.dz0 = static_cast<float*>(dz0);
  p.dh0 = static_cast<float*>(dh0);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  p.Z = Z;
  p.residual = residual;
  p.precision = precision;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)rssm_chain_bwd_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
