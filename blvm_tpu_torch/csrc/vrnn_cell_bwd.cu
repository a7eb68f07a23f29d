// K8-bwd: the VRNN cell's backward through all T' steps of a sequence batch, f32, on sm_90a.
//
// Replaces the autodiff backward of the nn.scan over blvm_tpu/models/vrnn.py VRNNCell.__call__ (:77-92)
// that the JAX train step computes, in inference mode (the only mode a train step differentiates). From
// what K8 saved (vrnn_cell.cu, save mode) and the gradients of its seven outputs, it runs the reverse chain
// from step T' - 1 to 0, with dh the gradient of the state leaving step t (carried from step t + 1, plus
// the incoming gradient of h[:, t]):
//   G:  the GRU's elementwise backward from the saved r, u, n, gh_n and h_{t-1}: d gi (3R), d gh (3R, its
//       n part scaled by r), and dh u
//   1:  d phi4 = d gi W_ih[phi]^T (+ the incoming d phi, masked by phi > 0); dh_gh = d gh W_hh^T
//   2-4: phi L4 -> L1, each through the ReLU mask of the saved activation
//   5:  dz = d phi1_pre W_f0^T (+ the incoming dz); the heads: d q_mu = dz + d q_mu_out, d q_sd = dz e +
//       d q_sd_out, d q_raw = d q_sd sigmoid(beta raw_q), d p_mu = d p_mu_out (+ d q_mu under the residual
//       posterior), d p_raw = d p_sd_out sigmoid(beta raw_p)
//   6-8: both heads' and MLPs' products, L3 -> L1, masked
//   9:  dh_{t-1} = dh u + dh_gh + d p1_pre W_p0^T + d q1_pre W_q0[:R]^T
// and writes every stage's pre-activation gradient of every step (d gi is d xg, d q1_pre is d xpost), which
// the wrapper turns into the 28 weight and bias gradients with cuBLAS (sums over B T' rows), and dh0.
//
// What bounds it. Each product sums over a layer's *output* units, so a CTA owns whole *input* units of
// every stage and keeps those rows of W resident in shared memory for the whole launch (the same 8.9 MB as
// K8, ~70 KB a CTA at the spec width, one CTA an SM, one cooperative launch): H units of each phi and MLP
// layer and of the heads, Z latent units for stage 5, R units of W_hh (stage 1) and of both MLPs' first
// layers (stage 9), so a CTA's GRU units' dh, dh u and dh_gh stay on chip from stage 9 of one step to
// stage G of the next and on to its stage 9: ten stages and nine grid barriers a step. The operations
// (~2.2M multiply-adds a row-step in the chain, as many again in the weight gradients) would take ~2.5 ms
// at 19 x 1000 row-steps; as in K8 the chain's latency, a product of B rows and a barrier each stage, sets
// the pace. Stage 1 reads all 6R
// gate gradients of a row (d gi and d gh) where the others read H or 2Z. No tensor cores: the JAX step is
// f32. K8's machinery is reused: staged L2 inputs, the products, the barrier and the trace.

#include "vrnn_common.cuh"

namespace blvm {
namespace vrnn_bwd {

using namespace blvm::vrnn;

constexpr int NSTAGES = 10;  // G, then the nine product stages 1-9; the trace has NSTAGES * NPHASES + 2 sums
constexpr int NPROD = 9;
constexpr int NSIDE = 8;  // side inputs of a (unit, row) pair a stage fetches before its products

struct Params {
  const float* w[NWEIGHTS];  // K8's 28 (biases unused)
  const float* h0;
  const float* eps;
  const float* h_out;  // K8's h (B, T, R): h_{t-1}
  const float* phi;    // K8's phi (B, T, H): the mask of phi L4
  const float* save;   // (B, T, 9H + 2Z + 4R), K8's save mode
  const float* g[7];   // gradients of h, z, phi, q_mu, q_sd, p_mu, p_sd (B, T, *); null for zero
  float* dpre;         // (B, T, 6R + 10H + 4Z): see blvm_vrnn_cell_bwd
  float* dh0;          // (B, R)
  unsigned int* barrier;
  long long* trace;
  int B, T, R, H, Z, residual;
  float sd_beta;
};

__global__ void __launch_bounds__(NT, 1) vrnn_cell_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, R = p.R, H = p.H, Z = p.Z, G = 3 * R;
  const int hlo = part_lo(H, cta, NB), nh = part_lo(H, cta + 1, NB) - hlo;
  const int zlo = part_lo(Z, cta, NB), nz = part_lo(Z, cta + 1, NB) - zlo;
  const int rlo = part_lo(R, cta, NB), nr = part_lo(R, cta + 1, NB) - rlo;
  // the save buffer's fields (K8's Params::act) and the gradient buffer's (blvm_vrnn_cell_bwd)
  const int64_t SW = (int64_t)9 * H + 2 * Z + 4 * R, DW = (int64_t)6 * R + 10 * H + 4 * Z;
  const int S_A1P = 0, S_A1Q = H, S_A2P = 2 * H, S_A2Q = 3 * H, S_A3P = 4 * H, S_A3Q = 5 * H;
  const int S_F[3] = {6 * H, 7 * H, 8 * H};  // phi L1-L3 activations
  const int S_RAWP = 9 * H, S_RAWQ = S_RAWP + Z, S_R = S_RAWP + 2 * Z, S_U = S_R + R, S_N = S_R + 2 * R,
            S_GHN = S_R + 3 * R;
  const int D_GI = 0, D_GH = G, D_F3 = 2 * G, D_HP = 2 * G + 4 * H, D_HQ = D_HP + 2 * Z, D_P2 = D_HQ + 2 * Z;
  const int D_Q2 = D_P2 + H, D_P1 = D_P2 + 2 * H, D_Q1 = D_P2 + 3 * H, D_P0 = D_P2 + 4 * H, D_Q0 = D_P2 + 5 * H;

  // the product stages' rows of W: input units of each layer
  Stage st[NPROD];
  const float* const* w = p.w;
  st[0].K = G;  // 1: W_ih's phi rows against d gi, W_hh's rows against d gh
  st[0].nseg = 2;
  st[0].seg[0] = make_seg(w[24], nullptr, G, hlo, nh, 0);
  st[0].seg[1] = make_seg(w[26], nullptr, G, rlo, nr, 1);
  for (int l = 0; l < 3; ++l) {  // 2-4: phi L4, L3, L2 (W_f3, W_f2, W_f1)
    st[1 + l].K = H;
    st[1 + l].nseg = 1;
    st[1 + l].seg[0] = make_seg(w[22 - 2 * l], nullptr, H, hlo, nh, 0);
  }
  st[4].K = H;  // 5: phi L1 (W_f0), latent units
  st[4].nseg = 1;
  st[4].seg[0] = make_seg(w[16], nullptr, H, zlo, nz, 0);
  st[5].K = 2 * Z;  // 6: the heads
  st[5].nseg = 2;
  st[5].seg[0] = make_seg(w[6], nullptr, 2 * Z, hlo, nh, 0);
  st[5].seg[1] = make_seg(w[14], nullptr, 2 * Z, hlo, nh, 1);
  for (int l = 0; l < 2; ++l) {  // 7-8: L3, L2 of both MLPs (W_2, W_1)
    st[6 + l].K = H;
    st[6 + l].nseg = 2;
    st[6 + l].seg[0] = make_seg(w[4 - 2 * l], nullptr, H, hlo, nh, 0);
    st[6 + l].seg[1] = make_seg(w[12 - 2 * l], nullptr, H, hlo, nh, 1);
  }
  st[8].K = H;  // 9: L1 of both MLPs, the h rows (W_p0, W_q0[:R]), GRU units
  st[8].nseg = 2;
  st[8].seg[0] = make_seg(w[0], nullptr, H, rlo, nr, 0);
  st[8].seg[1] = make_seg(w[8], nullptr, H, rlo, nr, 1);

  // shared memory: every stage's weight rows, the input rows, the products, the GRU units' carries
  float* cursor = smem;
  int max_cols = 0, max_k = 0;
  for (int s = 0; s < NPROD; ++s) {
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
  float* dh_c = cursor;  // B x nr: dh of this CTA's GRU units, from stage 9 to the next step's G
  cursor += B * nr;
  float* dhu = cursor;  // B x nr: dh u, from G to stage 9
  cursor += B * nr;
  float* dhgh = cursor;  // B x nr: d gh W_hh^T, from stage 1 to stage 9

  for (int s = 0; s < NPROD; ++s) {  // rows of W, coalesced along the row
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
  for (int i = tid; i < B * nr; i += NT) dh_c[i] = 0.0f;
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
  for (int t = T - 1; t >= 0; --t) {
    const float* sv = p.save + (int64_t)t * SW;  // step t's fields of row 0
    float* dp = p.dpre + (int64_t)t * DW;
    const float* h_prev = t == 0 ? p.h0 : p.h_out + (int64_t)(t - 1) * R;
    const int64_t hp_rs = t == 0 ? R : (int64_t)T * R;

    // stage G: the GRU's elementwise backward of this CTA's units, every row
    for (int idx = tid; idx < B * nr; idx += NT) {
      const int row = idx / nr, unit = rlo + idx % nr;
      const float* s_ = sv + row * srs;
      const float r = __ldg(s_ + S_R + unit), u = __ldg(s_ + S_U + unit), n = __ldg(s_ + S_N + unit);
      const float ghn = __ldg(s_ + S_GHN + unit), hp = __ldg(h_prev + row * hp_rs + unit);
      const float dh = dh_c[idx] + ldg_or0(p.g[0], ((int64_t)row * T + t) * R + unit);
      const float dn = dh * (1.0f - u), du = dh * (hp - n);
      dhu[idx] = dh * u;
      const float dan = dn * (1.0f - n * n);
      const float dar = dan * ghn * r * (1.0f - r);
      const float dau = du * u * (1.0f - u);
      float* d = dp + row * drs;
      __stcg(d + D_GI + unit, dar);
      __stcg(d + D_GI + R + unit, dau);
      __stcg(d + D_GI + 2 * R + unit, dan);
      __stcg(d + D_GH + unit, dar);
      __stcg(d + D_GH + R + unit, dau);
      __stcg(d + D_GH + 2 * R + unit, dan * r);
    }
    __syncthreads();
    tick(0, 2);
    grid_sync(p.barrier, target);
    tick(0, 3);

    // the nine product stages: rows [b0, b0 + BC) a pass; each thread finishes (unit, row) pairs
    // q = tid + i NT, i < 2, and fetches their side inputs into registers before the products
    for (int s = 0; s < NPROD; ++s) {
      const Stage& S = st[s];
      const float* src0;
      const float* src1 = nullptr;
      switch (s) {
        case 0: src0 = dp + D_GI; src1 = dp + D_GH; break;
        case 1: src0 = dp + D_F3; break;
        case 2: src0 = dp + D_F3 + H; break;
        case 3: src0 = dp + D_F3 + 2 * H; break;
        case 4: src0 = dp + D_F3 + 3 * H; break;
        case 5: src0 = dp + D_HP; src1 = dp + D_HQ; break;
        case 6: src0 = dp + D_P2; src1 = dp + D_Q2; break;
        case 7: src0 = dp + D_P1; src1 = dp + D_Q1; break;
        default: src0 = dp + D_P0; src1 = dp + D_Q0; break;
      }
      // the pairs a stage finishes: stage 1 its phi and GRU units, 5 its latent units, 9 its GRU units
      const int nfin = s == 4 ? nz : s == 8 ? nr : S.ncols;
      for (int b0 = 0; b0 < B; b0 += BC) {
        float side[2][NSIDE];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = tid + i * NT, c = q / BC, row = b0 + q % BC;
#pragma unroll
          for (int j = 0; j < NSIDE; ++j) side[i][j] = 0.0f;
          if (c >= nfin || row >= B) continue;
          const int64_t st_ = (int64_t)row * T + t;  // (row, step)
          const float* s_ = sv + row * srs;
          if (s == 0) {
            if (c < nh) {
              side[i][0] = __ldg(p.phi + st_ * H + hlo + c);
              side[i][1] = ldg_or0(p.g[2], st_ * H + hlo + c);
            }
          } else if (s <= 3) {
            side[i][0] = __ldg(s_ + S_F[3 - s] + hlo + c);
          } else if (s == 4) {
            const int64_t o = st_ * Z + zlo + c;
            side[i][0] = ldg_or0(p.g[1], o);
            side[i][1] = ldg_or0(p.g[3], o);
            side[i][2] = ldg_or0(p.g[4], o);
            side[i][3] = ldg_or0(p.g[5], o);
            side[i][4] = ldg_or0(p.g[6], o);
            side[i][5] = __ldg(p.eps + o);
            side[i][6] = __ldg(s_ + S_RAWP + zlo + c);
            side[i][7] = __ldg(s_ + S_RAWQ + zlo + c);
          } else if (s < 8) {  // 6-8: the mask of the layer below, prior units then posterior units
            const int f = c < nh ? (s == 5 ? S_A3P : s == 6 ? S_A2P : S_A1P) : (s == 5 ? S_A3Q : s == 6 ? S_A2Q : S_A1Q);
            side[i][0] = __ldg(s_ + f + hlo + (c < nh ? c : c - nh));
          }
        }
        load_stage(act, src0, src1, drs, S.K, b0, B);
        __syncthreads();
        tick(s + 1, 0);
        stage_products(S, act, res);
        __syncthreads();
        tick(s + 1, 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = tid + i * NT, c = q / BC, b = q % BC, row = b0 + b;
          if (c >= nfin || row >= B) continue;
          const float v = res[c * BC + b];
          float* d = dp + row * drs;
          if (s == 0) {
            if (c < nh) {
              const float dphi = v + side[i][1];
              __stcg(d + D_F3 + hlo + c, side[i][0] > 0.0f ? dphi : 0.0f);
            } else {
              dhgh[row * nr + c - nh] = v;
            }
          } else if (s <= 3) {  // phi L3, L2, L1 pre-activation gradients
            __stcg(d + D_F3 + s * H + hlo + c, side[i][0] > 0.0f ? v : 0.0f);
          } else if (s == 4) {
            const int j = zlo + c;
            const float dz = v + side[i][0];
            const float dmu_q = dz + side[i][1];
            const float dsd_q = dz * side[i][5] + side[i][2];
            const float dmu_p = p.residual ? side[i][3] + dmu_q : side[i][3];
            __stcg(d + D_HP + j, dmu_p);
            __stcg(d + D_HP + Z + j, side[i][4] * softplus_slope(side[i][6], p.sd_beta));
            __stcg(d + D_HQ + j, dmu_q);
            __stcg(d + D_HQ + Z + j, dsd_q * softplus_slope(side[i][7], p.sd_beta));
          } else if (s < 8) {  // the MLPs' L3, L2, L1 pre-activation gradients
            const float g = side[i][0] > 0.0f ? v : 0.0f;
            const int dst = (c < nh ? D_P2 : D_Q2) + 2 * (s - 5) * H;
            __stcg(d + dst + hlo + (c < nh ? c : c - nh), g);
          } else {  // dh entering step t, of this CTA's GRU units
            const int l = row * nr + c;
            dh_c[l] = ((dhu[l] + dhgh[l]) + v) + res[(nr + c) * BC + b];
          }
        }
        __syncthreads();
        tick(s + 1, 2);
      }
      if (s < 8) {
        grid_sync(p.barrier, target);
        tick(s + 1, 3);
      }
    }
  }
  for (int idx = tid; idx < B * nr; idx += NT) p.dh0[(int64_t)(idx / nr) * R + rlo + idx % nr] = dh_c[idx];
  if (trace) {
    trace[NSTAGES * NPHASES] += clock64() - cycles_begin;
    trace[NSTAGES * NPHASES + 1] += now_ns() - ns_begin;
  }
}

// shared memory of a CTA when each stage's units are cut into NB parts (the largest part)
size_t smem_bytes(int NB, int B, int R, int H, int Z) {
  const int mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB, mr = (R + NB - 1) / NB;
  const size_t cols[NPROD] = {(size_t)mh + mr, (size_t)mh, (size_t)mh, (size_t)mh, (size_t)mz,
                              (size_t)2 * mh, (size_t)2 * mh, (size_t)2 * mh, (size_t)2 * mr};
  const int K[NPROD] = {3 * R, H, H, H, H, 2 * Z, H, H, H};
  size_t floats = 0, max_cols = 0;
  int max_k = 0;
  for (int s = 0; s < NPROD; ++s) {
    floats += cols[s] * K[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
    max_k = K[s] > max_k ? K[s] : max_k;
  }
  floats += (size_t)2 * BC * max_k + max_cols * BC + (size_t)3 * B * mr;
  return floats * sizeof(float);
}

}  // namespace vrnn_bwd
}  // namespace blvm

// K8-bwd. weights: K8's 28 device pointers (blvm_vrnn_cell; the biases are not read). h0 (B, R), eps (B, T,
// Z), h_out and phi: K8's h (B, T, R) and phi (B, T, H); save: K8's (B, T, 9H + 2Z + 4R) save buffer.
// grads: 7 device pointers, the gradients of K8's h, z, phi, q_mu, q_sd, p_mu, p_sd, each null for zero.
// dpre (B, T, 6R + 10H + 4Z), every step's pre-activation gradients: d gi (3R; also d xg), d gh (3R), phi
// L4, L3, L2, L1 (H each), the prior head, the posterior head (2Z each: mu, raw sd), prior L3, posterior
// L3, prior L2, posterior L2, prior L1, posterior L1 (H each; the last also d xpost). dh0 (B, R). barrier:
// one uint32 (zeroed here); trace: null, or 42 int64 sums (the SM cycles of each of the 10 stages' four
// phases as CTA 0 sees them, then the loop's cycles and nanoseconds). The grid is K8's. Returns a
// cudaError_t: cudaErrorInvalidValue for shapes K8 does not take, cudaErrorCooperativeLaunchTooLarge when
// the grid's weights cannot all be resident.
extern "C" int blvm_vrnn_cell_bwd(const void* const* weights, const void* h0, const void* eps, const void* h_out,
                                  const void* phi, const void* save, const void* const* grads, void* dpre, void* dh0,
                                  void* barrier, void* trace, int B, int T, int R, int H, int Z, int residual,
                                  float sd_beta, void* stream) {
  using namespace blvm::vrnn;
  using namespace blvm::vrnn_bwd;
  if (B < 1 || T < 1 || R < 1 || H < 1 || Z < 1 || !eps || !h_out || !phi || !save || !dpre || !dh0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static LaunchCache cache;
  cudaError_t err = query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = R > H ? (R > Z ? R : Z) : (H > Z ? H : Z);
  const int NB = cache.sms < units ? cache.sms : units;
  // a thread finishes at most 2 (unit, row) pairs of a pass: 2 H or H + R units, 2 R units a stage
  const int mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB, mr = (R + NB - 1) / NB;
  if (mh > NT / BC || mz > NT / BC || 4 * mr > 2 * NT / BC) return (int)cudaErrorInvalidValue;
  const size_t smem = blvm::vrnn_bwd::smem_bytes(NB, B, R, H, Z);
  err = prepare_cooperative(cache, (const void*)vrnn_cell_bwd_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < NWEIGHTS; ++i) p.w[i] = w[i];
  const float* const* g = reinterpret_cast<const float* const*>(grads);
  for (int i = 0; i < 7; ++i) p.g[i] = g[i];
  p.h0 = static_cast<const float*>(h0);
  p.eps = static_cast<const float*>(eps);
  p.h_out = static_cast<const float*>(h_out);
  p.phi = static_cast<const float*>(phi);
  p.save = static_cast<const float*>(save);
  p.dpre = static_cast<float*>(dpre);
  p.dh0 = static_cast<float*>(dh0);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.T = T;
  p.R = R;
  p.H = H;
  p.Z = Z;
  p.residual = residual;
  p.sd_beta = sd_beta;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)vrnn_cell_bwd_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
