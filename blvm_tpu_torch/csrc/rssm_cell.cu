// K10: a CW-VAE level's RSSM cell chain over all T' steps of a sequence batch, f32, on sm_90a.
//
// Replaces the nn.scan of blvm_tpu/modules/rssm.py RSSMCell.__call__ (:46-62) over a level's steps
// (blvm_tpu/models/clockwork_vae/clockwork_vae.py CWVAE._run_level, :123-160) and, in its prior mode, the scan of
// RSSMCell.generate (:64-71) in CWVAE.generate (:352-369). Per step t, for a row of the batch (H = h_dim, Z = z_dim):
//   (reset: z, h = 0 at the parent level's ticks, where the caller gives a reset mask)
//   a  = relu(z_{t-1} Wg_z + xg_t)                          the GRU's input (gru_in Dense on [z, context])
//   h_t = GRU(a, h_{t-1})                                   torch gate order r, z, n; r multiplies h W_hn + b_hn
//   prior: p = MLP3_relu(h_t); (mu_p, raw_p) = p W_ph + b_ph;  sd_p = softplus(beta raw_p) / beta + eps_sd
//   posterior: q = MLP3_relu([h_t, enc_t]); (mu_q, raw_q) likewise; mu_q += mu_p (residual posterior) or
//              (mu_q, sd_q) = precision-weighted (mu_q, sd_q) and (mu_p, sd_p) (precision posterior)
//   z_t = mu_q + sd_q e_t   (prior mode: z_t = mu_p + sd_p e_t, or mu_p under use_mode)
// The parts that do not depend on the carry are the wrapper's cuBLAS GEMMs before the launch, for all B T' rows:
// xg = context Wg[Z:] + bg (the gru_in's context columns and bias; the bias alone on a level without context) and
// xq = enc Wq0[H:] + bq0 (the posterior's first layer's enc columns and bias); the chain keeps Wg's z rows and Wq0's
// h rows. Tensors are batch-first and contiguous: xg, xq (B, T', H); z0 (B, Z); h0 (B, H); e (B, T', Z); outputs z
// and the heads' mu and sd (B, T', Z), h (B, T', H).
//
// What bounds it. At the test pass's shape (B = 5, T' = 1126, H = 192, Z = 128) a row-step does ~0.60M
// multiply-adds (~6.8 GFLOP a launch, 0.10 ms at 67 TFLOP/s) over ~2.3 MB of weights read once a launch; but each
// step is six dependent products only B rows deep, so the latency of a product and of the grid barrier after it
// sets the pace, as in K8 and K9.
//
// The design is K9's (vrnn_common.cuh): one persistent cooperative launch for all T' steps, one CTA an SM, each
// CTA owning whole output units of every stage with their weight columns resident in shared memory for the whole
// launch, rows staged from L2, a grid barrier after every stage. A CTA owns GRU units [hlo, hlo + nh) of all three
// gates in both of the GRU's products, so its h W_hh columns (stage 1) are finished by the same CTA in stage 2
// through a scratch row in L2 that only it reads. Stages:
//   1: a from z's rows (Wg_z) and the GRU's h W_hh + b_hh, side by side      2: a W_ih + b_ih and the GRU update
//   3: prior and posterior L1 from h_t (+ xq)                                4-5: prior and posterior L2, L3
//   6: both heads, sd, the posterior's combination, z
// No tensor cores: the JAX step is f32.
//
// Save mode (a train step's forward, inference mode): besides its outputs the launch writes, per row-step, what
// K10-bwd (rssm_cell_bwd.cu) needs and cannot cheaply recompute, laid out as SAVE_* below: a (post-ReLU), the GRU's
// gates r, u, n and h W_hn + b_hn, the six MLP layers' post-ReLU values, and both heads' pre-activations (mu, then
// raw sd; the posterior's mu before the combination with the prior). The outputs are the same bits as without it.

#include "vrnn_common.cuh"

namespace blvm {
namespace rssm {

using vrnn::BC;
using vrnn::NT;
using vrnn::NW;

constexpr int NWEIGHTS = 20;  // see blvm_rssm_chain
constexpr int NSTAGES = 6;
constexpr int MAX_SEGS = 4;
constexpr int MAX_LOAD = 16;  // staged input floats a thread at most: BC x max(H, Z) <= NT x MAX_LOAD
// the save buffer's fields of a row-step, in units of H, then the heads at 11 H: prior (mu, raw) and posterior
// (mu, raw), 2 Z each; a row-step is 11 H + 4 Z floats
constexpr int SAVE_A = 0, SAVE_R = 1, SAVE_U = 2, SAVE_N = 3, SAVE_GHN = 4, SAVE_P1 = 5, SAVE_Q1 = 6, SAVE_HEADS = 11;

// Units [col0, col0 + n) of one (K, ld) kernel with their biases b[col0 ...], reading staged input `region`
struct Seg {
  const float* w;
  const float* b;
  int ld, col0, n, K, region;
};

struct Stage {
  Seg seg[MAX_SEGS];
  int nseg, ncols;
  float* ws[MAX_SEGS];  // each segment's units, K weights a unit, in shared memory
  float* bs;            // ncols
};

static __device__ __forceinline__ Seg make_seg(const float* w, const float* b, int ld, int col0, int n, int K,
                                               int region) {
  Seg s;
  s.w = w;
  s.b = b;
  s.ld = ld;
  s.col0 = col0;
  s.n = n;
  s.K = K;
  s.region = region;
  return s;
}

struct Params {
  const float* w[NWEIGHTS];
  const float* xg;
  const float* xq;      // null in prior mode
  const float* z0;
  const float* h0;
  const float* eps;     // null in prior mode under use_mode
  const int* resets;    // null, or (T,): 1 where the step starts from zero z and h
  float* z;
  float* h;
  float* q_mu;  // null in prior mode
  float* q_sd;
  float* p_mu;
  float* p_sd;
  float* act;  // B x 10H: a, gh (3H), prior L1, posterior L1, prior L2, posterior L2, prior L3, posterior L3
  float* save;  // null, or (B, T, 11H + 4Z) in inference mode: see SAVE_*
  unsigned int* barrier;
  int B, T, H, Z;
  int inference, residual, precision, use_mode;
  float sd_beta, sd_eps;
};

// res[c][b] = sum_k act[region(c)][b][k] ws[c][k] for the stage's columns; a warp reduces whole columns
static __device__ void products(const Stage& st, const float* act, int KR, float* res) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < st.ncols; c += NW) {
    int s = 0, first = 0;
    while (c >= first + st.seg[s].n) first += st.seg[s++].n;
    const int K = st.seg[s].K;
    const float* a = act + st.seg[s].region * BC * KR;
    const float* wc = st.ws[s] + (size_t)(c - first) * K;
    float acc[BC];
#pragma unroll
    for (int b = 0; b < BC; ++b) acc[b] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float wv = wc[k];
#pragma unroll
      for (int b = 0; b < BC; ++b) acc[b] = fmaf(a[b * K + k], wv, acc[b]);
    }
    float mine = 0.0f;
#pragma unroll
    for (int b = 0; b < BC; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      if (lane == b) mine = acc[b];
    }
    if (lane < BC) res[c * BC + lane] = mine;
  }
}

// rows [b0, b0 + BC) of a (B, K) input (row stride `stride`; src null: zeros) into a region of K-wide rows,
// zeros past B; every load issued before any store
static __device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride, int K, int b0, int B) {
  float v[MAX_LOAD];
#pragma unroll
  for (int i = 0; i < MAX_LOAD; ++i) {
    const int idx = threadIdx.x + i * NT, b = idx / K, k = idx % K;
    v[i] = src && idx < BC * K && b0 + b < B ? __ldcg(src + (int64_t)(b0 + b) * stride + k) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < MAX_LOAD; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (idx < BC * K) dst[idx] = v[i];
  }
}

static __device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

__global__ void __launch_bounds__(NT, 1) rssm_chain_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, Z = p.Z, KR = H > Z ? H : Z;
  const int hlo = vrnn::part_lo(H, cta, NB), nh = vrnn::part_lo(H, cta + 1, NB) - hlo;
  const int zlo = vrnn::part_lo(Z, cta, NB), nz = vrnn::part_lo(Z, cta + 1, NB) - zlo;
  const int nq = p.inference ? nh : 0, nqz = p.inference ? nz : 0;
  const int64_t SW = (int64_t)SAVE_HEADS * H + 4 * Z;  // the save buffer's row-step
  const float* const* w = p.w;

  Stage st[NSTAGES];
  st[0].nseg = 4;  // a's units from z's rows, then the three gates' h W_hh columns of the CTA's GRU units
  st[0].seg[0] = make_seg(w[0], nullptr, H, hlo, nh, Z, 0);
  for (int g = 0; g < 3; ++g) st[0].seg[1 + g] = make_seg(w[3], w[4], 3 * H, g * H + hlo, nh, H, 1);
  st[1].nseg = 3;  // the gates' a W_ih columns
  for (int g = 0; g < 3; ++g) st[1].seg[g] = make_seg(w[1], w[2], 3 * H, g * H + hlo, nh, H, 0);
  st[2].nseg = 2;  // prior and posterior L1, both from h_t
  st[2].seg[0] = make_seg(w[5], w[6], H, hlo, nh, H, 0);
  st[2].seg[1] = make_seg(w[13], nullptr, H, hlo, nq, H, 0);
  for (int l = 1; l < 3; ++l) {  // prior and posterior L2, L3
    st[2 + l].nseg = 2;
    st[2 + l].seg[0] = make_seg(w[5 + 2 * l], w[6 + 2 * l], H, hlo, nh, H, 0);
    st[2 + l].seg[1] = make_seg(w[12 + 2 * l], w[13 + 2 * l], H, hlo, nq, H, 1);
  }
  st[5].nseg = 4;  // heads: mu and raw sd columns of latent units [zlo, zlo + nz)
  st[5].seg[0] = make_seg(w[11], w[12], 2 * Z, zlo, nz, H, 0);
  st[5].seg[1] = make_seg(w[11], w[12], 2 * Z, Z + zlo, nz, H, 0);
  st[5].seg[2] = make_seg(w[18], w[19], 2 * Z, zlo, nqz, H, 1);
  st[5].seg[3] = make_seg(w[18], w[19], 2 * Z, Z + zlo, nqz, H, 1);

  // shared memory: every stage's weight columns and biases, the staged rows, the products, the side inputs
  float* cursor = smem;
  int max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    st[s].ncols = 0;
    for (int i = 0; i < st[s].nseg; ++i) {
      st[s].ws[i] = cursor;
      cursor += (size_t)st[s].seg[i].n * st[s].seg[i].K;
      st[s].ncols += st[s].seg[i].n;
    }
    max_cols = max(max_cols, st[s].ncols);
  }
  for (int s = 0; s < NSTAGES; ++s) {
    st[s].bs = cursor;
    cursor += st[s].ncols;
  }
  float* act = cursor;  // 2 regions of BC x KR
  cursor += 2 * BC * KR;
  float* res = cursor;  // max_cols x BC
  cursor += max_cols * BC;
  float* side = cursor;  // BC x max(nh, nz): a stage's other input for its units (xg, xq or e)

  for (int s = 0; s < NSTAGES; ++s) {  // a thread copies rows k of a segment's few columns, all loads first
    int first = 0;
    for (int i = 0; i < st[s].nseg; ++i) {
      const Seg& sg = st[s].seg[i];
      const int K = sg.K;
      float* ws = st[s].ws[i];
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

  const int64_t ars = (int64_t)10 * H;  // the scratch's row stride: a, gh (3H), p1, q1, p2, q2, p3, q3
  float* const a_g = p.act;
  float* const gh_g = p.act + H;
  float* const pin[3] = {p.act + 4 * H, p.act + 6 * H, p.act + 8 * H};
  float* const qin[3] = {p.act + 5 * H, p.act + 7 * H, p.act + 9 * H};
  unsigned int target = 0;

  for (int t = 0; t < T; ++t) {
    // the carry entering step t: z0, h0 or the previous step's outputs; nothing (zeros) after a reset
    const bool reset = p.resets && p.resets[t];
    const float* z_in = reset ? nullptr : t == 0 ? p.z0 : p.z + (int64_t)(t - 1) * Z;
    const float* h_in = reset ? nullptr : t == 0 ? p.h0 : p.h + (int64_t)(t - 1) * H;
    const int64_t z_stride = t == 0 ? Z : (int64_t)T * Z, h_stride = t == 0 ? H : (int64_t)T * H;

    // stage 1: a = relu(z Wg_z + xg) for the CTA's units; its units' h W_hh + b_hh kept in the scratch
    {
      const Stage& s0 = st[0];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv = 0.0f;  // xg of one (row, unit), issued first
        if (tid < BC * nh && b0 + tid / nh < B) sv = __ldg(p.xg + ((int64_t)(b0 + tid / nh) * T + t) * H + hlo + tid % nh);
        load_rows(act, z_in, z_stride, Z, b0, B);
        load_rows(act + BC * KR, h_in, h_stride, H, b0, B);
        if (tid < BC * nh) side[tid] = sv;
        __syncthreads();
        products(s0, act, KR, res);
        __syncthreads();
        for (int idx = tid; idx < s0.ncols * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const float pre = res[c * BC + b] + s0.bs[c];
          if (c < nh) {
            const float av = relu(pre + side[b * nh + c]);
            __stcg(a_g + (int64_t)row * ars + hlo + c, av);
            if (p.save) __stcg(p.save + ((int64_t)row * T + t) * SW + SAVE_A * H + hlo + c, av);
          } else {
            const int g = (c - nh) / nh, j = (c - nh) % nh;  // gate g of unit hlo + j
            __stcg(gh_g + (int64_t)row * ars + g * H + hlo + j, pre);
          }
        }
        __syncthreads();
      }
      vrnn::grid_sync(p.barrier, target);
    }

    // stage 2: a W_ih + b_ih and the GRU update of the CTA's units; h_t stored as an output
    {
      const Stage& s1 = st[1];
      for (int b0 = 0; b0 < B; b0 += BC) {
        load_rows(act, a_g, ars, H, b0, B);
        __syncthreads();
        products(s1, act, KR, res);
        __syncthreads();
        for (int idx = tid; idx < nh * BC; idx += NT) {
          const int j = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const float* gh = gh_g + (int64_t)row * ars + hlo + j;
          const float gi_r = res[j * BC + b] + s1.bs[j];
          const float gi_z = res[(nh + j) * BC + b] + s1.bs[nh + j];
          const float gi_n = res[(2 * nh + j) * BC + b] + s1.bs[2 * nh + j];
          const float ghn = __ldcg(gh + 2 * H);
          const float r = sigmoidf(gi_r + __ldcg(gh));
          const float zg = sigmoidf(gi_z + __ldcg(gh + H));
          const float n = tanhf(gi_n + r * ghn);
          const float hp = h_in ? __ldcg(h_in + (int64_t)row * h_stride + hlo + j) : 0.0f;
          __stcg(p.h + ((int64_t)row * T + t) * H + hlo + j, (1.0f - zg) * n + zg * hp);
          if (p.save) {
            float* sv = p.save + ((int64_t)row * T + t) * SW + hlo + j;
            __stcg(sv + SAVE_R * H, r);
            __stcg(sv + SAVE_U * H, zg);
            __stcg(sv + SAVE_N * H, n);
            __stcg(sv + SAVE_GHN * H, ghn);
          }
        }
        __syncthreads();
      }
      vrnn::grid_sync(p.barrier, target);
    }

    // stage 3: prior and posterior L1 from h_t (+ xq on the posterior's side)
    const float* h_t = p.h + (int64_t)t * H;
    {
      const Stage& s2 = st[2];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv = 0.0f;
        if (p.inference && tid < BC * nh && b0 + tid / nh < B)
          sv = __ldg(p.xq + ((int64_t)(b0 + tid / nh) * T + t) * H + hlo + tid % nh);
        load_rows(act, h_t, (int64_t)T * H, H, b0, B);
        if (tid < BC * nh) side[tid] = sv;
        __syncthreads();
        products(s2, act, KR, res);
        __syncthreads();
        for (int idx = tid; idx < s2.ncols * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const bool prior = c < nh;
          const float pre = res[c * BC + b] + (prior ? s2.bs[c] : side[b * nh + c - nh]);
          const float v = relu(pre);
          const int unit = hlo + (prior ? c : c - nh);
          __stcg((prior ? pin[0] : qin[0]) + (int64_t)row * ars + unit, v);
          if (p.save) __stcg(p.save + ((int64_t)row * T + t) * SW + (prior ? SAVE_P1 : SAVE_Q1) * H + unit, v);
        }
        __syncthreads();
      }
      vrnn::grid_sync(p.barrier, target);
    }

    // stages 4-5: prior and posterior L2, L3
    for (int l = 1; l < 3; ++l) {
      const Stage& sl = st[2 + l];
      for (int b0 = 0; b0 < B; b0 += BC) {
        load_rows(act, pin[l - 1], ars, H, b0, B);
        if (p.inference) load_rows(act + BC * KR, qin[l - 1], ars, H, b0, B);
        __syncthreads();
        products(sl, act, KR, res);
        __syncthreads();
        for (int idx = tid; idx < sl.ncols * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const bool prior = c < nh;
          const float v = relu(res[c * BC + b] + sl.bs[c]);
          const int unit = hlo + (prior ? c : c - nh);
          __stcg((prior ? pin[l] : qin[l]) + (int64_t)row * ars + unit, v);
          if (p.save) __stcg(p.save + ((int64_t)row * T + t) * SW + (SAVE_P1 + 2 * l + (prior ? 0 : 1)) * H + unit, v);
        }
        __syncthreads();
      }
      vrnn::grid_sync(p.barrier, target);
    }

    // stage 6: the heads, sd, the posterior's combination, z
    {
      const Stage& s5 = st[5];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv = 0.0f;  // e of one (row, latent unit), issued first
        if (p.eps && tid < BC * nz && b0 + tid / nz < B)
          sv = __ldg(p.eps + ((int64_t)(b0 + tid / nz) * T + t) * Z + zlo + tid % nz);
        load_rows(act, pin[2], ars, H, b0, B);
        if (p.inference) load_rows(act + BC * KR, qin[2], ars, H, b0, B);
        if (tid < BC * nz) side[tid] = sv;
        __syncthreads();
        products(s5, act, KR, res);
        __syncthreads();
        for (int idx = tid; idx < nz * BC; idx += NT) {
          const int j = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const int64_t o = ((int64_t)row * T + t) * Z + zlo + j;
          const float mu_p = res[j * BC + b] + s5.bs[j];
          const float raw_p = res[(nz + j) * BC + b] + s5.bs[nz + j];
          const float sd_p = vrnn::softplus_sd(raw_p, p.sd_beta, p.sd_eps);
          float zv;
          if (p.inference) {
            float mu_q = res[(2 * nz + j) * BC + b] + s5.bs[2 * nz + j];
            const float raw_q = res[(3 * nz + j) * BC + b] + s5.bs[3 * nz + j];
            float sd_q = vrnn::softplus_sd(raw_q, p.sd_beta, p.sd_eps);
            if (p.save) {
              float* sv = p.save + ((int64_t)row * T + t) * SW + SAVE_HEADS * H + zlo + j;
              __stcg(sv, mu_p);
              __stcg(sv + Z, raw_p);
              __stcg(sv + 2 * Z, mu_q);
              __stcg(sv + 3 * Z, raw_q);
            }
            if (p.residual) {
              mu_q = mu_q + mu_p;
            } else if (p.precision) {  // blvm_tpu/ops/variational.py:65-72, precisions as 1 / (sd sd)
              const float pr_q = 1.0f / (sd_q * sd_q), pr_p = 1.0f / (sd_p * sd_p);
              const float va = 1.0f / (pr_q + pr_p);
              mu_q = va * (mu_q * pr_q + mu_p * pr_p);
              sd_q = sqrtf(va);
            }
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
      }
      vrnn::grid_sync(p.barrier, target);
    }
  }
}

// shared memory of a CTA when each stage's units are cut into NB parts (the largest part)
size_t smem_bytes(int NB, int H, int Z) {
  const size_t mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB, KR = H > Z ? H : Z;
  const size_t weights = mh * Z + 3 * mh * H + 3 * mh * H + 3 * 2 * mh * H + 4 * mz * H;
  const size_t cols[NSTAGES] = {4 * mh, 3 * mh, 2 * mh, 2 * mh, 2 * mh, 4 * mz};
  size_t biases = 0, max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    biases += cols[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
  }
  const size_t floats = weights + biases + 2 * BC * KR + max_cols * BC + BC * (mh > mz ? mh : mz);
  return floats * sizeof(float);
}

}  // namespace rssm
}  // namespace blvm

// K10. weights: 20 device pointers in this order: gru_in's kernel's z rows (Z, H) (of (Z + C_ctx, H)); the GRU's
// w_ih (H, 3H), b_ih, w_hh (H, 3H), b_hh; the prior MLP's W0 (H, H), b0, W1, b1, W2, b2 and its head W (H, 2Z), b;
// the posterior MLP's W0's h rows (H, H) (of (H + E, H)), W1, b1, W2, b2 and its head W, b. xg (B, T, H): the
// context columns of gru_in with its bias; xq (B, T, H): the enc columns of the posterior's first layer with its bias
// (null in prior mode); z0 (B, Z), h0 (B, H); eps (B, T, Z), null in prior mode under use_mode; resets: null or T
// int32 (1: the step starts from zeros). outputs: 6 device pointers z, h, q_mu, q_sd, p_mu, p_sd; q_mu and q_sd null
// in prior mode. act: 10 B H floats of scratch; save: null, or (B, T, 11H + 4Z) floats in inference mode, which
// receive per row-step the fields SAVE_* (see the save mode above); barrier: one uint32 (zeroed here). The grid is
// one CTA an SM, or one a unit where the widths have fewer units than the card has SMs. Returns a cudaError_t:
// cudaErrorInvalidValue for shapes it does not take (more than NT / BC units of a layer or of the latent a CTA, or
// BC max(H, Z) > NT x 16 staged floats), cudaErrorCooperativeLaunchTooLarge when the grid's weights cannot all be
// resident.
extern "C" int blvm_rssm_chain(const void* const* weights, const void* xg, const void* xq, const void* z0,
                               const void* h0, const void* eps, const void* resets, void* const* outputs, void* act,
                               void* save, void* barrier, int B, int T, int H, int Z, int inference, int residual,
                               int precision, int use_mode, float sd_beta, float sd_eps, void* stream) {
  using namespace blvm::rssm;
  float* const* o = reinterpret_cast<float* const*>(outputs);
  if (B < 1 || T < 1 || H < 1 || Z < 1 || (inference && (!xq || !eps || !o[2] || !o[3])) ||
      (!inference && !use_mode && !eps) || (save && !inference) || (H > Z ? H : Z) * BC > NT * MAX_LOAD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static blvm::vrnn::LaunchCache cache;
  cudaError_t err = blvm::vrnn::query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = H > Z ? H : Z;
  const int NB = cache.sms < units ? cache.sms : units;
  if ((H + NB - 1) / NB > NT / BC || (Z + NB - 1) / NB > NT / BC) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(NB, H, Z);
  err = blvm::vrnn::prepare_cooperative(cache, (const void*)rssm_chain_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < NWEIGHTS; ++i) p.w[i] = w[i];
  p.xg = static_cast<const float*>(xg);
  p.xq = static_cast<const float*>(xq);
  p.z0 = static_cast<const float*>(z0);
  p.h0 = static_cast<const float*>(h0);
  p.eps = static_cast<const float*>(eps);
  p.resets = static_cast<const int*>(resets);
  p.z = o[0];
  p.h = o[1];
  p.q_mu = o[2];
  p.q_sd = o[3];
  p.p_mu = o[4];
  p.p_sd = o[5];
  p.act = static_cast<float*>(act);
  p.save = static_cast<float*>(save);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  p.Z = Z;
  p.inference = inference;
  p.residual = residual;
  p.precision = precision;
  p.use_mode = use_mode;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)rssm_chain_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
