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
// every stage and keeps those rows of W resident in shared memory for the whole launch (~80 KB a CTA at the
// spec width, one CTA an SM, one cooperative launch): H units of each phi and MLP layer and of the heads, Z
// latent units for stage 5, R units of W_hh (stage 1) and of both MLPs' first layers (stage 9), so a CTA's GRU
// units' dh, dh u and dh_gh stay on chip from stage 9 of one step to stage G of the next and on to its stage 9.
// The operations (~2.2M multiply-adds a row-step in the chain, as many again in the weight gradients) would take
// ~2.5 ms at 19 x 1000 row-steps; as in K8 the chain's latency sets the pace, a product of B rows and a handoff
// each stage, and at B = 19 the bytes every CTA pulls from L2: stage 1 reads the 4R distinct gate gradients of a
// row (d gi and d gh share two of their three parts) where the others read H or 2Z. On the H100 the handoffs take
// ~70 % of a step at B = 19, stage 1's ~12 us of ~60. No tensor cores: the JAX step is f32.
//
// The design is K8's (tagged_chain.cuh): all rows of a stage in one pass (up to 32), K cut into chunks
// where a stage's rows do not fit the staging buffer (stage 1 at B = 19), the stages handing values on as tagged
// words in two copies by the step's parity and no grid barrier (the argument is K8's: every CTA owns a unit of
// the widest of R, H and Z and publishes something every step). Stage G's saved inputs are copied in by
// cp.async during the previous step's stage 9, so G starts on its carried dh at once. Stage 1 reads the gate
// gradients as one row of 4R words, [d a_r | d a_u | d a_n | d a_n r]: W_ih's rows hold zeros against the last
// quarter and W_hh's against the third.

#include "tagged_chain.cuh"

namespace blvm {
namespace k8_bwd {

using namespace chain;
using vrnn::part_lo;
using vrnn::softplus_slope;

constexpr int NSTAGES = 10;  // G, then the nine product stages 1-9; the trace has NSTAGES * NPHASES + 3 sums
constexpr int NSIDE = 8;     // read-only inputs of a (unit, row) pair of stage 5
constexpr int NG = 6;        // stage G's of a (unit, row): r, u, n, gh_n, h_{t-1}, the incoming d h

struct Params {
  const float* w[vrnn::NWEIGHTS];  // K8's 28 (biases unused)
  const float* h0;
  const float* eps;
  const float* h_out;  // K8's h (B, T, R): h_{t-1}
  const float* phi;    // K8's phi (B, T, H): the mask of phi L4
  const float* save;   // (B, T, 9H + 2Z + 4R), K8's save mode
  const float* g[7];   // gradients of h, z, phi, q_mu, q_sd, p_mu, p_sd (B, T, *); null for zero
  float* dpre;         // (B, T, 6R + 10H + 4Z): see blvm_vrnn_cell_bwd
  float* dh0;          // (B, R)
  // the tagged words, two copies by the step's parity, each B x (4R + 10H + 4Z): the gate gradients (4R), phi
  // L4-L1 (H each), the prior head, the posterior head (2Z each), prior and posterior L3, L2, L1 (H each,
  // interleaved); zeroed by the entry point
  unsigned long long* hand;
  decode::Watch watch;
  long long* trace;
  int B, T, R, H, Z, RB, act_floats, residual;
  float sd_beta;
};

// the words of one copy of the handoff buffers
__host__ __device__ inline int64_t hand_words(int B, int R, int H, int Z) {
  return (int64_t)B * (4 * R + 10 * H + 4 * Z);
}

__global__ void __launch_bounds__(NT, 1) vrnn_cell_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Prod prod[NSTAGES];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, R = p.R, H = p.H, Z = p.Z, G3 = 3 * R, RB = p.RB;
  const int hlo = part_lo(H, cta, NB), nh = part_lo(H, cta + 1, NB) - hlo;
  const int zlo = part_lo(Z, cta, NB), nz = part_lo(Z, cta + 1, NB) - zlo;
  const int rlo = part_lo(R, cta, NB), nr = part_lo(R, cta + 1, NB) - rlo;
  // the save buffer's fields (K8's Params::save) and the gradient buffer's (blvm_vrnn_cell_bwd)
  const int64_t SW = (int64_t)9 * H + 2 * Z + 4 * R, DW = (int64_t)6 * R + 10 * H + 4 * Z;
  const int S_A1P = 0, S_A1Q = H, S_A2P = 2 * H, S_A2Q = 3 * H, S_A3P = 4 * H, S_A3Q = 5 * H;
  const int S_RAWP = 9 * H, S_RAWQ = S_RAWP + Z, S_R = S_RAWP + 2 * Z, S_U = S_R + R, S_N = S_R + 2 * R,
            S_GHN = S_R + 3 * R;
  const int D_GH = G3, D_F3 = 2 * G3, D_HP = 2 * G3 + 4 * H, D_HQ = D_HP + 2 * Z, D_P2 = D_HQ + 2 * Z;
  const int KH = pad4(H), KZ2 = pad4(2 * Z), K4R = 4 * R;
  const float* const* w = p.w;

  // resident weights: the product stages' rows of W, input units of each layer
  const int ncols[NSTAGES] = {0, nh + nr, nh, nh, nh, nz, 2 * nh, 2 * nh, 2 * nh, 2 * nr};
  const int Ks[NSTAGES] = {0, K4R, H, H, H, H, 2 * Z, H, H, H};
  float* ws[NSTAGES];
  float* cursor = smem;
  for (int s = 0; s < NSTAGES; ++s) {
    ws[s] = cursor;
    cursor += (size_t)ncols[s] * pad4(Ks[s]);
  }
  const size_t wfloats = cursor - smem;
  float* const act = cursor;  // the staged input rows
  cursor += p.act_floats;
  int max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) max_cols = max(max_cols, ncols[s]);
  float* const res = cursor;  // the k-parts' sums, 4 x max_cols x RB
  cursor += (size_t)4 * max_cols * RB;
  const int side_n = RB * max(2 * nh, NSIDE * nz);
  float* const side = cursor;  // a stage's read-only inputs for its finish, two buffers
  cursor += 2 * side_n;
  float* const side_g = cursor;  // RB x nr x NG: stage G's inputs of a pass
  cursor += (size_t)RB * nr * NG;
  float* const dh_c = cursor;  // B x nr: dh of this CTA's GRU units, from stage 9 to the next step's G
  cursor += (size_t)B * nr;
  float* const dhu = cursor;  // B x nr: dh u, from G to stage 9
  cursor += (size_t)B * nr;
  float* const dhgh = cursor;  // B x nr: d gh W_hh^T, from stage 1 to stage 9

  zero(smem, (int)wfloats);
  zero(dh_c, B * nr);
  __syncthreads();
  {  // the rows of W: stage 1 W_ih's phi rows [d a_r, d a_u, d a_n | 0] and W_hh's [d a_r, d a_u | 0 | d a_n r]
    load_rows(ws[1], w[24], G3, hlo, nh, 0, G3, K4R, 0);
    float* whh = ws[1] + (size_t)nh * K4R;
    load_rows(whh, w[26], G3, rlo, nr, 0, 2 * R, K4R, 0);
    load_rows(whh, w[26], G3, rlo, nr, 2 * R, R, K4R, 3 * R);
    for (int l = 0; l < 3; ++l) load_rows(ws[2 + l], w[22 - 2 * l], H, hlo, nh, 0, H, KH, 0);  // phi L4, L3, L2
    load_rows(ws[5], w[16], H, zlo, nz, 0, H, KH, 0);                                        // phi L1, latent units
    load_rows(ws[6], w[6], 2 * Z, hlo, nh, 0, 2 * Z, KZ2, 0);                                // the heads
    load_rows(ws[6] + (size_t)nh * KZ2, w[14], 2 * Z, hlo, nh, 0, 2 * Z, KZ2, 0);
    for (int l = 0; l < 2; ++l) {  // L3, L2 of both MLPs
      load_rows(ws[7 + l], w[4 - 2 * l], H, hlo, nh, 0, H, KH, 0);
      load_rows(ws[7 + l] + (size_t)nh * KH, w[12 - 2 * l], H, hlo, nh, 0, H, KH, 0);
    }
    load_rows(ws[9], w[0], H, rlo, nr, 0, H, KH, 0);  // L1 of both MLPs, the h rows: GRU units
    load_rows(ws[9] + (size_t)nr * KH, w[8], H, rlo, nr, 0, H, KH, 0);
  }
  if (tid == 0) {  // the stages' groups: which rows of W read which input region
    for (int s = 0; s < NSTAGES; ++s) {
      Prod& P = prod[s];
      P.K = Ks[s];
      P.KP = pad4(Ks[s]);
      P.ncols = ncols[s];
      P.bias = nullptr;
      const int first = s >= 6 ? ncols[s] / 2 : ncols[s];  // region 0's
      P.g[0] = Group{ws[s], first, 0, 0};
      P.g[1] = Group{ws[s] + (size_t)first * P.KP, ncols[s] - first, 1, first};
      P.ng = ncols[s] > first ? 2 : 1;
    }
  }

  const int64_t PW = hand_words(B, R, H, Z);
  const int64_t oF = (int64_t)B * K4R, oHP = oF + (int64_t)4 * B * H, oHQ = oHP + (int64_t)2 * B * Z,
                oP = oHQ + (int64_t)2 * B * Z;  // P2 Q2 P1 Q1 P0 Q0, H each
  const int64_t srs = (int64_t)T * SW, drs = (int64_t)T * DW;  // row strides of the save and gradient buffers
  auto tag = [&](int it, int s) { return (uint32_t)((it + 1) * NSTAGES + s + 1); };
  // stage G's inputs of rows [b0, b0 + nb) at step t, by cp.async
  auto fetch_g = [&](int t, int b0, int nb) {
    const float* h_prev = t == 0 ? p.h0 : p.h_out + (int64_t)(t - 1) * R;
    const int64_t hp_rs = t == 0 ? R : (int64_t)T * R;
    for (int i = tid; i < nb * nr; i += NT) {
      const int row = b0 + i / nr, unit = rlo + i % nr;
      const float* s_ = p.save + row * srs + (int64_t)t * SW;
      float* d = side_g + i * NG;
      fetch(d, s_, S_R + unit);
      fetch(d + 1, s_, S_U + unit);
      fetch(d + 2, s_, S_N + unit);
      fetch(d + 3, s_, S_GHN + unit);
      fetch(d + 4, h_prev, row * hp_rs + unit);
      fetch(d + 5, p.g[0], ((int64_t)row * T + t) * R + unit);
    }
  };
  // the finish's read-only inputs of product stage s at step t for rows [b0, b0 + nb), by cp.async into buf:
  // masks, noise, raw sd, incoming gradients
  auto prefetch = [&](int s, int t, int b0, int nb, float* buf) {
    const float* const sv = p.save + (int64_t)t * SW;
    if (s == 1) {
      for (int i = tid; i < nb * nh; i += NT) {
        const int64_t o = ((int64_t)(b0 + i / nh) * T + t) * H + hlo + i % nh;
        fetch(buf + 2 * i, p.phi, o);
        fetch(buf + 2 * i + 1, p.g[2], o);
      }
    } else if (s <= 4) {
      const int f = (4 - s + 6) * H;  // phi L3, L2, L1 activations
      for (int i = tid; i < nb * nh; i += NT) fetch(buf + i, sv + (b0 + i / nh) * srs + f + hlo, i % nh);
    } else if (s == 5) {
      for (int i = tid; i < nb * nz; i += NT) {
        const int row = b0 + i / nz, c = i % nz;
        const int64_t o = ((int64_t)row * T + t) * Z + zlo + c;
        float* d = buf + NSIDE * i;
        fetch(d, p.g[1], o);
        fetch(d + 1, p.g[3], o);
        fetch(d + 2, p.g[4], o);
        fetch(d + 3, p.g[5], o);
        fetch(d + 4, p.g[6], o);
        fetch(d + 5, p.eps, o);
        fetch(d + 6, sv + row * srs, S_RAWP + zlo + c);
        fetch(d + 7, sv + row * srs, S_RAWQ + zlo + c);
      }
    } else if (s <= 8) {  // the mask of the layer below, prior units then posterior units
      const int fp = s == 6 ? S_A3P : s == 7 ? S_A2P : S_A1P, fq = s == 6 ? S_A3Q : s == 7 ? S_A2Q : S_A1Q;
      for (int i = tid; i < nb * 2 * nh; i += NT) {
        const int row = b0 + i / (2 * nh), c = i % (2 * nh);
        fetch(buf + i, sv + row * srs, (c < nh ? fp + c : fq + c - nh) + hlo);
      }
    }
  };
  if (nr > 0) fetch_g(T - 1, 0, min(RB, B));
  __syncthreads();

  // the trace: sums in shared memory, added to the global ones once the loop is over
  __shared__ long long sums[NSTAGES * NPHASES];
  const bool trace = cta == 0 && tid == 0 && p.trace;
  if (trace)
    for (int i = 0; i < NSTAGES * NPHASES; ++i) sums[i] = 0;
  int reloads = 0;  // the words this thread's gathers had to load again (the trace counts CTA 0's)
  const long long ns_begin = trace ? decode::now_ns() : 0, cycles_begin = trace ? clock64() : 0;
  long long mark = cycles_begin;
  auto tick = [&](int stage, int phase) {  // after a CTA barrier: the phase's cycles as CTA 0 sees them
    if (trace) {
      const long long t_ = clock64();
      sums[stage * NPHASES + phase] += t_ - mark;
      mark = t_;
    }
  };

  int seq = 0;  // the product stages' passes so far: the side buffers alternate pass by pass
  for (int it = 0; it < T; ++it) {
    const int t = T - 1 - it;
    unsigned long long* const cur = p.hand + (it & 1) * PW;
    float* const dp = p.dpre + (int64_t)t * DW;

    // stage G: the GRU's elementwise backward of this CTA's units, every row, from the carried dh
    for (int b0 = 0; b0 < B && nr > 0; b0 += RB) {
      const int nb = min(RB, B - b0);
      if (b0 > 0) {  // the first pass's inputs came in during the previous step
        __syncthreads();
        fetch_g(t, b0, nb);
      }
      cp_async_wait_all();
      __syncthreads();
      for (int idx = tid; idx < nb * nr; idx += NT) {
        const int row = b0 + idx / nr, u_ = idx % nr, unit = rlo + u_;
        const float* gv = side_g + idx * NG;
        const float r = gv[0], u = gv[1], n = gv[2], ghn = gv[3], hp = gv[4];
        const float dh = dh_c[row * nr + u_] + gv[5];
        const float dn = dh * (1.0f - u), du = dh * (hp - n);
        dhu[row * nr + u_] = dh * u;
        const float dan = dn * (1.0f - n * n);
        const float dar = dan * ghn * r * (1.0f - r);
        const float dau = du * u * (1.0f - u);
        const float danr = dan * r;
        unsigned long long* o = cur + (int64_t)row * K4R + unit;
        decode::publish(o, dar, tag(it, 0));
        decode::publish(o + R, dau, tag(it, 0));
        decode::publish(o + 2 * R, dan, tag(it, 0));
        decode::publish(o + 3 * R, danr, tag(it, 0));
        float* d = dp + row * drs;
        __stcg(d + unit, dar);
        __stcg(d + R + unit, dau);
        __stcg(d + 2 * R + unit, dan);
        __stcg(d + D_GH + unit, dar);
        __stcg(d + D_GH + R + unit, dau);
        __stcg(d + D_GH + 2 * R + unit, danr);
      }
    }
    tick(0, 2);

#pragma unroll 1
    for (int s = 1; s < NSTAGES; ++s) {
      const Prod& P = prod[s];
      if (s == 9 && t > 0 && nr > 0) fetch_g(t - 1, 0, min(RB, B));  // stage G's inputs of the next step
      if (P.ncols == 0) continue;  // no unit of this stage here (narrow layers)
      Input in;
      in.want = tag(it, s - 1);
      in.nreg = 1;
      in.ld = H;
      if (s == 1) {  // [d a_r | d a_u | d a_n | d a_n r] of the GRU units
        in.src[0] = cur;
        in.ld = K4R;
      } else if (s <= 5) {
        in.src[0] = cur + oF + (int64_t)(s - 2) * B * H;
      } else if (s == 6) {  // both heads' [mu | raw sd] of the latent units
        in.src[0] = cur + oHP;
        in.src[1] = cur + oHQ;
        in.ld = 2 * Z;
        in.nreg = 2;
      } else {
        in.src[0] = cur + oP + (int64_t)2 * (s - 7) * B * H;
        in.src[1] = in.src[0] + (int64_t)B * H;
        in.nreg = 2;
      }
      for (int b0 = 0; b0 < B; b0 += RB) {
        const int nb = min(RB, B - b0);
        float* const sd = side + (seq++ & 1) * side_n;
        prefetch(s, t, b0, nb, sd);  // in flight during the gather
        const int rows = in.nreg * nb;
        const int kmax = (p.act_floats / rows) & ~3, nch = (P.KP + kmax - 1) / kmax;
        const int kc = min(P.KP, ((P.KP + nch - 1) / nch + 3) & ~3);  // equal chunks
        const int KS = k_parts(P, nb, kc);
        for (int k0 = 0; k0 < P.KP; k0 += kc) {
          const int kw = min(kc, P.KP - k0), kv = max(0, min(kw, P.K - k0));
          const bool ok = gather(in, nb, b0, k0, kv, act, kc, p.watch, reloads);
          zero_pad(act, rows, kv, kw, kc);
          if (s != 9) cp_async_wait_all();  // stage 9's copies are the next step's G inputs: waited for there
          if (__syncthreads_or(!ok)) return;
          tick(s, 0);
          products(P, act, kc, nb, k0, kw, KS, res, RB, k0 > 0);
          __syncthreads();
          tick(s, 1);
        }
        // the finish: each (unit, row) of the pass
        const int nfin = s == 9 ? nr : P.ncols;
        for (int idx = tid; idx < nfin * nb; idx += NT) {
          const int b = idx / nfin, c = idx % nfin, row = b0 + b;
          const float v = sum_of(res, P.ncols, RB, KS, c, b);
          float* d = dp + row * drs;
          if (s == 1) {
            if (c < nh) {
              const float* x = sd + 2 * (b * nh + c);  // phi, d phi
              const float g = x[0] > 0.0f ? v + x[1] : 0.0f;
              decode::publish(cur + oF + (int64_t)row * H + hlo + c, g, tag(it, s));
              __stcg(d + D_F3 + hlo + c, g);
            } else {
              dhgh[row * nr + c - nh] = v;
            }
          } else if (s <= 4) {  // phi L3, L2, L1 pre-activation gradients
            const float g = sd[b * nh + c] > 0.0f ? v : 0.0f;
            decode::publish(cur + oF + (int64_t)(s - 1) * B * H + (int64_t)row * H + hlo + c, g, tag(it, s));
            __stcg(d + D_F3 + (s - 1) * H + hlo + c, g);
          } else if (s == 5) {
            const float* x = sd + NSIDE * (b * nz + c);
            const int j = zlo + c;
            const float dz = v + x[0];
            const float dmu_q = dz + x[1];
            const float dsd_q = dz * x[5] + x[2];
            const float dmu_p = p.residual ? x[3] + dmu_q : x[3];
            const float draw_p = x[4] * softplus_slope(x[6], p.sd_beta);
            const float draw_q = dsd_q * softplus_slope(x[7], p.sd_beta);
            const uint32_t tg = tag(it, s);
            decode::publish(cur + oHP + (int64_t)row * 2 * Z + j, dmu_p, tg);
            decode::publish(cur + oHP + (int64_t)row * 2 * Z + Z + j, draw_p, tg);
            decode::publish(cur + oHQ + (int64_t)row * 2 * Z + j, dmu_q, tg);
            decode::publish(cur + oHQ + (int64_t)row * 2 * Z + Z + j, draw_q, tg);
            __stcg(d + D_HP + j, dmu_p);
            __stcg(d + D_HP + Z + j, draw_p);
            __stcg(d + D_HQ + j, dmu_q);
            __stcg(d + D_HQ + Z + j, draw_q);
          } else if (s <= 8) {  // the MLPs' L3, L2, L1 pre-activation gradients
            const bool q = c >= nh;
            const int unit = hlo + (q ? c - nh : c);
            const float g = sd[b * 2 * nh + c] > 0.0f ? v : 0.0f;
            decode::publish(cur + oP + (int64_t)(2 * (s - 6) + (q ? 1 : 0)) * B * H + (int64_t)row * H + unit, g,
                            tag(it, s));
            __stcg(d + D_P2 + 2 * (s - 6) * H + (q ? H : 0) + unit, g);
          } else {  // dh entering step t, of this CTA's GRU units
            const int l = row * nr + c;
            dh_c[l] = ((dhu[l] + dhgh[l]) + v) + sum_of(res, P.ncols, RB, KS, nr + c, b);
          }
        }
        tick(s, 2);
      }
    }
    __syncthreads();  // stage 9's dh before the next step's G
  }
  for (int idx = tid; idx < B * nr; idx += NT) p.dh0[(int64_t)(idx / nr) * R + rlo + idx % nr] = dh_c[idx];
  if (cta == 0 && p.trace && reloads)
    atomicAdd(reinterpret_cast<unsigned long long*>(p.trace + NSTAGES * NPHASES), (unsigned long long)reloads);
  if (trace) {
    for (int i = 0; i < NSTAGES * NPHASES; ++i) p.trace[i] += sums[i];
    p.trace[NSTAGES * NPHASES + 1] += clock64() - cycles_begin;
    p.trace[NSTAGES * NPHASES + 2] += decode::now_ns() - ns_begin;
  }
}

// shared memory of a CTA whose units are the largest part of each stage's cut into NB parts, at RB rows a pass,
// and the staging buffer's floats (all of a stage's K for its rows where it fits, else chunks of it)
struct Smem {
  size_t bytes;
  int act_floats;
};

Smem smem_for(int NB, int B, int RB, int R, int H, int Z, size_t optin) {
  const int mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB, mr = (R + NB - 1) / NB;
  const int cols[NSTAGES] = {0, mh + mr, mh, mh, mh, mz, 2 * mh, 2 * mh, 2 * mh, 2 * mr};
  const int K[NSTAGES] = {0, 4 * R, H, H, H, H, 2 * Z, H, H, H};
  size_t floats = 0;
  int max_cols = 0, want = 0;
  for (int s = 1; s < NSTAGES; ++s) {
    floats += (size_t)cols[s] * pad4(K[s]);
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
    const int nreg = s >= 6 ? 2 : 1;
    const int need = nreg * RB * pad4(K[s]);
    want = need > want ? need : want;
  }
  const int side = RB * (2 * mh > NSIDE * mz ? 2 * mh : NSIDE * mz);
  const size_t fixed = floats + work_floats(0, max_cols, RB, side) + (size_t)RB * mr * NG + (size_t)3 * B * mr;
  const long long left = (long long)((optin - STATIC_SMEM) / sizeof(float)) - (long long)fixed;
  const int least = 2 * RB * 128;
  const int act = (long long)want <= left ? want : (int)(left > least ? left & ~3ll : least);
  return Smem{(fixed + act) * sizeof(float), act};
}

}  // namespace k8_bwd
}  // namespace blvm

// K8-bwd. weights: K8's 28 device pointers (blvm_vrnn_cell; the biases are not read). h0 (B, R), eps (B, T,
// Z), h_out and phi: K8's h (B, T, R) and phi (B, T, H); save: K8's (B, T, 9H + 2Z + 4R) save buffer.
// grads: 7 device pointers, the gradients of K8's h, z, phi, q_mu, q_sd, p_mu, p_sd, each null for zero.
// dpre (B, T, 6R + 10H + 4Z), every step's pre-activation gradients: d gi (3R; also d xg), d gh (3R), phi
// L4, L3, L2, L1 (H each), the prior head, the posterior head (2Z each: mu, raw sd), prior L3, posterior
// L3, prior L2, posterior L2, prior L1, posterior L1 (H each; the last also d xpost). dh0 (B, R). hand:
// 2 B (4R + 10H + 4Z) int64 of scratch (zeroed here). status, host_status and limit_ns: as K8's. trace: null, or
// 33 int64 sums (the SM cycles of each of the 10 stages' three phases as CTA 0 sees them, the tagged words it
// had to load again, then the loop's cycles and nanoseconds). The grid is K8's. Returns a cudaError_t: cudaErrorInvalidValue for arguments it does not
// take, cudaErrorCooperativeLaunchTooLarge when the grid's weights and carries cannot all be resident.
extern "C" int blvm_vrnn_cell_bwd(const void* const* weights, const void* h0, const void* eps, const void* h_out,
                                  const void* phi, const void* save, const void* const* grads, void* dpre, void* dh0,
                                  void* hand, void* status, void* host_status, void* trace, int B, int T, int R, int H,
                                  int Z, int residual, float sd_beta, int64_t limit_ns, void* stream) {
  using namespace blvm::k8_bwd;
  if (B < 1 || T < 1 || R < 1 || H < 1 || Z < 1 || !eps || !h_out || !phi || !save || !dpre || !dh0 || !hand ||
      !status || !host_status || limit_ns <= 0 || (long long)(T + 1) * NSTAGES >= 0xffffffffll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static blvm::chain::LaunchCache cache;
  cudaError_t err = blvm::chain::query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = R > H ? (R > Z ? R : Z) : (H > Z ? H : Z);
  const int NB = cache.sms < units ? cache.sms : units;
  int RB = B < blvm::chain::RB_MAX ? B : blvm::chain::RB_MAX;
  Smem sm = smem_for(NB, B, RB, R, H, Z, (size_t)cache.smem_optin);
  while (sm.bytes > (size_t)cache.smem_optin - STATIC_SMEM && RB > 8) {  // fewer rows a pass where the carries leave no room
    RB -= 8;
    sm = smem_for(NB, B, RB, R, H, Z, (size_t)cache.smem_optin);
  }
  err = blvm::chain::prepare(cache, (const void*)vrnn_cell_bwd_kernel, sm.bytes, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < blvm::vrnn::NWEIGHTS; ++i) p.w[i] = w[i];
  const float* const* g = reinterpret_cast<const float* const*>(grads);
  for (int i = 0; i < 7; ++i) p.g[i] = g[i];
  p.h0 = static_cast<const float*>(h0);
  p.eps = static_cast<const float*>(eps);
  p.h_out = static_cast<const float*>(h_out);
  p.phi = static_cast<const float*>(phi);
  p.save = static_cast<const float*>(save);
  p.dpre = static_cast<float*>(dpre);
  p.dh0 = static_cast<float*>(dh0);
  p.hand = static_cast<unsigned long long*>(hand);
  p.watch = blvm::decode::Watch{static_cast<int*>(status), limit_ns};
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.T = T;
  p.R = R;
  p.H = H;
  p.Z = Z;
  p.RB = RB;
  p.act_floats = sm.act_floats;
  p.residual = residual;
  p.sd_beta = sd_beta;
  err = cudaMemsetAsync(hand, 0, 2 * hand_words(B, R, H, Z) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)vrnn_cell_bwd_kernel, dim3(NB), dim3(blvm::chain::NT), args,
                                    sm.bytes, st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_status, status, sizeof(int), cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
