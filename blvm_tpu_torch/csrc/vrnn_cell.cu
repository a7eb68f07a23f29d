// K8: the VRNN cell over all T' steps of a sequence batch, f32, on sm_90a.
//
// Replaces the lax.scan body of blvm_tpu/models/vrnn.py VRNNCell.__call__ (:77-92) and, in its prior
// mode, VRNNCell.generate_step (:94-103). Per step t, for a row of the batch (R = r_dim, H = h_dim,
// Z = z_dim; every MLP layer is a Dense and a ReLU):
//   prior:     p = MLP3(h);  (mu_p, raw_p) = p W_ph + b_ph;  sd_p = softplus(beta raw_p) / beta + eps_sd
//   posterior: q = MLP3([h, x]);  (mu_q, raw_q) = q W_qh + b_qh;  mu_q += mu_p under residual_posterior
//   z = mu_q + sd_q e_t   (prior mode: z = mu_p + sd_p e_t, or mu_p under use_mode)
//   phi = MLP4(z);  h' = GRUCell([x, phi], h)   (or GRUCell(phi, h) without condition_h_on_x)
// The x parts of the posterior's first layer (x W_q0[R:]) and of the GRU's input product
// (x W_ih[:X]) do not depend on h: the wrapper computes them for all B T' rows as two cuBLAS GEMMs
// (xpost, xg) before the launch, as K5's wrapper hoists its input projection. Tensors are batch-first
// and contiguous: h0 (B, R); xpost (B, T', H); xg (B, T', 3R); e (B, T', Z); outputs h (B, T', R), the
// state after each step; z, mu/sd of both heads (B, T', Z); phi (B, T', H).
//
// What bounds it. At the test pass's shape (B = 6, T' = 1125, R = 512, H = Z = 256) a row-step does
// ~2.2M multiply-adds in the kernel (~30 GFLOP in all, ~0.45 ms at 67 TFLOP/s) and moves ~10 KB, with
// ~10.7 MB of weights read once a launch. But the step is a chain of nine dependent products (the
// three MLP layers, the heads, the four phi layers, the GRU's input product; h W_hh runs beside the
// first), each only B rows deep and each followed by an all-to-all handoff among the CTAs: on the H100 the
// handoffs take ~60 % of a step (the trace), ~2 us a stage at B = 6 and 3-4 at B = 19, where every CTA reads
// ~0.5 MB of tagged words a step.
//
// The design (tagged_chain.cuh): one persistent cooperative launch for all T' steps. Each of the NB CTAs (one
// an SM) owns whole output units of every stage and keeps their weight columns in shared memory for the whole
// launch (~68 KB a CTA at the spec width): H units of each MLP layer, Z latent units (the mu and sd columns of
// both heads, so z is formed where its four values are), R GRU units (the r, z, n columns of W_hh in stage 1 and
// of W_ih's phi rows in stage 9, so the CTA keeps gh and its units' h on chip in between). The stages:
//   1: prior L1, posterior L1 (h part + xpost), gh = h W_hh + b_hh    2-3: prior and posterior L2, L3
//   4: both heads, sd, z    5-8: phi L1-L4    9: gi = phi W_ih[X:] + xg + b_ih, the gates, h'
// A stage gathers all rows of its input (up to 32 a pass: B = 19 is one) from the tagged words the stage before
// published; its products split (column, row) tiles over the warps; its finish publishes each unit's value as a
// tagged word (payload the f32, tag (step, stage)) and stores the plain f32 outputs and, in save mode, the saved
// activations beside it. Stage 1 publishes its L1 columns before it computes h W_hh, which only stage 9 reads. No
// grid barrier: each tagged buffer has two copies, by the step's parity, and a word of step t is overwritten at
// step t + 2 only after every CTA that read it has published something of step t + 1 (each CTA owns a unit of the
// widest of R, H and Z, and every unit of step t + 1 is an ancestor of every stage of step t + 2), so no word is
// overwritten before every reader has taken it. No tensor cores: the JAX step is f32, and TF32 or bf16 products
// would break parity. Given a trace buffer, the first CTA adds up the SM cycles of each stage's phases (inputs in,
// waiting included, products, finish and publish) and counts the words it had to load again, so a run can see
// where a step's time goes; without one it costs a branch a phase.
//
// Save mode, for a forward that will be differentiated (K8-bwd, vrnn_cell_bwd.cu, reads what it keeps):
// the nine MLP activations of every step go to a (B, T', 9H + 2Z + 4R) buffer, stage 4 adds both heads' raw sd
// pre-activations, stage 9 the GRU's r, u, n and gh_n.

#include "tagged_chain.cuh"

namespace blvm {
namespace k8 {

using namespace chain;
using vrnn::part_lo;
using vrnn::relu;
using vrnn::softplus_sd;

constexpr int NSTAGES = 9;

struct Params {
  const float* w[vrnn::NWEIGHTS];
  const float* h0;
  const float* xpost;  // null in prior mode
  const float* xg;     // null without condition_h_on_x
  const float* eps;    // null in prior mode under use_mode
  float* h_out;
  float* z;
  float* phi;
  float* q_mu;  // null in prior mode
  float* q_sd;
  float* p_mu;
  float* p_sd;
  // null, or the (B, T', 9H + 2Z + 4R) save buffer: the activations of prior L1, posterior L1, prior L2,
  // posterior L2, prior L3, posterior L3, phi L1-L3 (H each), raw_p, raw_q (Z each), r, u, n, gh_n (R each)
  float* save;
  // the tagged words, two copies by the step's parity, each B x (10H + Z + R): prior and posterior L1, L2, L3
  // (H each, interleaved P1 Q1 P2 Q2 P3 Q3), z (Z), phi L1-L4 (H each), h (R); zeroed by the entry point
  unsigned long long* hand;
  decode::Watch watch;
  long long* trace;  // null, or the sums of blvm_vrnn_cell's `trace`
  int B, T, R, H, Z, RB, act_floats;
  int inference, residual, use_mode;
  float sd_beta, sd_eps;
};

// the words of one copy of the handoff buffers
__host__ __device__ inline int64_t hand_words(int B, int R, int H, int Z) {
  return (int64_t)B * (10 * H + Z + R);
}

__global__ void __launch_bounds__(NT, 1) vrnn_cell_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Prod prod[NSTAGES];
  __shared__ Prod split[2];  // stage 1's L1 columns and its W_hh columns apart
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, R = p.R, H = p.H, Z = p.Z, G3 = 3 * R, RB = p.RB;
  const int hlo = part_lo(H, cta, NB), nh = part_lo(H, cta + 1, NB) - hlo;
  const int zlo = part_lo(Z, cta, NB), nz = part_lo(Z, cta + 1, NB) - zlo;
  const int rlo = part_lo(R, cta, NB), nr = part_lo(R, cta + 1, NB) - rlo;
  const int nq = p.inference ? nh : 0, nzq = p.inference ? nz : 0;  // posterior units: none in prior mode
  const int KR = pad4(R), KH = pad4(H), KZ = pad4(Z);
  const float* const* w = p.w;

  // resident weights, stage after stage in the column order of its groups, then every stage's biases
  const int ncols[NSTAGES] = {nh + nq + 3 * nr, nh + nq, nh + nq, 2 * nz + 2 * nzq, nh, nh, nh, nh, 3 * nr};
  const int Ks[NSTAGES] = {R, H, H, H, Z, H, H, H, H};
  float* ws[NSTAGES];
  float* cursor = smem;
  for (int s = 0; s < NSTAGES; ++s) {
    ws[s] = cursor;
    cursor += (size_t)ncols[s] * pad4(Ks[s]);
  }
  float* bs[NSTAGES];
  for (int s = 0; s < NSTAGES; ++s) {
    bs[s] = cursor;
    cursor += ncols[s];
  }
  cursor = smem + (((size_t)(cursor - smem) + 3) & ~(size_t)3);
  float* const act = cursor;  // the staged input rows
  cursor += p.act_floats;
  int max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) max_cols = max(max_cols, ncols[s]);
  float* const res = cursor;  // the k-parts' sums, 4 x max_cols x RB
  cursor += (size_t)4 * max_cols * RB;
  const int side_n = RB * max(nq, max(nz, 3 * nr));
  float* const side = cursor;  // a stage's read-only inputs for its finish, two buffers
  cursor += 2 * side_n;
  float* const gh = cursor;  // B x 3 nr: h W_hh + b_hh of this CTA's GRU units, stage 1 to stage 9
  cursor += (size_t)B * 3 * nr;
  float* const h_own = cursor;  // B x nr: h of this CTA's GRU units

  {  // the weights: stage 1 (prior L1, posterior L1's h rows, W_hh r, z, n), ...
    float* c = ws[0];
    load_columns(c, w[0], H, hlo, nh, R, KR);
    load_columns(c + (size_t)nh * KR, w[8], H, hlo, nq, R, KR);
    for (int g = 0; g < 3; ++g) load_columns(c + (size_t)(nh + nq + g * nr) * KR, w[26], G3, g * R + rlo, nr, R, KR);
    for (int l = 1; l < 3; ++l) {
      load_columns(ws[l], w[2 * l], H, hlo, nh, H, KH);
      load_columns(ws[l] + (size_t)nh * KH, w[8 + 2 * l], H, hlo, nq, H, KH);
    }
    load_columns(ws[3], w[6], 2 * Z, zlo, nz, H, KH);
    load_columns(ws[3] + (size_t)nz * KH, w[6], 2 * Z, Z + zlo, nz, H, KH);
    load_columns(ws[3] + (size_t)2 * nz * KH, w[14], 2 * Z, zlo, nzq, H, KH);
    load_columns(ws[3] + (size_t)(2 * nz + nzq) * KH, w[14], 2 * Z, Z + zlo, nzq, H, KH);
    for (int l = 0; l < 4; ++l) load_columns(ws[4 + l], w[16 + 2 * l], H, hlo, nh, l == 0 ? Z : H, l == 0 ? KZ : KH);
    for (int g = 0; g < 3; ++g) load_columns(ws[8] + (size_t)g * nr * KH, w[24], G3, g * R + rlo, nr, H, KH);
    // ... and the biases in the same order
    auto bias = [&](float* dst, const float* b, int col0, int n) {
      for (int j = tid; j < n; j += NT) dst[j] = __ldg(b + col0 + j);
    };
    bias(bs[0], w[1], hlo, nh);
    bias(bs[0] + nh, w[9], hlo, nq);
    for (int g = 0; g < 3; ++g) bias(bs[0] + nh + nq + g * nr, w[27], g * R + rlo, nr);
    for (int l = 1; l < 3; ++l) {
      bias(bs[l], w[2 * l + 1], hlo, nh);
      bias(bs[l] + nh, w[9 + 2 * l], hlo, nq);
    }
    bias(bs[3], w[7], zlo, nz);
    bias(bs[3] + nz, w[7], Z + zlo, nz);
    bias(bs[3] + 2 * nz, w[15], zlo, nzq);
    bias(bs[3] + 2 * nz + nzq, w[15], Z + zlo, nzq);
    for (int l = 0; l < 4; ++l) bias(bs[4 + l], w[17 + 2 * l], hlo, nh);
    for (int g = 0; g < 3; ++g) bias(bs[8] + g * nr, w[25], g * R + rlo, nr);
  }
  if (tid == 0) {  // the stages' groups: which columns read which input region
    for (int s = 0; s < NSTAGES; ++s) {
      Prod& P = prod[s];
      P.K = Ks[s];
      P.KP = pad4(Ks[s]);
      P.ncols = ncols[s];
      P.bias = bs[s];
      const int first = s == 1 || s == 2 ? nh : s == 3 ? 2 * nz : ncols[s];  // region 0's columns
      P.g[0] = Group{ws[s], first, 0, 0};
      P.g[1] = Group{ws[s] + (size_t)first * P.KP, ncols[s] - first, 1, first};
      P.ng = ncols[s] > first ? 2 : 1;
    }
    for (int i = 0; i < 2; ++i) {
      Prod& P = split[i];
      const int c0 = i == 0 ? 0 : nh + nq;
      P = prod[0];
      P.ncols = i == 0 ? nh + nq : 3 * nr;
      P.bias = bs[0] + c0;
      P.g[0] = Group{ws[0] + (size_t)c0 * KR, P.ncols, 0, 0};
      P.ng = 1;
    }
  }

  // the state entering step 0: this CTA's GRU units of h0 on chip and published, as if by stage 9 of step -1
  const int64_t PW = hand_words(B, R, H, Z);
  auto tag = [&](int t, int s) { return (uint32_t)((t + 1) * NSTAGES + s + 1); };
  const int64_t oZ = (int64_t)6 * B * H, oF = oZ + (int64_t)B * Z, oH = oF + (int64_t)4 * B * H;
  for (int i = tid; i < B * nr; i += NT) {
    const int b = i / nr, u = rlo + i % nr;
    const float v = __ldg(p.h0 + (int64_t)b * R + u);
    h_own[i] = v;
    decode::publish(p.hand + PW + oH + (int64_t)b * R + u, v, tag(-1, NSTAGES - 1));
  }
  __syncthreads();

  const int64_t SW = (int64_t)9 * H + 2 * Z + 4 * R;  // the save buffer's row-step
  const int64_t raw_off = (int64_t)9 * H, gate_off = raw_off + 2 * Z;
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

  // the finish's read-only inputs of stage s at step t for rows [b0, b0 + nb), by cp.async into buf
  auto prefetch = [&](int s, int t, int b0, int nb, float* buf) {
    if (s == 0) {
      for (int i = tid; i < nb * nq; i += NT)
        fetch(buf + i, p.xpost, ((int64_t)(b0 + i / nq) * T + t) * H + hlo + i % nq);
    } else if (s == 3 && p.eps) {
      for (int i = tid; i < nb * nz; i += NT) fetch(buf + i, p.eps, ((int64_t)(b0 + i / nz) * T + t) * Z + zlo + i % nz);
    } else if (s == 8) {
      for (int i = tid; i < nb * 3 * nr; i += NT) {
        const int b = i / (3 * nr), g = i % 3, u = (i / 3) % nr;
        fetch(buf + i, p.xg, ((int64_t)(b0 + b) * T + t) * G3 + g * R + rlo + u);
      }
    }
  };
  int seq = 0;  // the passes so far: the side buffers alternate pass by pass
  for (int t = 0; t < T; ++t) {
    unsigned long long* const cur = p.hand + (t & 1) * PW;  // this step's words
    const unsigned long long* const prev = p.hand + ((t + 1) & 1) * PW;
    float* const sv = p.save ? p.save + (int64_t)t * SW : nullptr;  // step t's fields of row 0
    const int64_t srs = (int64_t)T * SW;
#pragma unroll 1
    for (int s = 0; s < NSTAGES; ++s) {
      const Prod& P = prod[s];
      if (P.ncols == 0) continue;  // no unit of this stage here (narrow layers)
      Input in;
      in.want = s == 0 ? tag(t - 1, NSTAGES - 1) : tag(t, s - 1);
      in.nreg = 1;
      in.ld = s == 0 ? R : s == 4 ? Z : H;
      if (s == 0) {
        in.src[0] = prev + oH;
      } else if (s <= 3) {
        in.src[0] = cur + (int64_t)2 * (s - 1) * B * H;
        in.src[1] = in.src[0] + (int64_t)B * H;
        in.nreg = p.inference ? 2 : 1;
      } else if (s == 4) {
        in.src[0] = cur + oZ;
      } else {
        in.src[0] = cur + oF + (int64_t)(s - 5) * B * H;
      }
      for (int b0 = 0; b0 < B; b0 += RB) {
        const int nb = min(RB, B - b0);
        float* const sd = side + (seq++ & 1) * side_n;
        prefetch(s, t, b0, nb, sd);  // in flight during the gather
        // the input rows, in chunks of K that fit the staging buffer, each chunk's products added up
        const int rows = in.nreg * nb;
        const int kmax = (p.act_floats / rows) & ~3, nch = (P.KP + kmax - 1) / kmax;
        const int kc = min(P.KP, ((P.KP + nch - 1) / nch + 3) & ~3);  // equal chunks
        // stage 1 in one chunk: its L1 columns first, published before h W_hh, which only stage 9 reads
        const bool defer = s == 0 && kc == P.KP && split[0].ncols > 0 && split[1].ncols > 0;
        const Prod& Q = defer ? split[0] : P;
        const int KS = k_parts(Q, nb, kc);
        for (int k0 = 0; k0 < P.KP; k0 += kc) {
          const int kw = min(kc, P.KP - k0), kv = max(0, min(kw, P.K - k0));
          bool ok = gather(in, nb, b0, k0, kv, act, kc, p.watch, reloads);
          zero_pad(act, rows, kv, kw, kc);
          cp_async_wait_all();
          if (__syncthreads_or(!ok)) return;
          tick(s, 0);
          products(Q, act, kc, nb, k0, kw, KS, res, RB, k0 > 0);
          __syncthreads();
          tick(s, 1);
        }
        // the finish: each (unit, row) of the pass
        const float* const bias = Q.bias;
        if (s == 3) {  // the heads, sd, z
          for (int idx = tid; idx < nz * nb; idx += NT) {
            const int b = idx / nz, j = idx % nz, row = b0 + b;
            const int64_t o = ((int64_t)row * T + t) * Z + zlo + j;
            const float mu_p = sum_of(res, P.ncols, RB, KS, j, b) + bias[j];
            const float raw_p = sum_of(res, P.ncols, RB, KS, nz + j, b) + bias[nz + j];
            const float sd_p = softplus_sd(raw_p, p.sd_beta, p.sd_eps);
            if (sv) __stcg(sv + row * srs + raw_off + zlo + j, raw_p);
            float zv;
            if (p.inference) {
              float mu_q = sum_of(res, P.ncols, RB, KS, 2 * nz + j, b) + bias[2 * nz + j];
              const float raw_q = sum_of(res, P.ncols, RB, KS, 3 * nz + j, b) + bias[3 * nz + j];
              const float sd_q = softplus_sd(raw_q, p.sd_beta, p.sd_eps);
              if (sv) __stcg(sv + row * srs + raw_off + Z + zlo + j, raw_q);
              if (p.residual) mu_q = mu_q + mu_p;
              zv = __fadd_rn(mu_q, __fmul_rn(sd_q, sd[b * nz + j]));
              __stcg(p.q_mu + o, mu_q);
              __stcg(p.q_sd + o, sd_q);
            } else {
              zv = p.use_mode ? mu_p : __fadd_rn(mu_p, __fmul_rn(sd_p, sd[b * nz + j]));
            }
            decode::publish(cur + oZ + (int64_t)row * Z + zlo + j, zv, tag(t, s));
            __stcg(p.p_mu + o, mu_p);
            __stcg(p.p_sd + o, sd_p);
            __stcg(p.z + o, zv);
          }
        } else if (s == 8) {  // gi = phi W_ih[X:] + xg + b_ih, the gates, h'
          for (int idx = tid; idx < nr * nb; idx += NT) {
            const int b = idx / nr, u = idx % nr, row = b0 + b, unit = rlo + u;
            const float* x = sd + (b * nr + u) * 3;  // xg of the r, z, n gates
            float gi[3];
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              float v = sum_of(res, P.ncols, RB, KS, g * nr + u, b);
              if (p.xg) v = v + x[g];
              gi[g] = v + bias[g * nr + u];
            }
            const float* ghr = gh + (size_t)row * 3 * nr;
            const float h = h_own[row * nr + u];
            const float r = sigmoidf(gi[0] + ghr[u]);
            const float zg = sigmoidf(gi[1] + ghr[nr + u]);
            const float n = tanhf(__fadd_rn(gi[2], __fmul_rn(r, ghr[2 * nr + u])));
            const float h_new = __fadd_rn(__fmul_rn(1.0f - zg, n), __fmul_rn(zg, h));
            decode::publish(cur + oH + (int64_t)row * R + unit, h_new, tag(t, s));
            h_own[row * nr + u] = h_new;
            __stcg(p.h_out + ((int64_t)row * T + t) * R + unit, h_new);
            if (sv) {
              float* f = sv + row * srs + gate_off + unit;
              __stcg(f, r);
              __stcg(f + R, zg);
              __stcg(f + 2 * R, n);
              __stcg(f + 3 * R, ghr[2 * nr + u]);
            }
          }
        } else {  // an MLP layer (stage 1 also gh): ReLU, publish, save
          const int n_out = s == 0 ? nh + nq : Q.ncols;
          for (int idx = tid; idx < Q.ncols * nb; idx += NT) {
            const int b = idx / Q.ncols, c = idx % Q.ncols, row = b0 + b;
            float v = sum_of(res, Q.ncols, RB, KS, c, b);
            if (c >= n_out) {  // stage 1's h W_hh + b_hh, kept for stage 9
              gh[(size_t)row * 3 * nr + c - n_out] = v + bias[c];
              continue;
            }
            const bool q = c >= nh;  // a posterior unit
            const int unit = hlo + (q ? c - nh : c);
            if (s == 0 && q) v = v + sd[b * nq + c - nh];
            v = relu(v + bias[c]);
            int64_t buf, field;  // the tagged buffer and the save field of this stage's output
            if (s <= 2) {
              buf = (int64_t)(2 * s + (q ? 1 : 0)) * B * H;
              field = (int64_t)(2 * s + (q ? 1 : 0)) * H;
            } else {
              buf = oF + (int64_t)(s - 4) * B * H;
              field = (int64_t)(6 + s - 4) * H;
            }
            decode::publish(cur + buf + (int64_t)row * H + unit, v, tag(t, s));
            if (s == 7)
              __stcg(p.phi + ((int64_t)row * T + t) * H + unit, v);
            else if (sv)
              __stcg(sv + row * srs + field + unit, v);
          }
          if (defer) {  // h W_hh + b_hh from the rows still staged, while the L1 words travel
            tick(s, 2);
            __syncthreads();
            const Prod& G = split[1];
            const int KSg = k_parts(G, nb, kc);
            products(G, act, kc, nb, 0, kc, KSg, res, RB, false);
            __syncthreads();
            tick(s, 1);
            for (int idx = tid; idx < G.ncols * nb; idx += NT) {
              const int b = idx / G.ncols, c = idx % G.ncols;
              gh[(size_t)(b0 + b) * 3 * nr + c] = sum_of(res, G.ncols, RB, KSg, c, b) + G.bias[c];
            }
          }
        }
        tick(s, 2);
      }
    }
  }
  if (cta == 0 && p.trace && reloads)
    atomicAdd(reinterpret_cast<unsigned long long*>(p.trace + NSTAGES * NPHASES), (unsigned long long)reloads);
  if (trace) {
    for (int i = 0; i < NSTAGES * NPHASES; ++i) p.trace[i] += sums[i];
    p.trace[NSTAGES * NPHASES + 1] += clock64() - cycles_begin;
    p.trace[NSTAGES * NPHASES + 2] += decode::now_ns() - ns_begin;
  }
}

// The shared memory of a CTA whose units are the largest part of each stage's cut into NB parts, at RB rows a
// pass, and the staging buffer's floats (all of a stage's K for its rows where it fits, else chunks of it)
struct Smem {
  size_t bytes;
  int act_floats;
};

Smem smem_for(int NB, int B, int RB, int R, int H, int Z, size_t optin) {
  const int mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB, mr = (R + NB - 1) / NB;
  const int cols[NSTAGES] = {2 * mh + 3 * mr, 2 * mh, 2 * mh, 4 * mz, mh, mh, mh, mh, 3 * mr};
  const int K[NSTAGES] = {R, H, H, H, Z, H, H, H, H};
  size_t floats = 0;
  int max_cols = 0, want = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    floats += (size_t)cols[s] * pad4(K[s]) + cols[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
    const int nreg = s >= 1 && s <= 3 ? 2 : 1;
    const int need = nreg * RB * pad4(K[s]);
    want = need > want ? need : want;
  }
  floats = (floats + 3) & ~(size_t)3;
  const int side = RB * (mh > mz ? (mh > 3 * mr ? mh : 3 * mr) : (mz > 3 * mr ? mz : 3 * mr));
  const size_t fixed = floats + work_floats(0, max_cols, RB, side) + (size_t)B * 4 * mr;
  // the staging buffer: what the widest stage wants, or what is left (at least a chunk of 128 words a row)
  const long long left = (long long)((optin - STATIC_SMEM) / sizeof(float)) - (long long)fixed;
  const int least = 2 * RB * 128;
  const int act = (long long)want <= left ? want : (int)(left > least ? left & ~3ll : least);
  return Smem{(fixed + act) * sizeof(float), act};
}

}  // namespace k8
}  // namespace blvm

// K8. weights: 28 device pointers in this order: the prior MLP's W0 (R, H), b0, W1 (H, H), b1, W2, b2 and
// its head W (H, 2Z), b; the posterior's the same with W0 the h rows (R, H) of (R + X, H); phi's W0 (Z, H),
// b0, W1, b1, W2, b2, W3, b3; the GRU's W_ih phi rows (H, 3R), b_ih, W_hh (R, 3R), b_hh. outputs: 7 device
// pointers h (B, T, R), z, phi (B, T, H), q_mu, q_sd, p_mu, p_sd (B, T, Z); q_mu and q_sd null in prior
// mode. save: null, or the (B, T, 9H + 2Z + 4R) buffer K8-bwd reads (see Params::save). hand: 2 B (10H + Z + R)
// int64 of scratch (zeroed here). status: one int32 the kernel sets to 1 if a wait outlasts limit_ns nanoseconds
// (then the launch ends early and its outputs are not valid), never clears, and copies after the launch into
// host_status (page-locked host memory) for the wrapper to read where the host already waits for the card.
// trace: null, or 30 int64 sums the kernel adds to (the SM cycles of each stage's three phases as CTA 0 sees
// them, the tagged words it had to load again, then the loop's cycles and nanoseconds). The grid is one CTA an SM, or one a unit where every layer has
// fewer units than the card has SMs. Returns a cudaError_t: cudaErrorInvalidValue for arguments it does not
// take, cudaErrorCooperativeLaunchTooLarge when the grid's weights and carries cannot all be resident.
extern "C" int blvm_vrnn_cell(const void* const* weights, const void* h0, const void* xpost, const void* xg,
                              const void* eps, void* const* outputs, void* save, void* hand, void* status,
                              void* host_status, void* trace, int B, int T, int R, int H, int Z, int inference,
                              int residual, int use_mode, float sd_beta, float sd_eps, int64_t limit_ns,
                              void* stream) {
  using namespace blvm::k8;
  if (B < 1 || T < 1 || R < 1 || H < 1 || Z < 1 || (inference && (!xpost || !eps || !outputs[3] || !outputs[4])) ||
      (!inference && !use_mode && !eps) || !hand || !status || !host_status || limit_ns <= 0 ||
      (long long)(T + 1) * NSTAGES >= 0xffffffffll)
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
  err = blvm::chain::prepare(cache, (const void*)vrnn_cell_kernel, sm.bytes, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < blvm::vrnn::NWEIGHTS; ++i) p.w[i] = w[i];
  p.h0 = static_cast<const float*>(h0);
  p.xpost = static_cast<const float*>(xpost);
  p.xg = static_cast<const float*>(xg);
  p.eps = static_cast<const float*>(eps);
  float* const* o = reinterpret_cast<float* const*>(outputs);
  p.h_out = o[0];
  p.z = o[1];
  p.phi = o[2];
  p.q_mu = o[3];
  p.q_sd = o[4];
  p.p_mu = o[5];
  p.p_sd = o[6];
  p.save = static_cast<float*>(save);
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
  p.inference = inference;
  p.residual = residual;
  p.use_mode = use_mode;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  err = cudaMemsetAsync(hand, 0, 2 * hand_words(B, R, H, Z) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)vrnn_cell_kernel, dim3(NB), dim3(blvm::chain::NT), args, sm.bytes,
                                    st);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyAsync(host_status, status, sizeof(int), cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
