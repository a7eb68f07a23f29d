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
// first), each only B rows deep: the latency of a product and of the barrier after it sets the pace.
//
// The design: one persistent cooperative launch for all T' steps. Each of the NB CTAs (one an SM)
// owns whole output units of every stage and keeps their weight columns in shared memory for the
// whole launch (~70 KB a CTA at the spec width, 8.9 MB in all after hoisting, which no cluster could
// hold): H units of each MLP layer, Z latent units (the mu and sd columns of both heads, so z is formed
// where its four values are), R GRU units (the r, z, n columns of W_hh in stage 1 and of W_ih's phi
// rows in stage 9, so the CTA keeps gh on chip in between). A stage reads its input rows from L2 into
// shared memory (every load of a thread issued before the first is waited for), each warp reduces
// whole columns (lanes split K, shuffles sum), the CTA finishes its units and stores them; a grid-wide
// barrier (a release fence and a reduction on one counter, acquire loads polling it; all CTAs
// co-resident by the cooperative launch) orders the stages:
//   1: prior L1, posterior L1 (h part + xpost), gh = h W_hh + b_hh    2-3: prior and posterior L2, L3
//   4: both heads, sd, z    5-8: phi L1-L4    9: gi = phi W_ih[X:] + xg + b_ih, the gates, h'
// Values that cross CTAs go through L2 (__ldcg / __stcg: never the non-coherent L1 or texture path).
// No tensor cores: the JAX step is f32, and TF32 or bf16 products would break parity. Given a trace
// buffer, the first CTA adds up the SM cycles of each stage's phases (inputs in, products, finish and
// store, barrier), so a run can see where a step's time goes; without one it costs a branch a phase.
//
// Save mode, for a forward that will be differentiated (K8-bwd, vrnn_cell_bwd.cu, reads what it keeps):
// the nine MLP activations of every step go to a (B, T', 9H + 2Z + 4R) buffer instead of one step's
// scratch, and stage 4 adds both heads' raw sd pre-activations, stage 9 the GRU's r, u, n and gh_n.

#include "vrnn_common.cuh"

namespace blvm {
namespace vrnn {

constexpr int NSTAGES = 9;
constexpr int NTRACE = NSTAGES * NPHASES + 2;  // and the loop's SM cycles and nanoseconds, to convert

struct Params {
  const float* w[NWEIGHTS];
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
  // the activations of prior L1, posterior L1, prior L2, posterior L2, prior L3, posterior L3, phi L1-L3 (H
  // each) of row b at step t from act + b act_rs + t act_ts; in save mode (act_ts > 0) followed by raw_p,
  // raw_q (Z each), r, u, n, gh_n (R each)
  float* act;
  int64_t act_rs, act_ts;
  unsigned int* barrier;
  long long* trace;  // null, or NTRACE sums: SM cycles of each (stage, phase) as CTA 0 sees them, the totals
  int B, T, R, H, Z;
  int inference, residual, use_mode, save;
  float sd_beta, sd_eps;
};

__global__ void __launch_bounds__(NT, 1) vrnn_cell_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, R = p.R, H = p.H, Z = p.Z, G = 3 * R;
  const int hlo = part_lo(H, cta, NB), nh = part_lo(H, cta + 1, NB) - hlo;
  const int zlo = part_lo(Z, cta, NB), nz = part_lo(Z, cta + 1, NB) - zlo;
  const int rlo = part_lo(R, cta, NB), nr = part_lo(R, cta + 1, NB) - rlo;
  const int nq = p.inference ? nh : 0;  // posterior units: none in prior mode

  // the stages' column segments, in the order their columns lie in shared memory
  Stage st[NSTAGES];
  const float* const* w = p.w;
  st[0].K = R;
  st[0].nseg = 5;
  st[0].seg[0] = make_seg(w[0], w[1], H, hlo, nh, 0);   // prior L1
  st[0].seg[1] = make_seg(w[8], w[9], H, hlo, nq, 0);   // posterior L1, h rows
  for (int g = 0; g < 3; ++g) st[0].seg[2 + g] = make_seg(w[26], w[27], G, g * R + rlo, nr, 0);  // W_hh r, z, n
  for (int l = 1; l < 3; ++l) {  // prior and posterior L2, L3
    st[l].K = H;
    st[l].nseg = 2;
    st[l].seg[0] = make_seg(w[2 * l], w[2 * l + 1], H, hlo, nh, 0);
    st[l].seg[1] = make_seg(w[8 + 2 * l], w[9 + 2 * l], H, hlo, nq, 1);
  }
  st[3].K = H;  // heads: mu and sd columns of latent units [zlo, zlo + nz)
  st[3].nseg = 4;
  st[3].seg[0] = make_seg(w[6], w[7], 2 * Z, zlo, nz, 0);
  st[3].seg[1] = make_seg(w[6], w[7], 2 * Z, Z + zlo, nz, 0);
  st[3].seg[2] = make_seg(w[14], w[15], 2 * Z, zlo, p.inference ? nz : 0, 1);
  st[3].seg[3] = make_seg(w[14], w[15], 2 * Z, Z + zlo, p.inference ? nz : 0, 1);
  for (int l = 0; l < 4; ++l) {  // phi L1-L4
    st[4 + l].K = l == 0 ? Z : H;
    st[4 + l].nseg = 1;
    st[4 + l].seg[0] = make_seg(w[16 + 2 * l], w[17 + 2 * l], H, hlo, nh, 0);
  }
  st[8].K = H;  // W_ih's phi rows: r, z, n of GRU units [rlo, rlo + nr)
  st[8].nseg = 3;
  for (int g = 0; g < 3; ++g) st[8].seg[g] = make_seg(w[24], w[25], G, g * R + rlo, nr, 0);

  // shared memory: every stage's weight columns and biases, the input rows, the products, gh
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
  float* act = cursor;  // 2 regions of BC x max(R, H, Z)
  cursor += 2 * BC * max(R, max(H, Z));
  float* res = cursor;  // max_cols x BC
  cursor += max_cols * BC;
  float* side = cursor;  // a stage's other inputs for its units: xpost, e, or xg and h (BC x max(nh, nz, 4 nr))
  cursor += BC * max(nh, max(nz, 4 * nr));
  float* gh = cursor;  // B x 3 x nr: h W_hh + b_hh of this CTA's GRU units, stage 1 to stage 9

  for (int s = 0; s < NSTAGES; ++s) {  // a thread copies rows k of a segment's few columns, all loads first
    int first = 0;
    const int K = st[s].K;
    for (int i = 0; i < st[s].nseg; ++i) {
      const Seg& sg = st[s].seg[i];
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
      for (int j = tid; j < sg.n; j += NT) st[s].bs[first + j] = __ldg(sg.b + sg.col0 + j);
      first += sg.n;
    }
  }
  __syncthreads();

  const int64_t ars = p.act_rs;  // the activations' row stride
  const int64_t raw_off = (int64_t)9 * H, gate_off = raw_off + 2 * Z;  // save mode: raw sd, then r, u, n, gh_n
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

  for (int t = 0; t < T; ++t) {
    // activation buffers, each written in one stage and read in the next: step t's in save mode
    float* const at = p.act + (int64_t)t * p.act_ts;
    float* const a1p = at;
    float* const a1q = at + H;
    float* const pin[3] = {at, at + 2 * H, at + 4 * H};
    float* const qin[3] = {at + H, at + 3 * H, at + 5 * H};
    float* const fbuf[4] = {at + 6 * H, at + 7 * H, at + 8 * H, nullptr};
    // h entering step t: h0, or the state after step t - 1
    const float* h_in = t == 0 ? p.h0 : p.h_out + (int64_t)(t - 1) * R;
    const int64_t h_stride = t == 0 ? R : (int64_t)T * R;

    // stage 1: prior L1, posterior L1 (h part + xpost), gh
    for (int b0 = 0; b0 < B; b0 += BC) {
      float sv = 0.0f;  // xpost of one (row, posterior unit), issued first
      if (tid < BC * nq && b0 + tid / nq < B)
        sv = __ldg(p.xpost + ((int64_t)(b0 + tid / nq) * T + t) * H + hlo + tid % nq);
      load_stage(act, h_in, nullptr, h_stride, R, b0, B);
      if (tid < BC * nq) side[tid] = sv;
      __syncthreads();
      tick(0, 0);
      stage_products(st[0], act, res);
      __syncthreads();
      tick(0, 1);
      const Stage& s0 = st[0];
      for (int idx = tid; idx < s0.ncols * BC; idx += NT) {
        const int c = idx / BC, b = idx % BC, row = b0 + b;
        if (row >= B) continue;
        const float v = res[c * BC + b];
        if (c < nh) {
          __stcg(a1p + (int64_t)row * ars + hlo + c, relu(v + s0.bs[c]));
        } else if (c < nh + nq) {
          const int j = c - nh;
          __stcg(a1q + (int64_t)row * ars + hlo + j, relu((v + side[b * nq + j]) + s0.bs[c]));
        } else {
          const int gj = c - nh - nq;  // gate g = gj / nr, unit rlo + gj % nr
          gh[(size_t)row * 3 * nr + gj] = v + s0.bs[c];
        }
      }
      __syncthreads();
      tick(0, 2);
    }
    grid_sync(p.barrier, target);
    tick(0, 3);

    // stages 2-3: prior and posterior L2, L3
    for (int l = 1; l < 3; ++l) {
      const Stage& sl = st[l];
      for (int b0 = 0; b0 < B; b0 += BC) {
        load_stage(act, pin[l - 1], p.inference ? qin[l - 1] : nullptr, ars, H, b0, B);
        __syncthreads();
        tick(l, 0);
        stage_products(sl, act, res);
        __syncthreads();
        tick(l, 1);
        for (int idx = tid; idx < sl.ncols * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const float v = relu(res[c * BC + b] + sl.bs[c]);
          if (c < nh)
            __stcg(pin[l] + (int64_t)row * ars + hlo + c, v);
          else
            __stcg(qin[l] + (int64_t)row * ars + hlo + c - nh, v);
        }
        __syncthreads();
        tick(l, 2);
      }
      grid_sync(p.barrier, target);
      tick(l, 3);
    }

    // stage 4: the heads, sd, z
    {
      const Stage& s3 = st[3];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv = 0.0f;  // e of one (row, latent unit), issued first
        if (p.eps && tid < BC * nz && b0 + tid / nz < B)
          sv = __ldg(p.eps + ((int64_t)(b0 + tid / nz) * T + t) * Z + zlo + tid % nz);
        load_stage(act, pin[2], p.inference ? qin[2] : nullptr, ars, H, b0, B);
        if (tid < BC * nz) side[tid] = sv;
        __syncthreads();
        tick(3, 0);
        stage_products(s3, act, res);
        __syncthreads();
        tick(3, 1);
        for (int idx = tid; idx < nz * BC; idx += NT) {
          const int j = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const int64_t o = ((int64_t)row * T + t) * Z + zlo + j;
          const float mu_p = res[j * BC + b] + s3.bs[j];
          const float raw_p = res[(nz + j) * BC + b] + s3.bs[nz + j];
          const float sd_p = softplus_sd(raw_p, p.sd_beta, p.sd_eps);
          if (p.save) __stcg(at + (int64_t)row * ars + raw_off + zlo + j, raw_p);
          float zv;
          if (p.inference) {
            float mu_q = res[(2 * nz + j) * BC + b] + s3.bs[2 * nz + j];
            const float raw_q = res[(3 * nz + j) * BC + b] + s3.bs[3 * nz + j];
            const float sd_q = softplus_sd(raw_q, p.sd_beta, p.sd_eps);
            if (p.save) __stcg(at + (int64_t)row * ars + raw_off + Z + zlo + j, raw_q);
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
      grid_sync(p.barrier, target);
      tick(3, 3);
    }

    // stages 5-8: phi L1-L4 (L4 is the phi output)
    for (int l = 0; l < 4; ++l) {
      const Stage& sl = st[4 + l];
      const float* src = l == 0 ? p.z + (int64_t)t * Z : fbuf[l - 1];
      const int64_t stride = l == 0 ? (int64_t)T * Z : ars;
      float* dst = l == 3 ? p.phi + (int64_t)t * H : fbuf[l];
      const int64_t dst_stride = l == 3 ? (int64_t)T * H : ars;
      for (int b0 = 0; b0 < B; b0 += BC) {
        load_stage(act, src, nullptr, stride, sl.K, b0, B);
        __syncthreads();
        tick(4 + l, 0);
        stage_products(sl, act, res);
        __syncthreads();
        tick(4 + l, 1);
        for (int idx = tid; idx < nh * BC; idx += NT) {
          const int c = idx / BC, b = idx % BC, row = b0 + b;
          if (row < B) __stcg(dst + (int64_t)row * dst_stride + hlo + c, relu(res[c * BC + b] + sl.bs[c]));
        }
        __syncthreads();
        tick(4 + l, 2);
      }
      grid_sync(p.barrier, target);
      tick(4 + l, 3);
    }

    // stage 9: gi = phi W_ih[X:] + xg + b_ih, the gates, h'
    {
      const Stage& s8 = st[8];
      for (int b0 = 0; b0 < B; b0 += BC) {
        float sv[2];  // xg of the r, z, n gates and h of (row, GRU unit) pairs, issued first
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = tid + i * NT, g = q % 4, u = (q / 4) % max(nr, 1), row = b0 + q / (4 * max(nr, 1));
          sv[i] = 0.0f;
          if (q < BC * nr * 4 && row < B) {
            if (g == 3)
              sv[i] = __ldcg(h_in + (int64_t)row * h_stride + rlo + u);
            else if (p.xg)
              sv[i] = __ldg(p.xg + ((int64_t)row * T + t) * G + g * R + rlo + u);
          }
        }
        load_stage(act, p.phi + (int64_t)t * H, nullptr, (int64_t)T * H, H, b0, B);
        for (int i = 0; i < 2; ++i)
          if (tid + i * NT < BC * nr * 4) side[tid + i * NT] = sv[i];
        __syncthreads();
        tick(8, 0);
        stage_products(s8, act, res);
        __syncthreads();
        tick(8, 1);
        for (int idx = tid; idx < nr * BC; idx += NT) {
          const int u = idx / BC, b = idx % BC, row = b0 + b;
          if (row >= B) continue;
          const int unit = rlo + u;
          const float* sd = side + (b * nr + u) * 4;  // xg of the r, z, n gates, h
          float gi[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            float v = res[(g * nr + u) * BC + b];
            if (p.xg) v = v + sd[g];
            gi[g] = v + s8.bs[g * nr + u];
          }
          const float* ghr = gh + (size_t)row * 3 * nr;
          const float h = sd[3];
          const float r = sigmoidf(gi[0] + ghr[u]);
          const float zg = sigmoidf(gi[1] + ghr[nr + u]);
          const float n = tanhf(__fadd_rn(gi[2], __fmul_rn(r, ghr[2 * nr + u])));
          const float h_new = __fadd_rn(__fmul_rn(1.0f - zg, n), __fmul_rn(zg, h));
          __stcg(p.h_out + ((int64_t)row * T + t) * R + unit, h_new);
          if (p.save) {
            float* sv = at + (int64_t)row * ars + gate_off + unit;
            __stcg(sv, r);
            __stcg(sv + R, zg);
            __stcg(sv + 2 * R, n);
            __stcg(sv + 3 * R, ghr[2 * nr + u]);
          }
        }
        __syncthreads();
        tick(8, 2);
      }
      grid_sync(p.barrier, target);
      tick(8, 3);
    }
  }
  if (trace) {
    trace[NSTAGES * NPHASES] += clock64() - cycles_begin;
    trace[NSTAGES * NPHASES + 1] += now_ns() - ns_begin;
  }
}

// shared memory of a CTA when each stage's units are cut into NB parts (the largest part)
size_t smem_bytes(int NB, int B, int R, int H, int Z) {
  const int mh = (H + NB - 1) / NB, mz = (Z + NB - 1) / NB, mr = (R + NB - 1) / NB;
  const size_t cols[NSTAGES] = {(size_t)2 * mh + 3 * mr, (size_t)2 * mh, (size_t)2 * mh, (size_t)4 * mz, (size_t)mh,
                                (size_t)mh, (size_t)mh, (size_t)mh, (size_t)3 * mr};
  const int K[NSTAGES] = {R, H, H, H, Z, H, H, H, H};
  size_t floats = 0, max_cols = 0;
  for (int s = 0; s < NSTAGES; ++s) {
    floats += cols[s] * K[s] + cols[s];
    max_cols = cols[s] > max_cols ? cols[s] : max_cols;
  }
  const int side = 4 * mr > (mh > mz ? mh : mz) ? 4 * mr : (mh > mz ? mh : mz);
  floats += (size_t)2 * BC * (R > H ? (R > Z ? R : Z) : (H > Z ? H : Z)) + max_cols * BC + (size_t)BC * side +
            (size_t)B * 3 * mr;
  return floats * sizeof(float);
}

}  // namespace vrnn
}  // namespace blvm

// K8. weights: 28 device pointers in this order: the prior MLP's W0 (R, H), b0, W1 (H, H), b1, W2, b2 and
// its head W (H, 2Z), b; the posterior's the same with W0 the h rows (R, H) of (R + X, H); phi's W0 (Z, H),
// b0, W1, b1, W2, b2, W3, b3; the GRU's W_ih phi rows (H, 3R), b_ih, W_hh (R, 3R), b_hh. outputs: 7 device
// pointers h (B, T, R), z, phi (B, T, H), q_mu, q_sd, p_mu, p_sd (B, T, Z); q_mu and q_sd null in prior
// mode. act: 9 B H floats of scratch, or with `save` the (B, T, 9H + 2Z + 4R) buffer K8-bwd reads (see
// Params::act); barrier: one uint32 (zeroed here); trace: null, or 38 int64 sums the kernel adds
// to (the SM cycles of each stage's four phases as CTA 0 sees them, then the loop's cycles and nanoseconds).
// The grid is one CTA an SM, or one a unit where a layer has fewer units than the card has SMs.
// Returns a cudaError_t; cudaErrorInvalidValue for shapes it does not take (among them more than
// NT / BC units of an MLP layer or of the latent, or 2 NT / (4 BC) GRU units, a CTA: each thread
// fetches at most one or two of a stage's side inputs), cudaErrorCooperativeLaunchTooLarge when the
// grid's weights cannot all be resident.
extern "C" int blvm_vrnn_cell(const void* const* weights, const void* h0, const void* xpost, const void* xg,
                              const void* eps, void* const* outputs, void* act, void* barrier, void* trace,
                              int B, int T,
                              int R, int H, int Z, int inference, int residual, int use_mode, int save, float sd_beta,
                              float sd_eps, void* stream) {
  using namespace blvm::vrnn;
  if (B < 1 || T < 1 || R < 1 || H < 1 || Z < 1 || (inference && (!xpost || !eps || !outputs[3] || !outputs[4])) ||
      (!inference && !use_mode && !eps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static LaunchCache cache;
  cudaError_t err = query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int units = R > H ? (R > Z ? R : Z) : (H > Z ? H : Z);
  const int NB = cache.sms < units ? cache.sms : units;
  if ((H + NB - 1) / NB > NT / BC || (Z + NB - 1) / NB > NT / BC || 4 * ((R + NB - 1) / NB) > 2 * NT / BC)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(NB, B, R, H, Z);
  err = prepare_cooperative(cache, (const void*)vrnn_cell_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  for (int i = 0; i < NWEIGHTS; ++i) p.w[i] = w[i];
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
  p.act = static_cast<float*>(act);
  const int64_t save_width = (int64_t)9 * H + 2 * Z + 4 * R;
  p.act_rs = save ? (int64_t)T * save_width : (int64_t)9 * H;
  p.act_ts = save ? save_width : 0;
  p.barrier = static_cast<unsigned int*>(barrier);
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.T = T;
  p.R = R;
  p.H = H;
  p.Z = Z;
  p.inference = inference;
  p.residual = residual;
  p.use_mode = use_mode;
  p.save = save;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)vrnn_cell_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
