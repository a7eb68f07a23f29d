// K12: one generated frame of STCN's fast generation, every sequence of the batch, f32, on sm_90a.
//
// Replaces the frame step of blvm_tpu/models/stcn/stcn.py STCN._generate_fast (:626-638, with decode_step
// :608-619 and sample_z :523-533), the dense top-down s = 1 model. For frame f >= 1 of every row b (C the
// residual width, R = C, S the skip width, H = C the heads' hidden width, Z the concatenated latent width):
//   1. c = x[f-2] ck0 + x[f-1] ck1 + cb                    the causal k = 2 tap (x[-1] is the history's end)
//      h = c W_in + b_in                                    the encoder's in_transform
//   2. each encoder block i, dilation d_i, slot (f-1) % d_i of its circular buffer:
//      old = buf_i[slot]; buf_i[slot] = h; a = tanh([old | h] W_t + b_t) * sigmoid([old | h] W_s + b_s)
//      [r | s] = a W_rs + b_rs (r only for a block whose skip no level reads); h = (h + r) sqrt(1/2)
//   3. the used blocks' s (4, 9, 14, 19 and 24 at five levels of five blocks) are the levels' columns d_l
//   4. top-down prior, levels L-1 .. 0: in = [d_l | z_{l+1}]; mu = MLP3_mu(in), raw = MLP3_sd(in) (LeakyReLU
//      0.01 between the Dense layers), sd = softplus(beta raw) / beta + eps_sd; z_l = mu + sd e_l
//   5. h = [z_0 .. z_{L-1}] W_dec_in + b_dec_in
//   6. each decode block j (dilation 1, its buffer the previous frame's input): as 2, and acc += s in block order
//   7. logits = relu((acc / sqrt(n_stacks)) W_up + b_up); params = logits W_lik + b_lik, log-scales clamped at
//      log_eps; the DMoL sample (csrc/dmol_sample.cuh: K3's Philox stream at step f, row b, or the uniforms
//      given) or the mode becomes x[f].
// Frame 0 runs in the d-column mode: the five d columns come from the encoder prime (a windowed forward of
// K1 launches) and steps 1-3 are skipped, so a generation of n frames is n launches of this kernel.
//
// What bounds it. A frame touches every weight once: ~12.2M f32 (~49 MB: the encoder 25 x (512 x 512 gate +
// 256 x 256 or 256 x 512 rs), the decode stack 5 x (512 x 512 + 256 x 512), the prior heads ~1.6M, the decode
// in_transform 496 x 256), at B = 2 two multiply-adds each: ~15 us at the HBM rate against < 1 us of f32
// FMA. But the frame is ~78 dependent matrix-vector products (two a block, three a prior level), each only B
// rows deep, so the latency of a product and of the grid-wide barrier after it sets the pace.
//
// Design: K8's cooperative grid (vrnn_common.cuh), one CTA an SM, 8 warps a CTA. A stage is one product;
// its output units (columns) are dealt round-robin over the CTAs, then over their warps, and a warp computes
// a whole unit: its weight column, laid out contiguously by the wrapper (unit-major, once a generation) and
// read 16 bytes a lane at a time (4-byte loads left each stage ~3.9 us waiting on its weights), its
// bias and any side input that this launch does not write (the prior's noise) are read by the lanes into
// registers before the barrier that precedes the stage, so their latency may hide behind the barrier's. After
// the barrier each CTA with units stages the stage's input rows (B x K, from L2) in shared memory, with the
// running state only its own units read and write (h, the decode skip sum); each warp reduces its unit for
// every row with shuffles, and the lanes of the rows finish it (activation, residual, buffer and skip
// updates) and store it to L2. A gate unit computes its tanh and its sigmoid column together, a prior head's
// last unit its mean and its scale together, so an activation never waits for another unit. The head (30 +
// 30 units and the sampler) runs in CTA 0 after the last barrier, on kernels that were copied into its
// shared memory (cp.async) while the frame ran. Weights are not kept resident across frames (49 MB is about
// the L2); that, and fewer barriers a frame, are later work.

#include "dmol_sample.cuh"
#include "mma_bf16.cuh"
#include "vrnn_common.cuh"

namespace blvm {
namespace stcn {

constexpr int NT = 256, NW = NT / 32;
constexpr int KMAX = 512;            // the widest product's depth: [old | h] at C = 256, the decode in_transform's Z
constexpr int KV = KMAX / 128;       // float4s a lane holds of one column (every depth K is a multiple of 4)
constexpr int MAX_B = 8;             // rows of the batch
constexpr int MAX_LAT = 8;           // latent levels
constexpr int MAX_ENC = 64;          // encoder blocks
constexpr int MAX_D = 3 * DMOL_MAX_M;  // the head's width
constexpr int NFIXED = 18;           // weight pointers before the levels' six each
// shared memory: a stage's input rows, the head's rows, then (CTA 0) the head's S x D and D x D kernels
inline size_t smem_bytes(int S, int D) {
  return sizeof(float) * (2 * MAX_B * KMAX + 2 * MAX_B * MAX_D + S * D + D * D + 2 * D);
}

struct Params {
  const float *causal_w, *causal_b;  // (2, C), (C)
  const float *enc_in_w, *enc_in_b;  // (C, C) unit-major, (C)
  const float *enc_gate_w, *enc_gate_b, *enc_rs_w, *enc_rs_b;  // (Le, 2, half, 2C), (Le, 2, half), (Le, C+S, half), (Le, C+S)
  const float *dec_in_w, *dec_in_b;  // (C, Z), (C)
  const float *dec_gate_w, *dec_gate_b, *dec_rs_w, *dec_rs_b;  // as the encoder's, Ld blocks
  const float *up_w, *up_b, *lik_w, *lik_b;  // (S, D), (D), (D, D), (D): (in, out) as flax keeps them
  const float *w0[MAX_LAT], *b0[MAX_LAT];  // (2H, S + z_cond), (2H): mean MLP's units, then the scale MLP's
  const float *w1[MAX_LAT], *b1[MAX_LAT];  // (2H, H), (2H)
  const float *w2[MAX_LAT], *b2[MAX_LAT];  // (2, z_l, H), (2, z_l)
  int dil[MAX_ENC], buf_off[MAX_ENC], level_of_block[MAX_ENC];  // level -1: the block's skip is not read
  int zsize[MAX_LAT], zoff[MAX_LAT];
  float *enc_buf;  // (B, sum d, C)
  float *dec_buf;  // (Ld, B, C)
  float *x;        // (B, x_cols): x[:, 0] the history's last frame, x[:, f + 1] frame f
  float *h, *act, *dcol, *hid_a, *hid_b, *z, *skip;  // (B, C), (B, half), (L, B, S), (B, 2H) x 2, (B, Z), (B, S)
  const float *eps;  // (n_frames, B, Z)
  const int64_t *seed;
  const float *u_cat, *u_log;  // (n_frames, B, M), (n_frames, B), when seed is null
  float *z_out, *params_out;   // null, or (n_frames, B, Z) and (n_frames, B, D): each frame's z and DMoL parameters
  unsigned int *barrier;
  long long *trace;  // null, or seven sums CTA 0 adds to (see blvm_stcn_decode)
  int B, C, half, S, Le, Ld, L, Z, M, x_cols, frame, from_d, use_mode;
  float inv_std_n, sd_beta, sd_eps, log_eps;
  UniformMaps maps;
};

__device__ __forceinline__ float leaky_relu(float v) { return v >= 0.0f ? v : __fmul_rn(0.01f, v); }

// B rows of K values from src(b, k) into shared region `dst` (rows KMAX apart), all of a thread's loads first
template <class Src>
__device__ __forceinline__ void stage_rows(float* dst, int B, int K, Src src) {
  const int n = B * K;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * NT) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * NT;
      v[j] = i < n ? src(i / K, i % K) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j * NT;
      if (i < n) dst[(i / K) * KMAX + i % K] = v[j];
    }
  }
}

// One product of the frame: U units of NDOT columns of depth K each, weights (NDOT, U, K) unit-major, biases
// (NDOT, U); U <= the grid's warps (the entry point checks). Unit u lies with CTA u % NB, warp u / NB. The
// warp's weights and biases are loaded and pre(u) is called (a side input that does not depend on this
// launch's stores: the prior's noise), then (unless this is the launch's first stage) the grid meets, then
// the CTA stages its input rows with stage_in (region 0, and region 1 for units >= split or, with
// dot_regions, for dot 1), and the unit's sums plus biases go to finish(u, b, v[NDOT], pre) in the lane of
// row b.
template <int NDOT, class In, class Pre, class Finish>
__device__ __forceinline__ void gemv_stage(const float* __restrict__ w, const float* __restrict__ bias, int U, int K,
                                           int split, bool dot_regions, int B, float* in_s, unsigned int* barrier,
                                           unsigned int& target, bool sync, long long* trace, In stage_in, Pre pre,
                                           Finish finish) {
  const long long c0 = trace ? clock64() : 0;
  const int NB = gridDim.x, cta = blockIdx.x, lane = threadIdx.x & 31;
  const int u = cta + NB * (threadIdx.x >> 5);
  const bool mine = u < U;
  float4 wr[NDOT][KV];  // lane l holds k = 4 l + 128 i .. + 3: 16-byte loads, a quarter of the requests
  float bv[NDOT];
#pragma unroll
  for (int m = 0; m < NDOT; ++m) {
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      const int k = 4 * lane + 128 * i;
      wr[m][i] = mine && k < K ? __ldg(reinterpret_cast<const float4*>(w + ((size_t)m * U + u) * K + k))
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    bv[m] = mine ? __ldg(bias + (size_t)m * U + u) : 0.0f;
  }
  const float pv = mine ? pre(u) : 0.0f;
  if (sync) vrnn::grid_sync(barrier, target);
  const long long c1 = trace ? clock64() : 0;
  if (cta >= U) return;
  stage_in();
  __syncthreads();
  const long long c2 = trace ? clock64() : 0;
  if (!mine) return;
  float acc[NDOT][MAX_B];
#pragma unroll
  for (int m = 0; m < NDOT; ++m)
#pragma unroll
    for (int b = 0; b < MAX_B; ++b) acc[m][b] = 0.0f;
#pragma unroll
  for (int m = 0; m < NDOT; ++m) {
    const float* in = in_s + ((dot_regions ? m : (u >= split ? 1 : 0)) * MAX_B) * KMAX;
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      const int k = 4 * lane + 128 * i;
      if (k < K) {
        const float4 wv = wr[m][i];
#pragma unroll
        for (int b = 0; b < MAX_B; ++b) {
          if (b < B) {
            const float4 x = *reinterpret_cast<const float4*>(in + b * KMAX + k);
            acc[m][b] = fmaf(x.w, wv.w, fmaf(x.z, wv.z, fmaf(x.y, wv.y, fmaf(x.x, wv.x, acc[m][b]))));
          }
        }
      }
    }
  }
  float v[NDOT];
#pragma unroll
  for (int m = 0; m < NDOT; ++m) {
    v[m] = 0.0f;
#pragma unroll
    for (int b = 0; b < MAX_B; ++b) {
      if (b < B) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[m][b] += __shfl_xor_sync(0xffffffffu, acc[m][b], off);
        if (lane == b) v[m] = __fadd_rn(acc[m][b], bv[m]);
      }
    }
  }
  const long long c3 = trace ? clock64() : 0;
  if (lane < B) finish(u, lane, v, pv);
  if (trace) {  // CTA 0's thread 0 (its unit is 0, which every product has)
    trace[0] += c1 - c0;
    trace[1] += c2 - c1;
    trace[2] += c3 - c2;
    trace[3] += clock64() - c3;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src));
}

__global__ void __launch_bounds__(NT, 1) stcn_decode_kernel(const Params p) {
  extern __shared__ float smem[];
  float* in_s = smem;                        // 2 regions of MAX_B rows of KMAX: a stage's input rows
  float* head_s = smem + 2 * MAX_B * KMAX;   // the head's 2 x MAX_B rows of MAX_D
  float* head_w = head_s + 2 * MAX_B * MAX_D;  // CTA 0: the upsample (S x D) and likelihood (D x D) kernels, their biases
  const int B = p.B, C = p.C, half = p.half, S = p.S, H = p.C, Z = p.Z, f = p.frame, D = 3 * p.M;
  const float inv_std_block = 0.70710678118654752f;  // sqrt(0.5) in f32, as the f32 JAX step multiplies by it
  unsigned int target = 0;
  bool sync = false;  // no barrier before the launch's first stage
  long long stage_cycles[4] = {0, 0, 0, 0};  // the products' phases, summed here and added to p.trace once
  long long* const trace = blockIdx.x == 0 && threadIdx.x == 0 && p.trace ? stage_cycles : nullptr;
  const long long launch_cycles = trace ? clock64() : 0, launch_ns = trace ? vrnn::now_ns() : 0;
  int sum_d = 0;
  for (int i = 0; i < p.Le; ++i) sum_d += p.dil[i];
  if (blockIdx.x == 0) {  // the head's kernels land in CTA 0's shared memory while the frame runs
    for (int i = threadIdx.x; i < S * D; i += NT) cp_async4(head_w + i, p.up_w + i);
    for (int i = threadIdx.x; i < D * D; i += NT) cp_async4(head_w + S * D + i, p.lik_w + i);
    for (int i = threadIdx.x; i < D; i += NT) {
      cp_async4(head_w + (S + D) * D + i, p.up_b + i);
      cp_async4(head_w + (S + D) * D + D + i, p.lik_b + i);
    }
    cp_async_commit();
  }
  auto no_pre = [](int) { return 0.0f; };

  // a residual block: the gate product, then the [r | s] product with its buffer, residual and skip updates.
  // The [r | s] stage stages its CTA's units' h (and what on_skip adds to) in region 1: only a unit's owner
  // reads and writes them in this stage.
  // buf_at(b) is row b's slot: the block's input d frames back, read by the gate and replaced by the current one.
  auto block = [&](const float* gw, const float* gb, const float* rw, const float* rb, int n_rs, auto buf_at,
                   auto skip_in, auto on_skip) {
    gemv_stage<2>(gw, gb, half, 2 * C, half, false, B, in_s, p.barrier, target, sync, trace,
                  [&] {
                    stage_rows(in_s, B, 2 * C, [&](int b, int k) {
                      return k < C ? __ldcg(buf_at(b) + k) : __ldcg(p.h + b * C + k - C);
                    });
                  },
                  no_pre,
                  [&](int u, int b, const float* v, float) {
                    __stcg(p.act + b * half + u, __fmul_rn(tanhf(v[0]), sigmoidf(v[1])));
                  });
    sync = true;
    gemv_stage<1>(rw, rb, n_rs, half, n_rs, false, B, in_s, p.barrier, target, sync, trace,
                  [&] {
                    stage_rows(in_s, B, half, [&](int b, int k) { return __ldcg(p.act + b * half + k); });
                    for (int i = threadIdx.x; i < B * NW; i += NT) {  // the CTA's units, one a warp
                      const int b = i % B, u = blockIdx.x + gridDim.x * (i / B);
                      if (u < n_rs) in_s[(MAX_B + b) * KMAX + u] = u < C ? __ldcg(p.h + b * C + u) : skip_in(b, u - C);
                    }
                  },
                  no_pre,
                  [&](int u, int b, const float* v, float) {
                    const float prev = in_s[(MAX_B + b) * KMAX + u];
                    if (u < C) {
                      __stcg(buf_at(b) + u, prev);
                      __stcg(p.h + b * C + u, __fmul_rn(__fadd_rn(prev, v[0]), inv_std_block));
                    } else {
                      on_skip(b, u - C, v[0], prev);
                    }
                  });
  };

  if (!p.from_d) {
    // 1. the causal tap and the encoder's in_transform
    gemv_stage<1>(p.enc_in_w, p.enc_in_b, C, C, C, false, B, in_s, p.barrier, target, sync, trace,
                  [&] {
                    float x2[MAX_B], x1[MAX_B];
#pragma unroll
                    for (int b = 0; b < MAX_B; ++b) {
                      x2[b] = b < B ? __ldcg(p.x + (int64_t)b * p.x_cols + f - 1) : 0.0f;
                      x1[b] = b < B ? __ldcg(p.x + (int64_t)b * p.x_cols + f) : 0.0f;
                    }
                    stage_rows(in_s, B, C, [&](int b, int k) {
                      float a2 = 0.0f, a1 = 0.0f;
#pragma unroll
                      for (int r = 0; r < MAX_B; ++r)
                        if (r == b) a2 = x2[r], a1 = x1[r];
                      return __fadd_rn(__fadd_rn(__fmul_rn(a2, __ldg(p.causal_w + k)), __fmul_rn(a1, __ldg(p.causal_w + C + k))),
                                       __ldg(p.causal_b + k));
                    });
                  },
                  no_pre, [&](int u, int b, const float* v, float) { __stcg(p.h + b * C + u, v[0]); });
    sync = true;
    // 2-3. the encoder's blocks over their circular buffers; the used blocks' skips are the levels' columns
    for (int i = 0; i < p.Le; ++i) {
      const int slot = (f - 1) % p.dil[i], level = p.level_of_block[i];
      const int64_t at = (int64_t)(p.buf_off[i] + slot) * C;
      auto buf_at = [&](int b) { return p.enc_buf + (int64_t)b * sum_d * C + at; };
      block(p.enc_gate_w + (size_t)i * 2 * half * 2 * C, p.enc_gate_b + (size_t)i * 2 * half,
            p.enc_rs_w + (size_t)i * (C + S) * half, p.enc_rs_b + (size_t)i * (C + S), level >= 0 ? C + S : C,
            buf_at, [](int, int) { return 0.0f; },
            [&](int b, int j, float s, float) { __stcg(p.dcol + ((int64_t)level * B + b) * S + j, s); });
    }
  }

  // 4. the prior, top-down: two 3-layer MLPs a level, z_l = mu + sd e_l
  const int lane = threadIdx.x & 31;
  for (int l = p.L - 1; l >= 0; --l) {
    const int zc = l + 1 < p.L ? p.zsize[l + 1] : 0, zc_off = l + 1 < p.L ? p.zoff[l + 1] : 0;
    gemv_stage<1>(p.w0[l], p.b0[l], 2 * H, S + zc, 2 * H, false, B, in_s, p.barrier, target, sync, trace,
                  [&] {
                    stage_rows(in_s, B, S + zc, [&](int b, int k) {
                      return k < S ? __ldcg(p.dcol + ((int64_t)l * B + b) * S + k) : __ldcg(p.z + b * Z + zc_off + k - S);
                    });
                  },
                  no_pre, [&](int u, int b, const float* v, float) { __stcg(p.hid_a + b * 2 * H + u, leaky_relu(v[0])); });
    sync = true;
    auto two_regions = [&](const float* src) {
      stage_rows(in_s, B, H, [&](int b, int k) { return __ldcg(src + b * 2 * H + k); });
      stage_rows(in_s + MAX_B * KMAX, B, H, [&](int b, int k) { return __ldcg(src + b * 2 * H + H + k); });
    };
    gemv_stage<1>(p.w1[l], p.b1[l], 2 * H, H, H, false, B, in_s, p.barrier, target, sync, trace, [&] { two_regions(p.hid_a); },
                  no_pre, [&](int u, int b, const float* v, float) {  // mean units, then scale units, as hid_a
                    __stcg(p.hid_b + b * 2 * H + u, leaky_relu(v[0]));
                  });
    const int zl = p.zsize[l], zo = p.zoff[l];
    gemv_stage<2>(p.w2[l], p.b2[l], zl, H, zl, true, B, in_s, p.barrier, target, sync, trace, [&] { two_regions(p.hid_b); },
                  [&](int u) { return lane < B ? __ldg(p.eps + ((int64_t)f * B + lane) * Z + zo + u) : 0.0f; },
                  [&](int u, int b, const float* v, float e) {
                    const float sd = vrnn::softplus_sd(v[1], p.sd_beta, p.sd_eps);
                    const float zv = __fadd_rn(v[0], __fmul_rn(sd, e));
                    __stcg(p.z + b * Z + zo + u, zv);
                    if (p.z_out) p.z_out[((int64_t)f * B + b) * Z + zo + u] = zv;
                  });
  }

  // 5-6. the decode in_transform on all z, the decode blocks with the skip sum in block order
  gemv_stage<1>(p.dec_in_w, p.dec_in_b, C, Z, C, false, B, in_s, p.barrier, target, sync, trace,
                [&] { stage_rows(in_s, B, Z, [&](int b, int k) { return __ldcg(p.z + b * Z + k); }); },
                no_pre, [&](int u, int b, const float* v, float) { __stcg(p.h + b * C + u, v[0]); });
  for (int j = 0; j < p.Ld; ++j) {
    auto buf_at = [&](int b) { return p.dec_buf + ((int64_t)j * B + b) * C; };
    block(p.dec_gate_w + (size_t)j * 2 * half * 2 * C, p.dec_gate_b + (size_t)j * 2 * half,
          p.dec_rs_w + (size_t)j * (C + S) * half, p.dec_rs_b + (size_t)j * (C + S), C + S, buf_at,
          [&](int b, int k) { return j == 0 ? 0.0f : __ldcg(p.skip + b * S + k); },
          [&](int b, int k, float s, float prev) { __stcg(p.skip + b * S + k, j == 0 ? s : __fadd_rn(prev, s)); });
  }

  // 7. the head and the sampler, in CTA 0
  vrnn::grid_sync(p.barrier, target);
  if (blockIdx.x != 0) return;
  const long long head_cycles = trace ? clock64() : 0;
  const int warp = threadIdx.x >> 5;
  stage_rows(in_s, B, S, [&](int b, int k) { return __fmul_rn(__ldcg(p.skip + b * S + k), p.inv_std_n); });
  cp_async_wait_all();
  __syncthreads();
  const float* up_w = head_w;
  const float* lik_w = head_w + S * D;
  const float* up_b = head_w + (S + D) * D;
  const float* lik_b = up_b + D;
  float* logits = head_s;                  // [b][MAX_D]: relu(up)
  float* params = head_s + MAX_B * MAX_D;  // [b][MAX_D]: the DMoL parameters
  for (int unit = warp; unit < B * D; unit += NW) {
    const int b = unit / D, j = unit % D;
    float acc = 0.0f;
    for (int k = lane; k < S; k += 32) acc = fmaf(in_s[b * KMAX + k], up_w[k * D + j], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) logits[b * MAX_D + j] = vrnn::relu(__fadd_rn(acc, up_b[j]));
  }
  __syncthreads();
  for (int t = threadIdx.x; t < B * D; t += NT) {
    const int b = t / D, j = t % D;
    float acc = 0.0f;
    for (int k = 0; k < D; ++k) acc = fmaf(logits[b * MAX_D + k], lik_w[k * D + j], acc);
    float v = __fadd_rn(acc, lik_b[j]);
    if (j >= 2 * p.M) v = fmaxf(v, p.log_eps);
    params[b * MAX_D + j] = v;
    if (p.params_out) p.params_out[((int64_t)f * B + b) * D + j] = v;
  }
  __syncthreads();
  if (threadIdx.x < B) {
    const int b = threadIdx.x, M = p.M;
    const float* par = params + b * MAX_D;
    float U[DMOL_MAX_M + 1], u_logistic, mode;
    if (p.seed) {
      philox_uniforms(p.seed, f, b, M, U);
      u_logistic = U[M];
    } else {
      const int64_t row = (int64_t)f * B + b;
#pragma unroll
      for (int m = 0; m < DMOL_MAX_M; ++m)
        if (m < M) U[m] = p.u_cat[row * M + m];
      u_logistic = p.u_log[row];
    }
    const float sample = dmol_sample_frame(par, par + M, par + 2 * M, M, U, u_logistic, p.maps, &mode);
    p.x[(int64_t)b * p.x_cols + f + 1] = p.use_mode ? mode : sample;
  }
  if (trace) {
    const long long end = clock64();
    for (int i = 0; i < 4; ++i) p.trace[i] += stage_cycles[i];
    p.trace[4] += end - head_cycles;
    p.trace[5] += end - launch_cycles;
    p.trace[6] += vrnn::now_ns() - launch_ns;
  }
}

}  // namespace stcn
}  // namespace blvm

// One frame (see the top of this file). weights: NFIXED + 6 L device pointers in Params' order (causal_w ..
// lik_b, then each level's w0, b0, w1, b1, w2, b2); geometry: host ints, Le dilations, Le levels of the
// blocks (-1 for a block whose skip no level reads), L latent widths; state: device pointers enc_buf,
// dec_buf, x, h, act, dcol, hid_a, hid_b, z, skip and the barrier (one uint32, zeroed here). frame f >= 1
// runs the whole step, from_d (frame 0) takes the levels' columns from dcol. trace: null, or seven int64
// sums the launch adds to, as CTA 0's thread 0 sees them: SM cycles of every product's weight loads and
// barrier, its input staging, its products, its finish; the head's cycles; the launch's cycles and
// nanoseconds. Returns a cudaError_t: cudaErrorInvalidValue for what it does not take.
extern "C" int blvm_stcn_decode(const void* const* weights, const int* geometry, void* const* state, const void* eps,
                                const void* seed, const void* u_cat, const void* u_log, void* z_out, void* params_out,
                                void* trace,
                                int B, int C, int half, int S, int Le, int Ld, int L, int M, int x_cols, int frame,
                                int from_d, int use_mode, float inv_std_n, float sd_beta, float sd_eps, float log_eps,
                                float cat_low, float cat_scale, float logistic_low, float logistic_scale, void* stream) {
  using namespace blvm::stcn;
  if (B < 1 || B > MAX_B || L < 1 || L > MAX_LAT || Le < 1 || Le > MAX_ENC || Ld < 1 || C < 1 || 2 * C > KMAX ||
      half < 1 || half > KMAX || S < 1 || S > KMAX || M < 1 || M > blvm::DMOL_MAX_M || frame < 0 || frame + 2 > x_cols ||
      (frame == 0) != (from_d != 0) || !eps || (!seed && (!u_cat || !u_log)))
    return (int)cudaErrorInvalidValue;
  Params p;
  const float* const* w = reinterpret_cast<const float* const*>(weights);
  const float** fixed[NFIXED] = {&p.causal_w, &p.causal_b, &p.enc_in_w, &p.enc_in_b, &p.enc_gate_w, &p.enc_gate_b,
                                 &p.enc_rs_w, &p.enc_rs_b, &p.dec_in_w, &p.dec_in_b, &p.dec_gate_w, &p.dec_gate_b,
                                 &p.dec_rs_w, &p.dec_rs_b, &p.up_w, &p.up_b, &p.lik_w, &p.lik_b};
  for (int i = 0; i < NFIXED; ++i) *fixed[i] = w[i];
  int Z = 0, off = 0;
  for (int l = 0; l < L; ++l) {
    p.w0[l] = w[NFIXED + 6 * l];
    p.b0[l] = w[NFIXED + 6 * l + 1];
    p.w1[l] = w[NFIXED + 6 * l + 2];
    p.b1[l] = w[NFIXED + 6 * l + 3];
    p.w2[l] = w[NFIXED + 6 * l + 4];
    p.b2[l] = w[NFIXED + 6 * l + 5];
    p.zsize[l] = geometry[2 * Le + l];
    p.zoff[l] = Z;
    Z += p.zsize[l];
    if (p.zsize[l] < 1 || S + (l + 1 < L ? geometry[2 * Le + l + 1] : 0) > KMAX) return (int)cudaErrorInvalidValue;
  }
  // every product's depth a multiple of 4 (16-byte weight loads): C, half, S and each latent width
  if (Z > KMAX || C > KMAX || C % 4 || half % 4 || S % 4) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (p.zsize[l] % 4) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < Le; ++i) {
    p.dil[i] = geometry[i];
    p.level_of_block[i] = geometry[Le + i];
    p.buf_off[i] = off;
    off += p.dil[i];
    if (p.dil[i] < 1 || p.level_of_block[i] >= L) return (int)cudaErrorInvalidValue;
  }
  float* const* s = reinterpret_cast<float* const*>(state);
  p.enc_buf = s[0];
  p.dec_buf = s[1];
  p.x = s[2];
  p.h = s[3];
  p.act = s[4];
  p.dcol = s[5];
  p.hid_a = s[6];
  p.hid_b = s[7];
  p.z = s[8];
  p.skip = s[9];
  p.barrier = reinterpret_cast<unsigned int*>(s[10]);
  p.eps = static_cast<const float*>(eps);
  p.seed = static_cast<const int64_t*>(seed);
  p.u_cat = static_cast<const float*>(u_cat);
  p.u_log = static_cast<const float*>(u_log);
  p.z_out = static_cast<float*>(z_out);
  p.params_out = static_cast<float*>(params_out);
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.C = C;
  p.half = half;
  p.S = S;
  p.Le = Le;
  p.Ld = Ld;
  p.L = L;
  p.Z = Z;
  p.M = M;
  p.x_cols = x_cols;
  p.frame = frame;
  p.from_d = from_d;
  p.use_mode = use_mode;
  p.inv_std_n = inv_std_n;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  p.log_eps = log_eps;
  p.maps = blvm::UniformMaps{cat_low, cat_scale, logistic_low, logistic_scale};

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static blvm::vrnn::LaunchCache cache;
  cudaError_t err = blvm::vrnn::query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int NB = cache.sms;
  // one unit a warp: the widest product's units (the gate's half, the [r | s] product's C + S, the heads' 2C)
  // must not outnumber the grid's warps
  if (half > NB * NW || C + S > NB * NW || 2 * C > NB * NW) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, 3 * M);
  err = blvm::vrnn::prepare_cooperative(cache, (const void*)stcn_decode_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(p.barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)stcn_decode_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
