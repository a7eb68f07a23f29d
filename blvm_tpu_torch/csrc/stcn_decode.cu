// K12: STCN's fast generation, every frame of every sequence of the batch in one launch, f32, on sm_90a.
//
// Replaces the frame loop of blvm_tpu/models/stcn/stcn.py STCN._generate_fast (:626-638, with decode_step
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
// Frame 0 runs in the d-column mode: its five d columns come from the encoder prime (a windowed forward of
// K1 launches) and steps 1-3 are skipped.
//
// What bounds it. A frame touches every weight once: ~12.2M f32 (~49 MB: the encoder 25 x (512 x 512 gate +
// 256 x 256 or 256 x 512 rs), the decode stack 5 x (512 x 512 + 256 x 512), the prior heads ~1.6M, the decode
// in_transform 496 x 256), at B = 2 two multiply-adds each: ~15 us at the HBM rate against < 1 us of f32
// FMA. But the frame is 77 dependent matrix-vector products (two a block, three a prior level, the two
// in_transforms), each only B rows deep, so the latency of a product and of the handoff after it sets the pace.
//
// Design: one cooperative launch a generation (frames 0 .. n-1), one CTA an SM (at most C CTAs), 8 warps a
// CTA. A stage is one product; its output units are dealt round-robin over the CTAs, then over their warps
// (unit u: CTA u % NB, warp u / NB, the same every frame), and a warp computes a whole unit, its lanes
// across k. So each CTA's weight columns are fixed for the whole launch: the wrapper lays them out once a
// generation as one stream a CTA, stage after stage (pack_stcn_stream). The stream's first stages, as many
// as fit (162 KB a CTA at the :26 width, 41 % of its stream), are copied into shared memory once a launch by
// bulk copy and stay there; the rest pass through a ring of three chunk slots, each stage's chunk copied
// (cp.async.bulk on an mbarrier) two stages before it is needed, so the ~30 MB streamed a frame stays in L2
// (the per-frame design read all 49 MB a frame). Stage-to-stage handoffs inside a frame are tagged words
// (decode_common.cuh): a finishing lane stores its unit's value with the stage's tag, and the next stage's
// CTAs spin on exactly the words they read, so the wait and the load of the inputs are one round trip and no
// grid barrier separates the stages. One grid barrier ends each frame (the head's x[f] and every buffer slot
// written in the frame are then visible to all). A gate product's old half ([old | h] with old from a buffer
// slot written at least one frame before) is copied in by the stage before it (cp.async) and summed before
// the CTA waits for h, so after the handoff only the K = C half is left. The head (30 + 30 units and the
// sampler) runs in CTA 0 on kernels kept in its shared memory. Sums run in the same order as the per-frame
// design (a lane's float4s in k order, then a shuffle tree), with no atomics: two runs give the same bits.
// The frame's code is kept small, since it runs straight through once a frame and the SM's instruction cache
// does not hold it: both stacks' blocks share one code path, and the sums are unrolled for at most 2 rows
// unless B > 2 (at 8 rows the first version ran 0.27 ms a frame, at 2 rows 0.21, on an H100).
//
// Why no input lands on a stale or overwritten word: every cross-CTA value a stage reads carries the tag
// of the stage that wrote it in this frame (f * n_stages + s + 1), and is overwritten only by a later stage
// whose CTAs waited, directly or through the stages between, on an output of every CTA that read it
// (each stage reads all of the previous stage's output, and with NB <= C every CTA owns an h unit of
// every [r | s] stage); the encoder and the decoder keep their h and act in separate words.

#include "decode_common.cuh"
#include "dmol_sample.cuh"
#include "mma_bf16.cuh"
#include "vrnn_common.cuh"

namespace blvm {
namespace stcn {

constexpr int NT = 256, NW = NT / 32;
constexpr int KMAX = 512;            // the widest product's depth: [old | h] at C = 256, the decode in_transform's Z
constexpr int KV = KMAX / 128;       // float4s a lane covers of one column (every depth K is a multiple of 4)
constexpr int MAX_B = 8;             // rows of the batch
constexpr int MAX_LAT = 8;           // latent levels
constexpr int MAX_ENC = 64;          // encoder blocks
constexpr int MAX_DEC = 16;          // decode blocks
constexpr int MAX_D = 3 * DMOL_MAX_M;  // the head's width
constexpr int MAX_STAGES = 2 + 2 * MAX_ENC + 3 * MAX_LAT + 2 * MAX_DEC;
constexpr int RING = 3;              // streamed chunk slots
constexpr int ISSUER = NT - 32;      // the thread that issues the bulk copies: lane 0 of the last warp, which owns
                                     // no unit while every product has at most 7 NB units (the wrapper checks)
constexpr int NBIAS = 8;             // bias pointers before the levels' three each

struct Params {
  const float* stream;  // (NB, stream_floats): CTA c's weight chunks, stage after stage
  const float* head;    // up_w (S, D), lik_w (D, D), up_b (D), lik_b (D), zero-padded to head_floats
  const float *causal_w, *causal_b;  // (2, C), (C)
  const float *enc_in_b, *enc_gate_b, *enc_rs_b;  // (C), (Le, 2, half), (Le, C + S)
  const float *dec_in_b, *dec_gate_b, *dec_rs_b;  // (C), (Ld, 2, half), (Ld, C + S)
  const float *b0[MAX_LAT], *b1[MAX_LAT], *b2[MAX_LAT];  // (2H), (2H), (2, z_l)
  int chunk_off[MAX_STAGES + 1];  // stage s's chunk: floats [chunk_off[s], chunk_off[s + 1]) of a CTA's stream
  int stream_floats, resident_floats, slot_floats, head_floats, n_stages;
  int dil[MAX_ENC], buf_off[MAX_ENC], level_of_block[MAX_ENC], block_of_level[MAX_LAT];
  int zsize[MAX_LAT], zoff[MAX_LAT];
  float* enc_buf;  // (B, sum d, C)
  float* dec_buf;  // (Ld, B, C)
  float* x;        // (B, x_cols): x[:, 0] the history's last frame, x[:, f + 1] frame f
  // tagged words: (B, C), (B, half), (B, C), (B, half), (L, B, S), (B, 2H) x 2, (B, Z), (B, S)
  unsigned long long *h_enc, *act_enc, *h_dec, *act_dec, *dcol, *hid_a, *hid_b, *z, *skip;
  const float* eps;  // (n_frames, B, Z)
  const int64_t* seed;
  const float *u_cat, *u_log;  // (n_frames, B, M), (n_frames, B), when seed is null
  float *z_out, *params_out;   // null, or (n_frames, B, Z) and (n_frames, B, D): each frame's z and DMoL parameters
  unsigned int* barrier;
  long long* trace;  // null, or seven sums CTA 0 adds to (see blvm_stcn_decode)
  int B, C, half, S, Le, Ld, L, Z, M, x_cols, n_frames, use_mode;
  float inv_std_n, sd_beta, sd_eps, log_eps;
  UniformMaps maps;
  decode::Watch watch;
};

__device__ __forceinline__ float leaky_relu(float v) { return v >= 0.0f ? v : __fmul_rn(0.01f, v); }

// A CTA's weights and its ring of streamed chunks. Every thread keeps the same copy of the counters; ISSUER
// issues the copies.
struct Weights {
  const Params* p;
  const float* src;  // this CTA's stream in global memory
  float *res, *ring;
  uint64_t* bars;    // RING slot barriers, then the resident copy's
  int s_res, n_str;  // the first streamed stage, streamed stages a frame
  // ring positions: the next to consume, all of the launch, the one the current stage reads, one to refill
  long long next_use, total, current, release;

  __device__ __forceinline__ void issue(long long pos) {
    const int slot = (int)(pos % RING), s = s_res + (int)(pos % n_str);
    const unsigned bytes = 4u * (unsigned)(p->chunk_off[s + 1] - p->chunk_off[s]);
    decode::mbar_expect(bars + slot, bytes);
    decode::bulk_load(ring + (size_t)slot * p->slot_floats, src + p->chunk_off[s], bytes, bars + slot);
  }
  // after a CTA-wide sync that follows a stage's products: the slot it read is free again
  __device__ __forceinline__ void refill() {
    if (release >= 0 && threadIdx.x == ISSUER && release + RING < total) issue(release + RING);
    release = -1;
  }
  // stage s's chunk: resident, or the ring's next slot once its copy has landed. A CTA that computes nothing in
  // the stage (`reads` false) hands the slot straight back.
  __device__ __forceinline__ bool get(int s, bool reads, const float*& w) {
    current = -1;
    if (s < s_res) {
      w = res + p->chunk_off[s];
      return true;
    }
    const long long pos = next_use++;
    const int slot = (int)(pos % RING);
    if (!decode::mbar_wait(bars + slot, (unsigned)((pos / RING) & 1), p->watch)) return false;
    w = ring + (size_t)slot * p->slot_floats;
    if (reads) {
      current = pos;  // released when the stage ends, refilled after the CTA's next sync
    } else {
      __syncthreads();
      refill();
      release = pos;
      refill();
    }
    return true;
  }
};

struct Cta {
  Weights wt;
  float* in_s;       // 2 regions of B rows of KMAX: a stage's input rows
  float* old_s;      // B rows of C: the next gate product's old rows, prefetched
  bool trace;        // CTA 0's thread 0 of a traced launch: sums adds up its phases
  long long sums[4];
};

// acc[m][b] += the lane's share of dot m of a unit (its columns w, [dot][K]) times row b of input region
// region[m] (rows `stride` apart, B rows a region), over the lane's k in [lo, hi): float4s in k order
template <int NDOT, int BM>
__device__ __forceinline__ void dots(float (&acc)[NDOT][BM], const float* w, const float* rows, int stride,
                                     const int (&region)[NDOT], int K, int B, int lo, int hi) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int m = 0; m < NDOT; ++m) {
    const float* in = rows + region[m] * B * stride;
    const float* wm = w + m * K;
#pragma unroll
    for (int i = 0; i < KV; ++i) {
      const int k = 4 * lane + 128 * i;
      if (k >= lo && k < hi) {
        const float4 wv = *reinterpret_cast<const float4*>(wm + k);
#pragma unroll
        for (int b = 0; b < BM; ++b) {
          if (b < B) {
            const float4 x = *reinterpret_cast<const float4*>(in + b * stride + k);
            acc[m][b] = fmaf(x.w, wv.w, fmaf(x.z, wv.z, fmaf(x.y, wv.y, fmaf(x.x, wv.x, acc[m][b]))));
          }
        }
      }
    }
  }
}

// The frame's tag of stage s
__device__ __forceinline__ uint32_t tag(const Params& p, int f, int s) {
  return (uint32_t)f * (uint32_t)p.n_stages + (uint32_t)s + 1u;
}

// One product of the frame (stage s): U units of NDOT columns of depth K each. Unit u lies with CTA u % NB,
// warp u / NB; its columns are the warp's slice of the stage's chunk ([warp][dot][K]). The warp loads its
// biases and pre(u) (a side input this launch does not write: the prior's noise, or the thread's own value
// of an earlier stage). Once every warp of the CTA is past the previous stage (a CTA barrier: its input rows
// and its weight slot are free), the CTA starts the copy of the next gate product's old rows (prefetch_next),
// sums its rows k < K0 (PREFETCHED: the old rows this stage's prefetch landed in old_s, visible after the CTA
// barrier; else staged by stage_old into the input rows), then stages rows K0 <= k < K with stage_in (tagged
// words of this frame: the wait), and the unit's sums plus biases go to finish(u, b, v[NDOT], pre) in the lane
// of row b. Dot m of unit u reads input region reg(m, u). False when a wait timed out.
template <int NDOT, bool PREFETCHED, int BM, class Reg, class Old, class In, class Pre, class Finish, class Next>
__device__ __forceinline__ bool stage(Cta& t, int s, int U, int K, int K0, const float* __restrict__ bias, Reg reg,
                                      Old stage_old, In stage_in, Pre pre, Finish finish, Next prefetch_next) {
  const Params& p = *t.wt.p;
  const int NB = gridDim.x, cta = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31, B = p.B;
  const int u = cta + NB * warp;
  const bool mine = u < U;
  const long long c0 = t.trace ? clock64() : 0;
  const float* w;
  if (!t.wt.get(s, cta < U, w)) return false;
  if (cta >= U) {
    if (PREFETCHED) cp_async_wait_all();  // the old rows' copy lands before the next prefetch reuses old_s
    return true;
  }
  float bv[NDOT];
#pragma unroll
  for (int m = 0; m < NDOT; ++m) bv[m] = mine ? __ldg(bias + (size_t)m * U + u) : 0.0f;
  const float pv = mine ? pre(u) : 0.0f;
  const long long c1 = t.trace ? clock64() : 0;
  if (PREFETCHED) cp_async_wait_all();
  __syncthreads();
  t.wt.refill();
  prefetch_next();
  float acc[NDOT][BM];
  int region[NDOT];
#pragma unroll
  for (int m = 0; m < NDOT; ++m) {
    region[m] = reg(m, u);
#pragma unroll
    for (int b = 0; b < BM; ++b) acc[m][b] = 0.0f;
  }
  const float* wu = w + (size_t)warp * NDOT * K;
  if (K0 > 0) {
    if (!PREFETCHED) {
      stage_old();
      __syncthreads();
    }
    if (mine) dots<NDOT, BM>(acc, wu, PREFETCHED ? t.old_s : t.in_s, PREFETCHED ? p.C : KMAX, region, K, B, 0, K0);
  }
  const long long c2 = t.trace ? clock64() : 0;
  if (K0 < K) {
    const bool ok = stage_in();
    if (__syncthreads_or(!ok)) return false;
  }
  const long long c3 = t.trace ? clock64() : 0;
  if (mine) dots<NDOT, BM>(acc, wu, t.in_s, KMAX, region, K, B, K0, K);
  float v[NDOT];
#pragma unroll
  for (int m = 0; m < NDOT; ++m) {
    v[m] = 0.0f;
#pragma unroll
    for (int b = 0; b < BM; ++b) {
      if (b < B) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[m][b] += __shfl_xor_sync(0xffffffffu, acc[m][b], off);
        if (lane == b) v[m] = __fadd_rn(acc[m][b], bv[m]);
      }
    }
  }
  const long long c4 = t.trace ? clock64() : 0;
  if (mine && lane < B) finish(u, lane, v, pv);
  t.wt.release = t.wt.current;
  if (t.trace) {  // CTA 0's thread 0 (its unit is 0, which every product has)
    t.sums[0] += c3 - c2;
    t.sums[1] += c1 - c0;
    t.sums[2] += (c2 - c1) + (c4 - c3);
    t.sums[3] += clock64() - c4;
  }
  return true;
}

// Tagged rows of this frame into input regions: n words, word i at src(i) with tag want(i) into in_s at dst(i)
template <class Src, class Want, class Dst>
__device__ __forceinline__ bool poll(const Cta& t, int n, Src src, Want want, Dst dst) {
  return decode::gather<4>(n, src, want, [&](int i, uint32_t v) { t.in_s[dst(i)] = __uint_as_float(v); },
                           t.wt.p->watch);
}

// BM: the rows the sums and the reductions are unrolled for (B <= BM): 2, the generation hook's batch, or MAX_B;
// a smaller unrolled body keeps the frame's code closer to the SM's instruction cache
template <int BM>
__global__ void __launch_bounds__(NT, 1) stcn_decode_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int B = p.B, C = p.C, half = p.half, S = p.S, H = p.C, Z = p.Z, D = 3 * p.M, Le = p.Le, L = p.L;
  const int tid = threadIdx.x, lane = tid & 31;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // RING + 1 barriers in the first 64 bytes
  Cta t;
  t.in_s = smem + 16;
  t.old_s = t.in_s + 2 * B * KMAX;
  float* head_s = t.old_s + B * KMAX / 2;  // the head's 2 x B rows of MAX_D
  float* head_w = head_s + 2 * B * MAX_D;  // CTA 0: up_w, lik_w, up_b, lik_b
  t.wt.p = &p;
  t.wt.src = p.stream + (size_t)blockIdx.x * p.stream_floats;
  t.wt.ring = head_w + p.head_floats;
  t.wt.res = t.wt.ring + RING * p.slot_floats;
  t.wt.bars = bars;
  t.wt.s_res = 0;
  while (t.wt.s_res < p.n_stages && p.chunk_off[t.wt.s_res + 1] <= p.resident_floats) ++t.wt.s_res;
  t.wt.n_str = p.n_stages - t.wt.s_res;
  t.wt.next_use = 0;
  t.wt.total = (long long)p.n_frames * t.wt.n_str;
  t.wt.current = t.wt.release = -1;
  t.trace = blockIdx.x == 0 && tid == 0 && p.trace;
  for (int i = 0; i < 4; ++i) t.sums[i] = 0;
  long long head_cycles = 0;
  const long long launch_cycles = t.trace ? clock64() : 0, launch_ns = t.trace ? decode::now_ns() : 0;
  const decode::Watch& watch = p.watch;
  if (tid == ISSUER) {  // the resident chunks (and CTA 0's head) once a launch; the ring's first chunks
    for (int i = 0; i <= RING; ++i) decode::mbar_init(bars + i, 1);
    const unsigned head_bytes = blockIdx.x == 0 ? 4u * p.head_floats : 0u;
    decode::mbar_expect(bars + RING, 4u * p.resident_floats + head_bytes);
    if (p.resident_floats) decode::bulk_load(t.wt.res, t.wt.src, 4u * p.resident_floats, bars + RING);
    if (head_bytes) decode::bulk_load(head_w, p.head, head_bytes, bars + RING);
    for (long long pos = 0; pos < RING && pos < t.wt.total; ++pos) t.wt.issue(pos);
  }
  __syncthreads();
  if (!decode::mbar_wait(bars + RING, 0, watch)) return;
  unsigned int target = 0;
  int sum_d = 0;
  for (int i = 0; i < Le; ++i) sum_d += p.dil[i];
  const float inv_std_block = 0.70710678118654752f;  // sqrt(0.5) in f32, as the f32 JAX step multiplies by it
  const int s_prior = 1 + 2 * Le, s_dec = s_prior + 3 * L;
  auto reg0 = [](int, int) { return 0; };
  auto zero_pre = [](int) { return 0.0f; };
  auto none = [] {};
  // the next gate product's old rows into old_s: row b at base + b stride
  auto prefetch_rows = [&](const float* base, int64_t stride) {
    for (int q = tid; q < B * C / 4; q += NT) {
      const int b = q / (C / 4), k = 4 * (q % (C / 4));
      cp_async16(t.old_s + b * C + k, base + b * stride + k, true);
    }
    cp_async_commit();
  };
  auto enc_slot = [&](int i, int f) { return p.enc_buf + (int64_t)(p.buf_off[i] + (f - 1) % p.dil[i]) * C; };
  float own = 0.0f;  // this thread's running value: h[b][u] of its warp's unit u < C, or the decoder's skip sum

  for (int f = 0; f < p.n_frames; ++f) {
    const float* unused;
    // 1. the causal tap and the encoder's in_transform; frame 0 takes the levels' columns from the prime
    if (f == 0) {
      for (int s = 0; s < s_prior; ++s)
        if (!t.wt.get(s, false, unused)) return;
    } else {
      const bool ok = stage<1, false, BM>(
          t, 0, C, C, C, p.enc_in_b, reg0,
          [&] {
            for (int i = tid; i < B * C; i += NT) {
              const int b = i / C, k = i % C;
              const float x2 = __ldcg(p.x + (int64_t)b * p.x_cols + f - 1), x1 = __ldcg(p.x + (int64_t)b * p.x_cols + f);
              t.in_s[b * KMAX + k] = __fadd_rn(__fadd_rn(__fmul_rn(x2, __ldg(p.causal_w + k)),
                                                         __fmul_rn(x1, __ldg(p.causal_w + C + k))),
                                               __ldg(p.causal_b + k));
            }
          },
          [] { return true; }, zero_pre,
          [&](int u, int b, const float* v, float) {
            own = v[0];
            decode::publish(p.h_enc + b * C + u, v[0], tag(p, f, 0));
          },
          [&] { prefetch_rows(enc_slot(0, f), (int64_t)sum_d * C); });
      if (!ok) return;
    }
    // 2-6. the encoder's blocks over their circular buffers (the used blocks' skips are the levels' columns), then
    // (k == Le) the prior and the decode in_transform, then the decode blocks with the skip sum in block order: one
    // code path for both stacks' blocks, so the frame's code stays small
    for (int k = f == 0 ? Le : 0; k < Le + p.Ld; ++k) {
      if (k == Le) {
        // 4. the prior, top-down: two 3-layer MLPs a level, z_l = mu + sd e_l
        for (int l = L - 1; l >= 0; --l) {
          const int s0 = s_prior + 3 * (L - 1 - l);
          const int zc = l + 1 < L ? p.zsize[l + 1] : 0, zc_off = l + 1 < L ? p.zoff[l + 1] : 0;
          const uint32_t d_tag = tag(p, f, 2 + 2 * p.block_of_level[l]), zc_tag = tag(p, f, s0 - 1);
          const int K0w = S + zc;
          bool ok = stage<1, false, BM>(
              t, s0, 2 * H, K0w, 0, p.b0[l], reg0, none,
              [&] {
                return poll(
                    t, B * K0w,
                    [&](int j) {
                      const int b = j / K0w, kk = j % K0w;
                      return kk < S ? p.dcol + ((int64_t)l * B + b) * S + kk : p.z + b * Z + zc_off + kk - S;
                    },
                    [&](int j) { return j % K0w < S ? d_tag : zc_tag; },
                    [&](int j) { return (j / K0w) * KMAX + j % K0w; });
              },
              zero_pre,
              [&](int u, int b, const float* v, float) {
                decode::publish(p.hid_a + b * 2 * H + u, leaky_relu(v[0]), tag(p, f, s0));
              },
              none);
          if (!ok) return;
          // mean units read hid[:, :H] (region 0), scale units hid[:, H:] (region 1)
          auto two_regions = [&](const unsigned long long* src, uint32_t want) {
            return poll(
                t, 2 * B * H, [&](int j) { return src + (j % (B * H)) / H * 2 * H + (j / (B * H)) * H + j % H; },
                [&](int) { return want; },
                [&](int j) { return ((j / (B * H)) * B + (j % (B * H)) / H) * KMAX + j % H; });
          };
          ok = stage<1, false, BM>(
              t, s0 + 1, 2 * H, H, 0, p.b1[l], [&](int, int u) { return u >= H ? 1 : 0; }, none,
              [&] { return two_regions(p.hid_a, tag(p, f, s0)); }, zero_pre,
              [&](int u, int b, const float* v, float) {
                decode::publish(p.hid_b + b * 2 * H + u, leaky_relu(v[0]), tag(p, f, s0 + 1));
              },
              none);
          if (!ok) return;
          const int zl = p.zsize[l], zo = p.zoff[l];
          ok = stage<2, false, BM>(
              t, s0 + 2, zl, H, 0, p.b2[l], [](int m, int) { return m; }, none,
              [&] { return two_regions(p.hid_b, tag(p, f, s0 + 1)); },
              [&](int u) { return lane < B ? __ldg(p.eps + ((int64_t)f * B + lane) * Z + zo + u) : 0.0f; },
              [&](int u, int b, const float* v, float e) {
                const float sd = vrnn::softplus_sd(v[1], p.sd_beta, p.sd_eps);
                const float zv = __fadd_rn(v[0], __fmul_rn(sd, e));
                decode::publish(p.z + b * Z + zo + u, zv, tag(p, f, s0 + 2));
                if (p.z_out) p.z_out[((int64_t)f * B + b) * Z + zo + u] = zv;
              },
              none);
          if (!ok) return;
        }
        // 5. the decode in_transform on all z (level l's columns tagged by its last prior stage)
        const bool ok = stage<1, false, BM>(
            t, s_dec, C, Z, 0, p.dec_in_b, reg0, none,
            [&] {
              return poll(
                  t, B * Z, [&](int j) { return p.z + j; },
                  [&](int j) {
                    int l = 0;
                    while (l + 1 < L && j % Z >= p.zoff[l + 1]) ++l;
                    return tag(p, f, s_prior + 3 * (L - 1 - l) + 2);
                  },
                  [&](int j) { return (j / Z) * KMAX + j % Z; });
            },
            zero_pre,
            [&](int u, int b, const float* v, float) {
              own = v[0];
              decode::publish(p.h_dec + b * C + u, v[0], tag(p, f, s_dec));
            },
            [&] { prefetch_rows(p.dec_buf, C); });
        if (!ok) return;
      }
      // a residual block of either stack: the gate product, then [r | s] with its buffer, residual and skip updates.
      // buf + b buf_stride is row b's slot: the block's input d frames back, read by the gate (prefetched by the
      // stage before) and replaced by the current one.
      const bool enc = k < Le;
      const int i = enc ? k : k - Le, sg = enc ? 1 + 2 * i : s_dec + 1 + 2 * i;
      const int level = enc ? p.level_of_block[i] : -1;
      unsigned long long* h = enc ? p.h_enc : p.h_dec;
      unsigned long long* act = enc ? p.act_enc : p.act_dec;
      float* buf = enc ? enc_slot(i, f) : p.dec_buf + (int64_t)i * B * C;
      const int64_t buf_stride = enc ? (int64_t)sum_d * C : C;
      const uint32_t h_tag = tag(p, f, enc && i == 0 ? 0 : sg - 1), a_tag = tag(p, f, sg), o_tag = tag(p, f, sg + 1);
      bool ok = stage<2, true, BM>(
          t, sg, half, 2 * C, C, (enc ? p.enc_gate_b : p.dec_gate_b) + (size_t)i * 2 * half, reg0, none,
          [&] {
            return poll(t, B * C, [&](int j) { return h + j; }, [&](int) { return h_tag; },
                        [&](int j) { return (j / C) * KMAX + C + j % C; });
          },
          zero_pre,
          [&](int u, int b, const float* v, float) {
            decode::publish(act + b * half + u, __fmul_rn(tanhf(v[0]), sigmoidf(v[1])), a_tag);
          },
          none);
      if (!ok) return;
      ok = stage<1, false, BM>(
          t, sg + 1, !enc || level >= 0 ? C + S : C, half, 0, (enc ? p.enc_rs_b : p.dec_rs_b) + (size_t)i * (C + S),
          reg0, none,
          [&] {
            return poll(t, B * half, [&](int j) { return act + j; }, [&](int) { return a_tag; },
                        [&](int j) { return (j / half) * KMAX + j % half; });
          },
          zero_pre,
          [&](int u, int b, const float* v, float) {
            if (u < C) {
              __stcg(buf + b * buf_stride + u, own);
              own = __fmul_rn(__fadd_rn(own, v[0]), inv_std_block);
              decode::publish(h + b * C + u, own, o_tag);
            } else if (enc) {
              decode::publish(p.dcol + ((int64_t)level * B + b) * S + u - C, v[0], o_tag);
            } else {
              own = i == 0 ? v[0] : __fadd_rn(own, v[0]);
              if (i + 1 == p.Ld) decode::publish(p.skip + b * S + u - C, own, o_tag);
            }
          },
          [&] {
            if (enc && i + 1 < Le) prefetch_rows(enc_slot(i + 1, f), (int64_t)sum_d * C);
            if (!enc && i + 1 < p.Ld) prefetch_rows(p.dec_buf + (int64_t)(i + 1) * B * C, C);
          });
      if (!ok) return;
    }

    // 7. the head and the sampler, in CTA 0; then the frame's barrier
    if (blockIdx.x == 0) {
      const long long c_head = t.trace ? clock64() : 0;
      const int warp = tid >> 5;
      const uint32_t s_tag = tag(p, f, p.n_stages - 1);
      __syncthreads();  // every warp is past the last stage's input rows
      t.wt.refill();
      const bool got = decode::gather<4>(
          B * S, [&](int i) { return p.skip + i; }, [&](int) { return s_tag; },
          [&](int i, uint32_t v) { t.in_s[(i / S) * KMAX + i % S] = __fmul_rn(__uint_as_float(v), p.inv_std_n); }, watch);
      if (__syncthreads_or(!got)) return;
      const float* up_w = head_w;
      const float* lik_w = head_w + S * D;
      const float* up_b = head_w + (S + D) * D;
      const float* lik_b = up_b + D;
      float* logits = head_s;              // [b][MAX_D]: relu(up)
      float* params = head_s + B * MAX_D;  // [b][MAX_D]: the DMoL parameters
      for (int unit = warp; unit < B * D; unit += NW) {
        const int b = unit / D, j = unit % D;
        float acc = 0.0f;
        for (int k = lane; k < S; k += 32) acc = fmaf(t.in_s[b * KMAX + k], up_w[k * D + j], acc);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) logits[b * MAX_D + j] = vrnn::relu(__fadd_rn(acc, up_b[j]));
      }
      __syncthreads();
      for (int i = tid; i < B * D; i += NT) {
        const int b = i / D, j = i % D;
        float acc = 0.0f;
        for (int k = 0; k < D; ++k) acc = fmaf(logits[b * MAX_D + k], lik_w[k * D + j], acc);
        float v = __fadd_rn(acc, lik_b[j]);
        if (j >= 2 * p.M) v = fmaxf(v, p.log_eps);
        params[b * MAX_D + j] = v;
        if (p.params_out) p.params_out[((int64_t)f * B + b) * D + j] = v;
      }
      __syncthreads();
      if (tid < B) {
        const int b = tid, M = p.M;
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
      if (t.trace) head_cycles += clock64() - c_head;
    }
    const long long c_bar = t.trace ? clock64() : 0;
    if (!decode::grid_barrier(p.barrier, target, watch)) return;
    if (t.trace) t.sums[0] += clock64() - c_bar;
  }
  if (t.trace) {
    const long long end = clock64();
    for (int i = 0; i < 4; ++i) p.trace[i] += t.sums[i];
    p.trace[4] += head_cycles;
    p.trace[5] += end - launch_cycles;
    p.trace[6] += decode::now_ns() - launch_ns;
  }
}

}  // namespace stcn
}  // namespace blvm

// A generation of n_frames frames (see the top of this file). biases: NBIAS + 3 L device pointers (causal_w,
// causal_b, enc_in_b, enc_gate_b, enc_rs_b, dec_in_b, dec_gate_b, dec_rs_b, then each level's b0, b1, b2);
// geometry: host ints, Le dilations, Le levels of the blocks (-1 for a block whose skip no level reads), L
// latent widths; layout: host ints, the n_stages + 1 chunk offsets of a CTA's stream, then stream_floats,
// resident_floats, slot_floats, head_floats (ops/generation.py:pack_stcn_stream); state: device pointers
// enc_buf, dec_buf, x, h_enc, act_enc, h_dec, act_dec, dcol (frame 0's columns tagged), hid_a, hid_b, z, skip
// (the tagged words zeroed) and the barrier (one zeroed uint32). NB CTAs, NB <= C and the SM count. trace:
// null, or seven int64 sums the launch adds to, as CTA 0's thread 0 sees them: SM cycles of the products'
// waits for their inputs and of the frames' barriers, of their waits for streamed weights, of their sums, of
// their finishes; the head's cycles; the launch's cycles and nanoseconds. status: one zeroed int32, set to 1
// if a wait outlasted limit_ns nanoseconds. Returns a cudaError_t:
// cudaErrorInvalidValue for what it does not take.
extern "C" int blvm_stcn_decode(const void* const* biases, const int* geometry, const int* layout, void* const* state,
                                const void* stream, const void* head, const void* eps, const void* seed,
                                const void* u_cat, const void* u_log, void* z_out, void* params_out, void* trace,
                                void* status, int B, int C, int half, int S, int Le, int Ld, int L, int M, int NB,
                                int n_frames, int use_mode, float inv_std_n, float sd_beta, float sd_eps,
                                float log_eps, float cat_low, float cat_scale, float logistic_low,
                                float logistic_scale, int64_t limit_ns, void* cuda_stream) {
  using namespace blvm::stcn;
  const int n_stages = 2 + 2 * Le + 3 * L + 2 * Ld;
  if (B < 1 || B > MAX_B || L < 1 || L > MAX_LAT || Le < 1 || Le > MAX_ENC || Ld < 1 || Ld > MAX_DEC || C < 1 ||
      2 * C > KMAX || half < 1 || half > KMAX || S < 1 || S > KMAX || M < 1 || M > blvm::DMOL_MAX_M || n_frames < 1 ||
      (long long)n_frames * n_stages >= 0xffffffffll || !eps || (!seed && (!u_cat || !u_log)) || !stream || !head ||
      !status || limit_ns <= 0 || NB < 1 || NB > C)
    return (int)cudaErrorInvalidValue;
  Params p;
  const float* const* bw = reinterpret_cast<const float* const*>(biases);
  const float** fixed[NBIAS] = {&p.causal_w, &p.causal_b, &p.enc_in_b, &p.enc_gate_b,
                                &p.enc_rs_b, &p.dec_in_b, &p.dec_gate_b, &p.dec_rs_b};
  for (int i = 0; i < NBIAS; ++i) *fixed[i] = bw[i];
  int Z = 0, off = 0;
  for (int l = 0; l < L; ++l) {
    p.b0[l] = bw[NBIAS + 3 * l];
    p.b1[l] = bw[NBIAS + 3 * l + 1];
    p.b2[l] = bw[NBIAS + 3 * l + 2];
    p.zsize[l] = geometry[2 * Le + l];
    p.zoff[l] = Z;
    p.block_of_level[l] = -1;
    Z += p.zsize[l];
    if (p.zsize[l] < 1 || p.zsize[l] % 4 || S + (l + 1 < L ? geometry[2 * Le + l + 1] : 0) > KMAX)
      return (int)cudaErrorInvalidValue;
  }
  // every product's depth a multiple of 4 (16-byte loads): C, half, S and each latent width; the units of every
  // product within the grid's warps
  if (Z > KMAX || C % 4 || half % 4 || S % 4 || half > NB * (NW - 1) || C + S > NB * (NW - 1) ||
      2 * C > NB * (NW - 1) || Z > NB * (NW - 1))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < Le; ++i) {
    p.dil[i] = geometry[i];
    p.level_of_block[i] = geometry[Le + i];
    p.buf_off[i] = off;
    off += p.dil[i];
    if (p.dil[i] < 1 || p.level_of_block[i] >= L) return (int)cudaErrorInvalidValue;
    if (p.level_of_block[i] >= 0) p.block_of_level[p.level_of_block[i]] = i;
  }
  for (int l = 0; l < L; ++l)
    if (p.block_of_level[l] < 0) return (int)cudaErrorInvalidValue;
  for (int s = 0; s <= n_stages; ++s) p.chunk_off[s] = layout[s];
  p.stream_floats = layout[n_stages + 1];
  p.resident_floats = layout[n_stages + 2];
  p.slot_floats = layout[n_stages + 3];
  p.head_floats = layout[n_stages + 4];
  p.n_stages = n_stages;
  int max_chunk = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int n = p.chunk_off[s + 1] - p.chunk_off[s];
    if (n < 4 || n % 4 || p.chunk_off[s] % 4) return (int)cudaErrorInvalidValue;
    if (p.chunk_off[s + 1] > p.resident_floats && n > max_chunk) max_chunk = n;
  }
  const int D = 3 * M;
  if (p.chunk_off[0] != 0 || p.chunk_off[n_stages] != p.stream_floats || p.resident_floats % 4 ||
      p.resident_floats > p.stream_floats || p.slot_floats < max_chunk || p.slot_floats % 4 || p.head_floats % 4 ||
      p.head_floats < S * D + D * D + 2 * D)
    return (int)cudaErrorInvalidValue;
  void* const* s = state;
  p.enc_buf = static_cast<float*>(s[0]);
  p.dec_buf = static_cast<float*>(s[1]);
  p.x = static_cast<float*>(s[2]);
  unsigned long long** words[9] = {&p.h_enc, &p.act_enc, &p.h_dec, &p.act_dec, &p.dcol,
                                   &p.hid_a, &p.hid_b,   &p.z,     &p.skip};
  for (int i = 0; i < 9; ++i) *words[i] = static_cast<unsigned long long*>(s[3 + i]);
  p.barrier = static_cast<unsigned int*>(s[12]);
  p.stream = static_cast<const float*>(stream);
  p.head = static_cast<const float*>(head);
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
  p.x_cols = n_frames + 1;
  p.n_frames = n_frames;
  p.use_mode = use_mode;
  p.inv_std_n = inv_std_n;
  p.sd_beta = sd_beta;
  p.sd_eps = sd_eps;
  p.log_eps = log_eps;
  p.maps = blvm::UniformMaps{cat_low, cat_scale, logistic_low, logistic_scale};
  p.watch = blvm::decode::Watch{static_cast<int*>(status), limit_ns};

  const size_t smem = 4 * (16 + 2 * (size_t)B * KMAX + (size_t)B * KMAX / 2 + 2 * (size_t)B * MAX_D + p.head_floats +
                           (size_t)RING * p.slot_floats + p.resident_floats);
  const void* kernel = B <= 2 ? (const void*)stcn_decode_kernel<2> : (const void*)stcn_decode_kernel<MAX_B>;
  cudaError_t err = blvm::decode::prepare_persistent(kernel, NT, smem, NB);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, dim3(NB), dim3(NT), args, smem, static_cast<cudaStream_t>(cuda_stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
