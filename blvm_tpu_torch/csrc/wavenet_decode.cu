// K4: one Fast-WaveNet decode step (one generated frame of every sequence), for Hopper (sm_90a).
//
// Replaces the TPU path blvm_tpu/models/wavenet/wavenet.py WaveNet._generate_fast (:279-380),
// whose per-frame `step` (:350-375) XLA ran as a scan over the residual blocks. For one frame of
// sequence b (one thread block each), with x the generated waveform so far:
//
//   c     = x[t-2] Wc0 + x[t-1] Wc1 + bc                          causal k=2 tap, f32
//   h     = cast(c) Win + bin                                     in_transform, stack dtype
//   for each block l (dilation d, circular buffer of d frames, slot (t - 1) mod d):
//     old = buf[slot]; buf[slot] = h                              x[t-d] out, this frame's input in
//     gate = old [Wt0|Ws0] + h [Wt1|Ws1] + [bt|bs]
//     act  = tanh(gate_t) sigmoid(gate_s)
//     [r|s] = act Wrs + brs;  h = (h + r) sqrt(1/2);  acc += f32(s)
//   p     = relu(relu(acc variance_scale) Wout + bout) Whead + bhead   (f32; log-scales >= -7)
//   x[t]  = DMoL sample of p (dmol_sample.cuh: the Philox stream of K3 at step t, or given uniforms)
//
// Rounding follows the JAX step op for op: in bf16 every product, sum and activation is rounded to
// bf16 where XLA rounds it (each dot accumulates in f32 and rounds once); the causal tap, the skip
// sum and the head stay f32. Buffer slot (t - 1) mod d holds x[t-d] because the priming forward
// seeds each block's buffer with the last d frames of its input (ResidualStack collect_tails), and
// step t = 1 (the first frame after the primed frame 0) reads slot 0, the oldest of them.
//
// What bounds it on an H100: at the flagship width a frame runs 103 dependent GEMVs of width 30 to
// 192 (~5.6 MFLOP a sequence) over 5.53 MB of block weights in bf16 (11.06 MB in f32), which fit
// the 50 MB L2 but not an SM's shared memory. The compulsory traffic is the weights once a frame:
// ~1.65 us a frame in bf16 at 3.35 TB/s. The chain of 50 blocks, each two GEMVs deep, makes a
// frame's time one of latency and handoffs.
//
// Two routes, chosen by dtype and width:
//
// The resident route (bf16 at C = half = S = 96, blvm_wavenet_decode_resident): one launch a generation,
// frames 1 .. n-1, on clusters of 8 CTAs, all resident at once (checked before the launch): one CTA a
// residual block and one more (the "io" CTA) for the causal tap, the in_transform, the f32 head and the
// sampler. Each CTA stages its weights into shared memory once a launch by bulk copy (a block's gate taps
// and [r | s] kernel, 110.6 KB, laid out by the wrapper in mma.sync fragment order: a lane's A fragment of a
// 16 x 16 tile is one 16-byte load). A frame flows io -> block 0 -> ... -> block L-1 -> io. Inside a
// cluster a hop is asynchronous stores (st.async) of h (bf16 pairs) and the f32 skip sum straight into the
// next CTA's shared memory, which complete the bytes its mbarrier expects; between clusters (and io ->
// block 0) a mailbox of tagged words in global memory (decode_common.cuh, tagged with the frame). Every
// wait is bounded. (Tagged words for every hop measured 108.9 us a frame on an H100, plain DSMEM stores
// with one release arrival 107.7, st.async 93.0.) A block's products run on the tensor cores (m16n8k16, the B <= 8
// sequences as the n = 8 operand), one m-tile a warp, 12 warps: a tile's rows 0-7 are units j of the
// first kind (tanh, or r) and rows 8-15 the same units of the second (sigmoid, or s), so the thread
// that holds a unit's tanh sum also holds its sigmoid sum and the activation needs no exchange. The old
// tap (slot (t - 1) mod d, written d frames before) is multiplied before the frame's h arrives, so
// after the handoff only the h tap and [r | s] remain. Each product accumulates in f32 and is rounded
// to bf16 once, where the per-frame kernel rounds; every rounding after it is JAX's. The buffers stay
// in global memory (L2): a block loads its next slot right after it sends a frame on, ~50 handoffs
// before it needs it, so no dilation's slot is on the critical path.
//
// The per-frame route (f32, and bf16 at other widths, blvm_wavenet_decode): one launch a frame, one
// 512-thread block a sequence, weights read from global memory (L2-resident after the first frame) in
// 16-byte loads, each GEMV split over column groups and slices of its input with the partial sums
// reduced in shared memory: 260 us a frame at the flagship width on an H100, f32 no slower than bf16.

#include <cooperative_groups.h>

#include "common.cuh"
#include "decode_common.cuh"
#include "dmol_sample.cuh"
#include "mma_bf16.cuh"

namespace blvm {
namespace {

constexpr int THREADS = 512;
constexpr int MAX_WIDTH = 256;  // C, half, S
constexpr int MAX_COLS = 512;   // padded columns of one GEMV: 2 half, R + S, 3M
constexpr float INV_SQRT2 = 0.70710678118654752f;

__host__ __device__ constexpr int pad8(int n) { return (n + 7) / 8 * 8; }

struct DecodeArgs {
  const void *w_gate, *b_gate, *w_rs, *b_rs, *w_in, *b_in;  // stack dtype
  const float *w_causal, *b_causal, *w_out, *b_out, *w_head, *b_head;
  const int *dilations, *offsets;
  void* buffers;  // (B, D, C) stack dtype: block l's buffer is rows [offsets[l], offsets[l] + dilations[l])
  float* x;       // (B, x_cols): column 0 the history's last frame, column f + 1 frame f's sample
  const int64_t* seed;
  const float *u_cat, *u_log;  // (n_frames, B, M), (n_frames, B), when seed is null
  int B, L, C, half, S, M, D, x_cols, frame;
  float variance_scale, log_eps;
  UniformMaps maps;
};

template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32(from_f32<T>(v)); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float (&w)[4]) {
    w[0] = __uint_as_float(r.x), w[1] = __uint_as_float(r.y), w[2] = __uint_as_float(r.z), w[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float (&w)[8]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) w[2 * i] = __uint_as_float(u[i] << 16), w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
};

// y[m N + j] = sum_k x[m K + k] W[m][k][j] for m < nmat, j < N: nmat matrices K x N, row-major, contiguous,
// N a multiple of 8, x and y in shared memory. Thread (g, s) sums the 16-byte column group g over the s-th
// contiguous slice of k into partial; then one thread a column adds its slices in order.
template <typename T>
__device__ void gemv(const T* __restrict__ W, const float* x, int K, int N, int nmat, float* partial, float* y) {
  constexpr int VEC = Vec<T>::N;
  const int groups = N / VEC;
  const int per = max(1, min(K, THREADS / (groups * nmat)));  // slices of k per matrix
  const int kc = (K + per - 1) / per;
  const int g = threadIdx.x % groups, s = threadIdx.x / groups;
  if (s < nmat * per) {
    const int m = s / per, k0 = (s - m * per) * kc, k1 = min(K, k0 + kc);
    const T* Wm = W + (size_t)m * K * N + g * VEC;
    const float* xm = x + m * K;
    float a[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) a[v] = 0.f;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      float w[VEC];
      Vec<T>::unpack(*reinterpret_cast<const uint4*>(Wm + (size_t)k * N), w);
      const float xk = xm[k];
#pragma unroll
      for (int v = 0; v < VEC; ++v) a[v] = fmaf(xk, w[v], a[v]);
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) partial[s * N + g * VEC + v] = a[v];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nmat * N; j += THREADS) {
    const int m = j / N, col = j - m * N;
    float sum = 0.f;
    for (int sl = 0; sl < per; ++sl) sum += partial[(m * per + sl) * N + col];
    y[j] = sum;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wavenet_decode_kernel(const DecodeArgs a) {
  __shared__ float xin[2 * MAX_WIDTH];  // a block's [x[t-d] | h]; the head's inputs
  __shared__ float h[MAX_WIDTH];
  __shared__ float acc[MAX_WIDTH];
  __shared__ float act[MAX_WIDTH];
  __shared__ float y[2 * MAX_COLS];
  __shared__ float head[MAX_COLS];
  __shared__ float partial[THREADS * 8];

  const int b = blockIdx.x, t = threadIdx.x;
  const int C = a.C, H = a.half, S = a.S, M = a.M;
  const int Ng = pad8(2 * H), Nrs = pad8(C + S), Nc = pad8(C), Nh = pad8(3 * M);
  const T* w_gate = static_cast<const T*>(a.w_gate);
  const T* b_gate = static_cast<const T*>(a.b_gate);
  const T* w_rs = static_cast<const T*>(a.w_rs);
  const T* b_rs = static_cast<const T*>(a.b_rs);
  const T* b_in = static_cast<const T*>(a.b_in);
  float* xb = a.x + (size_t)b * a.x_cols;
  const float inv_std = rnd<T>(INV_SQRT2);  // JAX multiplies by sqrt(1/2) in the stack dtype

  // causal k=2 tap on the two previous frames (f32), cast to the stack dtype, in_transform
  const float prev2 = xb[a.frame - 1], prev1 = xb[a.frame];
  for (int j = t; j < C; j += THREADS)
    xin[j] = rnd<T>(__fadd_rn(__fadd_rn(__fmul_rn(prev2, a.w_causal[j]), __fmul_rn(prev1, a.w_causal[C + j])),
                              a.b_causal[j]));
  __syncthreads();
  gemv<T>(static_cast<const T*>(a.w_in), xin, C, Nc, 1, partial, y);
  for (int j = t; j < C; j += THREADS) h[j] = rnd<T>(__fadd_rn(rnd<T>(y[j]), to_f32(b_in[j])));
  for (int j = t; j < S; j += THREADS) acc[j] = 0.f;
  __syncthreads();

  for (int l = 0; l < a.L; ++l) {
    T* slot = static_cast<T*>(a.buffers) + ((size_t)b * a.D + a.offsets[l] + (a.frame - 1) % a.dilations[l]) * C;
    for (int j = t; j < C; j += THREADS) {
      xin[j] = to_f32(slot[j]);
      xin[C + j] = h[j];
      slot[j] = from_f32<T>(h[j]);
    }
    __syncthreads();
    gemv<T>(w_gate + (size_t)l * 2 * C * Ng, xin, C, Ng, 2, partial, y);  // y[:Ng] old tap, y[Ng:] this frame's
    const T* bg = b_gate + (size_t)l * Ng;
    for (int j = t; j < H; j += THREADS) {
      const float gt = rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(rnd<T>(y[j]), rnd<T>(y[Ng + j]))), to_f32(bg[j])));
      const float gs =
          rnd<T>(__fadd_rn(rnd<T>(__fadd_rn(rnd<T>(y[H + j]), rnd<T>(y[Ng + H + j]))), to_f32(bg[H + j])));
      act[j] = rnd<T>(__fmul_rn(rnd<T>(tanhf(gt)), rnd<T>(sigmoidf(gs))));
    }
    __syncthreads();
    gemv<T>(w_rs + (size_t)l * H * Nrs, act, H, Nrs, 1, partial, y);
    const T* br = b_rs + (size_t)l * Nrs;
    for (int j = t; j < C; j += THREADS) {
      const float r = rnd<T>(__fadd_rn(rnd<T>(y[j]), to_f32(br[j])));
      h[j] = rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(h[j], r)), inv_std));
    }
    for (int j = t; j < S; j += THREADS) acc[j] = __fadd_rn(acc[j], rnd<T>(__fadd_rn(rnd<T>(y[C + j]), to_f32(br[C + j]))));
    __syncthreads();
  }

  // the head in f32: relu -> Dense -> relu on acc * variance_scale, the DMoL Dense, the log-scale clamp
  for (int j = t; j < S; j += THREADS) xin[j] = fmaxf(__fmul_rn(acc[j], a.variance_scale), 0.f);
  __syncthreads();
  gemv<float>(a.w_out, xin, S, Nc, 1, partial, y);
  for (int j = t; j < C; j += THREADS) act[j] = fmaxf(__fadd_rn(y[j], a.b_out[j]), 0.f);
  __syncthreads();
  gemv<float>(a.w_head, act, C, Nh, 1, partial, y);
  for (int j = t; j < 3 * M; j += THREADS) {
    const float v = __fadd_rn(y[j], a.b_head[j]);
    head[j] = j >= 2 * M ? fmaxf(v, a.log_eps) : v;
  }
  __syncthreads();

  if (t == 0) {
    float U[DMOL_MAX_M + 1], u_logistic, mode;
    if (a.seed != nullptr) {
      philox_uniforms(a.seed, a.frame, b, M, U);
      u_logistic = U[M];
    } else {
      const size_t row = (size_t)a.frame * a.B + b;
#pragma unroll
      for (int m = 0; m < DMOL_MAX_M; ++m)
        if (m < M) U[m] = a.u_cat[row * M + m];
      u_logistic = a.u_log[row];
    }
    xb[a.frame + 1] = dmol_sample_frame(head, head + M, head + 2 * M, M, U, u_logistic, a.maps, &mode);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace blvm

// Frame `frame` (>= 1) of every sequence: reads x[:, frame - 1] and x[:, frame], the buffers and the
// weights; writes the buffers' slots and x[:, frame + 1]. Weight matrices are row-major with their
// columns zero-padded to a multiple of 8: w_gate (L, 2, C, pad8(2 half)) [tap 0 | tap 1] of
// [tanh | sigmoid] columns, b_gate (L, pad8(2 half)), w_rs (L, half, pad8(C + S)), b_rs (L, pad8(C + S)),
// w_in (C, pad8(C)), b_in (C,) in the stack dtype (0 = float32, 1 = bfloat16); w_causal (2, C),
// b_causal (C,), w_out (S, pad8(C)), b_out (C,), w_head (C, pad8(3M)), b_head (3M,) in float32.
// seed: a device int64[2] Philox key (K3's stream at step `frame`, row b), or null with u_cat and
// u_log supplied.
extern "C" int blvm_wavenet_decode(const void* w_gate, const void* b_gate, const void* w_rs, const void* b_rs,
                                   const void* w_in, const void* b_in, const void* w_causal, const void* b_causal,
                                   const void* w_out, const void* b_out, const void* w_head, const void* b_head,
                                   const void* dilations, const void* offsets, void* buffers, void* x,
                                   const void* seed, const void* u_cat, const void* u_log, int B, int L, int C,
                                   int half, int S, int M, int D, int x_cols, int frame, float variance_scale,
                                   float log_eps, float cat_low, float cat_scale, float logistic_low,
                                   float logistic_scale, int dtype, void* stream) {
  using namespace blvm;
  const bool widths_ok = B >= 1 && B <= 65535 && L >= 1 && C >= 1 && C <= MAX_WIDTH && half >= 1 &&
                         half <= MAX_WIDTH && S >= 1 && S <= MAX_WIDTH && pad8(C + S) <= MAX_COLS && M >= 1 &&
                         M <= DMOL_MAX_M;
  const bool frame_ok = frame >= 1 && frame + 1 < x_cols && D >= 1;
  const bool random_ok = seed != nullptr || (u_cat != nullptr && u_log != nullptr);
  const void* vec_loaded[] = {w_gate, w_rs, w_in, w_out, w_head};
  bool align_ok = true;
  for (const void* p : vec_loaded) align_ok = align_ok && aligned16(p);
  if (!widths_ok || !frame_ok || !random_ok || !align_ok || (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{w_gate, b_gate, w_rs, b_rs, w_in, b_in,
               static_cast<const float*>(w_causal), static_cast<const float*>(b_causal),
               static_cast<const float*>(w_out), static_cast<const float*>(b_out),
               static_cast<const float*>(w_head), static_cast<const float*>(b_head),
               static_cast<const int*>(dilations), static_cast<const int*>(offsets), buffers,
               static_cast<float*>(x), static_cast<const int64_t*>(seed), static_cast<const float*>(u_cat),
               static_cast<const float*>(u_log), B, L, C, half, S, M, D, x_cols, frame, variance_scale, log_eps,
               UniformMaps{cat_low, cat_scale, logistic_low, logistic_scale}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    wavenet_decode_kernel<__nv_bfloat16><<<B, THREADS, 0, s>>>(a);
  else
    wavenet_decode_kernel<float><<<B, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------------
// The resident route (see the top of this file).

namespace blvm {
namespace k4res {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
constexpr int NC = 8;             // CTAs of a cluster (the portable maximum)
constexpr int C = 96;             // C = half = S
constexpr int NT = 384;           // 12 warps: one m-tile of each 192-row product a warp
constexpr int MT = 12;            // m-tiles of a 192-row product: units 8 mt .. 8 mt + 7 of both kinds
constexpr int KT = C / 16;        // k-steps
constexpr int MAT_U4 = MT * KT * 32;  // uint4s of one packed 192 x 96 matrix (a lane's A fragment each)
constexpr int IN_MT = C / 16;     // the in_transform's m-tiles (96 rows)
constexpr int IN_U4 = IN_MT * KT * 32;
constexpr int MAX_B = 8;          // the mma's n
constexpr int VP = 104;           // row pitch (bf16) of a vector block in shared memory: conflict-free B loads
constexpr int HP = MAX_B / 2;     // h pairs a unit
constexpr int BOX = C * HP + MAX_B * C;  // words of a mailbox: h pairs [j][p], then the skip sum [n][j]
constexpr int HW = 96;            // padded head width (3 M <= 96)

struct Args {
  const uint4* w_blocks;          // (L, 3, MT, KT, 32): gate tap 0, gate tap 1, [r | s]
  const bf16* b_blocks;           // (L, 4, C): b_t, b_s, b_r, b_s of [r | s]
  const uint4* w_in;              // (IN_MT, KT, 32)
  const bf16* b_in;               // (C)
  const float *w_causal, *b_causal;  // (2, C), (C)
  const float *w_out, *b_out;     // (C, C) [k][j], (C)
  const float *w_head, *b_head;   // (C, HW) [k][m], (3M)
  const int *dilations, *offsets;
  bf16* buffers;                  // (B, D, C): block l's rows [offsets[l], offsets[l] + dilations[l])
  unsigned long long* boxes;      // (L + 1, BOX): box l feeds block l, box L the io CTA
  float* x;                       // (B, x_cols)
  const int64_t* seed;
  const float *u_cat, *u_log;
  int B, L, M, D, x_cols, n_frames;
  float variance_scale, log_eps;
  UniformMaps maps;
  decode::Watch watch;
  long long* trace;  // null, or (CTAs, 4) SM cycles by phase (see blvm_wavenet_decode_resident)
};

// Thread 0's clock by phase: add(i) adds the cycles since the last mark to phase i
struct Phases {
  bool on;
  long long last, sum[4];
  __device__ __forceinline__ void start(bool on_) {
    on = on_;
    last = on ? clock64() : 0;
    for (int i = 0; i < 4; ++i) sum[i] = 0;
  }
  __device__ __forceinline__ void add(int i) {
    if (!on) return;
    const long long now = clock64();
    sum[i] += now - last;
    last = now;
  }
  __device__ __forceinline__ void store(long long* out) const {
    if (!on) return;
    for (int i = 0; i < 4; ++i) out[4 * blockIdx.x + i] = sum[i];
  }
};

__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// c += A(tile row mt of the packed matrix W) x B(the vectors v, [n][k] with row pitch VP), over all k
__device__ __forceinline__ void product(float (&c)[4], const uint4* W, int mt, const bf16* v, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const uint4 a = W[(mt * KT + kt) * 32 + lane];
    const bf16* col = v + g * VP + kt * 16 + 2 * tig;
    mma_bf16(c, a.x, a.y, a.z, a.w, ld32(col), ld32(col + 8));
  }
}

// B rows of C bf16 (row pitch `pitch` elements) as uint4s: dst <- src
__device__ __forceinline__ void copy_rows(bf16* dst, int dst_pitch, const bf16* src, int src_pitch, int B) {
  for (int i = threadIdx.x; i < B * (C / 8); i += NT) {
    const int n = i / (C / 8), q = i % (C / 8);
    *reinterpret_cast<uint4*>(dst + (size_t)n * dst_pitch + 8 * q) =
        *reinterpret_cast<const uint4*>(src + (size_t)n * src_pitch + 8 * q);
  }
}

// What every CTA's shared memory starts with, at the same offsets in each (so a producer can name its
// consumer's copy): the inbox's barrier, the frame's h ([n][k], row pitch VP) and the skip sum ([j][n], MAX_B
// sequences a unit).
struct Inbox {
  uint64_t* bar;
  bf16* hs;
  float* accs;
};
constexpr size_t INBOX_BYTES = 16 + MAX_B * VP * 2 + MAX_B * C * 4;

// the bytes a producer in the same cluster stores into an inbox a frame: h's rows n < B (unless the consumer is the
// io CTA) and the skip sum, a pair of sequences a store
__device__ __forceinline__ unsigned inbox_bytes(int B, bool h) { return (h ? B * C * 2 : 0) + (B + 1) / 2 * C * 8; }

__device__ __forceinline__ Inbox inbox(char* smem) {
  return Inbox{reinterpret_cast<uint64_t*>(smem), reinterpret_cast<bf16*>(smem + 16),
               reinterpret_cast<float*>(smem + 16 + MAX_B * VP * 2)};
}

// Every thread: frame f's h (with `h`) and skip sum (with `acc`) from the previous CTA of the chain, into the
// inbox: from the previous CTA's asynchronous stores (`local`: the same cluster; they complete the inbox
// barrier's phase f - 1, which thread 0 then arms for the next frame's bytes) or from the tagged words of the
// global mailbox `box`. False on a timeout.
__device__ __forceinline__ bool receive(const Args& a, const Inbox& in, bool local, const unsigned long long* box,
                                        int f, bool h, bool acc) {
  if (local) {
    const bool ok = decode::mbar_wait_cluster(in.bar, (unsigned)((f - 1) & 1), a.watch);
    if (ok && threadIdx.x == 0 && f + 1 < a.n_frames) decode::mbar_expect(in.bar, inbox_bytes(a.B, h));
    return !__syncthreads_or(!ok);
  }
  const int B = a.B, np = (B + 1) / 2, n_h = h ? C * np : 0, n_acc = acc ? C * B : 0;
  const bool ok = decode::gather<3>(
      n_h + n_acc, [&](int i) { return i < n_h ? box + (i / np) * HP + i % np : box + C * HP + (i - n_h); },
      [&](int) { return (uint32_t)f; },
      [&](int i, uint32_t v) {
        if (i < n_h) {
          const int u = i / np, q = i % np;
          in.hs[(2 * q) * VP + u] = __ushort_as_bfloat16((unsigned short)(v & 0xffffu));
          if (2 * q + 1 < B) in.hs[(2 * q + 1) * VP + u] = __ushort_as_bfloat16((unsigned short)(v >> 16));
        } else {
          in.accs[(i - n_h) % C * MAX_B + (i - n_h) / C] = __uint_as_float(v);
        }
      },
      a.watch);
  return !__syncthreads_or(!ok);
}

// Every thread: its values of frame f for the next CTA of the chain, unit j of sequences n0 and n0 + 1: h (with
// `h`) and the skip sum. `local` (the next CTA is in this cluster): asynchronous stores straight into its inbox,
// each completing its barrier's bytes (h as bf16 pairs along j: lanes 4 apart swap one value, so the thread of
// an even unit stores sequence n0's pair and its neighbour sequence n0 + 1's); otherwise tagged words in the
// mailbox `box`.
__device__ __forceinline__ void send(const Args& a, const Inbox& in, bool local, unsigned long long* box, int f,
                                     int j, int n0, const float (&hn)[2], const float (&acc)[2], bool h) {
  const int B = a.B;
  if (local) {
    const unsigned next = cg::this_cluster().block_rank() + 1;
    const uint32_t bar = decode::remote(in.bar, next);
    const float other = __shfl_xor_sync(0xffffffffu, j & 1 ? hn[0] : hn[1], 4);
    if (h) {
      if (!(j & 1) && n0 < B) decode::st_async(decode::remote(in.hs + n0 * VP + j, next), pack(hn[0], other), bar);
      if ((j & 1) && n0 + 1 < B)
        decode::st_async(decode::remote(in.hs + (n0 + 1) * VP + j - 1, next), pack(other, hn[1]), bar);
    }
    if (n0 < B) decode::st_async(decode::remote(in.accs + j * MAX_B + n0, next), acc[0], acc[1], bar);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (n0 + e < B) decode::publish(box + C * HP + (n0 + e) * C + j, acc[e], (uint32_t)f);
  if (h && n0 < B) decode::publish(box + j * HP + n0 / 2, pack(hn[0], n0 + 1 < B ? hn[1] : 0.0f), (uint32_t)f);
}

// Block l: its weights staged once; each frame, the old tap before the frame's h arrives, then the h tap, the
// gate, [r | s], and the h and skip sum sent on. False on a timeout.
__device__ bool run_block(const Args& a, char* smem, int l) {
  const Inbox in = inbox(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + INBOX_BYTES);
  uint4* W = reinterpret_cast<uint4*>(smem + INBOX_BYTES + 16);  // 3 packed matrices
  bf16* os = reinterpret_cast<bf16*>(W + 3 * MAT_U4);             // the old tap's rows
  bf16* as = os + MAX_B * VP;                                     // the activation
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int B = a.B, j = 8 * warp + g, n0 = 2 * tig;  // this thread's unit and its two sequences
  if (tid == 0) {
    decode::mbar_init(bar, 1);
    decode::mbar_expect(bar, 3 * MAT_U4 * 16);
    decode::bulk_load(W, a.w_blocks + (size_t)l * 3 * MAT_U4, 3 * MAT_U4 * 16, bar);
  }
  for (int i = tid; i < 2 * MAX_B * VP; i += NT) os[i] = __float2bfloat16_rn(0.0f);  // rows >= B stay zero
  const bf16* bb = a.b_blocks + (size_t)l * 4 * C;
  const float b_t = __bfloat162float(bb[j]), b_s = __bfloat162float(bb[C + j]);
  const float b_r = __bfloat162float(bb[2 * C + j]), b_k = __bfloat162float(bb[3 * C + j]);
  const float inv_std = rnd(0.70710678118654752f);  // JAX multiplies by sqrt(1/2) in the stack dtype
  const int d = a.dilations[l];
  bf16* buf = a.buffers + (size_t)a.offsets[l] * C;  // row n: buf + (n D + slot) C
  const bool local_in = l % NC != 0, local_out = (l + 1) % NC != 0;
  __syncthreads();
  if (!decode::mbar_wait(bar, 0, a.watch)) return false;
  Phases phases;
  phases.start(a.trace && tid == 0);

  for (int f = 1; f < a.n_frames; ++f) {
    const int slot = (f - 1) % d;
    // the old tap: slot (f - 1) mod d holds the block's input d frames back
    copy_rows(os, VP, buf + (size_t)slot * C, a.D * C, B);
    __syncthreads();
    float co[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    product(co, W, warp, os, lane);
    phases.add(0);
    // this frame's h (and, after block 0, the skip sum) from the previous CTA
    if (!receive(a, in, local_in, a.boxes + (size_t)l * BOX, f, true, l > 0)) return false;
    phases.add(1);
    // the h tap, the gate, the activation
    float ch[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    product(ch, W + MAT_U4, warp, in.hs, lane);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float gt = rnd(__fadd_rn(rnd(__fadd_rn(rnd(co[e]), rnd(ch[e]))), b_t));
      const float gs = rnd(__fadd_rn(rnd(__fadd_rn(rnd(co[2 + e]), rnd(ch[2 + e]))), b_s));
      as[(n0 + e) * VP + j] = __float2bfloat16_rn(__fmul_rn(rnd(tanhf(gt)), rnd(sigmoidf(gs))));
    }
    copy_rows(buf + (size_t)slot * C, a.D * C, in.hs, VP, B);  // read back as the old tap d frames on
    __syncthreads();
    phases.add(2);
    // [r | s]: the residual and the skip
    float cr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    product(cr, W + 2 * MAT_U4, warp, as, lane);
    float hn[2], acc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + e;
      const float r = rnd(__fadd_rn(rnd(cr[e]), b_r));
      const float sk = rnd(__fadd_rn(rnd(cr[2 + e]), b_k));
      hn[e] = rnd(__fmul_rn(rnd(__fadd_rn(__bfloat162float(in.hs[n * VP + j]), r)), inv_std));
      acc[e] = __fadd_rn(l > 0 && n < B ? in.accs[j * MAX_B + n] : 0.0f, sk);
    }
    send(a, in, local_out, a.boxes + (size_t)(l + 1) * BOX, f, j, n0, hn, acc, l + 1 < a.L);
    phases.add(3);
  }
  phases.store(a.trace);
  return true;
}

// The io CTA: each frame the causal tap and the in_transform, sent to block 0, then the skip sum of the last
// block, the head and the sampler. False on a timeout.
__device__ bool run_io(const Args& a, char* smem) {
  const Inbox in = inbox(smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + INBOX_BYTES);
  uint4* Win = reinterpret_cast<uint4*>(smem + INBOX_BYTES + 16);
  float* Wout = reinterpret_cast<float*>(Win + IN_U4);  // [k][j]
  float* Whead = Wout + C * C;                          // [k][m], HW columns
  float* part = Whead + C * HW;                         // [4][n][HW]
  float* hid = part + 4 * MAX_B * HW;                   // [n][j]
  float* par = hid + MAX_B * C;                         // [n][HW]
  float* xs = par + MAX_B * HW;                         // [n][2]: x[f - 1], x[f]
  bf16* cs = reinterpret_cast<bf16*>(xs + 2 * MAX_B);   // the causal tap, [n][k]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int B = a.B, M = a.M, D3 = 3 * M, L = a.L;
  if (tid == 0) {
    decode::mbar_init(bar, 1);
    decode::mbar_expect(bar, IN_U4 * 16 + (C * C + C * HW) * 4);
    decode::bulk_load(Win, a.w_in, IN_U4 * 16, bar);
    decode::bulk_load(Wout, a.w_out, C * C * 4, bar);
    decode::bulk_load(Whead, a.w_head, C * HW * 4, bar);
  }
  for (int i = tid; i < MAX_B * VP; i += NT) cs[i] = __float2bfloat16_rn(0.0f);
  if (tid < B) {
    xs[2 * tid] = a.x[(size_t)tid * a.x_cols];
    xs[2 * tid + 1] = a.x[(size_t)tid * a.x_cols + 1];
  }
  __syncthreads();
  if (!decode::mbar_wait(bar, 0, a.watch)) return false;
  Phases phases;
  phases.start(a.trace && tid == 0);

  for (int f = 1; f < a.n_frames; ++f) {
    // the causal k = 2 tap on the two previous frames (f32), cast to bf16, and the in_transform, to block 0
    for (int i = tid; i < B * C; i += NT) {
      const int n = i / C, k = i % C;
      cs[n * VP + k] = __float2bfloat16_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(xs[2 * n], a.w_causal[k]), __fmul_rn(xs[2 * n + 1], a.w_causal[C + k])), a.b_causal[k]));
    }
    __syncthreads();
    if (warp < IN_MT) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      product(c, Win, warp, cs, lane);
      const int u = 16 * warp + g, n0 = 2 * tig;
      if (n0 < B) {
        const float b0 = __bfloat162float(a.b_in[u]), b8 = __bfloat162float(a.b_in[u + 8]);
        const bool two = n0 + 1 < B;
        decode::publish(a.boxes + u * HP + tig,
                        pack(rnd(__fadd_rn(rnd(c[0]), b0)), two ? rnd(__fadd_rn(rnd(c[1]), b0)) : 0.0f), (uint32_t)f);
        decode::publish(a.boxes + (u + 8) * HP + tig,
                        pack(rnd(__fadd_rn(rnd(c[2]), b8)), two ? rnd(__fadd_rn(rnd(c[3]), b8)) : 0.0f), (uint32_t)f);
      }
    }
    phases.add(0);
    // the skip sum after the last block
    if (!receive(a, in, L % NC != 0, a.boxes + (size_t)L * BOX, f, false, true)) return false;
    phases.add(1);
    // the head in f32: relu(acc variance_scale) W_out + b_out, relu, W_head + b_head, log-scales >= log_eps; each
    // product in four quarters of k, added in order
    {
      const int q = tid / C, jj = tid % C;
      for (int n = 0; n < B; ++n) {
        float s = 0.0f;
        for (int k = 24 * q; k < 24 * q + 24; ++k)
          s = fmaf(fmaxf(__fmul_rn(in.accs[k * MAX_B + n], a.variance_scale), 0.0f), Wout[k * C + jj], s);
        part[(q * MAX_B + n) * HW + jj] = s;
      }
    }
    __syncthreads();
    for (int i = tid; i < B * C; i += NT) {
      const int n = i / C, jj = i % C;
      const float* p = part + n * HW + jj;
      hid[i] = fmaxf(__fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(p[0], p[MAX_B * HW]), p[2 * MAX_B * HW]), p[3 * MAX_B * HW]),
                               a.b_out[jj]),
                     0.0f);
    }
    __syncthreads();
    {
      const int q = tid / HW, m = tid % HW;
      if (m < D3)
        for (int n = 0; n < B; ++n) {
          float s = 0.0f;
          for (int k = 24 * q; k < 24 * q + 24; ++k) s = fmaf(hid[n * C + k], Whead[k * HW + m], s);
          part[(q * MAX_B + n) * HW + m] = s;
        }
    }
    __syncthreads();
    for (int i = tid; i < B * D3; i += NT) {
      const int n = i / D3, m = i % D3;
      const float* p = part + n * HW + m;
      const float v = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(p[0], p[MAX_B * HW]), p[2 * MAX_B * HW]), p[3 * MAX_B * HW]),
                                a.b_head[m]);
      par[n * HW + m] = m >= 2 * M ? fmaxf(v, a.log_eps) : v;
    }
    __syncthreads();
    phases.add(2);
    if (tid < B) {
      const int n = tid;
      float U[DMOL_MAX_M + 1], u_logistic, mode;
      if (a.seed != nullptr) {
        philox_uniforms(a.seed, f, n, M, U);
        u_logistic = U[M];
      } else {
        const size_t row = (size_t)f * B + n;
#pragma unroll
        for (int m = 0; m < DMOL_MAX_M; ++m)
          if (m < M) U[m] = a.u_cat[row * M + m];
        u_logistic = a.u_log[row];
      }
      const float* p = par + n * HW;
      const float xf = dmol_sample_frame(p, p + M, p + 2 * M, M, U, u_logistic, a.maps, &mode);
      a.x[(size_t)n * a.x_cols + f + 1] = xf;
      xs[2 * n] = xs[2 * n + 1];
      xs[2 * n + 1] = xf;
    }
    __syncthreads();
    phases.add(3);
  }
  phases.store(a.trace);
  return true;
}

inline size_t smem_bytes() {
  const size_t block = INBOX_BYTES + 16 + 3 * MAT_U4 * 16 + 2 * MAX_B * VP * 2;
  const size_t io = INBOX_BYTES + 16 + IN_U4 * 16 + (C * C + C * HW + 4 * MAX_B * HW + MAX_B * C + MAX_B * HW + 2 * MAX_B) * 4 +
                    MAX_B * VP * 2;
  return block > io ? block : io;
}

// Clusters of NC CTAs: CTA l < L is block l, CTA L the io CTA, the rest of the last cluster idle. Every CTA's
// inbox barrier is set before the cluster's first barrier, and no CTA leaves before its cluster's last one (a
// producer may still store into a consumer that gave up).
__global__ void __launch_bounds__(NT, 1) wavenet_decode_resident_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Inbox in = inbox(smem);
  if (threadIdx.x == 0) {  // armed for frame 1's bytes when a CTA of this cluster feeds this one
    decode::mbar_init(in.bar, 1);
    const int l = blockIdx.x;
    if (l < a.L ? l % NC != 0 : l == a.L && a.L % NC != 0) decode::mbar_expect(in.bar, inbox_bytes(a.B, l < a.L));
  }
  for (int i = threadIdx.x; i < MAX_B * VP; i += NT) in.hs[i] = __float2bfloat16_rn(0.0f);  // rows >= B stay zero
  cluster.sync();
  if ((int)blockIdx.x < a.L)
    run_block(a, smem, blockIdx.x);
  else if ((int)blockIdx.x == a.L)
    run_io(a, smem);
  cluster.sync();
}
}  // namespace k4res
}  // namespace blvm

// The resident route: frames 1 .. n_frames - 1 of every sequence in one cooperative launch of ceil((L + 1) / 8)
// clusters of 8 CTAs, cudaErrorCooperativeLaunchTooLarge unless all are resident at once (bf16, C = half = S = 96,
// 1 <= B <= 8, M <= 32). x (B, x_cols = n_frames + 1): column 0 the history's
// last frame, column 1 frame 0, column f + 1 frame f. w_blocks (L, 3, 12, 6, 32) uint4 and w_in (6, 6, 32)
// uint4 in mma fragment order (ops/generation.py:pack_wavenet_resident), b_blocks (L, 4, 96) and b_in (96)
// bf16; w_causal (2, 96), b_causal, w_out (96, 96), b_out, w_head (96, 96) (3M columns used), b_head
// float32; dilations, offsets int32 device arrays; buffers (B, D, 96) bf16 as the per-frame route's;
// boxes (L + 1) x 1152 zeroed uint64 words; status one zeroed int32, set to 1 if a wait outlasted
// limit_ns; trace null, or (8 ceil((L + 1) / 8), 4) int64 that each CTA's thread 0 sets to its SM cycles by
// phase over the launch: a block's old tap, its wait for h, the h tap and gate, [r | s] and the send; the io
// CTA's causal tap and in_transform, its wait for the skip sum, the head, the sampler. seed a device int64[2]
// Philox key (K3's stream at step f, row n), or null with u_cat, u_log.
extern "C" int blvm_wavenet_decode_resident(const void* w_blocks, const void* b_blocks, const void* w_in,
                                            const void* b_in, const void* w_causal, const void* b_causal,
                                            const void* w_out, const void* b_out, const void* w_head,
                                            const void* b_head, const void* dilations, const void* offsets,
                                            void* buffers, void* boxes, void* x, const void* seed, const void* u_cat,
                                            const void* u_log, void* status, void* trace, int B, int L, int M, int D,
                                            int n_frames, float variance_scale, float log_eps, float cat_low,
                                            float cat_scale, float logistic_low, float logistic_scale,
                                            int64_t limit_ns, void* stream) {
  using namespace blvm::k4res;
  if (B < 1 || B > MAX_B || L < 1 || M < 1 || 3 * M > HW || M > blvm::DMOL_MAX_M || D < L || n_frames < 2 ||
      !status || limit_ns <= 0 || (!seed && (!u_cat || !u_log)))
    return (int)cudaErrorInvalidValue;
  const void* vec_loaded[] = {w_blocks, w_in, w_out, w_head, buffers};
  for (const void* p : vec_loaded)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint4*>(w_blocks), static_cast<const bf16*>(b_blocks), static_cast<const uint4*>(w_in),
         static_cast<const bf16*>(b_in), static_cast<const float*>(w_causal), static_cast<const float*>(b_causal),
         static_cast<const float*>(w_out), static_cast<const float*>(b_out), static_cast<const float*>(w_head),
         static_cast<const float*>(b_head), static_cast<const int*>(dilations), static_cast<const int*>(offsets),
         static_cast<bf16*>(buffers), static_cast<unsigned long long*>(boxes), static_cast<float*>(x),
         static_cast<const int64_t*>(seed), static_cast<const float*>(u_cat), static_cast<const float*>(u_log),
         B, L, M, D, n_frames + 1, n_frames, variance_scale, log_eps,
         blvm::UniformMaps{cat_low, cat_scale, logistic_low, logistic_scale},
         blvm::decode::Watch{static_cast<int*>(status), limit_ns}, static_cast<long long*>(trace)};
  const size_t smem = smem_bytes();
  const int clusters = (L + 1 + NC - 1) / NC;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;  // the launch fails, not the waits, if a CTA cannot be resident
  attr[1].val.cooperative = 1;
  cfg.gridDim = dim3(NC * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  // every cluster must be resident at once: the frame passes through all of them
  cudaError_t err = cudaFuncSetAttribute(wavenet_decode_resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int resident = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&resident, wavenet_decode_resident_kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (resident < clusters) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchKernelEx(&cfg, wavenet_decode_resident_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
