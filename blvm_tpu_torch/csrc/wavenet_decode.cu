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
// the 50 MB L2 but not an SM's shared memory. The compulsory traffic is the weights once a launch:
// ~1.65 us a frame in bf16 at 3.35 TB/s. The chain of 50 blocks, each two GEMVs deep, makes a
// frame's time one of latency and synchronisation. This first design is simple: one launch per
// frame, one 512-thread block per sequence, weights read from global memory (L2-resident after
// the first frame) in 16-byte loads, each GEMV split over column groups and slices of its input
// with the partial sums reduced in shared memory. So every sequence streams all the weights
// through one SM's L2 port each frame: 260 us a frame on an H100, f32 no slower than bf16, so
// latency and synchronisation, not bytes, set the pace. A variant that loaded every block's slot
// when the launch starts, issued all of a thread's GEMV loads together and left the column sums
// to the consuming threads (four barriers a block instead of seven) measured slower (299 us):
// fewer threads then add longer chains of partial sums. A persistent kernel that keeps the
// weights resident in the shared memory of many SMs (a cluster per sequence) is later work.

#include "common.cuh"
#include "dmol_sample.cuh"

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
