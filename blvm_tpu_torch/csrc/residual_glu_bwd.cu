// K1-bwd: backward of the fused WaveNet residual-GLU block (residual_glu.cu), for Hopper (sm_90a).
//
// Replaces the VJP of the cut Pallas kernel blvm_tpu/ops/pallas/wavenet_block.py:fused_residual_glu
// (commit 1788a18^, _bwd :144-148), which recomputed the block from its saved inputs
// (x and the cast weights) instead of saving activations. With pre_t, pre_s, act as in the
// forward, dO (B, L, R) the gradient of o and dS (B, skip_size, S) that of s:
//
//   d_rs[t]  = [dO[t] sqrt(1/2) | dS[t - (L - skip_size)] or 0 above the skip window]
//   d_act[t] = d_rs[t] Wrs^T
//   d_pre_t  = d_act sigmoid(pre_s) (1 - tanh^2(pre_t))     d_pre_s = d_act tanh(pre_t) sigmoid'(pre_s)
//   dx[r]    = d_pre[r] W0^T + d_pre[r - d] W1^T + dO[r - d] sqrt(1/2)   (W0 = [Wt0 | Ws0], W1 the tap-1 pair)
//
// Each row of dx takes d_pre from two output rows (r and r - d), so the backward runs in two
// passes, race-free and without atomics: pass A recomputes the gate per output row and writes
// d_pre = [d_pre_t | d_pre_s] (B, L, 2 half) and act (B, L, half); pass B gathers dx per input
// row. The weight and bias gradients are sums over all B * L rows (x[t]^T d_pre, x[t+d]^T d_pre,
// act^T d_rs and column sums), large products that the JAX backward left to XLA.
//
// Routes. bf16 at C = half = R = S = 96 with the skip (WaveNet's run specs): the warpgroup route
// (namespace wg, below), four kernels a block on the wgmma tile of wgmma_bf16.cuh that take the
// weight and bias gradients too and write them into the caller's slots; it is described where it
// starts. Every other width and dtype: the two passes here, and the Python wrapper takes the weight
// gradients with torch.matmul on their outputs (f32 accumulation). f32 and bf16 at half <= 128 and
// R + S <= 256 run on CUDA-core FMAs with the weights streamed through shared memory in chunks, as
// the forward's FMA path; bf16 at C = half = R = S = 32 on mma.sync m16n8k16 (mma_bf16.cuh):
// persistent blocks, the block's weights staged once in shared memory, each warp 16 rows; f32 at
// STCN's width (C = half = R = 256) the register-tiled path (namespace tiled).
//
// What bounds it on an H100: at the flagship width (C = half = R = S = 96) the two passes do
// 2 * (4 C half + half (R+S)) + 2 * 4 half C = 184 kFLOP per row and must read x, dO and dS and
// write dx (768 bytes a row in bf16), ~240 FLOP/byte: close to the bf16 tensor-core ridge.
// d_pre and act (576 bytes a row in bf16) make a round trip through device memory between the
// passes and the weight-gradient products.
//
// Dtypes: f32 accumulation inside, rounded once at the store to x's dtype, as the forward.
//
// Skip-free mode (S = 0, the blocks STCN runs with need_skip=False): d_rs is only dO sqrt(1/2), no
// row lies in a skip window, and only the R residual columns of rs_kernel (rows rs_ld wide) are read.
// The wrapper gives the S skip columns of the rs_kernel and rs_bias gradients as zeros, as the
// gradient of JAX's column slice rs_kernel[0, :, :R] is.

#include "common.cuh"
#include "fma_tile.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace blvm {
namespace {

constexpr int TT = 32;              // rows per thread block (FMA path)
constexpr int KC = 32;              // reduction elements per staged weight chunk
constexpr int THREADS = 256;        // 8 warps
constexpr int ROWS = TT / (THREADS / 32);
constexpr int MAX_GATE_COLS = 4;    // half  <= 128
constexpr int MAX_C_COLS = 8;       // C     <= 256
constexpr int MAX_C = 256;
constexpr int MAX_RS = 256;

// ---- FMA path, pass A: recompute the gate, write d_pre and act -------------------------------
size_t smem_a_bytes(int C, int half, int RS) {
  return sizeof(float) * (2 * (size_t)TT * C + (size_t)TT * RS + 4 * (size_t)KC * half);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
glu_bwd_a_kernel(const T* __restrict__ x, const T* __restrict__ w_t, const T* __restrict__ w_s,
                 const T* __restrict__ b_t, const T* __restrict__ b_s, const T* __restrict__ w_rs,
                 const T* __restrict__ d_o, const T* __restrict__ d_s, T* __restrict__ d_pre, T* __restrict__ act,
                 int T_in, int C, int half, int R, int S, int rs_ld, int d, int skip_size) {
  extern __shared__ float smem[];
  const int RS = R + S;
  float* x_old = smem;            // [TT][C]  x[t]
  float* x_cur = x_old + TT * C;  // [TT][C]  x[t+d]
  float* drs = x_cur + TT * C;    // [TT][RS] d_rs
  float* w = drs + TT * RS;       // gate chunk [4][KC][half] or Wrs^T chunk [KC][half]

  const int b = blockIdx.y, t0 = blockIdx.x * TT, T_out = T_in - d, skip_start = T_out - skip_size;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * ROWS;
  const float inv_std = to_f32(from_f32<T>(0.70710678118654752f));
  const T* xb = x + (size_t)b * T_in * C;

  for (int i = threadIdx.x; i < TT * C; i += THREADS) {
    const int r = i / C, c = i - r * C, t = t0 + r;
    x_old[i] = t < T_out ? to_f32(xb[(size_t)t * C + c]) : 0.f;
    x_cur[i] = t < T_out ? to_f32(xb[(size_t)(t + d) * C + c]) : 0.f;
  }
  for (int i = threadIdx.x; i < TT * RS; i += THREADS) {
    const int r = i / RS, c = i - r * RS, t = t0 + r;
    float v = 0.f;
    if (t < T_out) {
      if (c < R)
        v = to_f32(d_o[((size_t)b * T_out + t) * R + c]) * inv_std;
      else if (t >= skip_start)
        v = to_f32(d_s[((size_t)b * skip_size + (t - skip_start)) * S + (c - R)]);
    }
    drs[i] = v;
  }

  // gate pre-activations, as the forward
  float acc_t[ROWS][MAX_GATE_COLS], acc_s[ROWS][MAX_GATE_COLS], acc_d[ROWS][MAX_GATE_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < MAX_GATE_COLS; ++j) acc_t[i][j] = acc_s[i][j] = acc_d[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += KC) {
    const int kc = min(KC, C - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * kc * half; i += THREADS) {
      const int m = i / (kc * half), rem = i - m * kc * half, k = rem / half, c = rem - k * half;
      const T* src = (m < 2 ? w_t : w_s) + ((size_t)(m & 1) * C + k0 + k) * half + c;
      w[(m * KC + k) * half + c] = to_f32(*src);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float xo[ROWS], xc[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        xo[i] = x_old[(row0 + i) * C + k0 + k];
        xc[i] = x_cur[(row0 + i) * C + k0 + k];
      }
#pragma unroll
      for (int j = 0; j < MAX_GATE_COLS; ++j) {
        const int col = lane + 32 * j;
        if (col < half) {
          const float t0w = w[(0 * KC + k) * half + col], t1w = w[(1 * KC + k) * half + col];
          const float s0w = w[(2 * KC + k) * half + col], s1w = w[(3 * KC + k) * half + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            acc_t[i][j] = fmaf(xc[i], t1w, fmaf(xo[i], t0w, acc_t[i][j]));
            acc_s[i][j] = fmaf(xc[i], s1w, fmaf(xo[i], s0w, acc_s[i][j]));
          }
        }
      }
    }
  }

  // d_act = d_rs Wrs^T: Wrs (1, half, rs_ld), its first R+S columns streamed in chunks of KC
  for (int k0 = 0; k0 < RS; k0 += KC) {
    const int kc = min(KC, RS - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kc * half; i += THREADS) {
      const int j = i / kc, k = i - j * kc;
      w[k * half + j] = to_f32(w_rs[(size_t)j * rs_ld + k0 + k]);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float a[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = drs[(row0 + i) * RS + k0 + k];
#pragma unroll
      for (int j = 0; j < MAX_GATE_COLS; ++j) {
        const int col = lane + 32 * j;
        if (col < half) {
          const float wv = w[k * half + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc_d[i][j] = fmaf(a[i], wv, acc_d[i][j]);
        }
      }
    }
  }

  // d_pre and act; the derivatives in the form autograd of the plain version takes
#pragma unroll
  for (int j = 0; j < MAX_GATE_COLS; ++j) {
    const int col = lane + 32 * j;
    if (col >= half) continue;
    const float bt = to_f32(b_t[col]), bs = to_f32(b_s[col]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = t0 + row0 + i;
      if (t >= T_out) continue;
      const float th = tanhf(acc_t[i][j] + bt), sg = sigmoidf(acc_s[i][j] + bs), da = acc_d[i][j];
      const size_t row = (size_t)b * T_out + t;
      act[row * half + col] = from_f32<T>(th * sg);
      d_pre[row * 2 * half + col] = from_f32<T>(da * sg * (1.f - th * th));
      d_pre[row * 2 * half + half + col] = from_f32<T>(da * th * (sg * (1.f - sg)));
    }
  }
}

// ---- FMA path, pass B: dx[r] = d_pre[r] W0^T + d_pre[r - d] W1^T + dO[r - d] sqrt(1/2) ---------
size_t smem_b_bytes(int C, int half) { return sizeof(float) * (2 * (size_t)TT * 2 * half + 4 * (size_t)KC * C); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
glu_bwd_b_kernel(const T* __restrict__ w_t, const T* __restrict__ w_s, const T* __restrict__ d_pre,
                 const T* __restrict__ d_o, T* __restrict__ dx, int T_in, int C, int half, int d) {
  extern __shared__ float smem[];
  const int H2 = 2 * half;
  float* dp_cur = smem;             // [TT][2 half]  d_pre[r]
  float* dp_old = dp_cur + TT * H2;  // [TT][2 half]  d_pre[r - d]
  float* w = dp_old + TT * H2;       // [4][KC][C]: Wt0, Ws0, Wt1, Ws1 transposed, a chunk of half

  const int b = blockIdx.y, r0 = blockIdx.x * TT, T_out = T_in - d;
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * ROWS;
  const float inv_std = to_f32(from_f32<T>(0.70710678118654752f));
  const T* dpb = d_pre + (size_t)b * T_out * H2;

  for (int i = threadIdx.x; i < TT * H2; i += THREADS) {
    const int rr = i / H2, k = i - rr * H2, r = r0 + rr;
    dp_cur[i] = r < T_out ? to_f32(dpb[(size_t)r * H2 + k]) : 0.f;
    dp_old[i] = (r >= d && r < T_in) ? to_f32(dpb[(size_t)(r - d) * H2 + k]) : 0.f;
  }

  float acc[ROWS][MAX_C_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < MAX_C_COLS; ++j) acc[i][j] = 0.f;

  for (int j0 = 0; j0 < half; j0 += KC) {
    const int kc = min(KC, half - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < 4 * kc * C; i += THREADS) {
      const int k = i % kc, rest = i / kc, c = rest % C, m = rest / C;  // m = 2 tap + branch
      const T* src = (m & 1 ? w_s : w_t) + ((size_t)(m >> 1) * C + c) * half + j0 + k;
      w[(m * KC + k) * C + c] = to_f32(*src);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float at0[ROWS], as0[ROWS], at1[ROWS], as1[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int base = (row0 + i) * H2 + j0 + k;
        at0[i] = dp_cur[base];
        as0[i] = dp_cur[base + half];
        at1[i] = dp_old[base];
        as1[i] = dp_old[base + half];
      }
#pragma unroll
      for (int j = 0; j < MAX_C_COLS; ++j) {
        const int col = lane + 32 * j;
        if (col < C) {
          const float wt0 = w[(0 * KC + k) * C + col], ws0 = w[(1 * KC + k) * C + col];
          const float wt1 = w[(2 * KC + k) * C + col], ws1 = w[(3 * KC + k) * C + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
            acc[i][j] = fmaf(as1[i], ws1, fmaf(at1[i], wt1, fmaf(as0[i], ws0, fmaf(at0[i], wt0, acc[i][j]))));
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + row0 + i;
    if (r >= T_in) continue;
#pragma unroll
    for (int j = 0; j < MAX_C_COLS; ++j) {
      const int col = lane + 32 * j;
      if (col >= C) continue;
      float v = acc[i][j];
      if (r >= d) v += to_f32(d_o[((size_t)b * T_out + r - d) * C + col]) * inv_std;
      dx[((size_t)b * T_in + r) * C + col] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
           const void* d_o, const void* d_s, void* d_pre, void* act, void* dx, int B, int T_in, int C, int half,
           int R, int S, int rs_ld, int d, int skip_size, cudaStream_t stream) {
  const size_t smem_a = smem_a_bytes(C, half, R + S), smem_b = smem_b_bytes(C, half);
  cudaError_t err = cudaFuncSetAttribute(glu_bwd_a_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(glu_bwd_b_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  const int T_out = T_in - d;
  glu_bwd_a_kernel<T><<<dim3((T_out + TT - 1) / TT, B), THREADS, smem_a, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_t), static_cast<const T*>(w_s), static_cast<const T*>(b_t),
      static_cast<const T*>(b_s), static_cast<const T*>(w_rs), static_cast<const T*>(d_o),
      static_cast<const T*>(d_s), static_cast<T*>(d_pre), static_cast<T*>(act), T_in, C, half, R, S, rs_ld, d,
      skip_size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glu_bwd_b_kernel<T><<<dim3((T_in + TT - 1) / TT, B), THREADS, smem_b, stream>>>(
      static_cast<const T*>(w_t), static_cast<const T*>(w_s), static_cast<const T*>(d_pre),
      static_cast<const T*>(d_o), static_cast<T*>(dx), T_in, C, half, d);
  return (int)cudaGetLastError();
}

// ---- register-tiled f32 path: STCN's width ------------------------------------------------------
//
// f32 at C = half = R = 256, with the skip (S = 256) or skip-free (S = 0). The FMA path above needs
// 262,144 bytes of shared memory in each pass here (above the 232,448-byte opt-in) and 8 gate columns a
// lane; this path takes the forward's answer (residual_glu.cu, namespace tiled): each thread owns 8 rows x
// 4 units and takes each k step from 16-byte loads (fma_tile.cuh), so FMA issue bounds the products.
//
// Pass A (a thread block a tile of 32 output rows): x[t] and x[t+d] (64 KB) and d_rs = [dO | dS or 0]
// (64 KB with the skip) land by cp.async with the first gate chunk; the gate is the forward's GEMM
// [x[t] | x[t+d]] (32 x 2C) times [W_t | W_s] (2C x 2 half), its chunks streamed by cp.async into two
// buffers; then d_act = d_rs Wrs^T (32 x RS times RS x half), whose operand is rs_kernel transposed:
// each thread loads one unit's row of 16 consecutive columns as four 16-byte loads (the next chunk's
// while the current one is multiplied) and stores it k-major, a warp's stores on 32 consecutive floats.
// The residual columns' share is scaled by sqrt(1/2) once, before the skip columns add theirs. The
// epilogue writes act and d_pre = [d_pre_t | d_pre_s] with 16-byte stores.
//
// Pass B (a tile of 32 input rows): [d_pre[r] | d_pre[r - d]] (32 x 4 half, 128 KB) lands by cp.async;
// dx = that times [Wt0 ; Ws0 ; Wt1 ; Ws1]^T (4 half x C), its chunks transposed into shared memory as in
// pass A, plus dO[r - d] sqrt(1/2).
//
// What bounds it: a row costs 2 (4 C half + half (R + S)) + 2 (4 half C) FLOP, 1.31 MFLOP with the skip
// and 1.18 M skip-free, against 4 (2 C + R + S) bytes of compulsory traffic (x and dx, dO and dS): ~1000
// FLOP a byte, so the f32 FMA rate (67 TFLOP/s) bounds it. d_pre and act make a round trip through device
// memory between the passes and the weight-gradient products (3 half floats a row).
namespace tiled {

constexpr int C = 256, HALF = 256;
constexpr int TM = 32;           // rows a thread block
constexpr int THREADS = 256;     // 4 row groups x 64 unit groups; also the N of a transposed product
constexpr int KC = 16;           // k rows a staged weight chunk
constexpr int RM = 8;            // rows a thread (and 4 units)
constexpr int GCOLS = 2 * HALF;  // a staged gate row: [tanh | sigmoid]
constexpr float INV_STD = 0.70710678118654752f;

template <int RS>
constexpr size_t smem_a() { return sizeof(float) * (2 * TM * C + TM * RS + 2 * KC * GCOLS); }
constexpr size_t SMEM_B = sizeof(float) * (TM * 4 * HALF + 2 * KC * C);

// This thread's share of a chunk of a transposed product's weights: W row-major with row stride ld, row
// n = threadIdx.x, its KC columns k0 .. k0 + KC as four 16-byte loads ...
__device__ __forceinline__ void load_t(const float* w, size_t ld, int k0, float4 (&r)[KC / 4]) {
  const float4* src = reinterpret_cast<const float4*>(w + threadIdx.x * ld + k0);
#pragma unroll
  for (int q = 0; q < KC / 4; ++q) r[q] = __ldg(src + q);
}
// ... stored k-major into a chunk buffer [KC][THREADS]
__device__ __forceinline__ void store_t(const float4 (&r)[KC / 4], float* dst) {
#pragma unroll
  for (int q = 0; q < KC / 4; ++q) {
    dst[(4 * q + 0) * THREADS + threadIdx.x] = r[q].x;
    dst[(4 * q + 1) * THREADS + threadIdx.x] = r[q].y;
    dst[(4 * q + 2) * THREADS + threadIdx.x] = r[q].z;
    dst[(4 * q + 3) * THREADS + threadIdx.x] = r[q].w;
  }
}

__device__ __forceinline__ void scale(float (&acc)[RM][4], float s) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= s;
}

template <int RS>  // R + S: 512 with the skip, 256 skip-free
__global__ void __launch_bounds__(THREADS, 1)
pass_a_kernel(const float* __restrict__ x, const float* __restrict__ w_t, const float* __restrict__ w_s,
              const float* __restrict__ b_t, const float* __restrict__ b_s, const float* __restrict__ w_rs,
              const float* __restrict__ d_o, const float* __restrict__ d_s, float* __restrict__ d_pre,
              float* __restrict__ act, int T_in, int rs_ld, int d, int skip_size) {
  extern __shared__ __align__(16) float sm[];
  float* xo = sm;               // [TM][C] x[t]
  float* xc = xo + TM * C;      // [TM][C] x[t+d]
  float* drs = xc + TM * C;     // [TM][RS] [dO | dS or 0]
  float* wbuf = drs + TM * RS;  // 2 x [KC][GCOLS]
  constexpr bool SKIP = RS > C;
  constexpr int S = RS - C;
  const int b = blockIdx.y, t0 = blockIdx.x * TM, T_out = T_in - d, skip_start = T_out - skip_size;
  const int r0 = (threadIdx.x >> 6) * RM, u0 = (threadIdx.x & 63) * 4;
  const float* xb = x + (size_t)b * T_in * C;

  for (int i = threadIdx.x; i < TM * (C / 4); i += THREADS) {  // rows past T_out read as 0
    const int r = i / (C / 4), v = 4 * (i % (C / 4)), t = t0 + r;
    const bool valid = t < T_out;
    cp_async16(xo + r * C + v, xb + (valid ? (size_t)t * C + v : 0), valid);
    cp_async16(xc + r * C + v, xb + (valid ? (size_t)(t + d) * C + v : 0), valid);
  }
  for (int i = threadIdx.x; i < TM * (RS / 4); i += THREADS) {  // d_rs: 0 past T_out and above the skip window
    const int r = i / (RS / 4), v = 4 * (i % (RS / 4)), t = t0 + r;
    const bool valid = t < T_out && (v < C || t >= skip_start);
    const float* src = !valid ? d_o
                       : v < C ? d_o + ((size_t)b * T_out + t) * C + v
                               : d_s + ((size_t)b * skip_size + (t - skip_start)) * S + (v - C);
    cp_async16(drs + r * RS + v, src, valid);
  }
  // chunk k0 of the gate weights' 2C rows [tap 0 ; tap 1], each [tanh | sigmoid], into buffer buf
  auto stage_gate = [&](int k0, int buf) {
    float* dst = wbuf + buf * KC * GCOLS;
    for (int i = threadIdx.x; i < KC * (GCOLS / 4); i += THREADS) {
      const int r = i / (GCOLS / 4), col = 4 * (i % (GCOLS / 4)), k = k0 + r;
      cp_async16(dst + r * GCOLS + col, (col < HALF ? w_t : w_s) + (size_t)k * HALF + col % HALF, true);
    }
    cp_async_commit();
  };

  // ---- gate pre-activations: [x[t] | x[t+d]] (TM x 2C) times [W_t | W_s] (2C x 2 HALF), as the forward ---------
  float acc_t[RM][4], acc_s[RM][4], acc_d[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_t[i][j] = acc_s[i][j] = acc_d[i][j] = 0.f;
  constexpr int NG = 2 * C / KC;
  stage_gate(0, 0);  // with the x and d_rs tiles: one group
  for (int ci = 0; ci < NG; ++ci) {
    if (ci + 1 < NG) {
      stage_gate((ci + 1) * KC, (ci + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int k0 = ci * KC;
    fma_tile::chunk<KC, RM, GCOLS, HALF, true>(k0 < C ? xo : xc, C, k0 % C, wbuf + (ci & 1) * KC * GCOLS, r0, u0,
                                               acc_t, acc_s);
    __syncthreads();  // every thread is done with this buffer
  }

  // ---- d_act = d_rs (TM x RS) times Wrs^T (RS x HALF) ----------------------------------------------------------
  constexpr int NR = RS / KC;
  float4 wr[KC / 4];
  load_t(w_rs, rs_ld, 0, wr);
  store_t(wr, wbuf);
  __syncthreads();
  for (int ci = 0; ci < NR; ++ci) {
    if (ci + 1 < NR) load_t(w_rs, rs_ld, (ci + 1) * KC, wr);  // the next chunk's loads fly during this product
    if (SKIP && ci == C / KC) scale(acc_d, INV_STD);        // the residual columns' share is dO sqrt(1/2) Wr^T
    fma_tile::chunk<KC, RM, HALF, 0, false>(drs, RS, ci * KC, wbuf + (ci & 1) * KC * GCOLS, r0, u0, acc_d, acc_d);
    if (ci + 1 < NR) store_t(wr, wbuf + ((ci + 1) & 1) * KC * GCOLS);  // its buffer was released a chunk ago
    __syncthreads();
  }
  if (!SKIP) scale(acc_d, INV_STD);

  // ---- d_pre and act; the derivatives in the form autograd of the plain version takes -------------------------
  const float4 bt = *reinterpret_cast<const float4*>(b_t + u0), bs = *reinterpret_cast<const float4*>(b_s + u0);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = t0 + r0 + i;
    if (t >= T_out) continue;
    float a[4], dt[4], ds[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float th = tanhf(acc_t[i][j] + fma_tile::lane4(bt, j)), sg = sigmoidf(acc_s[i][j] + fma_tile::lane4(bs, j));
      const float da = acc_d[i][j];
      a[j] = th * sg;
      dt[j] = da * sg * (1.f - th * th);
      ds[j] = da * th * (sg * (1.f - sg));
    }
    const size_t row = (size_t)b * T_out + t;
    *reinterpret_cast<float4*>(act + row * HALF + u0) = make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(d_pre + row * 2 * HALF + u0) = make_float4(dt[0], dt[1], dt[2], dt[3]);
    *reinterpret_cast<float4*>(d_pre + row * 2 * HALF + HALF + u0) = make_float4(ds[0], ds[1], ds[2], ds[3]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
pass_b_kernel(const float* __restrict__ w_t, const float* __restrict__ w_s, const float* __restrict__ d_pre,
              const float* __restrict__ d_o, float* __restrict__ dx, int T_in, int d) {
  extern __shared__ __align__(16) float sm[];
  constexpr int H2 = 2 * HALF, KB = 4 * HALF;
  float* dp = sm;              // [TM][KB]: [d_pre[r] | d_pre[r - d]]
  float* wbuf = dp + TM * KB;  // 2 x [KC][C]
  const int b = blockIdx.y, t0 = blockIdx.x * TM, T_out = T_in - d;
  const int r0 = (threadIdx.x >> 6) * RM, u0 = (threadIdx.x & 63) * 4;
  const float* dpb = d_pre + (size_t)b * T_out * H2;

  for (int i = threadIdx.x; i < TM * (KB / 4); i += THREADS) {  // rows outside d_pre read as 0
    const int rr = i / (KB / 4), v = 4 * (i % (KB / 4)), r = t0 + rr;
    const bool cur = v < H2;  // d_pre[r] (tap 0) or d_pre[r - d] (tap 1)
    const bool valid = cur ? r < T_out : (r >= d && r < T_in);
    cp_async16(dp + rr * KB + v, dpb + (valid ? (size_t)(cur ? r : r - d) * H2 + v % H2 : 0), valid);
  }
  cp_async_commit();
  // chunk k0 of [Wt0 ; Ws0 ; Wt1 ; Ws1]^T: rows c of the (2, C, HALF) kernels, HALF-wide segment k0 / HALF
  float4 wr[KC / 4];
  auto load_w = [&](int k0) {
    const int m = k0 / HALF;
    load_t((m & 1 ? w_s : w_t) + (size_t)(m >> 1) * C * HALF, HALF, k0 % HALF, wr);
  };
  load_w(0);
  store_t(wr, wbuf);
  cp_async_wait_all();
  __syncthreads();

  float acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  constexpr int NB = KB / KC;
  for (int ci = 0; ci < NB; ++ci) {
    if (ci + 1 < NB) load_w((ci + 1) * KC);
    fma_tile::chunk<KC, RM, C, 0, false>(dp, KB, ci * KC, wbuf + (ci & 1) * KC * C, r0, u0, acc, acc);
    if (ci + 1 < NB) store_t(wr, wbuf + ((ci + 1) & 1) * KC * C);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = t0 + r0 + i;
    if (r >= T_in) continue;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (r >= d) {
      const float4 o = *reinterpret_cast<const float4*>(d_o + ((size_t)b * T_out + r - d) * C + u0);
      v.x += o.x * INV_STD;
      v.y += o.y * INV_STD;
      v.z += o.z * INV_STD;
      v.w += o.w * INV_STD;
    }
    *reinterpret_cast<float4*>(dx + ((size_t)b * T_in + r) * C + u0) = v;
  }
}

template <int RS>
int launch(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
           const void* d_o, const void* d_s, void* d_pre, void* act, void* dx, int B, int T_in, int rs_ld, int d,
           int skip_size, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(pass_a_kernel<RS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_a<RS>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pass_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_B);
  if (err != cudaSuccess) return (int)err;
  const int T_out = T_in - d;
  pass_a_kernel<RS><<<dim3((T_out + TM - 1) / TM, B), THREADS, smem_a<RS>(), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_t), static_cast<const float*>(w_s),
      static_cast<const float*>(b_t), static_cast<const float*>(b_s), static_cast<const float*>(w_rs),
      static_cast<const float*>(d_o), static_cast<const float*>(d_s), static_cast<float*>(d_pre),
      static_cast<float*>(act), T_in, rs_ld, d, skip_size);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass_b_kernel<<<dim3((T_in + TM - 1) / TM, B), THREADS, SMEM_B, stream>>>(
      static_cast<const float*>(w_t), static_cast<const float*>(w_s), static_cast<const float*>(d_pre),
      static_cast<const float*>(d_o), static_cast<float*>(dx), T_in, d);
  return (int)cudaGetLastError();
}

}  // namespace tiled

// ---- tensor-core path: bf16 at fixed widths -------------------------------------------------------
namespace mma {

using bf = __nv_bfloat16;
constexpr int WARPS = 8;
constexpr int TT = 16 * WARPS;  // rows per tile

// bf16 pair * s, rounded back to a bf16 pair
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack(f.x * s, f.y * s);
}

// Pass A for one warp's 16 rows starting at output row t0 of batch row b.
template <int C, int HALF, int RS>
__device__ __forceinline__ void pass_a_warp(const bf* wg, const bf* wr, const bf* __restrict__ x,
                                            const bf* __restrict__ b_t, const bf* __restrict__ b_s,
                                            const bf* __restrict__ d_o, const bf* __restrict__ d_s,
                                            bf* __restrict__ d_pre, bf* __restrict__ act, int b, int t0, int T_in,
                                            int d, int skip_size, int g, int q, float inv_std) {
  constexpr int S = RS - C, KG_PAD = 2 * C + 8, RS_PAD = RS + 8, NTG = 2 * HALF / 8, NTH = HALF / 8;
  const int T_out = T_in - d, skip_start = T_out - skip_size;
  const int ta = t0 + g, tb = ta + 8;  // the two rows whose fragments this lane holds
  const bool va = ta < T_out, vb = tb < T_out;
  const bf* xb = x + (size_t)b * T_in * C;

  // gate pre-activations: [x[t] | x[t+d]] (16 x 2C) times the gate weights (2C x 2 HALF)
  float acc[NTG][4];
#pragma unroll
  for (int j = 0; j < NTG; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2 * C / 16; ++ks) {
    const int shift = ks < C / 16 ? 0 : d, k = (ks % (C / 16)) * 16 + 2 * q;
    const bf* pa = xb + (size_t)(ta + shift) * C + k;
    const bf* pb = xb + (size_t)(tb + shift) * C + k;
    const uint32_t a0 = va ? ld32(pa) : 0u, a1 = vb ? ld32(pb) : 0u;
    const uint32_t a2 = va ? ld32(pa + 8) : 0u, a3 = vb ? ld32(pb + 8) : 0u;
#pragma unroll
    for (int j = 0; j < NTG; ++j) {
      const bf* wb = wg + (j * 8 + g) * KG_PAD + ks * 16 + 2 * q;
      mma_bf16(acc[j], a0, a1, a2, a3, ld32(wb), ld32(wb + 8));
    }
  }

  // d_act: d_rs (16 x RS, [dO sqrt(1/2) | dS or 0]) times Wrs^T (RS x HALF)
  float accd[NTH][4];
#pragma unroll
  for (int j = 0; j < NTH; ++j) accd[j][0] = accd[j][1] = accd[j][2] = accd[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < RS / 16; ++ks) {
    uint32_t a0 = 0u, a1 = 0u, a2 = 0u, a3 = 0u;
    if (ks < C / 16) {
      const bf* pa = d_o + ((size_t)b * T_out + ta) * C + ks * 16 + 2 * q;
      const bf* pb = d_o + ((size_t)b * T_out + tb) * C + ks * 16 + 2 * q;
      if (va) a0 = scale2(ld32(pa), inv_std), a2 = scale2(ld32(pa + 8), inv_std);
      if (vb) a1 = scale2(ld32(pb), inv_std), a3 = scale2(ld32(pb + 8), inv_std);
    } else {
      const int k = (ks - C / 16) * 16 + 2 * q;
      const bf* pa = d_s + ((size_t)b * skip_size + (ta - skip_start)) * S + k;
      const bf* pb = d_s + ((size_t)b * skip_size + (tb - skip_start)) * S + k;
      if (va && ta >= skip_start) a0 = ld32(pa), a2 = ld32(pa + 8);
      if (vb && tb >= skip_start) a1 = ld32(pb), a3 = ld32(pb + 8);
    }
#pragma unroll
    for (int j = 0; j < NTH; ++j) {
      const bf* wb = wr + (j * 8 + g) * RS_PAD + ks * 16 + 2 * q;
      mma_bf16(accd[j], a0, a1, a2, a3, ld32(wb), ld32(wb + 8));
    }
  }

  // d_pre and act. tanh and sigmoid from one __expf each, so that 1 - tanh^2 = 4e / (1 + e)^2 and
  // sigmoid' = e / (1 + e)^2 keep their relative precision where they are small (1 - tanh^2 from
  // an approximate tanh near +-1 would not).
#pragma unroll
  for (int j = 0; j < NTH; ++j) {
    const int col = j * 8 + 2 * q;
    const float bt[2] = {__bfloat162float(b_t[col]), __bfloat162float(b_t[col + 1])};
    const float bs[2] = {__bfloat162float(b_s[col]), __bfloat162float(b_s[col + 1])};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = h ? tb : ta;
      if (t >= T_out) continue;
      float va_[2], dt[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pt = acc[j][2 * h + e] + bt[e], ps = acc[j + NTH][2 * h + e] + bs[e], da = accd[j][2 * h + e];
        const float et = __expf(-2.f * fabsf(pt)), it = __fdividef(1.f, 1.f + et);
        const float th = copysignf((1.f - et) * it, pt), dth = 4.f * et * it * it;
        const float es = __expf(-fabsf(ps)), is = __fdividef(1.f, 1.f + es);
        const float sg = ps >= 0.f ? is : es * is, dsg = es * is * is;
        va_[e] = th * sg;
        dt[e] = da * sg * dth;
        ds[e] = da * th * dsg;
      }
      const size_t row = (size_t)b * T_out + t;
      *reinterpret_cast<uint32_t*>(act + row * HALF + col) = pack(va_[0], va_[1]);
      *reinterpret_cast<uint32_t*>(d_pre + row * 2 * HALF + col) = pack(dt[0], dt[1]);
      *reinterpret_cast<uint32_t*>(d_pre + row * 2 * HALF + HALF + col) = pack(ds[0], ds[1]);
    }
  }
}

template <int C, int HALF, int RS>
struct CfgA {
  static_assert(C % 16 == 0 && HALF % 16 == 0 && RS % 16 == 0 && RS > C, "mma path widths");
  static constexpr int KG_PAD = 2 * C + 8, RS_PAD = RS + 8;
  static constexpr size_t smem = sizeof(bf) * ((size_t)2 * HALF * KG_PAD + (size_t)HALF * RS_PAD);
};

template <int C, int HALF, int RS>
__global__ void __launch_bounds__(WARPS * 32, 1)
pass_a_kernel(const bf* __restrict__ x, const bf* __restrict__ w_t, const bf* __restrict__ w_s,
              const bf* __restrict__ b_t, const bf* __restrict__ b_s, const bf* __restrict__ w_rs,
              const bf* __restrict__ d_o, const bf* __restrict__ d_s, bf* __restrict__ d_pre, bf* __restrict__ act,
              int B, int T_in, int d, int skip_size) {
  using K = CfgA<C, HALF, RS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* wg = reinterpret_cast<bf*>(smem_raw);  // [2 HALF][KG_PAD]: gate, n-major (as the forward stages it)
  bf* wr = wg + 2 * HALF * K::KG_PAD;        // [HALF][RS_PAD]: Wrs as it lies, already n-major for d_rs Wrs^T

  constexpr int NG = HALF / 8, KG = 2 * C;
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * NG * KG; i += WARPS * 32) {
    const int k = i % KG, group = i / KG, branch = group / NG, n = (group - branch * NG) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(branch ? w_s : w_t) + k * NG + n / 8);
    const bf* e = reinterpret_cast<const bf*>(&v);
#pragma unroll
    for (int u = 0; u < 8; ++u) wg[(branch * HALF + n + u) * K::KG_PAD + k] = e[u];
  }
  for (int i = threadIdx.x; i < HALF * (RS / 8); i += WARPS * 32) {
    const int n = i / (RS / 8), v = i - n * (RS / 8);
    *reinterpret_cast<uint4*>(wr + n * K::RS_PAD + v * 8) = __ldg(reinterpret_cast<const uint4*>(w_rs) + i);
  }
  __syncthreads();

  const int T_out = T_in - d, tiles_per_row = (T_out + TT - 1) / TT, n_tiles = B * tiles_per_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float inv_std = __bfloat162float(__float2bfloat16_rn(0.70710678118654752f));
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row, t0 = (tile - b * tiles_per_row) * TT + warp * 16;
    if (t0 < T_out)
      pass_a_warp<C, HALF, RS>(wg, wr, x, b_t, b_s, d_o, d_s, d_pre, act, b, t0, T_in, d, skip_size, g, q, inv_std);
  }
}

template <int C, int HALF>
struct CfgB {
  static constexpr int KB = 4 * HALF, KB_PAD = KB + 8;
  static constexpr size_t smem = sizeof(bf) * (size_t)C * KB_PAD;
};

template <int C, int HALF>
__global__ void __launch_bounds__(WARPS * 32, 1)
pass_b_kernel(const bf* __restrict__ w_t, const bf* __restrict__ w_s, const bf* __restrict__ d_pre,
              const bf* __restrict__ d_o, bf* __restrict__ dx, int B, int T_in, int d) {
  using K = CfgB<C, HALF>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [C][KB_PAD]: row c holds Wt0[c] | Ws0[c] | Wt1[c] | Ws1[c] (each HALF wide), n-major for d_pre W^T
  bf* wb = reinterpret_cast<bf*>(smem_raw);
  for (int i = threadIdx.x; i < 4 * C * (HALF / 8); i += WARPS * 32) {
    const int seg = i % (HALF / 8), rest = i / (HALF / 8), c = rest % C, m = rest / C;  // m = 2 tap + branch
    const uint4* src = reinterpret_cast<const uint4*>((m & 1 ? w_s : w_t) + ((size_t)(m >> 1) * C + c) * HALF) + seg;
    *reinterpret_cast<uint4*>(wb + c * K::KB_PAD + m * HALF + seg * 8) = __ldg(src);
  }
  __syncthreads();

  constexpr int H2 = 2 * HALF, NTO = C / 8;
  const int T_out = T_in - d, tiles_per_row = (T_in + TT - 1) / TT, n_tiles = B * tiles_per_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const float inv_std = __bfloat162float(__float2bfloat16_rn(0.70710678118654752f));
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_row, r0 = (tile - b * tiles_per_row) * TT + warp * 16;
    if (r0 >= T_in) continue;
    const int ra = r0 + g, rb = ra + 8;
    const bf* dpb = d_pre + (size_t)b * T_out * H2;
    float acc[NTO][4];
#pragma unroll
    for (int j = 0; j < NTO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4 * HALF / 16; ++ks) {
      const bool cur = ks < H2 / 16;  // d_pre[r] (tap 0) or d_pre[r - d] (tap 1)
      const int k = (cur ? ks : ks - H2 / 16) * 16 + 2 * q;
      const int rowa = cur ? ra : ra - d, rowb = cur ? rb : rb - d;
      const bool va = cur ? ra < T_out : (ra >= d && ra < T_in);
      const bool vb = cur ? rb < T_out : (rb >= d && rb < T_in);
      const bf* pa = dpb + (size_t)rowa * H2 + k;
      const bf* pb = dpb + (size_t)rowb * H2 + k;
      const uint32_t a0 = va ? ld32(pa) : 0u, a1 = vb ? ld32(pb) : 0u;
      const uint32_t a2 = va ? ld32(pa + 8) : 0u, a3 = vb ? ld32(pb + 8) : 0u;
#pragma unroll
      for (int j = 0; j < NTO; ++j) {
        const bf* w = wb + (j * 8 + g) * K::KB_PAD + ks * 16 + 2 * q;
        mma_bf16(acc[j], a0, a1, a2, a3, ld32(w), ld32(w + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
      const int col = j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? rb : ra;
        if (r >= T_in) continue;
        float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
        if (r >= d) {
          const float2 o = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(d_o + ((size_t)b * T_out + r - d) * C + col));
          v0 += o.x * inv_std;
          v1 += o.y * inv_std;
        }
        *reinterpret_cast<uint32_t*>(dx + ((size_t)b * T_in + r) * C + col) = pack(v0, v1);
      }
    }
  }
}

template <int C, int HALF, int RS>
int launch(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
           const void* d_o, const void* d_s, void* d_pre, void* act, void* dx, int B, int T_in, int d, int skip_size,
           cudaStream_t stream) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pass_a_kernel<C, HALF, RS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)CfgA<C, HALF, RS>::smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(pass_b_kernel<C, HALF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)CfgB<C, HALF>::smem);
    if (err != cudaSuccess) {
      n_sm = 0;
      return (int)err;
    }
  }
  const int tiles_a = B * ((T_in - d + TT - 1) / TT), tiles_b = B * ((T_in + TT - 1) / TT);
  pass_a_kernel<C, HALF, RS><<<tiles_a < n_sm ? tiles_a : n_sm, WARPS * 32, CfgA<C, HALF, RS>::smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w_t), static_cast<const bf*>(w_s), static_cast<const bf*>(b_t),
      static_cast<const bf*>(b_s), static_cast<const bf*>(w_rs), static_cast<const bf*>(d_o),
      static_cast<const bf*>(d_s), static_cast<bf*>(d_pre), static_cast<bf*>(act), B, T_in, d, skip_size);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pass_b_kernel<C, HALF><<<tiles_b < n_sm ? tiles_b : n_sm, WARPS * 32, CfgB<C, HALF>::smem, stream>>>(
      static_cast<const bf*>(w_t), static_cast<const bf*>(w_s), static_cast<const bf*>(d_pre),
      static_cast<const bf*>(d_o), static_cast<bf*>(dx), B, T_in, d);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---- the warpgroup route: bf16 at C = half = R = S = 96 (the WaveNet run specs), with the skip -----------------
//
// Four launches a block, each a kernel of its own, on the warpgroup tile of wgmma_bf16.cuh (wgmma on 64-row tiles,
// f32 accumulators in registers, operands staged by cp.async in the core-matrix layout, results staged in shared
// memory and written 16 bytes a thread):
//   pass A   persistent, two warpgroups a CTA, the gate weights and W_rs^T resident in shared memory: a 64-row tile
//            of output rows recomputes the gate ([x[t] | x[t+d]] (64 x 192) times the gate weights (192 x 192))
//            and d_act = dO W_r^T sqrt(1/2) + dS W_s^T (the skip half only for tiles that reach the skip window),
//            and writes d_pre = [d_pre_t | d_pre_s] (B, L, 192) and act (B, L, 96) in bf16.
//   weight   split-K over the rows: CTA (s, y), one warpgroup, walks split s's contiguous range of 64-row chunks
//            with two chunks in flight and keeps in registers the f32 partial of rows 64 y .. 64 y + 63 of dW_gate =
//            [x[t] | x[t+d]]^T d_pre (192 x 192) and of dW_rs^T = [dO | dS]^T act (192 x 96) (both operands read
//            transposed from how they lie), and the column sums of d_pre's and [dO | dS]'s columns 64 y .. from
//            shared memory. The three CTAs of a split read its d_pre and act chunks each (through L2): one
//            warpgroup's two accumulators (144 registers a thread) leave no room for a second in a CTA (three
//            warpgroups sharing the chunks spilled and ran slower on the H100).
//   reduce   sums the partials in split order (no atomics: two runs give the same bits), scales dO's share by
//            sqrt(1/2), rounds once to bf16 and writes each gradient into its slot in flax layout.
// d_pre goes through device memory between A and B (row r needs row r - d of another tile) and feeds the weight
// gradients with act. What bounds it at the flagship shape: the bytes of pass A (it writes d_pre and act) and of the
// weight kernel (it reads them back), ~0.05 ms each a block (chip_smoke.wg_bwd_kernel_work); the whole block's
// operations ~0.05 ms (chip_smoke.residual_glu_bwd_work).
namespace wg {

using bf = __nv_bfloat16;
constexpr int C = 96, HALF = 96, RS = 2 * C, KG = 2 * C, H2 = 2 * HALF, KB = 2 * H2;
constexpr int TM = 64;                     // rows a warpgroup tile
constexpr int WGS = 2, THREADS = 128 * WGS;  // the persistent passes: two warpgroups a CTA

__device__ __forceinline__ float inv_std_bf16() { return __bfloat162float(__float2bfloat16_rn(0.70710678118654752f)); }

// The gate weights as B (K = [tap 0 c | tap 1 c], N = [tanh h | sigmoid h]), N-major: (2, C, HALF) each as it lies
__device__ __forceinline__ void stage_gate(bf* sw, const bf* w_t, const bf* w_s, int tid, int nthreads) {
  wgmma::load_tile<H2>(sw, KG, [&](int k, int col) { return (col < HALF ? w_t : w_s) + k * HALF + col % HALF; }, w_t,
                       tid, nthreads);
}

// ---- pass A ----
constexpr size_t SMEM_A = sizeof(bf) * ((size_t)KG * H2 + (size_t)RS * HALF + WGS * (size_t)TM * (KG + RS));

__global__ void __launch_bounds__(THREADS, 1)
pass_a_kernel(const bf* __restrict__ x, const bf* __restrict__ w_t, const bf* __restrict__ w_s,
              const bf* __restrict__ b_t, const bf* __restrict__ b_s, const bf* __restrict__ w_rs,
              const bf* __restrict__ d_o, const bf* __restrict__ d_s, bf* __restrict__ d_pre, bf* __restrict__ act,
              int B, int T_in, int d, int skip_size) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* sw = reinterpret_cast<bf*>(smem_raw);  // gate weights, B N-major [k 192][n 192]
  bf* swr = sw + KG * H2;                    // W_rs^T, B N-major [j 192][h 96]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  bf* sx = swr + RS * HALF + wg * TM * (KG + RS);  // this warpgroup's [x[t] | x[t+d]] tile, A K-major [64][192]
  bf* sd = sx + TM * KG;                           // its [dO | dS or 0] tile, A K-major [64][192]
  const int T_out = T_in - d, skip_start = T_out - skip_size, per_row = (T_out + TM - 1) / TM, n_tiles = B * per_row;
  const int n_workers = gridDim.x * WGS;
  const float inv_std = inv_std_bf16();

  auto load = [&](int tile) {
    const int b = tile / per_row, t0 = (tile - b * per_row) * TM;
    const bf* xb = x + (size_t)b * T_in * C;
    wgmma::load_tile<KG>(sx, TM, [&](int r, int col) -> const bf* {
      const int t = t0 + r;
      if (t >= T_out) return nullptr;
      return col < C ? xb + (size_t)t * C + col : xb + (size_t)(t + d) * C + (col - C);
    }, x, tid, 128);
    wgmma::load_tile<RS>(sd, TM, [&](int r, int col) -> const bf* {
      const int t = t0 + r;
      if (t >= T_out || (col >= C && t < skip_start)) return nullptr;
      return col < C ? d_o + ((size_t)b * T_out + t) * C + col : d_s + ((size_t)b * skip_size + (t - skip_start)) * C + (col - C);
    }, d_o, tid, 128);
    cp_async_commit();
  };

  stage_gate(sw, w_t, w_s, threadIdx.x, THREADS);
  cp_async_commit();
  for (int i = threadIdx.x; i < HALF * (RS / 8); i += THREADS) {  // W_rs (HALF, RS) transposed: element (j, h)
    const int h = i / (RS / 8), j0 = (i - h * (RS / 8)) * 8;
    wgmma::store_transposed<HALF>(swr, j0, h, __ldg(reinterpret_cast<const uint4*>(w_rs + (size_t)h * RS + j0)));
  }
  const int first = blockIdx.x * WGS + wg;
  if (first < n_tiles) load(first);
  cp_async_wait_all();
  wgmma::fence_async_smem();
  __syncthreads();

  for (int tile = first; tile < n_tiles; tile += n_workers) {
    const int b = tile / per_row, t0 = (tile - b * per_row) * TM;
    cp_async_wait_all();
    wgmma::fence_async_smem();
    wgmma::wg_sync(wg);  // the tile's rows landed for the whole warpgroup

    float acc[H2 / 2], accd[HALF / 2];
#pragma unroll
    for (int i = 0; i < H2 / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) accd[i] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int ks = 0; ks < KG / 16; ++ks)
      wgmma::mma_ss_n192<0, 1>(acc, wgmma::desc_k(sx, KG, ks), wgmma::desc_mn(sw, H2, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < C / 16; ++ks)
      wgmma::mma_ss_n96<0, 1>(accd, wgmma::desc_k(sd, RS, ks), wgmma::desc_mn(swr, HALF, ks), ks > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    wgmma::fence_operand(accd);
#pragma unroll
    for (int i = 0; i < HALF / 2; ++i) accd[i] *= inv_std;  // dO's share of d_act, then dS's adds on
    if (t0 + TM > skip_start) {
      wgmma::fence();
#pragma unroll
      for (int ks = C / 16; ks < RS / 16; ++ks)
        wgmma::mma_ss_n96<0, 1>(accd, wgmma::desc_k(sd, RS, ks), wgmma::desc_mn(swr, HALF, ks), 1);
      wgmma::commit();
      wgmma::wait<0>();
      wgmma::fence_operand(accd);
    }
    wgmma::wg_sync(wg);  // every warp's products are done with the tile buffers

    // d_pre and act (tanh and sigmoid from one __expf each, as the mma.sync path: 1 - tanh^2 = 4e / (1 + e)^2 and
    // sigmoid' = e / (1 + e)^2 keep their relative precision where they are small), staged in the tile buffers: d_pre
    // over x's, act over the first half of d_rs's; rows past T_out are staged but not stored.
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int col = j * 8 + 2 * q;
      const float bt[2] = {__bfloat162float(b_t[col]), __bfloat162float(b_t[col + 1])};
      const float bs[2] = {__bfloat162float(b_s[col]), __bfloat162float(b_s[col + 1])};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        float va[2], dt[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pt = acc[4 * j + 2 * h + e] + bt[e], ps = acc[4 * (j + HALF / 8) + 2 * h + e] + bs[e];
          const float da = accd[4 * j + 2 * h + e];
          const float et = __expf(-2.f * fabsf(pt)), it = __fdividef(1.f, 1.f + et);
          const float th = copysignf((1.f - et) * it, pt), dth = 4.f * et * it * it;
          const float es = __expf(-fabsf(ps)), is = __fdividef(1.f, 1.f + es);
          const float sg = ps >= 0.f ? is : es * is, dsg = es * is * is;
          va[e] = th * sg;
          dt[e] = da * sg * dth;
          ds[e] = da * th * dsg;
        }
        wgmma::put2<HALF>(sd, r, col, pack(va[0], va[1]));
        wgmma::put2<H2>(sx, r, col, pack(dt[0], dt[1]));
        wgmma::put2<H2>(sx, r, HALF + col, pack(ds[0], ds[1]));
      }
    }
    wgmma::wg_sync(wg);
    const size_t row0 = (size_t)b * T_out + t0;
    wgmma::store_tile<H2>(sx, TM, [&](int r, int col) { return t0 + r < T_out ? d_pre + (row0 + r) * H2 + col : nullptr; },
                          tid, 128);
    wgmma::store_tile<HALF>(sd, TM, [&](int r, int col) { return t0 + r < T_out ? act + (row0 + r) * HALF + col : nullptr; },
                            tid, 128);
    wgmma::wg_sync(wg);  // the staged outputs are out before the next tile's rows land over them
    if (tile + n_workers < n_tiles) load(tile + n_workers);
  }
}

// ---- the weight gradients' partials ----
constexpr int WT = 128;  // one warpgroup a CTA, two CTAs an SM
constexpr int SX = TM * 64, SP = TM * H2, SR = TM * 64, SA = TM * HALF, STAGE = SX + SP + SR + SA;  // elements
constexpr size_t SMEM_W = sizeof(bf) * 2 * (size_t)STAGE;
constexpr int PART = (H2 / 2 + HALF / 2) * WT + 128;  // floats a partial: the two accumulators, 128 column sums

__global__ void __launch_bounds__(WT, 2)
wgrad_kernel(const bf* __restrict__ x, const bf* __restrict__ d_o, const bf* __restrict__ d_s,
             const bf* __restrict__ d_pre, const bf* __restrict__ act, float* __restrict__ part, int B, int T_in,
             int d, int skip_size) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* stage0 = reinterpret_cast<bf*>(smem_raw);
  const int tid = threadIdx.x, y = blockIdx.y, s = blockIdx.x, n_split = gridDim.x;
  const int T_out = T_in - d, skip_start = T_out - skip_size, per_row = (T_out + TM - 1) / TM, n_chunks = B * per_row;
  const int per_split = (n_chunks + n_split - 1) / n_split, c_begin = s * per_split;
  const int c_end = min(n_chunks, c_begin + per_split);

  // chunk c's operands into stage buf: [x[t] | x[t+d]]'s and [dO | dS]'s columns 64 y .. 64 y + 63 (A, M-major), d_pre
  // and act (B, N-major); rows past T_out and dS above the skip window read as 0
  auto load = [&](int c, int buf) {
    const int b = c / per_row, t0 = (c - b * per_row) * TM;
    bf* sx = stage0 + buf * STAGE;
    const bf* xb = x + (size_t)b * T_in * C;
    wgmma::load_tile<64>(sx, TM, [&](int r, int col) -> const bf* {
      const int t = t0 + r, f = 64 * y + col;
      if (t >= T_out) return nullptr;
      return f < C ? xb + (size_t)t * C + f : xb + (size_t)(t + d) * C + (f - C);
    }, x, tid, WT);
    wgmma::load_tile<H2>(sx + SX, TM, [&](int r, int col) -> const bf* {
      const int t = t0 + r;
      return t < T_out ? d_pre + ((size_t)b * T_out + t) * H2 + col : nullptr;
    }, x, tid, WT);
    wgmma::load_tile<64>(sx + SX + SP, TM, [&](int r, int col) -> const bf* {
      const int t = t0 + r, j = 64 * y + col;
      if (t >= T_out || (j >= C && t < skip_start)) return nullptr;
      return j < C ? d_o + ((size_t)b * T_out + t) * C + j : d_s + ((size_t)b * skip_size + (t - skip_start)) * C + (j - C);
    }, x, tid, WT);
    wgmma::load_tile<HALF>(sx + SX + SP + SR, TM, [&](int r, int col) -> const bf* {
      const int t = t0 + r;
      return t < T_out ? act + ((size_t)b * T_out + t) * HALF + col : nullptr;
    }, x, tid, WT);
  };

  float acc_g[H2 / 2], acc_r[HALF / 2], cs[8];
#pragma unroll
  for (int i = 0; i < H2 / 2; ++i) acc_g[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc_r[i] = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) cs[u] = 0.f;
  // column sums: thread tid sums 8 columns (group cg) over 8 rows (group rg) of d_pre's columns 64 y .. (op 0) or of
  // [dO | dS]'s (op 1), a row at a time in an order rotated by cg so that eight threads read eight bank groups
  const int op = tid >> 6, cg = tid & 7, rg = (tid >> 3) & 7;

  if (c_begin < c_end) load(c_begin, 0);
  cp_async_commit();
  for (int c = c_begin, buf = 0; c < c_end; ++c, buf ^= 1) {
    if (c + 1 < c_end) load(c + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    wgmma::fence_async_smem();
    __syncthreads();
    const bf* sx = stage0 + buf * STAGE;
    const bf *sp = sx + SX, *sr = sp + SP, *sa = sr + SR;
    wgmma::fence();
#pragma unroll
    for (int ks = 0; ks < TM / 16; ++ks) {
      wgmma::mma_ss_n192<1, 1>(acc_g, wgmma::desc_mn(sx, 64, ks), wgmma::desc_mn(sp, H2, ks), 1);
      wgmma::mma_ss_n96<1, 1>(acc_r, wgmma::desc_mn(sr, 64, ks), wgmma::desc_mn(sa, HALF, ks), 1);
    }
    wgmma::commit();
    const char* src = op ? reinterpret_cast<const char*>(sr) : reinterpret_cast<const char*>(sp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * rg + ((i + cg) & 7);
      const uint4 v = *reinterpret_cast<const uint4*>(src + (op ? wgmma::offset(r, 8 * cg, 64)
                                                              : wgmma::offset(r, 64 * y + 8 * cg, H2)));
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(e[u]);
        cs[2 * u] += f.x;
        cs[2 * u + 1] += f.y;
      }
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc_g);
    wgmma::fence_operand(acc_r);
    __syncthreads();  // every thread is done with this stage before the next chunk's copies overwrite it
  }
  cp_async_wait_all();

  float* out = part + ((size_t)s * gridDim.y + y) * PART;
#pragma unroll
  for (int i = 0; i < H2 / 2; ++i) out[i * WT + tid] = acc_g[i];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) out[(H2 / 2 + i) * WT + tid] = acc_r[i];
  float* red = reinterpret_cast<float*>(smem_raw);  // [op][rg][64 columns]
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 8; ++u) red[(op * 8 + rg) * 64 + 8 * cg + u] = cs[u];
  __syncthreads();
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) sum += red[(op * 8 + k) * 64 + (tid & 63)];
  out[(H2 / 2 + HALF / 2) * WT + tid] = sum;
}

// ---- the fixed-order reduction into the gradients' slots ----
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part, bf* __restrict__ d_w_t, bf* __restrict__ d_w_s, bf* __restrict__ d_b_t,
              bf* __restrict__ d_b_s, bf* __restrict__ d_w_rs, bf* __restrict__ d_b_rs, int n_split) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 3 * PART) return;
  const int y = idx / PART, i = idx - y * PART;
  float sum = 0.f;
  for (int s = 0; s < n_split; ++s) sum += part[((size_t)s * 3 + y) * PART + i];
  const float inv_std = inv_std_bf16();
  if (i < (H2 / 2 + HALF / 2) * WT) {
    // accumulator element ri of thread t: row m = 16 warp + g + 8 (e / 2), column n = 8 j + 2 q + e % 2
    const int ri = i / WT, t = i - ri * WT, gate = ri < H2 / 2, r2 = gate ? ri : ri - H2 / 2;
    const int lane = t & 31, m = 16 * (t >> 5) + (lane >> 2) + 8 * ((r2 & 3) >> 1), n = 8 * (r2 >> 2) + 2 * (lane & 3) + (r2 & 1);
    const int f = 64 * y + m;  // the row of dW_gate (a [x[t] | x[t+d]] feature) or of dW_rs^T (a [dO | dS] column)
    if (gate) {
      const int tap = f / C, c = f - tap * C, branch = n / HALF, h = n - branch * HALF;
      (branch ? d_w_s : d_w_t)[((size_t)tap * C + c) * HALF + h] = __float2bfloat16_rn(sum);
    } else {
      d_w_rs[(size_t)n * RS + f] = __float2bfloat16_rn(f < C ? sum * inv_std : sum);
    }
  } else {
    const int k = i - (H2 / 2 + HALF / 2) * WT, col = 64 * y + (k & 63);
    if (k < 64)
      (col < HALF ? d_b_t : d_b_s)[col % HALF] = __float2bfloat16_rn(sum);
    else
      d_b_rs[col] = __float2bfloat16_rn(col < C ? sum * inv_std : sum);
  }
}

// ---- pass B ----
constexpr size_t SMEM_B = sizeof(bf) * ((size_t)KB * C + WGS * (size_t)TM * (KB + C));

__global__ void __launch_bounds__(THREADS, 1)
pass_b_kernel(const bf* __restrict__ w_t, const bf* __restrict__ w_s, const bf* __restrict__ d_pre,
              const bf* __restrict__ d_o, bf* __restrict__ dx, int B, int T_in, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* swb = reinterpret_cast<bf*>(smem_raw);  // [Wt0 | Ws0 | Wt1 | Ws1]^T as B N-major [k 384][c 96]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2,
            q = lane & 3;
  bf* sdp = swb + KB * C + wg * TM * (KB + C);  // this warpgroup's [d_pre[r] | d_pre[r - d]] tile, A K-major [64][384]
  bf* so = sdp + TM * KB;                       // its dO[r - d] rows [64][96]
  const int T_out = T_in - d, per_row = (T_in + TM - 1) / TM, n_tiles = B * per_row, n_workers = gridDim.x * WGS;
  const float inv_std = inv_std_bf16();

  auto load = [&](int tile) {
    const int b = tile / per_row, r0 = (tile - b * per_row) * TM;
    const bf* dpb = d_pre + (size_t)b * T_out * H2;
    wgmma::load_tile<KB>(sdp, TM, [&](int rr, int col) -> const bf* {
      const int r = r0 + rr, src = col < H2 ? r : r - d;  // tap 0 reads d_pre[r], tap 1 d_pre[r - d]
      if (r >= T_in || src < 0 || src >= T_out) return nullptr;
      return dpb + (size_t)src * H2 + col % H2;
    }, d_pre, tid, 128);
    wgmma::load_tile<C>(so, TM, [&](int rr, int col) -> const bf* {
      const int r = r0 + rr;
      return r < T_in && r >= d ? d_o + ((size_t)b * T_out + r - d) * C + col : nullptr;
    }, d_pre, tid, 128);
    cp_async_commit();
  };

  // k = 192 tap + 96 branch + h, n = c: W_{tap, branch}[c][h], each (2, C, HALF) kernel transposed
  for (int i = threadIdx.x; i < 4 * C * (HALF / 8); i += THREADS) {
    const int h0 = (i % (HALF / 8)) * 8, rest = i / (HALF / 8), c = rest % C, m = rest / C, tap = m >> 1;
    const bf* src = (m & 1 ? w_s : w_t) + ((size_t)tap * C + c) * HALF + h0;
    wgmma::store_transposed<C>(swb, m * HALF + h0, c, __ldg(reinterpret_cast<const uint4*>(src)));
  }
  const int first = blockIdx.x * WGS + wg;
  if (first < n_tiles) load(first);
  cp_async_wait_all();
  wgmma::fence_async_smem();
  __syncthreads();

  for (int tile = first; tile < n_tiles; tile += n_workers) {
    const int b = tile / per_row, r0 = (tile - b * per_row) * TM;
    cp_async_wait_all();
    wgmma::fence_async_smem();
    wgmma::wg_sync(wg);
    float acc[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
    wgmma::fence();
#pragma unroll
    for (int ks = 0; ks < KB / 16; ++ks)
      wgmma::mma_ss_n96<0, 1>(acc, wgmma::desc_k(sdp, KB, ks), wgmma::desc_mn(swb, C, ks), ks > 0);
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    wgmma::wg_sync(wg);
    // dx = acc + dO[r - d] sqrt(1/2) (0 where r < d: its rows read as 0), staged over the d_pre tile, then out
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float2 o = wgmma::get2<C>(so, r, col);
        wgmma::put2<C>(sdp, r, col, pack(acc[4 * j + 2 * h] + o.x * inv_std, acc[4 * j + 2 * h + 1] + o.y * inv_std));
      }
    }
    wgmma::wg_sync(wg);
    wgmma::store_tile<C>(sdp, TM, [&](int r, int col) {
      return r0 + r < T_in ? dx + ((size_t)b * T_in + r0 + r) * C + col : nullptr;
    }, tid, 128);
    wgmma::wg_sync(wg);
    if (tile + n_workers < n_tiles) load(tile + n_workers);
  }
}

// the SM count and the shared-memory opt-ins, asked once per process (the card does not change under it)
int n_sm() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(pass_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_A);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_W);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(pass_b_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_B);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return -(int)err;
    }
    sms = v;
  }
  return sms;
}

}  // namespace wg
}  // namespace
}  // namespace blvm

// Limits the Python wrapper enforces before it calls in (returns cudaErrorInvalidValue otherwise): f32 at
// C = half = R = 256 with S = 256 or 0 (the tiled path), or half <= 128 and R + S <= 256. S = 0 is the
// skip-free mode: d_s and skip_size are not used, and rs_ld (the rs kernel's row width) may exceed R.
// d_pre (B, T_in - d, 2 half) and act (B, T_in - d, half) are scratch outputs the wrapper keeps for
// the weight gradients; dx is (B, T_in, C). All in x's dtype.
extern "C" int blvm_residual_glu_bwd(const void* x, const void* w_t, const void* w_s, const void* b_t,
                                     const void* b_s, const void* w_rs, const void* d_o, const void* d_s,
                                     void* d_pre, void* act, void* dx, int B, int T_in, int C, int half, int R, int S,
                                     int rs_ld, int dilation, int skip_size, int dtype, void* stream) {
  using namespace blvm;
  if (R != C || S < 0 || rs_ld < R + S || (S > 0 && rs_ld != R + S) || dilation < 1 || T_in - dilation < 1 ||
      (S > 0 && (skip_size < 1 || skip_size > T_in - dilation)) || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the register-tiled path: f32 at STCN's width, 16-byte aligned rows and weights
  const bool aligned16 = ((uintptr_t)x | (uintptr_t)w_t | (uintptr_t)w_s | (uintptr_t)b_t | (uintptr_t)b_s |
                          (uintptr_t)w_rs | (uintptr_t)d_o | (uintptr_t)d_s | (uintptr_t)d_pre | (uintptr_t)act |
                          (uintptr_t)dx | (uintptr_t)(rs_ld * sizeof(float))) % 16 == 0;
  if (C == tiled::C && half == tiled::HALF) {
    if (dtype != kFloat32 || !aligned16 || (S != 0 && S != tiled::C)) return (int)cudaErrorInvalidValue;
    if (S == 0)
      return tiled::launch<tiled::C>(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx, B, T_in, rs_ld, dilation,
                                     skip_size, st);
    return tiled::launch<2 * tiled::C>(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx, B, T_in, rs_ld,
                                       dilation, skip_size, st);
  }
  if (C > MAX_C || half > 32 * MAX_GATE_COLS || R + S > MAX_RS) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float>(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx, B, T_in, C, half, R, S, rs_ld,
                         dilation, skip_size, st);
  // the tensor-core path reads 4-byte bf16 pairs and stages the weights with 16-byte loads
  const bool aligned = ((uintptr_t)x | (uintptr_t)d_o | (uintptr_t)d_s | (uintptr_t)d_pre | (uintptr_t)act |
                        (uintptr_t)dx) % 4 == 0 &&
                       ((uintptr_t)w_t | (uintptr_t)w_s | (uintptr_t)w_rs) % 16 == 0;
  if (dtype == kBFloat16 && aligned && C == 32 && half == 32 && S == 32)
    return mma::launch<32, 32, 64>(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx, B, T_in, dilation,
                                   skip_size, st);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, w_t, w_s, b_t, b_s, w_rs, d_o, d_s, d_pre, act, dx, B, T_in, C, half, R, S,
                                 rs_ld, dilation, skip_size, st);
  return (int)cudaErrorInvalidValue;
}

// ---- the warpgroup route (namespace wg): bf16 at C = half = R = S = 96 with the skip, one entry a kernel ----------
// Shapes: x (B, T_in, 96), w_t and w_s (2, 96, 96), b_t and b_s (96), w_rs (96, 192), d_o (B, T_in - d, 96),
// d_s (B, skip_size, 96), d_pre (B, T_in - d, 192), act (B, T_in - d, 96), dx (B, T_in, 96); part n_split x 3 x
// 18560 floats (the weight kernel's partials: n_split CTAs for each of its 3 row blocks); the gradient slots d_w_t,
// d_w_s (2, 96, 96), d_b_t, d_b_s (96), d_w_rs (96, 192), d_b_rs (192), each contiguous (one block's slot of the
// stack's (L, ...) tensors). All bf16 but part; every pointer but the biases 16-byte aligned. Each returns
// cudaErrorInvalidValue for what it does not take, else the launch's cudaError_t.
namespace {
int wg_geometry_ok(int B, int T_in, int dilation, int skip_size) {
  return B >= 1 && B <= 65535 && dilation >= 1 && T_in - dilation >= 1 && skip_size >= 1 && skip_size <= T_in - dilation;
}
int wg_aligned(const void* a, const void* b, const void* c, const void* d, const void* e = nullptr,
               const void* f = nullptr, const void* g = nullptr, const void* h = nullptr) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d | (uintptr_t)e | (uintptr_t)f | (uintptr_t)g |
           (uintptr_t)h) % 16) == 0;
}
}  // namespace

// pass A: d_pre and act from x, the weights, dO and dS
extern "C" int blvm_glu_bwd_pass_a(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s,
                                   const void* w_rs, const void* d_o, const void* d_s, void* d_pre, void* act, int B,
                                   int T_in, int dilation, int skip_size, void* stream) {
  using namespace blvm::wg;
  if (!wg_geometry_ok(B, T_in, dilation, skip_size) || !wg_aligned(x, w_t, w_s, w_rs, d_o, d_s, d_pre, act))
    return (int)cudaErrorInvalidValue;
  const int sms = n_sm();
  if (sms < 0) return -sms;
  const int tiles = B * ((T_in - dilation + TM - 1) / TM), want = (tiles + WGS - 1) / WGS, grid = want < sms ? want : sms;
  pass_a_kernel<<<grid, THREADS, SMEM_A, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w_t), static_cast<const bf*>(w_s), static_cast<const bf*>(b_t),
      static_cast<const bf*>(b_s), static_cast<const bf*>(w_rs), static_cast<const bf*>(d_o),
      static_cast<const bf*>(d_s), static_cast<bf*>(d_pre), static_cast<bf*>(act), B, T_in, dilation, skip_size);
  return (int)cudaGetLastError();
}

// the weight gradients' f32 partials: n_split CTAs over the rows times the gradients' 3 row blocks
extern "C" int blvm_glu_bwd_wgrad(const void* x, const void* d_o, const void* d_s, const void* d_pre, const void* act,
                                  void* part, int B, int T_in, int dilation, int skip_size, int n_split, void* stream) {
  using namespace blvm::wg;
  if (!wg_geometry_ok(B, T_in, dilation, skip_size) || n_split < 1 || n_split > 65535 ||
      !wg_aligned(x, d_o, d_s, d_pre, act, part))
    return (int)cudaErrorInvalidValue;
  const int sms = n_sm();
  if (sms < 0) return -sms;
  wgrad_kernel<<<dim3(n_split, 3), WT, SMEM_W, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(d_o), static_cast<const bf*>(d_s),
      static_cast<const bf*>(d_pre), static_cast<const bf*>(act), static_cast<float*>(part), B, T_in, dilation,
      skip_size);
  return (int)cudaGetLastError();
}

// the partials summed in split order, scaled, rounded once and written into the block's gradient slots
extern "C" int blvm_glu_bwd_reduce(const void* part, void* d_w_t, void* d_w_s, void* d_b_t, void* d_b_s, void* d_w_rs,
                                   void* d_b_rs, int n_split, void* stream) {
  using namespace blvm::wg;
  if (n_split < 1 || !wg_aligned(part, d_w_t, d_w_s, d_w_rs)) return (int)cudaErrorInvalidValue;
  reduce_kernel<<<(3 * PART + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<bf*>(d_w_t), static_cast<bf*>(d_w_s), static_cast<bf*>(d_b_t),
      static_cast<bf*>(d_b_s), static_cast<bf*>(d_w_rs), static_cast<bf*>(d_b_rs), n_split);
  return (int)cudaGetLastError();
}

// pass B: dx from d_pre, the gate weights and dO
extern "C" int blvm_glu_bwd_pass_b(const void* w_t, const void* w_s, const void* d_pre, const void* d_o, void* dx,
                                   int B, int T_in, int dilation, void* stream) {
  using namespace blvm::wg;
  if (!wg_geometry_ok(B, T_in, dilation, 1) || !wg_aligned(w_t, w_s, d_pre, d_o, dx)) return (int)cudaErrorInvalidValue;
  const int sms = n_sm();
  if (sms < 0) return -sms;
  const int tiles = B * ((T_in + TM - 1) / TM), want = (tiles + WGS - 1) / WGS, grid = want < sms ? want : sms;
  pass_b_kernel<<<grid, THREADS, SMEM_B, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(w_t), static_cast<const bf*>(w_s), static_cast<const bf*>(d_pre),
      static_cast<const bf*>(d_o), static_cast<bf*>(dx), B, T_in, dilation);
  return (int)cudaGetLastError();
}
