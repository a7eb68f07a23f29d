// K1: fused WaveNet residual-GLU block, forward, for Hopper (sm_90a).
//
// Replaces the TPU path blvm_tpu/models/wavenet/modules.py Conv1dResidualGLU.__call__
// (k=2, need_skip True or False), i.e. the block the cut Pallas kernel
// blvm_tpu/ops/pallas/wavenet_block.py:_forward_kernel (commit 1788a18^) computed:
//
//   pre_t[t] = x[t] Wt0 + x[t+d] Wt1 + bt       pre_s[t] = x[t] Ws0 + x[t+d] Ws1 + bs
//   act[t]   = tanh(pre_t[t]) * sigmoid(pre_s[t])
//   rs[t]    = act[t] Wrs + brs = [r | s]
//   o[t]     = (r[t] + x[t+d]) * sqrt(1/2)      s kept for the last skip_size output rows
//
// What bounds it on an H100: at the flagship width (C = half = R = S = 96) a block does
// 2 * (4*C*half + half*(R+S)) = 110.6 kFLOP per output row against 3*C*2 = 576 bytes of
// compulsory traffic in bf16 (x read once, o and s written once), ~192 FLOP/byte: below the
// bf16 tensor-core ridge (~295 FLOP/byte) but far above the CUDA-core f32 FMA ridge
// (~20 FLOP/byte). Both paths below remove the traffic of the plain version: the gate
// pre-activations, the gated activation and the joint [r | s] output never reach device memory
// (the plain version writes and re-reads each, ~10 tensors of (B, T, 96) per block).
// The bf16 path at the instantiated widths (namespace mma, below) runs on the tensor cores; with
// 16 rows a warp, every warp re-reads the block's weights from shared memory for each tile,
// so shared-memory bandwidth and MMA issue bound it. wgmma, TMA staging and fusing the
// 50-block stack are later work. At STCN's f32 width (C = half = 256, R + S = 512) a block does
// 2 (4 C half + half (R + S)) = 786 kFLOP per output row against 4 (C + R + S) = 3 KB of traffic,
// ~256 FLOP/byte: far above the f32 ridge, so the FMA path below is bound by FMA issue and the
// shared-memory loads that feed it (67 TFLOP/s of f32 FMA is its ceiling).
//
// FMA path (f32, and bf16 at other widths): f32 FMAs on the CUDA cores fed from shared memory,
// bound by shared-memory loads and FMA issue. One thread block per (time tile of TT output
// rows, batch row). The TT rows of
// x[t] and x[t+d] are staged in shared memory as f32; gate weights are streamed through
// shared memory in chunks of KC input channels (so f32 weights, 221 KB at C=96, never have to
// fit at once); the activation tile stays in shared memory for the 1x1 [r | s] product.
// Each of the 8 warps owns 4 output rows; lane l owns columns l, l+32, l+64, ...
// Accumulation is f32 throughout; the compute dtype (f32 or bf16) is only the storage type
// of x, weights and outputs, which are rounded once at the store.
//
// The accumulator widths are template arguments, instantiated for the widths the port runs: the
// WaveNet flagship (half <= 128, R + S <= 256: 4 and 8 columns a lane) keeps its registers, and
// STCN's C = half = 256 (R + S = 512 with the skip, 256 without) takes 8 and 16 (or 8 and 8).
// At STCN's widest shape the shared memory is 4 (2 TT C + TT half + 4 KC half) = 229,376 bytes of
// the H100's 232,448-byte opt-in limit.
//
// Skip-free mode (S = 0, need_skip=False in the JAX block, which STCN sets for the blocks whose
// skip it never reads): only the R residual columns of rs_kernel are contracted (its rows are
// rs_ld = R + S_full wide), as JAX contracts rs_kernel[0, :, :R], and no skip is written.

#include "common.cuh"
#include "fma_tile.cuh"
#include "mma_bf16.cuh"
#include "residual_glu_mma.cuh"

namespace blvm {
namespace {

constexpr int TT = 32;              // output rows per thread block
constexpr int KC = 32;              // input channels per staged weight chunk
constexpr int THREADS = 256;        // 8 warps
constexpr int ROWS = TT / (THREADS / 32);  // output rows per warp (4)
constexpr int MAX_C = 256;
constexpr int MAX_HALF = 256;       // 32 x the widest instantiation's gate columns a lane
constexpr int MAX_RS = 512;         // 32 x its [r | s] columns a lane

size_t smem_bytes(int C, int half, int RS) {
  size_t w = 4 * KC * half > KC * RS ? 4 * KC * half : KC * RS;
  return sizeof(float) * (2 * (size_t)TT * C + (size_t)TT * half + w);
}

template <typename T, int MAX_GATE_COLS, int MAX_RS_COLS>
__global__ void __launch_bounds__(THREADS)
residual_glu_kernel(const T* __restrict__ x, const T* __restrict__ w_t, const T* __restrict__ w_s,
                    const T* __restrict__ b_t, const T* __restrict__ b_s, const T* __restrict__ w_rs,
                    const T* __restrict__ b_rs, T* __restrict__ o, T* __restrict__ s, int T_in, int C,
                    int half, int R, int S, int rs_ld, int d, int skip_size) {
  extern __shared__ float smem[];
  const int RS = R + S;
  float* x_old = smem;                   // [TT][C]  x[t]
  float* x_cur = x_old + TT * C;         // [TT][C]  x[t+d]
  float* act = x_cur + TT * C;           // [TT][half]
  float* w = act + TT * half;            // gate chunk [4][KC][half] or rs chunk [KC][RS]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int T_out = T_in - d;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * ROWS;
  const T* xb = x + (size_t)b * T_in * C;

  for (int i = threadIdx.x; i < TT * C; i += THREADS) {
    const int r = i / C, c = i - r * C, t = t0 + r;
    float vo = 0.f, vc = 0.f;
    if (t < T_out) {
      vo = to_f32(xb[(size_t)t * C + c]);
      vc = to_f32(xb[(size_t)(t + d) * C + c]);
    }
    x_old[i] = vo;
    x_cur[i] = vc;
  }

  // ---- gate: two k=2 dilated convs (tanh and sigmoid branches) --------------------------
  float acc_t[ROWS][MAX_GATE_COLS], acc_s[ROWS][MAX_GATE_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < MAX_GATE_COLS; ++j) acc_t[i][j] = acc_s[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += KC) {
    const int kc = min(KC, C - k0);
    __syncthreads();  // x tiles written / previous chunk consumed
    for (int i = threadIdx.x; i < 4 * kc * half; i += THREADS) {
      const int m = i / (kc * half), rem = i - m * kc * half, k = rem / half, c = rem - k * half;
      // m: 0 = tanh tap 0, 1 = tanh tap 1, 2 = sigmoid tap 0, 3 = sigmoid tap 1; weights (2, C, half)
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
#pragma unroll
  for (int j = 0; j < MAX_GATE_COLS; ++j) {
    const int col = lane + 32 * j;
    if (col < half) {
      const float bt = to_f32(b_t[col]), bs = to_f32(b_s[col]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        act[(row0 + i) * half + col] = tanhf(acc_t[i][j] + bt) * sigmoidf(acc_s[i][j] + bs);
    }
  }

  // ---- 1x1 conv to [r | s] ------------------------------------------------------------------
  float acc[ROWS][MAX_RS_COLS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < MAX_RS_COLS; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < half; k0 += KC) {
    const int kc = min(KC, half - k0);
    __syncthreads();  // act written / previous chunk consumed
    for (int i = threadIdx.x; i < kc * RS; i += THREADS) {
      const int k = i / RS, c = i - k * RS;
      w[k * RS + c] = to_f32(w_rs[(size_t)(k0 + k) * rs_ld + c]);  // rs kernel (1, half, rs_ld), its RS first columns
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      float a[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = act[(row0 + i) * half + k0 + k];
#pragma unroll
      for (int j = 0; j < MAX_RS_COLS; ++j) {
        const int col = lane + 32 * j;
        if (col < RS) {
          const float wv = w[k * RS + col];
#pragma unroll
          for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
        }
      }
    }
  }

  // ---- epilogue: residual add and the skip rows -------------------------------------------
  // sqrt(1/2) in the compute dtype, as the JAX block multiplies by it (a weakly typed constant
  // takes the dtype of (r + x): 0.70703125 in bf16).
  const float inv_std = to_f32(from_f32<T>(0.70710678118654752f));
  const int skip_start = T_out - skip_size;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + i, t = t0 + r;
    if (t >= T_out) continue;
#pragma unroll
    for (int j = 0; j < MAX_RS_COLS; ++j) {
      const int col = lane + 32 * j;
      if (col >= RS) continue;
      const float v = acc[i][j] + to_f32(b_rs[col]);
      if (col < R) {
        o[((size_t)b * T_out + t) * R + col] = from_f32<T>((v + x_cur[r * C + col]) * inv_std);
      } else if (t >= skip_start) {
        s[((size_t)b * skip_size + (t - skip_start)) * S + (col - R)] = from_f32<T>(v);
      }
    }
  }
}

template <typename T, int GATE_COLS, int RS_COLS>
int launch(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
           const void* b_rs, void* o, void* s, int B, int T_in, int C, int half, int R, int S, int rs_ld, int d,
           int skip_size, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, half, R + S);
  cudaError_t err = cudaFuncSetAttribute(residual_glu_kernel<T, GATE_COLS, RS_COLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int T_out = T_in - d;
  dim3 grid((T_out + TT - 1) / TT, B);
  residual_glu_kernel<T, GATE_COLS, RS_COLS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w_t), static_cast<const T*>(w_s),
      static_cast<const T*>(b_t), static_cast<const T*>(b_s), static_cast<const T*>(w_rs),
      static_cast<const T*>(b_rs), static_cast<T*>(o), static_cast<T*>(s), T_in, C, half, R, S, rs_ld, d, skip_size);
  return (int)cudaGetLastError();
}

// the narrowest instantiation whose accumulators hold (half, R + S)
template <typename T>
int launch_fma(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
               const void* b_rs, void* o, void* s, int B, int T_in, int C, int half, int R, int S, int rs_ld, int d,
               int skip_size, cudaStream_t stream) {
  if (half <= 128 && R + S <= 256)
    return launch<T, 4, 8>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, C, half, R, S, rs_ld, d, skip_size, stream);
  if (R + S <= 256)
    return launch<T, 8, 8>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, C, half, R, S, rs_ld, d, skip_size, stream);
  return launch<T, 8, 16>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, C, half, R, S, rs_ld, d, skip_size, stream);
}


// ---- register-tiled f32 path: STCN's width -------------------------------------------------------
//
// f32 at C = half = 256 (STCN's blocks, with the skip, R + S = 512, or skip-free, R = 256): the two
// products as register-tiled FMA GEMMs. The FMA path above reloads a weight from shared memory for every
// 4 multiply-adds and is bound by shared-memory loads; here each thread owns 8 rows x 4 units, the tanh
// and sigmoid columns of the same units (so the gate is computed in its registers), and takes each k step
// as 2 broadcast row loads and 2 weight loads of 16 bytes for 64 multiply-adds: FMA-bound. A thread block
// holds 32 rows of x[t] and x[t+d] (f32, 64 KB) and streams the weights through two 32 KB buffers of 16 k
// rows by cp.async, the next chunk landing while the current one is multiplied; the gated activation
// replaces x[t] in shared memory for the [r | s] product, whose epilogue adds x[t+d] and stores 16 bytes a
// thread. The sums run over all 2C gate inputs in one accumulator (the twin sums the two taps apart): the
// FMA order against cuBLAS's, as on the FMA path.
namespace tiled {

constexpr int C = 256, HALF = 256;
constexpr int TM = 32;        // output rows a thread block
constexpr int THREADS = 256;  // 4 row groups x 64 unit groups
constexpr int KC = 16;        // k rows a staged weight chunk
constexpr int RM = 8, UN = 4;  // rows and units a thread
constexpr int WCOLS = 2 * HALF;  // a staged weight row: [tanh | sigmoid] or [r | s]
constexpr size_t SMEM = sizeof(float) * (2 * TM * C + 2 * KC * WCOLS);

template <int RS>  // R + S: 512 with the skip, 256 skip-free
__global__ void __launch_bounds__(THREADS, 1)
residual_glu_tiled_kernel(const float* __restrict__ x, const float* __restrict__ w_t, const float* __restrict__ w_s,
                          const float* __restrict__ b_t, const float* __restrict__ b_s, const float* __restrict__ w_rs,
                          const float* __restrict__ b_rs, float* __restrict__ o, float* __restrict__ s, int T_in,
                          int rs_ld, int d, int skip_size) {
  extern __shared__ __align__(16) float sm[];
  float* xo = sm;             // [TM][C] x[t]; then the gated activation [TM][HALF]
  float* xc = xo + TM * C;    // [TM][C] x[t+d]
  float* wbuf = xc + TM * C;  // 2 x [KC][WCOLS]
  constexpr bool SKIP = RS > C;
  const int b = blockIdx.y, t0 = blockIdx.x * TM, T_out = T_in - d;
  const int ug = threadIdx.x & 63, r0 = (threadIdx.x >> 6) * RM, u0 = ug * UN;
  const float* xb = x + (size_t)b * T_in * C;

  for (int i = threadIdx.x; i < TM * (C / 4); i += THREADS) {  // rows past T_out read as 0
    const int r = i / (C / 4), v = 4 * (i % (C / 4)), t = t0 + r;
    const bool valid = t < T_out;
    cp_async16(xo + r * C + v, xb + (valid ? (size_t)t * C + v : 0), valid);
    cp_async16(xc + r * C + v, xb + (valid ? (size_t)(t + d) * C + v : 0), valid);
  }
  // chunk k0 of the gate weights' 2C rows [tap 0 ; tap 1], each [tanh | sigmoid], into buffer buf
  auto stage_gate = [&](int k0, int buf) {
    float* dst = wbuf + buf * KC * WCOLS;
    for (int i = threadIdx.x; i < KC * (WCOLS / 4); i += THREADS) {
      const int r = i / (WCOLS / 4), col = 4 * (i % (WCOLS / 4)), k = k0 + r;
      cp_async16(dst + r * WCOLS + col, (col < HALF ? w_t : w_s) + (size_t)k * HALF + col % HALF, true);
    }
    cp_async_commit();
  };
  // chunk k0 of the rs kernel's HALF rows, its first RS columns (rows rs_ld wide)
  auto stage_rs = [&](int k0, int buf) {
    float* dst = wbuf + buf * KC * WCOLS;
    for (int i = threadIdx.x; i < KC * (RS / 4); i += THREADS) {
      const int r = i / (RS / 4), col = 4 * (i % (RS / 4));
      cp_async16(dst + r * WCOLS + col, w_rs + (size_t)(k0 + r) * rs_ld + col, true);
    }
    cp_async_commit();
  };

  // ---- gate: [x[t] | x[t+d]] (TM x 2C) times [W_t | W_s] (2C x 2 HALF) ----------------------------------
  float acc_t[RM][UN], acc_s[RM][UN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < UN; ++j) acc_t[i][j] = acc_s[i][j] = 0.f;
  constexpr int NG = 2 * C / KC;
  stage_gate(0, 0);  // with the x tiles: one group
  for (int ci = 0; ci < NG; ++ci) {
    if (ci + 1 < NG) {
      stage_gate((ci + 1) * KC, (ci + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    const int k0 = ci * KC;
    fma_tile::chunk<KC, RM, WCOLS, HALF, true>(k0 < C ? xo : xc, C, k0 % C, wbuf + (ci & 1) * KC * WCOLS, r0, u0,
                                                acc_t, acc_s);
    __syncthreads();  // every thread is done with this buffer (and, after the last chunk, with x[t])
  }
  stage_rs(0, 0);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float4 a;
    a.x = tanhf(acc_t[i][0] + b_t[u0]) * sigmoidf(acc_s[i][0] + b_s[u0]);
    a.y = tanhf(acc_t[i][1] + b_t[u0 + 1]) * sigmoidf(acc_s[i][1] + b_s[u0 + 1]);
    a.z = tanhf(acc_t[i][2] + b_t[u0 + 2]) * sigmoidf(acc_s[i][2] + b_s[u0 + 2]);
    a.w = tanhf(acc_t[i][3] + b_t[u0 + 3]) * sigmoidf(acc_s[i][3] + b_s[u0 + 3]);
    *reinterpret_cast<float4*>(xo + (r0 + i) * HALF + u0) = a;
  }

  // ---- [r | s] = act (TM x HALF) W_rs (HALF x RS) --------------------------------------------------------
  float acc_r[RM][UN], acc_k[RM][UN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < UN; ++j) acc_r[i][j] = acc_k[i][j] = 0.f;
  constexpr int NR = HALF / KC;
  for (int ci = 0; ci < NR; ++ci) {
    if (ci + 1 < NR) {
      stage_rs((ci + 1) * KC, (ci + 1) & 1);
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();  // (the first time: the activation written too)
    fma_tile::chunk<KC, RM, WCOLS, HALF, SKIP>(xo, HALF, ci * KC, wbuf + (ci & 1) * KC * WCOLS, r0, u0, acc_r, acc_k);
    __syncthreads();
  }

  // ---- epilogue: o = (r + x[t+d]) sqrt(1/2); the skip rows ----------------------------------------------
  const float inv_std = 0.70710678118654752f;
  const int skip_start = T_out - skip_size;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + i, t = t0 + r;
    if (t >= T_out) continue;
    float4 ov;
    ov.x = (acc_r[i][0] + b_rs[u0] + xc[r * C + u0]) * inv_std;
    ov.y = (acc_r[i][1] + b_rs[u0 + 1] + xc[r * C + u0 + 1]) * inv_std;
    ov.z = (acc_r[i][2] + b_rs[u0 + 2] + xc[r * C + u0 + 2]) * inv_std;
    ov.w = (acc_r[i][3] + b_rs[u0 + 3] + xc[r * C + u0 + 3]) * inv_std;
    *reinterpret_cast<float4*>(o + ((size_t)b * T_out + t) * C + u0) = ov;
    if (SKIP && t >= skip_start) {
      float4 sv;
      sv.x = acc_k[i][0] + b_rs[C + u0];
      sv.y = acc_k[i][1] + b_rs[C + u0 + 1];
      sv.z = acc_k[i][2] + b_rs[C + u0 + 2];
      sv.w = acc_k[i][3] + b_rs[C + u0 + 3];
      *reinterpret_cast<float4*>(s + ((size_t)b * skip_size + (t - skip_start)) * (RS - C) + u0) = sv;
    }
  }
}

template <int RS>
int launch(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
           const void* b_rs, void* o, void* s, int B, int T_in, int rs_ld, int d, int skip_size, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(residual_glu_tiled_kernel<RS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_in - d + TM - 1) / TM, B);
  residual_glu_tiled_kernel<RS><<<grid, THREADS, SMEM, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_t), static_cast<const float*>(w_s),
      static_cast<const float*>(b_t), static_cast<const float*>(b_s), static_cast<const float*>(w_rs),
      static_cast<const float*>(b_rs), static_cast<float*>(o), static_cast<float*>(s), T_in, rs_ld, d, skip_size);
  return (int)cudaGetLastError();
}

}  // namespace tiled

// ---- tensor-core path: bf16 at fixed widths ----------------------------------------------------
//
// The same block on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate), for bf16 at the widths it is
// instantiated for (C = half = R = S = 96, the flagship; 32, for tests). The tile's products, the gate and the weight
// layout are residual_glu_mma.cuh's (the fused stack takes the same products on wgmma). Weights are staged once per
// thread block; blocks are persistent (one per SM) and walk over (batch row, 128-row time tile) pairs, the next
// tile's x rows streaming into a second buffer (cp.async) while the current one computes. Each of the 8 warps owns
// 16 rows of a tile.
namespace mma {

using glu_mma::Cfg;
using glu_mma::TT;
using glu_mma::WARPS;

// One warp's 16 rows of a tile: both GEMMs and the gate (residual_glu_mma.cuh), and the epilogue (no shared-memory
// writes).
template <int C, int HALF, int RS>
__device__ __forceinline__ void warp_tile(const __nv_bfloat16* wg, const __nv_bfloat16* wr, const __nv_bfloat16* xo,
                                          const __nv_bfloat16* xc, const __nv_bfloat16* __restrict__ b_t,
                                          const __nv_bfloat16* __restrict__ b_s, const __nv_bfloat16* __restrict__ b_rs,
                                          __nv_bfloat16* __restrict__ o, __nv_bfloat16* __restrict__ s, int b, int t0,
                                          int T_out, int skip_size, int r0, int g, int q, float inv_std) {
  using K = Cfg<C, HALF, RS>;
  constexpr int S = RS - C;
  float acc2[K::NTR][4];
  glu_mma::warp_products<C, HALF, RS>(wg, wr, xo, xc, b_t, b_s, r0, g, q, acc2);

  const int skip_start = T_out - skip_size;
#pragma unroll
  for (int j = 0; j < K::NTR; ++j) {
    const int col = j * 8 + 2 * q;
    const float br0 = __bfloat162float(b_rs[col]), br1 = __bfloat162float(b_rs[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, t = t0 + r;
      if (t >= T_out) continue;
      const float v0 = acc2[j][2 * h] + br0, v1 = acc2[j][2 * h + 1] + br1;
      if (j < K::NTO) {
        const float x0 = __bfloat162float(xc[r * K::C_PAD + col]), x1 = __bfloat162float(xc[r * K::C_PAD + col + 1]);
        *reinterpret_cast<uint32_t*>(o + ((size_t)b * T_out + t) * C + col) = pack((v0 + x0) * inv_std, (v1 + x1) * inv_std);
      } else if (t >= skip_start) {
        *reinterpret_cast<uint32_t*>(s + ((size_t)b * skip_size + (t - skip_start)) * S + (col - C)) = pack(v0, v1);
      }
    }
  }
}

template <int C, int HALF, int RS>
__global__ void __launch_bounds__(WARPS * 32, 1)
residual_glu_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_t,
                        const __nv_bfloat16* __restrict__ w_s, const __nv_bfloat16* __restrict__ b_t,
                        const __nv_bfloat16* __restrict__ b_s, const __nv_bfloat16* __restrict__ w_rs,
                        const __nv_bfloat16* __restrict__ b_rs, __nv_bfloat16* __restrict__ o,
                        __nv_bfloat16* __restrict__ s, int B, int T_in, int d, int skip_size) {
  using K = Cfg<C, HALF, RS>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* wg = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2 HALF][KG_PAD]: gate, n-major
  __nv_bfloat16* wr = wg + 2 * HALF * K::KG_PAD;                      // [RS][KR_PAD]: rs kernel, n-major
  __nv_bfloat16* xbuf = wr + RS * K::KR_PAD;  // 2 buffers x {[TT][C_PAD] x[t], [TT][C_PAD] x[t+d]}
  glu_mma::stage_weights<C, HALF, RS>(wg, wr, w_t, w_s, w_rs);

  const int T_out = T_in - d;
  const int tiles_per_row = (T_out + TT - 1) / TT;
  const int n_tiles = B * tiles_per_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r0 = warp * 16;
  const float inv_std = __bfloat162float(__float2bfloat16_rn(0.70710678118654752f));

  // issue the copies of a tile's x[t] and x[t+d] rows into buffer `buf` (rows past T_out read as 0)
  auto load_tile = [&](int tile, int buf) {
    if (tile < n_tiles) {
      const int b = tile / tiles_per_row, t0 = (tile - b * tiles_per_row) * TT;
      const __nv_bfloat16* xb = x + (size_t)b * T_in * C;
      __nv_bfloat16* xo = xbuf + buf * 2 * K::X_TILE;
      for (int i = threadIdx.x; i < TT * (C / 8); i += WARPS * 32) {
        const int r = i / (C / 8), v = i - r * (C / 8), t = t0 + r;
        const bool valid = t < T_out;
        cp_async16(xo + r * K::C_PAD + v * 8, xb + (valid ? (size_t)t * C + v * 8 : 0), valid);
        cp_async16(xo + K::X_TILE + r * K::C_PAD + v * 8, xb + (valid ? (size_t)(t + d) * C + v * 8 : 0), valid);
      }
    }
    cp_async_commit();  // an empty group past the last tile keeps the wait count uniform
  };

  load_tile(blockIdx.x, 0);
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int b = tile / tiles_per_row, t0 = (tile - b * tiles_per_row) * TT;
    load_tile(tile + gridDim.x, buf ^ 1);  // the next tile's rows stream in during this one's math
    cp_async_wait_one();                   // this tile's copies (all but the newest group) have landed
    __syncthreads();                       // ... for every thread's copies; weights staged on the first pass
    const __nv_bfloat16* xo = xbuf + buf * 2 * K::X_TILE;  // x[t]
    const __nv_bfloat16* xc = xo + K::X_TILE;               // x[t+d]
    if (t0 + r0 < T_out)  // else this warp's rows are all past the end
      warp_tile<C, HALF, RS>(wg, wr, xo, xc, b_t, b_s, b_rs, o, s, b, t0, T_out, skip_size, r0, g, q, inv_std);
    __syncthreads();  // every warp is done with buffer `buf` before the next pass refills it
  }
}

template <int C, int HALF, int RS>
int launch(const void* x, const void* w_t, const void* w_s, const void* b_t, const void* b_s, const void* w_rs,
           const void* b_rs, void* o, void* s, int B, int T_in, int d, int skip_size, cudaStream_t stream) {
  using K = Cfg<C, HALF, RS>;
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(residual_glu_mma_kernel<C, HALF, RS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)K::smem);
    if (err != cudaSuccess) {
      n_sm = 0;
      return (int)err;
    }
  }
  const int tiles = B * ((T_in - d + TT - 1) / TT);
  const int grid = tiles < n_sm ? tiles : n_sm;
  using bf = __nv_bfloat16;
  residual_glu_mma_kernel<C, HALF, RS><<<grid, WARPS * 32, K::smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w_t), static_cast<const bf*>(w_s), static_cast<const bf*>(b_t),
      static_cast<const bf*>(b_s), static_cast<const bf*>(w_rs), static_cast<const bf*>(b_rs), static_cast<bf*>(o),
      static_cast<bf*>(s), B, T_in, d, skip_size);
  return (int)cudaGetLastError();
}

}  // namespace mma
}  // namespace
}  // namespace blvm

// Limits the Python wrapper enforces before it calls in (returns cudaErrorInvalidValue otherwise). S = 0 is the
// skip-free mode: s and skip_size are not used, and rs_ld (the rs kernel's row width) may exceed R.
extern "C" int blvm_residual_glu(const void* x, const void* w_t, const void* w_s, const void* b_t,
                                 const void* b_s, const void* w_rs, const void* b_rs, void* o, void* s, int B,
                                 int T_in, int C, int half, int R, int S, int rs_ld, int dilation, int skip_size,
                                 int dtype, void* stream) {
  using namespace blvm;
  if (C > MAX_C || half > MAX_HALF || R + S > MAX_RS || R != C || S < 0 || rs_ld < R + S || (S > 0 && rs_ld != R + S) ||
      dilation < 1 || T_in - dilation < 1 || (S > 0 && (skip_size < 1 || skip_size > T_in - dilation)) || B < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the register-tiled path: f32 at STCN's width, 16-byte aligned rows and weights
  const bool aligned16 = ((uintptr_t)x | (uintptr_t)w_t | (uintptr_t)w_s | (uintptr_t)w_rs | (uintptr_t)o |
                          (uintptr_t)s | (uintptr_t)(rs_ld * sizeof(float))) % 16 == 0;
  if (dtype == kFloat32 && aligned16 && C == tiled::C && half == tiled::HALF && (S == 0 || S == tiled::C)) {
    if (S == 0)
      return tiled::launch<tiled::C>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, rs_ld, dilation, skip_size, st);
    return tiled::launch<2 * tiled::C>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, rs_ld, dilation, skip_size,
                                       st);
  }
  if (dtype == kFloat32)
    return launch_fma<float>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, C, half, R, S, rs_ld, dilation,
                             skip_size, st);
  // the tensor-core path needs its widths instantiated and 16-byte aligned x rows and weights
  const bool aligned = ((uintptr_t)x | (uintptr_t)w_t | (uintptr_t)w_s | (uintptr_t)w_rs) % 16 == 0;
  if (dtype == kBFloat16 && aligned && C == 96 && half == 96 && S == 96)
    return mma::launch<96, 96, 192>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, dilation, skip_size, st);
  if (dtype == kBFloat16 && aligned && C == 32 && half == 32 && S == 32)
    return mma::launch<32, 32, 64>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, dilation, skip_size, st);
  if (dtype == kBFloat16)
    return launch_fma<__nv_bfloat16>(x, w_t, w_s, b_t, b_s, w_rs, b_rs, o, s, B, T_in, C, half, R, S, rs_ld,
                                     dilation, skip_size, st);
  return (int)cudaErrorInvalidValue;
}
