// P2/P3: the fused WaveNet residual stack (L residual-GLU blocks of K1, k = 2), forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels 1788a18^:blvm_tpu/ops/pallas/wavenet_stack.py:128 (_forward_kernel, P2: one launch
// over a whole batch) and :219 (_forward_windowed, P3: the same stack over halo'd windows). One kernel serves
// both: a launch over a batch (the test pass and the train step's forward) and a launch over one receptive-field
// window a generation step (skip_size = 1). Given a stack's input x (B, T_in, C), whose left T_in - T_out rows are
// the halo the model's receptive-field padding provides, and the L blocks' weights stacked on a leading axis, it
// computes block after block, each exactly K1's block (residual_glu.cu):
//
//   o_l[t] = (r_l[t] + x_l[t + d_l]) sqrt(1/2),  [r_l | s_l] = (tanh(pre_t) sigmoid(pre_s)) W_rs + b_rs
//
// and returns the last block's o (B, T_in - sum d, C) and the f32 sum over the blocks, in block order, of each
// block's skip over the last skip_size rows, (B, skip_size, S), added into the sum a caller passes with
// `accumulate` (the model's later stacks add into the first one's). Given tap pointers it also writes the skips
// of the blocks the model reports as z.
//
// What bounds it on an H100: per output row a block does 2 (4 C half + half (R + S)) operations; at the flagship
// (C = half = R = S = 96, bf16, B = 8, a stack's input of 21117 rows, the last 16000 rows' skips) a stack is 185
// GFLOP against ~160 MB of compulsory traffic (x read once; the output, the f32 skip sum and the two z taps written
// once): 0.187 ms of operations at the bf16 tensor-core peak against 0.048 ms of bytes, so operations bound it
// (chip_smoke.wavenet_stack_work, scripts/torch_kernel_bounds.py). The TPU
// kernel kept a tile's whole halo and all L layers' weights in VMEM; here the halo (1023 rows x 96 x 2 B = 196 KB)
// and the weights (10 x 110 KB) would not fit the 227 KB of shared memory a CTA can use. So the design keeps
// what fits and lets L2 carry the rest:
//   - one persistent cooperative launch a stack, one CTA an SM, the layers in turn with a grid barrier between
//     them; the residual stream between blocks lives in device memory (two buffers in turn, or the save-mode
//     buffer that keeps every block's input for the backward), read back through L2;
//   - fixed row ownership: a tile of TT output rows is counted from the right end of the layer's output, and tile
//     j of batch row b goes to the same worker (a CTA's warpgroup, or the CTA on the f32 path) in every layer, so
//     the owner of a skip row is the same in every block, and it adds the block's skip into the f32 sum in place, in
//     block order, with no atomics (a warp stages its rows' skips in shared memory and adds them 16 bytes a lane,
//     every load of the lane in flight at once);
//   - bf16 at C = 96: the warpgroup tile of wgmma_bf16.cuh. Two warpgroups a CTA, each with 64-row tiles and two tile
//     buffers (the next tile's rows stream in by cp.async while this one computes); one layer's weights (108 KB)
//     staged once a layer by 16-byte copies as they lie (B read N-major); the gate product from shared memory, the
//     gated activation kept in registers as the [r | s] product's A operand; o and the skip staged over the tile
//     and written 16 bytes a lane, the skip sum's rows fetched into L2 a tile ahead;
//   - f32: the register-tiled FMA products of fma_tile.cuh, each thread 8 rows x 4 units, the weights streamed
//     through shared memory in chunks of 16 k rows (a layer's f32 weights, 221 KB, do not fit beside the tiles).
// Rounding follows K1, so that the stack matches the chain of K1 launches within K1's own limits: in bf16 the
// residual stream is rounded to bf16 at each block's store, the gated activation before the [r | s] product, and
// each block's skip to bf16 before it is added in f32; only the order of the f32 sums differs (in bf16 the tensor
// cores' k-steps run in K1's order). Keeping weights resident across layers, and TMA, are later work.

#include "common.cuh"
#include "fma_tile.cuh"
#include "vrnn_common.cuh"
#include "wgmma_bf16.cuh"

namespace blvm {
namespace wstack {

constexpr int MAX_LAYERS = 16;

template <typename T>
struct Params {
  const T* io[MAX_LAYERS + 1];  // io[l]: block l's input (B, T_l, C); io[L]: the stack's output
  T* tap[MAX_LAYERS];           // null, or where block l's skip rows (B, skip_size, S) are written
  const T *w_t, *w_s, *b_t, *b_s, *w_rs, *b_rs;  // (L, 2, C, half) x 2, (L, half) x 2, (L, half, R + S), (L, R + S)
  float* skip_sum;                                // (B, skip_size, S)
  unsigned int* barrier;
  int dil[MAX_LAYERS];
  int B, T_in, L, skip_size, accumulate;
};

// Tiles of TT output rows counted from the right end of a layer's output (T_out rows): tile j of batch row b
// covers [T_out - (j + 1) TT, T_out - j TT), so a skip row lies in the same tile, and goes to the same worker, in
// every layer.
template <int TT>
__device__ __forceinline__ void tile_of(int tile, int B, int T_out, int& b, int& t0) {
  const int j = tile / B;
  b = tile - j * B;
  t0 = T_out - (j + 1) * TT;
}

template <int TT>
__device__ __forceinline__ int n_tiles_of(int B, int T_out) { return B * ((T_out + TT - 1) / TT); }

// a lane's k-th item of a warp-strided loop
__device__ __forceinline__ int lane_item(int k) { return (threadIdx.x & 31) + 32 * k; }

// ---- bf16: the warpgroup path (wgmma_bf16.cuh) at C = half = R = S = 96 --------------------------------------------
namespace tc {

using bf = __nv_bfloat16;
constexpr int C = 96, HALF = 96, S = 96, RS = C + S, KG = 2 * C, H2 = 2 * HALF;
constexpr int TT = 64;                       // output rows a tile: one warpgroup's wgmma rows
constexpr int WGS = 2, THREADS = 128 * WGS;  // two warpgroups a CTA, each with its own tiles
constexpr int XT = TT * KG;                  // elements of a staged [x[t] | x[t+d]] tile
// the layer's weights (gate [k 192][n 192], rs [h 96][j 192], both B N-major) and two tile buffers a warpgroup
constexpr size_t SMEM = sizeof(bf) * ((size_t)KG * H2 + (size_t)HALF * RS + (size_t)WGS * 2 * XT);

__device__ __forceinline__ const bf* at(const bf* tile, int r, int col) {
  return reinterpret_cast<const bf*>(reinterpret_cast<const char*>(tile) + wgmma::offset(r, col, KG));
}

// One warpgroup's tile: the gate product ([x[t] | x[t+d]] (64 x 192) times the gate weights), the gated activation
// in registers (rounded to bf16, as K1 rounds it) as the A operand of the [r | s] product (times W_rs), and the
// epilogue: o, the tap and the skip sum of the rows that exist (t >= 0). sx: the tile, [64][192] K-major.
__device__ __forceinline__ void tile_products(const bf* sw, const bf* swr, bf* sx, const bf* __restrict__ b_t,
                                              const bf* __restrict__ b_s, const bf* __restrict__ b_rs, bf* o, bf* tap,
                                              float* skip_sum, bool first, int b, int t0, int T_out, int skip_size,
                                              float inv_std) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3, r0 = 16 * warp;
  float acc[H2 / 2];
#pragma unroll
  for (int i = 0; i < H2 / 2; ++i) acc[i] = 0.f;
  wgmma::fence();
#pragma unroll
  for (int ks = 0; ks < KG / 16; ++ks)
    wgmma::mma_ss_n192<0, 1>(acc, wgmma::desc_k(sx, KG, ks), wgmma::desc_mn(sw, H2, ks), ks > 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);

  // the gated activation, repacked as the A fragments (16 x 16 a k-step) of the [r | s] product
  uint32_t af[HALF / 16][4];
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
    const int col = j * 8 + 2 * q;
    const float bt0 = __bfloat162float(b_t[col]), bt1 = __bfloat162float(b_t[col + 1]);
    const float bs0 = __bfloat162float(b_s[col]), bs1 = __bfloat162float(b_s[col + 1]);
    constexpr int js = HALF / 8;  // the sigmoid branch's tile of the same columns is j + HALF / 8
    af[j / 2][(j % 2) * 2 + 0] = pack(gate(acc[4 * j + 0] + bt0, acc[4 * (j + js) + 0] + bs0),
                                      gate(acc[4 * j + 1] + bt1, acc[4 * (j + js) + 1] + bs1));
    af[j / 2][(j % 2) * 2 + 1] = pack(gate(acc[4 * j + 2] + bt0, acc[4 * (j + js) + 2] + bs0),
                                      gate(acc[4 * j + 3] + bt1, acc[4 * (j + js) + 3] + bs1));
  }
  float acc2[RS / 2];
#pragma unroll
  for (int i = 0; i < RS / 2; ++i) acc2[i] = 0.f;
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < HALF / 16; ++kk) wgmma::mma_rs_n192<1>(acc2, af[kk], wgmma::desc_mn(swr, RS, kk), kk > 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc2);

  // o = ((acc + b) + x[t+d]) sqrt(1/2), as K1 orders it, rounded to bf16 over the x[t+d] pair it was made from (each
  // pair read and written by one lane), the skip rows over the warp's own x[t] columns (no wgmma reads the tile after
  // the gate product, which every warp has waited for); then o goes out 16 bytes a lane and the skip rows are added
  // into the f32 sum 16 bytes a lane, every load of the lane in flight at once (the sum's rows were sent to L2 a tile
  // ahead). (A second pass over the accumulators to stage o, or loading the sum's rows into registers while the
  // [r | s] product runs, took registers past the 255 a thread and spilled: both were slower on the H100.)
  const int skip_start = T_out - skip_size;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < RS / 8; ++j) {
    const int col = j * 8 + 2 * q;
    const float br0 = __bfloat162float(b_rs[col]), br1 = __bfloat162float(b_rs[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h, t = t0 + r;
      if (t < 0) continue;
      const float v0 = acc2[4 * j + 2 * h] + br0, v1 = acc2[4 * j + 2 * h + 1] + br1;
      if (j < C / 8) {  // o over the x[t+d] pair it was made from (no other lane reads that pair)
        const float2 xc = wgmma::get2<KG>(sx, r, C + col);
        wgmma::put2<KG>(sx, r, C + col, pack((v0 + xc.x) * inv_std, (v1 + xc.y) * inv_std));
      } else if (t >= skip_start) {
        wgmma::put2<KG>(sx, r, col - C, pack(v0, v1));
      }
    }
  }
  __syncwarp();
  // o's rows that exist (t >= 0), 16 bytes a lane: eight lanes on eight rows, four neighbouring chunks a warp
#pragma unroll
  for (int k = 0; k < 16 * (C / 8) / 32; ++k) {
    const int item = lane_item(k), row = (item & 7) + 8 * (item / (8 * (C / 8))), v = (item >> 3) % (C / 8);
    const int t = t0 + r0 + row;
    if (t >= 0)
      *reinterpret_cast<uint4*>(o + ((size_t)b * T_out + t) * C + 8 * v) =
          *reinterpret_cast<const uint4*>(at(sx, r0 + row, C + 8 * v));
  }
  constexpr int SV = S / 8;                      // 16-byte groups of 8 skip columns a row
  constexpr int PER_LANE = (16 * SV + 31) / 32;  // groups a lane
  const int row_lo = max(0, skip_start - (t0 + r0));  // the warp's first row in the skip rows (skip_start >= 0)
  const int n_items = (16 - row_lo) * SV;
  float4 cur[PER_LANE][2];
  if (!first) {
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int item = lane_item(k), row = row_lo + item / SV;
      if (item < n_items) {
        const float4* src = reinterpret_cast<const float4*>(
            skip_sum + ((size_t)b * skip_size + (t0 + r0 + row - skip_start)) * S + (item % SV) * 8);
        cur[k][0] = src[0];
        cur[k][1] = src[1];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER_LANE; ++k) {
    const int item = lane_item(k), row = row_lo + item / SV;
    if (item < n_items) {
      const uint4 sv = *reinterpret_cast<const uint4*>(at(sx, r0 + row, (item % SV) * 8));
      const size_t off = ((size_t)b * skip_size + (t0 + r0 + row - skip_start)) * S + (item % SV) * 8;
      if (tap) *reinterpret_cast<uint4*>(tap + off) = sv;
      const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&sv);
      const float2 f0 = __bfloat1622float2(e[0]), f1 = __bfloat1622float2(e[1]);
      const float2 f2 = __bfloat1622float2(e[2]), f3 = __bfloat1622float2(e[3]);
      float4 lo = make_float4(f0.x, f0.y, f1.x, f1.y), hi = make_float4(f2.x, f2.y, f3.x, f3.y);
      if (!first) {
        lo = make_float4(cur[k][0].x + lo.x, cur[k][0].y + lo.y, cur[k][0].z + lo.z, cur[k][0].w + lo.w);
        hi = make_float4(cur[k][1].x + hi.x, cur[k][1].y + hi.y, cur[k][1].z + hi.z, cur[k][1].w + hi.w);
      }
      float4* dst = reinterpret_cast<float4*>(skip_sum + off);
      dst[0] = lo;
      dst[1] = hi;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) stack_wg_kernel(const Params<bf> p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* sw = reinterpret_cast<bf*>(smem_raw);  // the layer's gate weights, B N-major [k 192][n 192]
  bf* swr = sw + KG * H2;                    // its rs weights, B N-major [h 96][j 192]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  bf* xbuf = swr + HALF * RS + wg * 2 * XT;  // this warpgroup's two tile buffers
  const int worker = blockIdx.x * WGS + wg, n_workers = gridDim.x * WGS;
  const float inv_std = __bfloat162float(__float2bfloat16_rn(0.70710678118654752f));
  unsigned int target = 0;
  int T_cur = p.T_in;

  for (int l = 0; l < p.L; ++l) {
    const int d = p.dil[l], T_out = T_cur - d, n_tiles = n_tiles_of<TT>(p.B, T_out);
    const bf* x = p.io[l];
    bf* o = const_cast<bf*>(p.io[l + 1]);
    const bf *w_t = p.w_t + (size_t)l * 2 * C * HALF, *w_s = p.w_s + (size_t)l * 2 * C * HALF;
    const bf* w_rs = p.w_rs + (size_t)l * HALF * RS;
    const bf *b_t = p.b_t + l * HALF, *b_s = p.b_s + l * HALF, *b_rs = p.b_rs + l * RS;
    const bool first = l == 0 && !p.accumulate;

    if (blockIdx.x * WGS < n_tiles) {  // the layer's weights as they lie, 16-byte copies (a CTA without a tile skips them)
      wgmma::load_tile<H2>(sw, KG, [&](int k, int col) { return (col < HALF ? w_t : w_s) + k * HALF + col % HALF; },
                           w_t, threadIdx.x, THREADS);
      wgmma::load_tile<RS>(swr, HALF, [&](int h, int col) { return w_rs + h * RS + col; }, w_rs, threadIdx.x, THREADS);
    }
    // a tile's x[t] and x[t+d] rows into buffer `buf` (rows before the layer's first, t < 0, read as 0); the stream
    // is written by this launch, so it is read through L2 (cp.async.cg), never the read-only path
    auto load = [&](int tile, int buf) {
      if (tile < n_tiles) {
        int b, t0;
        tile_of<TT>(tile, p.B, T_out, b, t0);
        const bf* xb = x + (size_t)b * T_cur * C;
        wgmma::load_tile<KG>(xbuf + buf * XT, TT, [&](int r, int col) -> const bf* {
          const int t = t0 + r;
          if (t < 0) return nullptr;
          return col < C ? xb + (size_t)t * C + col : xb + (size_t)(t + d) * C + (col - C);
        }, x, tid, 128);
        // the tile's rows of the f32 skip sum into L2, 128 bytes a thread, a tile ahead of their read
        const int skip_start = T_out - p.skip_size, r_lo = max(0, skip_start - t0);
        if (!(l == 0 && !p.accumulate))
          for (int i = tid; i < (TT - r_lo) * 3; i += 128) {
            const int r = r_lo + i / 3, part = i - (i / 3) * 3;
            const float* a = p.skip_sum + ((size_t)b * p.skip_size + (t0 + r - skip_start)) * S + 32 * part;
            asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
          }
      }
      cp_async_commit();
    };

    load(worker, 0);
    cp_async_wait_all();
    wgmma::fence_async_smem();
    __syncthreads();  // the layer's weights and both warpgroups' first tiles landed
    int buf = 0;
    for (int tile = worker; tile < n_tiles; tile += n_workers, buf ^= 1) {
      int b, t0;
      tile_of<TT>(tile, p.B, T_out, b, t0);
      load(tile + n_workers, buf ^ 1);
      cp_async_wait_one();
      wgmma::fence_async_smem();
      wgmma::wg_sync(wg);  // this tile's rows landed for the whole warpgroup
      tile_products(sw, swr, xbuf + buf * XT, b_t, b_s, b_rs, o, p.tap[l], p.skip_sum, first, b, t0, T_out,
                    p.skip_size, inv_std);
      wgmma::wg_sync(wg);  // every warp is done with buffer `buf` before the next load overwrites it
    }
    cp_async_wait_all();
    T_cur = T_out;
    if (l + 1 < p.L) vrnn::grid_sync(p.barrier, target);  // also: every warp is done with the layer's weights
  }
}

}  // namespace tc

// ---- f32: register-tiled FMA products (fma_tile.cuh), at C = half = R = S ---------------------------------------
namespace f32 {

constexpr int TT = 128;             // output rows a tile
constexpr int RM = 8;               // rows a thread
constexpr int RG = TT / RM;         // row groups a tile (16)
constexpr int KC = 16;              // k rows a staged weight chunk

template <int C>
struct Cfg {
  static_assert(C % 16 == 0, "fma path widths");
  static constexpr int UG = C / 4, NT = UG * RG;  // unit groups of 4 columns; threads
  static constexpr int WCOLS = 2 * C;             // a staged weight row: [tanh | sigmoid] or [r | s]
  static constexpr size_t smem = sizeof(float) * ((size_t)2 * TT * C + 2 * KC * WCOLS);
};

template <int C>
__global__ void __launch_bounds__(Cfg<C>::NT, 1) stack_fma_kernel(const Params<float> p) {
  using K = Cfg<C>;
  constexpr int HALF = C, WCOLS = K::WCOLS;
  extern __shared__ __align__(16) float sm[];
  float* xo = sm;             // [TT][C] x[t]; then the gated activation [TT][HALF]
  float* xc = xo + TT * C;    // [TT][C] x[t+d]
  float* wbuf = xc + TT * C;  // 2 x [KC][WCOLS]
  const int ug = threadIdx.x % K::UG, r0 = (threadIdx.x / K::UG) * RM, u0 = ug * 4;
  const float inv_std = 0.70710678118654752f;
  unsigned int target = 0;
  int T_cur = p.T_in;

  for (int l = 0; l < p.L; ++l) {
    const int d = p.dil[l], T_out = T_cur - d, n_tiles = n_tiles_of<TT>(p.B, T_out);
    const float* x = p.io[l];
    float* o = const_cast<float*>(p.io[l + 1]);
    const float *w_t = p.w_t + (size_t)l * 2 * C * HALF, *w_s = p.w_s + (size_t)l * 2 * C * HALF;
    const float* w_rs = p.w_rs + (size_t)l * HALF * WCOLS;
    const float *b_t = p.b_t + l * HALF, *b_s = p.b_s + l * HALF, *b_rs = p.b_rs + l * WCOLS;
    float* tap = p.tap[l];
    const bool first = l == 0 && !p.accumulate;
    const int skip_start = T_out - p.skip_size;

    // chunk k0 of the gate weights' 2C rows [tap 0 ; tap 1], each [tanh | sigmoid], into buffer buf
    auto stage_gate = [&](int k0, int buf) {
      float* dst = wbuf + buf * KC * WCOLS;
      for (int i = threadIdx.x; i < KC * (WCOLS / 4); i += K::NT) {
        const int r = i / (WCOLS / 4), col = 4 * (i % (WCOLS / 4)), k = k0 + r;
        cp_async16(dst + r * WCOLS + col, (col < HALF ? w_t : w_s) + (size_t)k * HALF + col % HALF, true);
      }
      cp_async_commit();
    };
    // chunk k0 of the rs kernel's HALF rows of [r | s]
    auto stage_rs = [&](int k0, int buf) {
      float* dst = wbuf + buf * KC * WCOLS;
      for (int i = threadIdx.x; i < KC * (WCOLS / 4); i += K::NT) {
        const int r = i / (WCOLS / 4), col = 4 * (i % (WCOLS / 4));
        cp_async16(dst + r * WCOLS + col, w_rs + (size_t)(k0 + r) * WCOLS + col, true);
      }
      cp_async_commit();
    };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      int b, t0;
      tile_of<TT>(tile, p.B, T_out, b, t0);
      const float* xb = x + (size_t)b * T_cur * C;
      for (int i = threadIdx.x; i < TT * (C / 4); i += K::NT) {  // rows before the layer's first read as 0
        const int r = i / (C / 4), v = 4 * (i % (C / 4)), t = t0 + r;
        const bool valid = t >= 0;
        cp_async16(xo + r * C + v, xb + (valid ? (size_t)t * C + v : 0), valid);
        cp_async16(xc + r * C + v, xb + (valid ? (size_t)(t + d) * C + v : 0), valid);
      }

      // gate: [x[t] | x[t+d]] (TT x 2C) times [W_t | W_s] (2C x 2 HALF)
      float acc_t[RM][4], acc_s[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_t[i][j] = acc_s[i][j] = 0.f;
      constexpr int NGC = 2 * C / KC;
      stage_gate(0, 0);  // with the x tiles: one group
      for (int ci = 0; ci < NGC; ++ci) {
        if (ci + 1 < NGC) {
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
      for (int i = 0; i < RM; ++i) {  // K1's f32 gate: tanhf and sigmoidf (common.cuh), no approximation
        float4 a;
        a.x = tanhf(acc_t[i][0] + b_t[u0]) * sigmoidf(acc_s[i][0] + b_s[u0]);
        a.y = tanhf(acc_t[i][1] + b_t[u0 + 1]) * sigmoidf(acc_s[i][1] + b_s[u0 + 1]);
        a.z = tanhf(acc_t[i][2] + b_t[u0 + 2]) * sigmoidf(acc_s[i][2] + b_s[u0 + 2]);
        a.w = tanhf(acc_t[i][3] + b_t[u0 + 3]) * sigmoidf(acc_s[i][3] + b_s[u0 + 3]);
        *reinterpret_cast<float4*>(xo + (r0 + i) * HALF + u0) = a;
      }

      // [r | s] = act (TT x HALF) W_rs (HALF x 2C)
      float acc_r[RM][4], acc_k[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_k[i][j] = 0.f;
      constexpr int NRC = HALF / KC;
      for (int ci = 0; ci < NRC; ++ci) {
        if (ci + 1 < NRC) {
          stage_rs((ci + 1) * KC, (ci + 1) & 1);
          cp_async_wait_one();
        } else {
          cp_async_wait_all();
        }
        __syncthreads();  // (the first time: the activation written too)
        fma_tile::chunk<KC, RM, WCOLS, C, true>(xo, HALF, ci * KC, wbuf + (ci & 1) * KC * WCOLS, r0, u0, acc_r, acc_k);
        __syncthreads();
      }

      // epilogue: o = ((acc + b) + x[t+d]) sqrt(1/2), as K1 orders it; the skip rows into the tap and the sum
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int r = r0 + i, t = t0 + r;
        if (t < 0) continue;
        float4 ov;
        ov.x = (acc_r[i][0] + b_rs[u0] + xc[r * C + u0]) * inv_std;
        ov.y = (acc_r[i][1] + b_rs[u0 + 1] + xc[r * C + u0 + 1]) * inv_std;
        ov.z = (acc_r[i][2] + b_rs[u0 + 2] + xc[r * C + u0 + 2]) * inv_std;
        ov.w = (acc_r[i][3] + b_rs[u0 + 3] + xc[r * C + u0 + 3]) * inv_std;
        *reinterpret_cast<float4*>(o + ((size_t)b * T_out + t) * C + u0) = ov;
        if (t >= skip_start) {
          float4 sv;
          sv.x = acc_k[i][0] + b_rs[C + u0];
          sv.y = acc_k[i][1] + b_rs[C + u0 + 1];
          sv.z = acc_k[i][2] + b_rs[C + u0 + 2];
          sv.w = acc_k[i][3] + b_rs[C + u0 + 3];
          const size_t k = ((size_t)b * p.skip_size + (t - skip_start)) * C + u0;
          if (tap) *reinterpret_cast<float4*>(tap + k) = sv;
          float4* dst = reinterpret_cast<float4*>(p.skip_sum + k);
          if (!first) {
            const float4 cur = *dst;
            sv.x = cur.x + sv.x;
            sv.y = cur.y + sv.y;
            sv.z = cur.z + sv.z;
            sv.w = cur.w + sv.w;
          }
          *dst = sv;
        }
      }
      __syncthreads();  // every thread is done with the tiles before the next tile's rows land
    }
    T_cur = T_out;
    if (l + 1 < p.L) vrnn::grid_sync(p.barrier, target);
  }
}

}  // namespace f32

// The launch of one CTA an SM, asked once per device and shared-memory size.
struct LaunchCache {
  int dev = -1, sms = 0, per_sm = 0;
  size_t smem = 0;
};

template <typename P>
int launch(LaunchCache& c, const void* kernel, int threads, size_t smem, P& params, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev != c.dev) {
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    c.dev = err == cudaSuccess ? dev : -1;
    c.smem = 0;
  }
  if (err == cudaSuccess && smem != c.smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, threads, smem);
    c.smem = err == cudaSuccess ? smem : 0;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  if (c.per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(params.barrier, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&params};
  err = cudaLaunchCooperativeKernel(kernel, dim3(c.sms), dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
Params<T> make_params(const void* const* io, void* const* taps, const void* w_t, const void* w_s, const void* b_t,
                      const void* b_s, const void* w_rs, const void* b_rs, void* skip_sum, void* barrier,
                      const int* dilations, int B, int T_in, int L, int skip_size, int accumulate) {
  Params<T> p = {};
  for (int l = 0; l < L; ++l) {
    p.io[l] = static_cast<const T*>(io[l]);
    p.tap[l] = static_cast<T*>(taps[l]);
    p.dil[l] = dilations[l];
  }
  p.io[L] = static_cast<const T*>(io[L]);
  p.w_t = static_cast<const T*>(w_t);
  p.w_s = static_cast<const T*>(w_s);
  p.b_t = static_cast<const T*>(b_t);
  p.b_s = static_cast<const T*>(b_s);
  p.w_rs = static_cast<const T*>(w_rs);
  p.b_rs = static_cast<const T*>(b_rs);
  p.skip_sum = static_cast<float*>(skip_sum);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T_in = T_in;
  p.L = L;
  p.skip_size = skip_size;
  p.accumulate = accumulate;
  return p;
}

}  // namespace wstack
}  // namespace blvm

// P2/P3. io: a host array of L + 1 device pointers, io[0] the stack's input x (B, T_in, C), io[l] block l's input
// and io[L] the stack's output (B, T_in - sum d, C): two buffers in turn, or the save-mode buffer's slots (the
// arithmetic does not depend on which). taps: a host array of L device pointers, null or (B, skip_size, S) in the
// compute dtype. Weights stacked on a leading axis of L blocks: w_t, w_s (L, 2, C, half), b_t, b_s (L, half), w_rs
// (L, half, R + S), b_rs (L, R + S). skip_sum (B, skip_size, S) float32: with accumulate 0 it is overwritten,
// with 1 added into. barrier: one uint32 (zeroed here). dilations: a host array of L ints. Every pointer 16-byte
// aligned. Takes C = half = R = S = 96 (the run specs), float32 (dtype 0) or bfloat16 (1), 1 <= L <= 16,
// 1 <= skip_size <= the last block's output rows; returns cudaErrorInvalidValue otherwise, else a cudaError_t.
extern "C" int blvm_wavenet_stack(const void* const* io, void* const* taps, const void* w_t, const void* w_s,
                                  const void* b_t, const void* b_s, const void* w_rs, const void* b_rs, void* skip_sum,
                                  void* barrier, const int* dilations, int B, int T_in, int C, int half, int S, int L,
                                  int skip_size, int accumulate, int dtype, void* stream) {
  using namespace blvm;
  using namespace blvm::wstack;
  if (L < 1 || L > MAX_LAYERS || B < 1 || half != C || S != C || C != 96 || skip_size < 1)
    return (int)cudaErrorInvalidValue;
  int T_out = T_in;
  uintptr_t align = (uintptr_t)w_t | (uintptr_t)w_s | (uintptr_t)b_t | (uintptr_t)b_s | (uintptr_t)w_rs |
                    (uintptr_t)b_rs | (uintptr_t)skip_sum;
  for (int l = 0; l < L; ++l) {
    if (dilations[l] < 1) return (int)cudaErrorInvalidValue;
    T_out -= dilations[l];
    align |= (uintptr_t)io[l] | (uintptr_t)taps[l];
  }
  align |= (uintptr_t)io[L];
  if (T_out < skip_size || align % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16) {
    auto p = make_params<__nv_bfloat16>(io, taps, w_t, w_s, b_t, b_s, w_rs, b_rs, skip_sum, barrier, dilations, B, T_in,
                                        L, skip_size, accumulate);
    static LaunchCache cache;
    return launch(cache, (const void*)tc::stack_wg_kernel, tc::THREADS, tc::SMEM, p, st);
  }
  if (dtype == kFloat32) {
    auto p = make_params<float>(io, taps, w_t, w_s, b_t, b_s, w_rs, b_rs, skip_sum, barrier, dilations, B, T_in, L,
                                skip_size, accumulate);
    static LaunchCache cache;
    return launch(cache, (const void*)f32::stack_fma_kernel<96>, f32::Cfg<96>::NT, f32::Cfg<96>::smem, p, st);
  }
  return (int)cudaErrorInvalidValue;
}
