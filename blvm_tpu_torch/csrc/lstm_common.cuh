// The cluster LSTM recurrence that K5 (lstm.cu, one direction) and K6 (bilstm.cu, both directions of a
// bidirectional layer in one launch) share: the step of the forward and of the backward through time, and the
// launch on 8-CTA clusters. The design is set out in lstm.cu; D, the directions of a launch, is its only axis.
//
// Layout, for D directions: xw and gates (B, T, D 4H), direction d's gate columns at offset 4 d H; out, h_prev
// and c_prev (B, T, D H), direction d at offset d H; W_hh (D, H, 4H), b_hh (D, 4H); mask (B, T) float32 or null
// (all ones); h0, c0, h_n, c_n (D, B, H) or null (zero state in, nothing out). On its step s, direction 1 reads
// and writes time t = T - 1 - s (it consumes the whole padded sequence reversed, padding first); direction 0
// reads and writes t = s. A launch holds D x groups clusters: cluster c serves direction c / groups and rows
// [BG (c % groups), BG (c % groups + 1)), so a cluster never mixes directions and keeps its own W_hh resident.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace blvm {
namespace lstm {

namespace cg = cooperative_groups;

constexpr int NC = 8;       // CTAs of a cluster (the portable maximum)
constexpr int MAX_H = 256;  // 2 H^2 bytes of W_hh per CTA, plus buffers, under 227 KB
constexpr int MAX_BG = 8;   // rows of one cluster: the owner threads, U BG, must not outnumber the H threads

// the value a T holds: f32 unchanged, bf16 rounded to nearest even
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32<T>(from_f32<T>(v)); }

template <typename T>
__device__ __forceinline__ float ld(const T* p, int64_t i) { return to_f32<T>(p[i]); }

inline size_t fwd_smem(int H, int BG) {  // W (H x U float4), h (2 x H x BG), partial sums (NC x BG x U float4)
  return (size_t)2 * H * H + (size_t)8 * H * BG + (size_t)16 * H * BG;
}

inline size_t bwd_smem(int H, int BG) {  // W rows (U x 4H), dgates (2 x BG x 4H), partial sums (NC x BG x U)
  return (size_t)2 * H * H + (size_t)32 * H * BG + (size_t)4 * H * BG;
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_H) lstm_fwd_kernel(
    const T* __restrict__ xw, const T* __restrict__ w_hh, const T* __restrict__ b_hh, const float* __restrict__ mask,
    const T* __restrict__ h0, const T* __restrict__ c0, T* __restrict__ out, T* __restrict__ h_n,
    T* __restrict__ c_n, T* __restrict__ gates_out, T* __restrict__ h_prev_out, T* __restrict__ c_prev_out, int B,
    int Tn, int H, int BG, int groups) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / NC, dir = D == 1 ? 0 : cid / groups, group = D == 1 ? cid : cid % groups;
  const int U = H / NC, G = 4 * H;
  const int64_t XS = (int64_t)D * G, OS = (int64_t)D * H;  // row strides of xw and gates, of out, h_prev, c_prev
  const int tid = threadIdx.x;
  const int j = tid % U, s = tid / U;  // the product: unit j of this CTA, k-slice s
  const T* w_d = w_hh + (int64_t)dir * H * G;

  extern __shared__ float4 smem4[];
  float4* w4 = smem4;                                  // [H][U]: W_hh[d][k][g H + unit j], g = 0..3
  float* hbuf = reinterpret_cast<float*>(w4 + H * U);  // [2][H][BG]: h of the group before the step
  float4* part = reinterpret_cast<float4*>(hbuf + 2 * H * BG);  // [NC][BG][U]: partial gate sums

  float* w = reinterpret_cast<float*>(w4);
  for (int idx = tid; idx < H * 4 * U; idx += blockDim.x) {
    const int k = idx / (4 * U), r = idx % (4 * U), g = r / U, jj = r % U;
    w[(k * U + jj) * 4 + g] = ld(w_d, (int64_t)k * G + g * H + rank * U + jj);
  }
  for (int idx = tid; idx < H * BG; idx += blockDim.x) {
    const int k = idx / BG, b = idx % BG, row = group * BG + b;
    hbuf[idx] = h0 && row < B ? ld(h0, ((int64_t)dir * B + row) * H + k) : 0.0f;
  }
  // the owner of (unit, row): thread bo U + j keeps unit j's state of row bo of the group
  const bool owner = tid < U * BG;
  const int bo = s, unit = rank * U + j, row = group * BG + bo;
  const bool active = owner && row < B;
  const int64_t state = ((int64_t)dir * B + row) * H + unit;
  float h = 0.0f, c = 0.0f, bias[4];
  if (active && h0) {
    h = ld(h0, state);
    c = ld(c0, state);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = ld(b_hh, dir * G + g * H + unit);
  cluster.sync();  // every CTA of the cluster runs and holds its weights before any h is exchanged

  for (int st = 0; st < Tn; ++st) {
    const int p = st & 1;
    const int t = dir ? Tn - 1 - st : st;
    const int64_t rt = (int64_t)row * Tn + t;
    const int64_t gi = rt * XS + dir * G + unit, hi = rt * OS + dir * H + unit;
    float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m = 0.0f;
    if (active) {  // issued before the product, which hides their latency
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[g] = ld(xw, gi + g * H);
      m = mask ? mask[rt] : 1.0f;
    }
    float acc[MAX_BG][4];
#pragma unroll
    for (int b = 0; b < MAX_BG; ++b) acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.0f;
    const float* hb = hbuf + p * H * BG;
    for (int kk = 0; kk < U; ++kk) {
      const int k = s * U + kk;
      const float4 wk = w4[k * U + j];
#pragma unroll
      for (int b = 0; b < MAX_BG; ++b) {
        if (b < BG) {
          const float hv = hb[k * BG + b];
          acc[b][0] = fmaf(hv, wk.x, acc[b][0]);
          acc[b][1] = fmaf(hv, wk.y, acc[b][1]);
          acc[b][2] = fmaf(hv, wk.z, acc[b][2]);
          acc[b][3] = fmaf(hv, wk.w, acc[b][3]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAX_BG; ++b)
      if (b < BG) part[(s * BG + b) * U + j] = make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
    __syncthreads();
    if (owner) {
      if (active) {
        float dot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int q = 0; q < NC; ++q) {
          const float4 v = part[(q * BG + bo) * U + j];
          dot[0] += v.x;
          dot[1] += v.y;
          dot[2] += v.z;
          dot[3] += v.w;
        }
        float a[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) a[g] = rnd<T>(rnd<T>(xg[g] + rnd<T>(dot[g])) + bias[g]);
        const float ig = rnd<T>(sigmoidf(a[0])), fg = rnd<T>(sigmoidf(a[1]));
        const float gg = rnd<T>(tanhf(a[2])), og = rnd<T>(sigmoidf(a[3]));
        const float c_new = rnd<T>(rnd<T>(fg * c) + rnd<T>(ig * gg));
        const float h_new = rnd<T>(og * rnd<T>(tanhf(c_new)));
        if (gates_out) {
          gates_out[gi] = from_f32<T>(ig);
          gates_out[gi + H] = from_f32<T>(fg);
          gates_out[gi + 2 * H] = from_f32<T>(gg);
          gates_out[gi + 3 * H] = from_f32<T>(og);
          h_prev_out[hi] = from_f32<T>(h);
          c_prev_out[hi] = from_f32<T>(c);
        }
        const float keep = rnd<T>(1.0f - m);
        h = rnd<T>(rnd<T>(m * h_new) + rnd<T>(keep * h));
        c = rnd<T>(rnd<T>(m * c_new) + rnd<T>(keep * c));
        out[hi] = from_f32<T>(h_new * m);
      }
      float* next = hbuf + (1 - p) * H * BG + unit * BG + bo;  // h of a padding row stays 0
#pragma unroll
      for (int r = 0; r < NC; ++r) *cluster.map_shared_rank(next, r) = h;
    }
    cluster.sync();  // the next h is in every CTA; the last reads of this step's buffers are done
  }
  if (active && h_n) {
    h_n[state] = from_f32<T>(h);
    c_n[state] = from_f32<T>(c);
  }
}

// d_out, d_h_n, d_c_n: null reads as zeros; d_h0, d_c0: null writes nothing.
template <typename T, int D>
__global__ void __launch_bounds__(MAX_H) lstm_bwd_kernel(
    const T* __restrict__ w_hh, const float* __restrict__ mask, const T* __restrict__ gates,
    const T* __restrict__ c_prev, const T* __restrict__ d_out, const T* __restrict__ d_h_n,
    const T* __restrict__ d_c_n, T* __restrict__ d_gates, T* __restrict__ d_h0, T* __restrict__ d_c0, int B, int Tn,
    int H, int BG, int groups) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / NC, dir = D == 1 ? 0 : cid / groups, group = D == 1 ? cid : cid % groups;
  const int U = H / NC, G = 4 * H;
  const int64_t XS = (int64_t)D * G, OS = (int64_t)D * H;
  const int tid = threadIdx.x;
  const int j = tid % U, s = tid / U;  // the product: unit j of this CTA, slice s of the 4H columns (H/8 float4s)
  const T* w_d = w_hh + (int64_t)dir * H * G;

  extern __shared__ float4 smem4[];
  float4* wr4 = smem4;                                // [H][U]: W_hh[d][unit j][4 c4 .. 4 c4 + 3] at [c4][j]
  float* dg = reinterpret_cast<float*>(wr4 + H * U);  // [2][BG][4H]: dgates of the group
  float* part = dg + 2 * BG * G;                      // [NC][BG][U]: partial sums of dh

  float* wr = reinterpret_cast<float*>(wr4);
  for (int idx = tid; idx < U * G; idx += blockDim.x) {
    const int jj = idx / G, col = idx % G;
    wr[((col / 4) * U + jj) * 4 + col % 4] = ld(w_d, (int64_t)(rank * U + jj) * G + col);
  }
  const bool owner = tid < U * BG;
  const int bo = s, unit = rank * U + j, row = group * BG + bo;
  const bool active = owner && row < B;
  const int64_t state = ((int64_t)dir * B + row) * H + unit;
  float dh = 0.0f, dc = 0.0f;
  if (active) {
    dh = d_h_n ? ld(d_h_n, state) : 0.0f;
    dc = d_c_n ? ld(d_c_n, state) : 0.0f;
  }
  cluster.sync();

  for (int st = Tn - 1; st >= 0; --st) {  // each direction's chain in reverse
    const int p = st & 1;
    const int t = dir ? Tn - 1 - st : st;
    if (owner) {
      float dgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
        const int64_t rt = (int64_t)row * Tn + t;
        const int64_t gi = rt * XS + dir * G + unit, hi = rt * OS + dir * H + unit;
        const float ig = ld(gates, gi), fg = ld(gates, gi + H);
        const float gg = ld(gates, gi + 2 * H), og = ld(gates, gi + 3 * H);
        const float cp = ld(c_prev, hi);
        const float m = mask ? mask[rt] : 1.0f;
        const float dout = d_out ? ld(d_out, hi) : 0.0f;
        const float c_new = rnd<T>(rnd<T>(fg * cp) + rnd<T>(ig * gg));  // as the forward rounded it
        const float tc = rnd<T>(tanhf(c_new));
        const float dh_new = m * (dh + dout);
        const float dc_new = m * dc + dh_new * og * (1.0f - tc * tc);
        dgt[0] = rnd<T>(dc_new * gg * ig * (1.0f - ig));
        dgt[1] = rnd<T>(dc_new * cp * fg * (1.0f - fg));
        dgt[2] = rnd<T>(dc_new * ig * (1.0f - gg * gg));
        dgt[3] = rnd<T>(dh_new * tc * og * (1.0f - og));
#pragma unroll
        for (int g = 0; g < 4; ++g) d_gates[gi + g * H] = from_f32<T>(dgt[g]);
        dc = (1.0f - m) * dc + dc_new * fg;
        dh = (1.0f - m) * dh;  // + dgates W_hh^T, below
      }
      float* slot = dg + p * BG * G + bo * G + unit;  // a padding row sends zeros
#pragma unroll
      for (int r = 0; r < NC; ++r) {
        float* dst = cluster.map_shared_rank(slot, r);
#pragma unroll
        for (int g = 0; g < 4; ++g) dst[g * H] = dgt[g];
      }
    }
    cluster.sync();  // every CTA holds the group's dgates of this step
    float acc[MAX_BG];
#pragma unroll
    for (int b = 0; b < MAX_BG; ++b) acc[b] = 0.0f;
    const float4* dg4 = reinterpret_cast<const float4*>(dg + p * BG * G);
    for (int cc = 0; cc < U; ++cc) {
      const int c4 = s * U + cc;
      const float4 wv = wr4[c4 * U + j];
#pragma unroll
      for (int b = 0; b < MAX_BG; ++b) {
        if (b < BG) {
          const float4 d = dg4[b * H + c4];
          acc[b] = fmaf(d.x, wv.x, fmaf(d.y, wv.y, fmaf(d.z, wv.z, fmaf(d.w, wv.w, acc[b]))));
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAX_BG; ++b)
      if (b < BG) part[(s * BG + b) * U + j] = acc[b];
    __syncthreads();
    if (active) {
      float sum = 0.0f;
      for (int q = 0; q < NC; ++q) sum += part[(q * BG + bo) * U + j];
      dh += sum;
    }
  }
  if (active && d_h0) {
    d_h0[state] = from_f32<T>(dh);
    d_c0[state] = from_f32<T>(dc);
  }
}

// The clusters that can run at once with `smem` bytes a CTA (cached in `cache` by H: a generation launches K5
// once a stack). The kernel's dynamic shared memory limit is raised once, to what the largest H and BG need.
template <typename Kernel>
int resident_clusters(Kernel kernel, int* cache, int H, size_t smem, size_t smem_max) {
  if (cache[H] > 0) return cache[H];
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_max);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(NC);
  cfg.blockDim = dim3(H);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  if (n < 1) return -(int)cudaErrorInvalidConfiguration;
  cache[H] = n;
  return n;
}

// Launch `kernel` (D directions) on clusters of NC CTAs of H threads: for each direction as many clusters of BG
// rows as the batch needs, BG the least that keeps every cluster of the launch resident (at most MAX_BG). A
// larger batch runs in waves: clusters never wait on each other.
template <int D, typename Kernel, typename... Args>
int launch(Kernel kernel, int* cache, size_t (*smem_of)(int, int), int B, int H, cudaStream_t stream,
           Args... args) {
  const int clusters = resident_clusters(kernel, cache, H, smem_of(H, MAX_BG), smem_of(MAX_H, MAX_BG));
  if (clusters < 0) {
    cudaGetLastError();
    return -clusters;
  }
  const int per_direction = clusters / D > 0 ? clusters / D : 1;
  int BG = (B + per_direction - 1) / per_direction;
  BG = BG < 1 ? 1 : (BG > MAX_BG ? MAX_BG : BG);
  const int groups = (B + BG - 1) / BG;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(NC * groups * D);
  cfg.blockDim = dim3(H);
  cfg.dynamicSmemBytes = smem_of(H, BG);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., BG, groups);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline bool valid(int B, int T, int H) { return B >= 1 && T >= 1 && H % NC == 0 && H >= NC && H <= MAX_H; }

}  // namespace lstm
}  // namespace blvm
