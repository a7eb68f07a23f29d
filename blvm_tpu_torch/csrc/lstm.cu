// K5 and K5-bwd: the masked LSTM recurrence, forward and backward through time, on sm_90a.
//
// Replaces the lax.scan step of blvm_tpu/modules/recurrent.py LSTM.__call__ (:92-102), which the JAX
// package shaped by hand for the TPU (time-parallel input projection outside the scan, the carry masked
// past each length). Per step t, for a row of the batch:
//   gates = xw_t + h_{t-1} W_hh + b_hh   (gate order i, f, g, o; xw = x W_ih + b_ih, computed outside)
//   c_new = sigmoid(f) c + sigmoid(i) tanh(g);  h_new = sigmoid(o) tanh(c_new)
//   h = m h_new + (1 - m) h;  c = m c_new + (1 - m) c;  out_t = h_new m
// Tensors are batch-first and contiguous: xw (B, T, 4H), out (B, T, H), W_hh (H, 4H), h0 / c0 (B, H),
// mask (B, T) float32 or null (all ones).
//
// What bounds it. At the benchmark shape (B = 10, T ~ 1000 stacks, H = 256, f32) the products are
// 2 B T H 4H ~ 5.2 GFLOP (~78 us at 67 TFLOP/s) and the compulsory bytes ~0.1 GB (~30 us at 3.35 TB/s),
// but the T steps form a serial chain of (B, H) x (H, 4H) products: each step's latency (reading W_hh,
// a barrier, the exchange of h) sets the pace, not bytes or operations.
//
// The design: one persistent launch for all T steps. A thread-block cluster of NC = 8 CTAs runs a group
// of BG sequences (several clusters split the batch, BG chosen so that they are all resident). CTA r owns
// hidden units [r U, (r + 1) U), U = H / 8, and keeps the four gate columns of W_hh for those units in
// shared memory for the whole launch (2 H^2 bytes, 128 KB at H = 256), so W_hh is read from device
// memory once a launch, not once a step. A step: each of the CTA's H threads (unit j, k-slice s) forms
// the partial gate sums of unit j over k in [s U, (s + 1) U) from the CTA's copy of h_{t-1}; a barrier;
// the "owner" thread of (unit, row) adds the 8 partials, updates c and h in registers with the mask,
// writes the step's output and sends h to every CTA's next h buffer through distributed shared memory
// (double-buffered); one cluster barrier ends the step. For training the forward also writes the
// activated gates and the carried (h, c) before each step, so the backward never replays the chain.
//
// K5-bwd runs the chain in reverse with the same split. The owner of (unit, row) holds the carried dh
// and dc in registers, forms dgates for its unit from dh + dout m and dc, writes them and sends them to
// every CTA's dgates buffer through distributed shared memory; after the cluster barrier each CTA forms
// dh_{t-1} for its units as dgates (B, 4H) times its rows W_hh[units, :], which it keeps resident. A
// masked step passes dh and dc through unchanged. dW_hh, db_hh (sums over B T rows) and dxw = dgates are
// left to cuBLAS by the wrapper, as the JAX backward leaves them to XLA.
//
// bf16: every value is rounded where XLA rounds it in the JAX step: each dot's f32 sum once, then every
// add, nonlinearity and product; the state is kept as its bf16 values. The backward computes in f32
// from the saved bf16 values and rounds dgates to bf16.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace blvm {
namespace lstm {

constexpr int NC = 8;       // CTAs of a cluster (the portable maximum)
constexpr int MAX_H = 256;  // 2 H^2 bytes of W_hh per CTA, plus buffers, under 227 KB
constexpr int MAX_BG = 8;   // sequences of one cluster: the owner threads, U BG, must not outnumber the H threads

// the value a T holds: f32 unchanged, bf16 rounded to nearest even
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f32<T>(from_f32<T>(v)); }

template <typename T>
__device__ __forceinline__ float ld(const T* p, int64_t i) { return to_f32<T>(p[i]); }

size_t fwd_smem(int H, int BG) {  // W (H x U float4), h (2 x H x BG), partial sums (NC x BG x U float4)
  return (size_t)2 * H * H + (size_t)8 * H * BG + (size_t)16 * H * BG;
}

size_t bwd_smem(int H, int BG) {  // W rows (U x 4H), dgates (2 x BG x 4H), partial sums (NC x BG x U)
  return (size_t)2 * H * H + (size_t)32 * H * BG + (size_t)4 * H * BG;
}

template <typename T>
__global__ void __launch_bounds__(MAX_H) lstm_fwd_kernel(
    const T* __restrict__ xw, const T* __restrict__ w_hh, const T* __restrict__ b_hh, const float* __restrict__ mask,
    const T* __restrict__ h0, const T* __restrict__ c0, T* __restrict__ out, T* __restrict__ h_n,
    T* __restrict__ c_n, T* __restrict__ gates_out, T* __restrict__ h_prev_out, T* __restrict__ c_prev_out, int B,
    int Tn, int H, int BG) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / NC;
  const int U = H / NC, G = 4 * H;
  const int tid = threadIdx.x;
  const int j = tid % U, s = tid / U;  // the product: unit j of this CTA, k-slice s

  extern __shared__ float4 smem4[];
  float4* w4 = smem4;                                  // [H][U]: W_hh[k][g H + unit j], g = 0..3
  float* hbuf = reinterpret_cast<float*>(w4 + H * U);  // [2][H][BG]: h_{t-1} of the group
  float4* part = reinterpret_cast<float4*>(hbuf + 2 * H * BG);  // [NC][BG][U]: partial gate sums

  float* w = reinterpret_cast<float*>(w4);
  for (int idx = tid; idx < H * 4 * U; idx += blockDim.x) {
    const int k = idx / (4 * U), r = idx % (4 * U), g = r / U, jj = r % U;
    w[(k * U + jj) * 4 + g] = ld(w_hh, (int64_t)k * G + g * H + rank * U + jj);
  }
  for (int idx = tid; idx < H * BG; idx += blockDim.x) {
    const int k = idx / BG, b = idx % BG, row = group * BG + b;
    hbuf[idx] = row < B ? ld(h0, (int64_t)row * H + k) : 0.0f;
  }
  // the owner of (unit, row): thread bo U + j keeps unit j's state of row bo of the group
  const bool owner = tid < U * BG;
  const int bo = s, unit = rank * U + j, row = group * BG + bo;
  const bool active = owner && row < B;
  float h = 0.0f, c = 0.0f, bias[4];
  if (active) {
    h = ld(h0, (int64_t)row * H + unit);
    c = ld(c0, (int64_t)row * H + unit);
  }
#pragma unroll
  for (int g = 0; g < 4; ++g) bias[g] = ld(b_hh, g * H + unit);
  cluster.sync();  // every CTA of the cluster runs and holds its weights before any h is exchanged

  for (int t = 0; t < Tn; ++t) {
    const int p = t & 1;
    const int64_t rt = (int64_t)row * Tn + t;
    float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f}, m = 0.0f;
    if (active) {  // issued before the product, which hides their latency
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[g] = ld(xw, rt * G + g * H + unit);
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
          gates_out[rt * G + unit] = from_f32<T>(ig);
          gates_out[rt * G + H + unit] = from_f32<T>(fg);
          gates_out[rt * G + 2 * H + unit] = from_f32<T>(gg);
          gates_out[rt * G + 3 * H + unit] = from_f32<T>(og);
          h_prev_out[rt * H + unit] = from_f32<T>(h);
          c_prev_out[rt * H + unit] = from_f32<T>(c);
        }
        const float keep = rnd<T>(1.0f - m);
        h = rnd<T>(rnd<T>(m * h_new) + rnd<T>(keep * h));
        c = rnd<T>(rnd<T>(m * c_new) + rnd<T>(keep * c));
        out[rt * H + unit] = from_f32<T>(h_new * m);
      }
      float* next = hbuf + (1 - p) * H * BG + unit * BG + bo;  // h of a padding row stays 0
#pragma unroll
      for (int r = 0; r < NC; ++r) *cluster.map_shared_rank(next, r) = h;
    }
    cluster.sync();  // the next h is in every CTA; the last reads of this step's buffers are done
  }
  if (active) {
    h_n[(int64_t)row * H + unit] = from_f32<T>(h);
    c_n[(int64_t)row * H + unit] = from_f32<T>(c);
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_H) lstm_bwd_kernel(
    const T* __restrict__ w_hh, const float* __restrict__ mask, const T* __restrict__ gates,
    const T* __restrict__ c_prev, const T* __restrict__ d_out, const T* __restrict__ d_h_n,
    const T* __restrict__ d_c_n, T* __restrict__ d_gates, T* __restrict__ d_h0, T* __restrict__ d_c0, int B, int Tn,
    int H, int BG) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int group = blockIdx.x / NC;
  const int U = H / NC, G = 4 * H;
  const int tid = threadIdx.x;
  const int j = tid % U, s = tid / U;  // the product: unit j of this CTA, slice s of the 4H columns (H/8 float4s)

  extern __shared__ float4 smem4[];
  float4* wr4 = smem4;                                   // [H][U]: W_hh[unit j][4 c4 .. 4 c4 + 3] at [c4][j]
  float* dg = reinterpret_cast<float*>(wr4 + H * U);     // [2][BG][4H]: dgates of the group
  float* part = dg + 2 * BG * G;                         // [NC][BG][U]: partial sums of dh

  float* wr = reinterpret_cast<float*>(wr4);
  for (int idx = tid; idx < U * G; idx += blockDim.x) {
    const int jj = idx / G, col = idx % G;
    wr[((col / 4) * U + jj) * 4 + col % 4] = ld(w_hh, (int64_t)(rank * U + jj) * G + col);
  }
  const bool owner = tid < U * BG;
  const int bo = s, unit = rank * U + j, row = group * BG + bo;
  const bool active = owner && row < B;
  float dh = 0.0f, dc = 0.0f;
  if (active) {
    dh = d_h_n ? ld(d_h_n, (int64_t)row * H + unit) : 0.0f;
    dc = d_c_n ? ld(d_c_n, (int64_t)row * H + unit) : 0.0f;
  }
  cluster.sync();

  for (int t = Tn - 1; t >= 0; --t) {
    const int p = t & 1;
    if (owner) {
      float dgt[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (active) {
        const int64_t rt = (int64_t)row * Tn + t;
        const float ig = ld(gates, rt * G + unit), fg = ld(gates, rt * G + H + unit);
        const float gg = ld(gates, rt * G + 2 * H + unit), og = ld(gates, rt * G + 3 * H + unit);
        const float cp = ld(c_prev, rt * H + unit);
        const float m = mask ? mask[rt] : 1.0f;
        const float dout = d_out ? ld(d_out, rt * H + unit) : 0.0f;
        const float c_new = rnd<T>(rnd<T>(fg * cp) + rnd<T>(ig * gg));  // as the forward rounded it
        const float tc = rnd<T>(tanhf(c_new));
        const float dh_new = m * (dh + dout);
        const float dc_new = m * dc + dh_new * og * (1.0f - tc * tc);
        dgt[0] = rnd<T>(dc_new * gg * ig * (1.0f - ig));
        dgt[1] = rnd<T>(dc_new * cp * fg * (1.0f - fg));
        dgt[2] = rnd<T>(dc_new * ig * (1.0f - gg * gg));
        dgt[3] = rnd<T>(dh_new * tc * og * (1.0f - og));
#pragma unroll
        for (int g = 0; g < 4; ++g) d_gates[rt * G + g * H + unit] = from_f32<T>(dgt[g]);
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
    cluster.sync();  // every CTA holds the group's dgates of step t
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
  if (active) {
    d_h0[(int64_t)row * H + unit] = from_f32<T>(dh);
    d_c0[(int64_t)row * H + unit] = from_f32<T>(dc);
  }
}

// The clusters that can run at once with `smem` bytes a CTA, per kernel and H (cached: a generation
// launches K5 once a stack). The kernel's dynamic shared memory limit is raised once, to what the
// largest H and BG need.
template <typename Kernel>
int resident_clusters(Kernel kernel, int H, size_t smem, size_t smem_max) {
  static int cache[MAX_H + 1] = {0};
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

// Launch `kernel` on clusters of NC CTAs of H threads, BG sequences a cluster, as many clusters as the
// batch needs; BG is the least that keeps every cluster resident (at most MAX_BG).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t (*smem_of)(int, int), int B, int H, cudaStream_t stream, Args... args) {
  const int clusters = resident_clusters(kernel, H, smem_of(H, MAX_BG), smem_of(MAX_H, MAX_BG));
  if (clusters < 0) {
    cudaGetLastError();
    return -clusters;
  }
  int BG = (B + clusters - 1) / clusters;
  BG = BG < 1 ? 1 : (BG > MAX_BG ? MAX_BG : BG);
  const int groups = (B + BG - 1) / BG;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(NC * groups);
  cfg.blockDim = dim3(H);
  cfg.dynamicSmemBytes = smem_of(H, BG);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., BG);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool valid(int B, int T, int H, int dtype) {
  return B >= 1 && T >= 1 && H % NC == 0 && H >= NC && H <= MAX_H && (dtype == kFloat32 || dtype == kBFloat16);
}

template <typename T>
int run_fwd(const void* xw, const void* w_hh, const void* b_hh, const void* mask, const void* h0, const void* c0,
            void* out, void* h_n, void* c_n, void* gates, void* h_prev, void* c_prev, int B, int Tn, int H,
            cudaStream_t stream) {
  return launch(lstm_fwd_kernel<T>, fwd_smem, B, H, stream, static_cast<const T*>(xw), static_cast<const T*>(w_hh),
                static_cast<const T*>(b_hh), static_cast<const float*>(mask), static_cast<const T*>(h0),
                static_cast<const T*>(c0), static_cast<T*>(out), static_cast<T*>(h_n), static_cast<T*>(c_n),
                static_cast<T*>(gates), static_cast<T*>(h_prev), static_cast<T*>(c_prev), B, Tn, H);
}

template <typename T>
int run_bwd(const void* w_hh, const void* mask, const void* gates, const void* c_prev, const void* d_out,
            const void* d_h_n, const void* d_c_n, void* d_gates, void* d_h0, void* d_c0, int B, int Tn, int H,
            cudaStream_t stream) {
  return launch(lstm_bwd_kernel<T>, bwd_smem, B, H, stream, static_cast<const T*>(w_hh),
                static_cast<const float*>(mask), static_cast<const T*>(gates), static_cast<const T*>(c_prev),
                static_cast<const T*>(d_out), static_cast<const T*>(d_h_n), static_cast<const T*>(d_c_n),
                static_cast<T*>(d_gates), static_cast<T*>(d_h0), static_cast<T*>(d_c0), B, Tn, H);
}

}  // namespace lstm
}  // namespace blvm

// gates, h_prev, c_prev: null for inference; else (B, T, 4H), (B, T, H), (B, T, H), all written.
extern "C" int blvm_lstm_recurrence(const void* xw, const void* w_hh, const void* b_hh, const void* mask,
                                    const void* h0, const void* c0, void* out, void* h_n, void* c_n, void* gates,
                                    void* h_prev, void* c_prev, int B, int T, int H, int dtype, void* stream) {
  using namespace blvm;
  if (!lstm::valid(B, T, H, dtype) || (gates && (!h_prev || !c_prev))) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return lstm::run_fwd<__nv_bfloat16>(xw, w_hh, b_hh, mask, h0, c0, out, h_n, c_n, gates, h_prev, c_prev, B, T,
                                         H, st);
  return lstm::run_fwd<float>(xw, w_hh, b_hh, mask, h0, c0, out, h_n, c_n, gates, h_prev, c_prev, B, T, H, st);
}

// d_out, d_h_n, d_c_n: null reads as zeros. Writes d_gates (B, T, 4H), d_h0 and d_c0 (B, H).
extern "C" int blvm_lstm_recurrence_bwd(const void* w_hh, const void* mask, const void* gates, const void* c_prev,
                                        const void* d_out, const void* d_h_n, const void* d_c_n, void* d_gates,
                                        void* d_h0, void* d_c0, int B, int T, int H, int dtype, void* stream) {
  using namespace blvm;
  if (!lstm::valid(B, T, H, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16)
    return lstm::run_bwd<__nv_bfloat16>(w_hh, mask, gates, c_prev, d_out, d_h_n, d_c_n, d_gates, d_h0, d_c0, B, T,
                                         H, st);
  return lstm::run_bwd<float>(w_hh, mask, gates, c_prev, d_out, d_h_n, d_c_n, d_gates, d_h0, d_c0, B, T, H, st);
}
