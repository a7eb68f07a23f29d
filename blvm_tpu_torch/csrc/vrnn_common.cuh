// What the chain kernels with a grid barrier a stage share: K7 (gru.cu), K7-bwd (gru_bwd.cu), K9
// (srnn_chain.cu), K9-bwd (srnn_chain_bwd.cu), K10 (rssm_cell.cu) and K10-bwd (rssm_cell_bwd.cu): the CTA's
// shape, a stage's weight segments in shared memory, its staged input rows, its products, the grid barrier, the
// trace clock, the backward's softplus slope and the cooperative launch's limits. Other kernels (K8 and K8-bwd
// through tagged_chain.cuh, K12, P2/P3) take helpers from here.
#pragma once

#include "common.cuh"

namespace blvm {
namespace vrnn {

constexpr int NT = 256;       // threads a CTA
constexpr int NW = NT / 32;   // warps a CTA
constexpr int BC = 8;         // batch rows a pass of a stage (accumulators a lane)
constexpr int NWEIGHTS = 28;  // prior 8, posterior 8, phi 8, GRU 4 (see blvm_vrnn_cell)
constexpr int MAX_SEGS = 5;
constexpr int NPHASES = 4;  // of a stage, in the trace: inputs in, products, finish and store, barrier

// Units [col0, col0 + n) of one weight matrix with row stride ld, one unit's K weights contiguous in shared
// memory: K8 keeps output units (columns of a (K, ld) kernel, with their biases b[col0 ...]), K8-bwd input
// units (rows of an (n_in, K) kernel, ld = K, no bias). `region` picks the staged input the unit reads.
struct Seg {
  const float* w;
  const float* b;
  int ld, col0, n, region;
};

struct Stage {
  Seg seg[MAX_SEGS];
  int nseg, K, ncols;
  float* ws;  // ncols x K in shared memory, unit after unit
  float* bs;  // ncols
};

static __device__ __forceinline__ Seg make_seg(const float* w, const float* b, int ld, int col0, int n, int region) {
  Seg s;
  s.w = w;
  s.b = b;
  s.ld = ld;
  s.col0 = col0;
  s.n = n;
  s.region = region;
  return s;
}

static __device__ __forceinline__ int part_lo(int n, int c, int parts) { return (int)((long long)n * c / parts); }

// All CTAs meet (they are co-resident: a cooperative launch). The CTA's stores are ordered before the
// arrival by the CTA barrier and a gpu-scope release fence; the arrival is a fire-and-forget reduction on
// one counter; the acquire load that sees every arrival orders the CTA's later loads after them.
static __device__ __forceinline__ void grid_sync(unsigned int* counter, unsigned int& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
    } while ((int)(seen - target) < 0);
  }
  __syncthreads();
}

static __device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the partial products of a stage: res[c][b] = sum_k act[region(c)][b][k] ws[c][k] for its ncols units
static __device__ void stage_products(const Stage& st, const float* act, float* res) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = st.K, ncols = st.ncols;
  for (int c = warp; c < ncols; c += NW) {
    int s = 0, first = 0;
    while (c >= first + st.seg[s].n) first += st.seg[s++].n;
    const float* a = act + st.seg[s].region * BC * K;
    const float* wc = st.ws + (size_t)c * K;
    float acc[BC];
#pragma unroll
    for (int b = 0; b < BC; ++b) acc[b] = 0.0f;
#pragma unroll 4
    for (int k = lane; k < K; k += 32) {
      const float wv = wc[k];
#pragma unroll
      for (int b = 0; b < BC; ++b) acc[b] = fmaf(a[b * K + k], wv, acc[b]);
    }
    float mine = 0.0f;
#pragma unroll
    for (int b = 0; b < BC; ++b) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
      if (lane == b) mine = acc[b];
    }
    if (lane < BC) res[c * BC + lane] = mine;
  }
}

// Rows [b0, b0 + BC) of one or two (B, K) inputs (row stride `stride`; s1 may be null) into act's
// regions 0 and 1, zeros past B. Each thread issues all its loads (up to 2 x 2 x BC) before it stores
// any, so a stage waits out one L2 latency, not one a load.
static __device__ __forceinline__ void load_stage(float* act, const float* s0, const float* s1, int64_t stride, int K,
                                                  int b0, int B) {
  const int nb = min(BC, B - b0);
  for (int k0 = threadIdx.x; k0 < K; k0 += 2 * NT) {
    float v0[2][BC], v1[2][BC];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + j * NT;
#pragma unroll
      for (int b = 0; b < BC; ++b) {
        const bool ok = k < K && b < nb;
        const int64_t o = (int64_t)(b0 + b) * stride + k;
        v0[j][b] = ok ? __ldcg(s0 + o) : 0.0f;
        v1[j][b] = ok && s1 ? __ldcg(s1 + o) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = k0 + j * NT;
      if (k < K) {
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          act[b * K + k] = v0[j][b];
          if (s1) act[(BC + b) * K + k] = v1[j][b];
        }
      }
    }
  }
}

static __device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.0f); }

static __device__ __forceinline__ float softplus_sd(float raw, float beta, float eps) {
  return __fadd_rn(__fdiv_rn(softplusf(__fmul_rn(beta, raw)), beta), eps);
}

// d softplus(beta x) / beta / dx = sigmoid(beta x), in a form that neither overflows nor loses the tails
static __device__ __forceinline__ float softplus_slope(float raw, float beta) {
  const float x = __fmul_rn(beta, raw);
  const float e = expf(-fabsf(x));
  return x >= 0.0f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

static __device__ __forceinline__ float ldg_or0(const float* p, int64_t o) { return p ? __ldg(p + o) : 0.0f; }

// A cooperative kernel's launch limits, asked once per device and shared-memory size (a generation
// launches K8 once a stack).
struct LaunchCache {
  int dev = -1, sms = 0, smem_optin = 0, per_sm = 0;
  size_t smem = 0;
};

// the current device's SM count into c.sms
static inline cudaError_t query_device(LaunchCache& c) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev == c.dev) return err;
  err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&c.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  c.dev = dev;
  c.smem = 0;
  return cudaSuccess;
}

// cudaSuccess when a grid of NB CTAs of NT threads with `smem` bytes each can all be resident;
// cudaErrorCooperativeLaunchTooLarge when they cannot
static inline cudaError_t prepare_cooperative(LaunchCache& c, const void* kernel, size_t smem, int NB) {
  if (smem > (size_t)c.smem_optin) return cudaErrorCooperativeLaunchTooLarge;
  if (smem != c.smem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, kernel, NT, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    c.smem = smem;
  }
  return (long long)c.per_sm * c.sms < NB ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

}  // namespace vrnn
}  // namespace blvm
