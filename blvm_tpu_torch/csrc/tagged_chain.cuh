// What K8 (vrnn_cell.cu) and K8-bwd (vrnn_cell_bwd.cu) share: a chain of dependent products a step, run as one
// persistent cooperative launch over all steps, its stages handing values from CTA to CTA as tagged words
// (decode_common.cuh) in place of grid barriers.
//
//   - A stage's units (output units in K8, input units in K8-bwd) are cut over the CTAs; each CTA keeps its units'
//     weights resident in shared memory for the whole launch, a unit's K weights contiguous (K padded to KP, a
//     multiple of 4, with zeros).
//   - A stage gathers its input rows, all rows of the batch up to RB_MAX a pass, from tagged words that every CTA
//     published in the stage before (gather): each thread spins on exactly the words it loads, so a word that is
//     there when first loaded costs one round trip through L2, and no fence, flag or barrier is needed.
//   - Products: a work item is 4 columns x 8 rows of one group (the columns that read one input region); its
//     warp's lanes split K in float4s, a lane keeps the 32 partial sums in registers, and one transposing
//     reduction (31 shuffles) leaves one (column, row) sum a lane. With few items, K is split into 2 or 4 parts
//     over more warps, summed in a fixed order by the stage's finish, so two launches are bitwise equal.
//   - Read-only inputs a stage's finish needs (x products, noise, saved activations, incoming gradients) are
//     copied into shared memory by cp.async before the stage's gather, so their latency hides behind it.
//   - Every wait is bounded (decode::Watch): a timeout sets the status word and ends the launch.
#pragma once

#include "decode_common.cuh"
#include "vrnn_common.cuh"

namespace blvm {
namespace chain {

constexpr int NT = 256;      // threads a CTA
constexpr int NW = NT / 32;  // warps a CTA
constexpr int CB = 4;        // columns of a work item
constexpr int RBK = 8;       // rows of a work item
constexpr int RB_MAX = 32;   // rows a pass, at most (the entry point's choice: all of B up to this)
constexpr int MAX_GROUPS = 2;
constexpr int NPHASES = 3;  // of a stage, in the trace: inputs in (waiting included), products, finish and publish
constexpr int GATHER = 8;    // tagged words a thread has in flight in a gather
constexpr size_t STATIC_SMEM = 2048;  // room left for a kernel's static shared memory (descriptors, trace)

__host__ __device__ constexpr int pad4(int k) { return (k + 3) & ~3; }

// The columns of a stage that read one input region: n units of KP weights each, unit after unit, from ws; their
// sums go to columns [col0, col0 + n) of the stage's results.
struct Group {
  const float* ws;
  int n, region, col0;
};

// A stage's products: its groups, its column count and the weights' row length
struct Prod {
  Group g[MAX_GROUPS];
  const float* bias;  // the columns' biases (K8), or null
  int ng, ncols, K, KP;
};

// The tagged input of a stage: region r's row b is the words src[r] + b ld + [0, K), each to carry `want`
struct Input {
  const unsigned long long* src[2];
  int64_t ld;
  int nreg;
  uint32_t want;
};

static __device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(decode::smem_addr(dst)), "l"(src) : "memory");
}
static __device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

// A read-only input into shared memory without a register: by cp.async, or 0 where there is no tensor
static __device__ __forceinline__ void fetch(float* dst, const float* src, int64_t o) {
  if (src)
    cp_async4(dst, src + o);
  else
    *dst = 0.0f;
}

// Columns [col0, col0 + n) of a (K, ld) matrix (K8: a layer's output units) into ws, KP floats a unit, zero-padded;
// a thread copies rows k of 4 columns, all its loads first
static __device__ __forceinline__ void load_columns(float* ws, const float* W, int ld, int col0, int n, int K,
                                                    int KP) {
  for (int j0 = 0; j0 < n; j0 += 4)
    for (int k = threadIdx.x; k < KP; k += NT) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j0 + j < n && k < K ? __ldg(W + (int64_t)k * ld + col0 + j0 + j) : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j0 + j < n) ws[(size_t)(j0 + j) * KP + k] = v[j];
    }
}

// Rows [row0, row0 + n) of an (n_in, ld) matrix (K8-bwd: a layer's input units), words [kw0, kw0 + K) of each, into
// ws at offset `at` of KP-float units (the rest of each unit left as it is); coalesced along the row
static __device__ __forceinline__ void load_rows(float* ws, const float* W, int ld, int row0, int n, int kw0,
                                                 int K, int KP, int at) {
  for (int j = 0; j < n; ++j)
    for (int k = threadIdx.x; k < K; k += NT) ws[(size_t)j * KP + at + k] = __ldg(W + (int64_t)(row0 + j) * ld + kw0 + k);
}

static __device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += NT) p[i] = 0.0f;
}

// The input rows of a pass (rows b0 ... b0 + nb - 1 of each region), words [k0, k0 + w) of each, into act: row'
// = r nb + b at act + row' stride. A thread's loads are words i = tid + j NT of the rows laid end to end, each CTA
// starting at its own place (rotated by its index, so the CTAs reading the same words do not all ask the same L2
// slice at once), stepped from row to row without a division. A batch's GATHER loads are all in flight before the
// first is waited for; each further round loads again, together, the words not tagged yet, and `reloads` counts
// them. False on a timeout (the status word set).
static __device__ __forceinline__ bool gather(const Input& in, int nb, int b0, int k0, int w, float* act, int stride,
                                              const decode::Watch& watch, int& reloads) {
  const unsigned long long* const s0 = in.src[0] + (int64_t)b0 * in.ld + k0;
  const unsigned long long* const s1 = in.nreg > 1 ? in.src[1] + (int64_t)(b0 - nb) * in.ld + k0 : s0;
  const uint32_t want = in.want;
  const int n = in.nreg * nb * w, dq = NT / w, dr = NT - dq * w;
  const int nrows = in.nreg * nb;
  const int q0 = (int)((threadIdx.x + (long long)n * blockIdx.x / gridDim.x) % n);
  int row = q0 / w, k = q0 - row * w;
  auto step = [&](int& r_, int& k_) {
    k_ += dr;
    r_ += dq;
    if (k_ >= w) {
      k_ -= w;
      ++r_;
    }
    if (r_ >= nrows) r_ -= nrows;
  };
  auto load = [&](int r_, int k_) { return decode::peek((r_ < nb ? s0 : s1) + (int64_t)r_ * in.ld + k_); };
  for (int i0 = threadIdx.x; i0 < n; i0 += GATHER * NT) {
    const int m = min(GATHER, (n - i0 + NT - 1) / NT);  // this batch's loads
    unsigned long long v[GATHER];
    int r_ = row, k_ = k;
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      if (j < m) v[j] = load(r_, k_);
      step(r_, k_);
    }
    long long deadline = decode::now_ns() + watch.limit_ns;  // the wait counts from the batch's first loads
    int spins = 0;
    auto bad = [&](int j) { return j < m && decode::tag_of(v[j]) != want; };
    for (;;) {
      bool ready = true;
#pragma unroll
      for (int j = 0; j < GATHER; ++j)
        if (bad(j)) ready = false;
      if (ready) break;
      if (!decode::keep_waiting(watch, deadline, spins)) return false;
      int r2 = row, k2 = k;
#pragma unroll
      for (int j = 0; j < GATHER; ++j) {
        if (bad(j)) {
          v[j] = load(r2, k2);
          ++reloads;
        }
        step(r2, k2);
      }
    }
    int r2 = row, k2 = k;
#pragma unroll
    for (int j = 0; j < GATHER; ++j) {
      if (j < m) act[r2 * stride + k2] = __uint_as_float((uint32_t)v[j]);
      step(r2, k2);
    }
    row = r_;
    k = k_;
  }
  return true;
}

// zeros into words [w, wp) of each of nrows staged rows: the padding of K past its last chunk's words
static __device__ __forceinline__ void zero_pad(float* act, int nrows, int w, int wp, int stride) {
  const int pad = wp - w;
  for (int i = threadIdx.x; i < nrows * pad; i += NT) act[(i / pad) * stride + w + i % pad] = 0.0f;
}

// One round of reduce_transposed: of the 2H values a lane holds, it keeps the half its lane bit H picks and adds
// the partner's (lane ^ H) copy of that half; v[i] then holds value (lane & H) + i of the round before's numbering
template <int H>
static __device__ __forceinline__ void reduce_round(float (&v)[32], int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// The 32 partial sums of a lane (a[c][r], c < CB, r < RBK) summed over the warp's lanes, transposed: lane l gets
// the sum of value l = c RBK + r. Five rounds, each sending half of what the lane holds (31 shuffles), every index
// known when compiled, so the values stay in registers.
static __device__ __forceinline__ float reduce_transposed(float (&a)[CB][RBK]) {
  static_assert(CB * RBK == 32, "one value a lane");
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int c = 0; c < CB; ++c)
#pragma unroll
    for (int r = 0; r < RBK; ++r) v[c * RBK + r] = a[c][r];
  reduce_round<16>(v, lane);
  reduce_round<8>(v, lane);
  reduce_round<4>(v, lane);
  reduce_round<2>(v, lane);
  reduce_round<1>(v, lane);
  return v[0];
}

// How many parts a stage's K is split into: as many (1, 2 or 4) as keep every warp busy and each part at least a
// float4 a lane
static __device__ __forceinline__ int k_parts(const Prod& P, int nb, int kw) {
  const int rblocks = (nb + RBK - 1) / RBK;
  int items = 0;
  for (int i = 0; i < P.ng; ++i) items += (P.g[i].n + CB - 1) / CB * rblocks;
  int ks = 1;
  while (ks < 4 && items * ks * 2 <= NW && kw / 4 / (ks * 2) >= 32) ks *= 2;
  return ks;
}

// The partial products of words [k0, k0 + kw) of K: every (column, row) of the stage's groups against the staged
// rows (region r's row b at act + (r nb + b) stride); part p of KS k-parts of column c, row b to
// res[(p ncols + c) RS + b], added to what is there when `accumulate` (a later chunk of K)
static __device__ __forceinline__ void products(const Prod& P, const float* act, int stride, int nb, int k0, int kw, int KS,
                                      float* res, int RS, bool accumulate) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rblocks = (nb + RBK - 1) / RBK;
  const int cb0 = (P.g[0].n + CB - 1) / CB;
  const int items = (cb0 + (P.ng > 1 ? (P.g[1].n + CB - 1) / CB : 0)) * rblocks;
  const int K4 = kw >> 2, q = (K4 + KS - 1) / KS, s4 = stride >> 2;
  for (int wi = warp; wi < items * KS; wi += NW) {
    const int item = wi / KS, part = wi - item * KS;
    const int cbi = item / rblocks, rb = item - cbi * rblocks;
    const bool second = cbi >= cb0;
    const Group& G = P.g[second ? 1 : 0];
    const int c0 = (second ? cbi - cb0 : cbi) * CB, r0 = rb * RBK;
    const float4* wv[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c)
      wv[c] = reinterpret_cast<const float4*>(G.ws + (size_t)min(c0 + c, G.n - 1) * P.KP + k0);
    // rows past the pass's last repeat it (their sums are not stored), so no row past the staged ones is read
    const float4* av = reinterpret_cast<const float4*>(act + (size_t)G.region * nb * stride);
    int ro[RBK];
#pragma unroll
    for (int r = 0; r < RBK; ++r) ro[r] = min(r0 + r, nb - 1) * s4;
    float a[CB][RBK];
#pragma unroll
    for (int c = 0; c < CB; ++c)
#pragma unroll
      for (int r = 0; r < RBK; ++r) a[c][r] = 0.0f;
    const int kb = part * q, ke = min(K4, kb + q);
    for (int k4 = kb + lane; k4 < ke; k4 += 32) {
      float4 w[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) w[c] = wv[c][k4];
#pragma unroll
      for (int r = 0; r < RBK; ++r) {
        const float4 x = av[ro[r] + k4];
#pragma unroll
        for (int c = 0; c < CB; ++c)
          a[c][r] = fmaf(x.w, w[c].w, fmaf(x.z, w[c].z, fmaf(x.y, w[c].y, fmaf(x.x, w[c].x, a[c][r]))));
      }
    }
    const float v = reduce_transposed(a);
    const int c = c0 + lane / RBK, r = r0 + lane % RBK;
    if (c < G.n && r < nb) {
      float* d = res + (size_t)(part * P.ncols + G.col0 + c) * RS + r;
      *d = accumulate ? *d + v : v;
    }
  }
}

// The stage's sum of column c, row b: its k-parts in order
static __device__ __forceinline__ float sum_of(const float* res, int ncols, int RS, int KS, int c, int b) {
  float v = res[(size_t)c * RS + b];
  for (int p = 1; p < KS; ++p) v += res[(size_t)(p * ncols + c) * RS + b];
  return v;
}

// Shared memory a CTA needs beside its resident weights and carries: the staged rows (act_floats, 16-byte
// aligned), the k-parts' sums (4 parts of max_cols columns of RB rows) and two buffers of side inputs
__host__ __device__ inline size_t work_floats(int act_floats, int max_cols, int RB, int side) {
  return (size_t)act_floats + (size_t)4 * max_cols * RB + 2 * (size_t)side;
}

// The co-residency of a cooperative launch of NB CTAs of NT threads and `smem` bytes, its limits asked once per
// device and shared-memory size (a generation launches K8 once a stack)
struct LaunchCache {
  int dev = -1, sms = 0, smem_optin = 0, per_sm = 0;
  size_t smem = 0;
};

inline cudaError_t query_device(LaunchCache& c) {
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

inline cudaError_t prepare(LaunchCache& c, const void* kernel, size_t smem, int NB) {
  if (smem + STATIC_SMEM > (size_t)c.smem_optin) return cudaErrorCooperativeLaunchTooLarge;
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

}  // namespace chain
}  // namespace blvm
