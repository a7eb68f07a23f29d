// K13 and K13-bwd: the CTC loss of the ASR probe and its gradient, optax's recursion, on sm_90a.
//
// Replaces no TPU kernel: the JAX package calls optax.ctc_loss (blvm_tpu/models/lstm_asr.py:80), a lax.scan that XLA
// compiles. It was added because PyTorch's own CUDA CTC loss copies host-made offset and length tensors to the card
// from pageable memory, which synchronizes the stream several times a call: the host waited on the card in the middle
// of every train step of the probe. This kernel takes its lengths from device tensors and never waits. It computes
// optax's recursion (ctc_loss_with_forward_probs), log_epsilon included, so it gives optax's values on every row:
// where the labels cannot fit the frames it returns optax's finite ~1e5, where PyTorch returns inf.
//
// Per row b, with N padded labels y, rep_n = (y[n - 1] == y[n]) for 1 <= n < N (0 else), c_n = eps rep_n and
// d_n = eps (1 - rep_n) (eps = log_epsilon), the states phi[0..N] (blank after n labels) and emit[0..N-1] (emitting
// label n), from phi = [0, eps, ...], emit = eps, for each frame t < z_sl[b] (f = lp[t, blank], e_n = lp[t, y[n]]):
//   emit'_n = e_n + lse(phi_n, emit_{n-1} + c_n, emit_n)
//   phi'_n  = f   + lse(phi_n, emit_{n-1} + c_n, emit_{n-1} + d_n)        (emit_{-1}: no path)
// optax's a_n = lae(phi_n, emit_{n-1} + c_n) folded into each sum; frames at or past z_sl keep the state; the loss is
// -L, L = phi_ls, or lae(phi_ls, emit_{ls-1}) for ls = y_sl[b] > 0. lp (B, T, K) are log-probabilities (log_softmax
// of the logits; the logits' gradient follows from K13-bwd's through log_softmax's backward).
//
// K13 (what bounds it: the T dependent frames of a row, ~0.3 us each on an H100 at the probe's N = 48; its bytes, the
// frames' emissions, take microseconds). A warp a row, its lanes owning J consecutive positions each (J = 1-4, N + 1 <=
// 128), so a frame needs no barrier: the left neighbour's emit comes by one __shfl_up_sync. Wider rows (up to N = 1023)
// take up to 8 warps of J = 4 and one named barrier a frame, the warps' edge states through shared memory. The
// emissions a lane reads (the blank and its positions' labels) do not depend on the state: cp.async copies them RING
// frames ahead into a ring in shared memory, so no device-memory load waits on the chain. The states stay in double:
// they reach thousands of nats, where a float's rounding (~2e-4 at 3000) walks over the frames and the gradient's
// exp(state - state) factors inherit it. The logsumexps' correction, log(1 + sum exp(x_i - max)), is taken in single
// precision by the special-function unit's ex2 and lg2 on the double differences (~2e-7 nats a sum), the max's own term
// left out; that unit's pipe, shared with the double-single conversions, is what a frame waits on (the correction in
// double, exp and log some 40 dependent double operations each, made the chain ~5x slower).
//
// Save mode (the train step's forward): the launch has a second CTA a row that runs beta, the log-adjoint of the same
// recursion, log d exp(L) / d exp(state), from the end: 0 on the states L reads and no path (a finite -1e300, so that
// no difference of two is NaN) elsewhere; through a frame (the adjoint of each exp-space sum above):
//   beta_phi_n  = lse(beta'_emit_n + e_n, beta'_phi_n + f)
//   beta_emit_n = lse(beta'_emit_n + e_n, beta'_emit_{n+1} + e_{n+1} + c_{n+1}, beta'_phi_{n+1} + f + c_{n+1},
//                     beta'_phi_{n+1} + f + d_{n+1})
// with the right neighbour's state by __shfl_down_sync. The two chains are independent, so save mode takes about as
// long as alpha alone. Alpha, the states before every frame and after the last, and beta at the same frames are
// written into (B, T + 1, 2N + 1) doubles each, phi_0..phi_N then emit_0..emit_{N-1}: the live states only (phi up to
// ls = y_sl[b], emit below it, frames up to z_sl[b]), since the rest have no path to the loss; the stores are off the
// chain. The alpha chain's arithmetic is the same with and without save mode, so its losses are bitwise the same.
//
// K13-bwd (bound by its bytes: alpha and beta read once at the live states, d lp written once): no recursion. Every
// state after frame t entered it with one emission of frame t, so the gradient of a frame is that frame's posterior:
//   d lp[t, k] = -g_b (sum_{n: y_n = k} exp(aE_n + bE_n - Z) + [k = blank] sum_n exp(aP_n + bP_n - Z))
// at the states after frame t, for t < z_sl, and 0 past it; Z = lse over those states of alpha + beta, which is L at
// every frame in exact arithmetic (the inner product of a forward vector and its adjoint), taken per frame so that
// rounding common to a frame's states cancels; each exp in single precision on the double exponent. A CTA takes a
// row's 32 frames, a warp a frame at a time: the blank's share is a warp sum, the label columns sum the row's positions
// through per-class lists built once a CTA (no atomics), and the frame's K gradients are stored once, coalesced.

#include "common.cuh"

namespace blvm {
namespace ctc {

// the trace's layout: SM cycles of each stage summed over the frames, then the loop's total cycles and nanoseconds
// (the rate the clock ran at), as the first thread of the first row's forward chain sees them
enum Stage : int { kExchange = 0, kEmissions = 1, kStores = 2, kArithmetic = 3, kStages = 4 };
constexpr int TRACE_SIZE = kStages + 2;

// a length clamped into [0, hi]
__device__ __forceinline__ int clamp_len(int64_t v, int hi) { return v < 0 ? 0 : (v > hi ? hi : (int)v); }

__device__ __forceinline__ double lae(double x, double y) {
  const double m = fmax(x, y);
  return m + log1p(exp(-fabs(x - y)));
}

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// clock64 read once x is in its register: the read is predicated on a comparison of x, so it waits for x
__device__ __forceinline__ long long clock_after(double x) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.eq.f64 p, %1, %1;\n\tmov.u64 %0, 0;\n\t@p mov.u64 %0, %%clock64;\n}"
      : "=l"(t)
      : "d"(x));
  return t;
}
// Per-stage SM cycles of one thread's loop; every call is a no-op when the trace pointer is null.
struct Tracer {
  long long* out;
  long long mark, cycles0, ns0;
  long long acc[kStages];

  __device__ __forceinline__ explicit Tracer(long long* out_) : out(out_), mark(0), cycles0(0), ns0(0) {
    if (out) {
      ns0 = now_ns();
      mark = cycles0 = clock64();
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) acc[s] = 0;
  }
  // the stage ends once x (its last result) is ready
  __device__ __forceinline__ void tick(int stage, double x) {
    if (out) {
      const long long t = clock_after(x);
      acc[stage] += t - mark;
      mark = t;
    }
  }
  __device__ __forceinline__ void finish() {
    if (out) {
#pragma unroll
      for (int s = 0; s < kStages; ++s) out[s] += acc[s];
      out[kStages] += clock64() - cycles0;
      out[kStages + 1] += now_ns() - ns0;
    }
  }
};

constexpr int MAX_LABELS = 1023;
constexpr int MAX_K = 4096;        // classes (the backward's per-class lists live in shared memory)
constexpr int MAX_WARPS = 8;       // a chain's warps: N + 1 <= 8 x 32 x 4 positions
constexpr int RING = 8;            // frames of emissions in flight ahead of a chain
constexpr double NO_PATH = -1e300;  // log 0 of beta and of emit_{-1}: finite, so no difference of two is NaN
constexpr unsigned FULL = 0xffffffffu;
constexpr int BWD_WARPS = 8, BWD_FRAMES = 32;

// exp(x) of x <= 0 and log(x) of x >= 1 in single precision: one MUFU instruction and a multiply each, no range fix-up
// (flushed to zero: exp(x) < 1.2e-38 is 0, below any term that counts)
__device__ __forceinline__ float fast_exp(double x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((float)x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ double fast_log(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return (double)(y * 0.6931471805599453f);
}

// (larger, smaller) of two states by one compare (no state is NaN)
__device__ __forceinline__ void order(double a, double b, double& hi, double& lo) {
  const bool ab = a > b;
  hi = ab ? a : b;
  lo = ab ? b : a;
}

// m + log(1 + sum exp(x_i - m)) over the terms x_i other than their max m, whose term is exactly 1 and is not taken,
// in single precision on the double differences. The special-function unit's ex2 and lg2 and the conversions between
// double and single share one pipe, which bounds the chain: each term left out saves two of them.
__device__ __forceinline__ double lse_around(double m, double x1) { return m + fast_log(1.0f + fast_exp(x1 - m)); }
__device__ __forceinline__ double lse_around(double m, double x1, double x2) {
  return m + fast_log(1.0f + fast_exp(x1 - m) + fast_exp(x2 - m));
}
__device__ __forceinline__ double lse_around(double m, double x1, double x2, double x3) {
  return m + fast_log(1.0f + fast_exp(x1 - m) + fast_exp(x2 - m) + fast_exp(x3 - m));
}

// logsumexp of 2-4 double terms
__device__ __forceinline__ double lse2(double a, double b) {
  double m, x;
  order(a, b, m, x);
  return lse_around(m, x);
}

__device__ __forceinline__ double lse3(double a, double b, double c) {
  double hi, lo, m, mid;
  order(a, b, hi, lo);
  order(hi, c, m, mid);
  return lse_around(m, mid, lo);
}

__device__ __forceinline__ double lse4(double a, double b, double c, double d) {
  double hi1, lo1, hi2, lo2, m, mid;
  order(a, b, hi1, lo1);
  order(c, d, hi2, lo2);
  order(hi1, hi2, m, mid);
  return lse_around(m, mid, lo1, lo2);
}

__device__ __forceinline__ double dmax(double a, double b) { return a > b ? a : b; }

__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(addr), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// all but the RING - 1 newest groups landed: the oldest frame in flight is ready
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(RING - 1) : "memory");
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = dmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

struct FwdArgs {
  const float* lp;
  const int64_t* y;
  const int64_t* z_sl;
  const int64_t* y_sl;
  float* nll;
  double* alpha;  // save mode: (B, T + 1, 2N + 1), else null
  double* beta;
  long long* trace;  // TRACE_SIZE sums of row 0's alpha chain, or null
  int T, N, K, blank, warps;
  double log_eps;
};

// blockIdx.y 0: alpha and the loss; 1 (save mode): beta. Thread i owns positions J i .. J i + J - 1.
template <int J>
__global__ void __launch_bounds__(MAX_WARPS * 32) ctc_fwd_kernel(FwdArgs p) {
  __shared__ double edge[2][MAX_WARPS][2];  // each warp's edge state, double-buffered by frame
  extern __shared__ double dsm[];
  double* final_emit = dsm;                                   // [N]: alpha's last emit, for the loss
  float* ring = reinterpret_cast<float*>(dsm + p.N);          // [RING][threads][J + 2]: blank, then labels n0..n0+J
  const int b = blockIdx.x;
  const bool beta_chain = blockIdx.y == 1;
  const int threads = blockDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = p.T, N = p.N, K = p.K, W = p.warps, S = 2 * N + 1;
  const int n0 = threadIdx.x * J;
  const int64_t* yb = p.y + (int64_t)b * N;
  const int steps = clamp_len(p.z_sl[b], T), ls = clamp_len(p.y_sl[b], N);
  const double log_eps = p.log_eps;

  // positions n0 .. n0 + J: label, c, d (the last one is the right neighbour's, for beta)
  int label[J + 1];
  double c[J + 1], d[J + 1];
#pragma unroll
  for (int j = 0; j <= J; ++j) {
    const int m = n0 + j;
    label[j] = m < N ? (int)yb[m] : p.blank;
    const bool rep = m >= 1 && m < N && yb[m - 1] == yb[m];
    c[j] = rep ? log_eps : 0.0;
    d[j] = rep ? 0.0 : log_eps;
  }

  const int slot = threads * (J + 2);
  float* my_ring = ring + threadIdx.x * (J + 2);
  // the next frame of this chain's order (alpha: t = 0, 1, ...; beta: t = steps - 1, ...) into ring slot i % RING
  const float* next_row = p.lp + ((int64_t)b * T + (beta_chain ? steps - 1 : 0)) * K;
  const int64_t row_step = beta_chain ? -(int64_t)K : (int64_t)K;
  int next_i = 0;
  auto fetch = [&]() {
    if (next_i < steps) {
      float* dst = my_ring + (next_i % RING) * slot;
      cp_async4(dst, next_row + p.blank);
#pragma unroll
      for (int j = 0; j <= J; ++j)
        if (j < J || beta_chain) cp_async4(dst + 1 + j, next_row + label[j]);
    }
    cp_async_commit();  // empty past the last frame, so that the count of groups stays RING - 1 ahead
    next_row += row_step;
    ++next_i;
  };
  // the live states only, phi_0..phi_ls and emit_0..emit_{ls-1}: the rest have no path to the loss, and K13-bwd
  // reads none of them
  auto store = [&](double* out, int t, const double (&Pv)[J], const double (&Ev)[J]) {
    double* row = out + ((int64_t)b * (T + 1) + t) * S;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int m = n0 + j;
      if (m <= ls) row[m] = Pv[j];
      if (m < ls) row[N + 1 + m] = Ev[j];
    }
  };
  for (int i = 0; i < RING - 1; ++i) fetch();

  if (!beta_chain) {
    Tracer tr(b == 0 && threadIdx.x == 0 ? p.trace : nullptr);
    double P[J], E[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      P[j] = n0 + j == 0 ? 0.0 : log_eps;
      E[j] = log_eps;
    }
    if (W > 1) {
      if (lane == 31) edge[0][warp][0] = E[J - 1];
      named_sync(threads);
    }
    for (int i = 0; i < steps; ++i) {
      fetch();  // frame i + RING - 1, into the slot frame i - 1 was read from
      double left = __shfl_up_sync(FULL, E[J - 1], 1);
      if (lane == 0) left = warp == 0 ? NO_PATH : edge[i & 1][warp - 1][0];
      tr.tick(kExchange, left);
      cp_async_wait_ring();
      const float* src = my_ring + (i % RING) * slot;
      const double f = src[0];
      double e[J];
#pragma unroll
      for (int j = 0; j < J; ++j) e[j] = src[1 + j];
      tr.tick(kEmissions, f + e[J - 1]);
      if (p.alpha) store(p.alpha, i, P, E);
      tr.tick(kStores, 0.0);
      double nP[J], nE[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const double em1 = j == 0 ? left : E[j - 1];
        const double via = em1 + c[j];
        nE[j] = e[j] + lse3(P[j], via, E[j]);
        nP[j] = f + lse3(P[j], via, em1 + d[j]);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        P[j] = nP[j];
        E[j] = nE[j];
      }
      tr.tick(kArithmetic, P[J - 1] + E[J - 1]);
      if (W > 1) {
        if (lane == 31) edge[(i + 1) & 1][warp][0] = E[J - 1];
        named_sync(threads);
      }
    }
    tr.finish();
    if (p.alpha) store(p.alpha, steps, P, E);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (n0 + j < N) final_emit[n0 + j] = E[j];
    if (W > 1) {
      named_sync(threads);
    } else {
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (n0 + j == ls) p.nll[b] = (float)(-(ls == 0 ? P[j] : lae(P[j], final_emit[ls - 1])));
  } else {
    double BP[J], BE[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      BP[j] = n0 + j == ls ? 0.0 : NO_PATH;
      BE[j] = n0 + j + 1 == ls ? 0.0 : NO_PATH;
    }
    store(p.beta, steps, BP, BE);
    if (W > 1) {
      if (lane == 0) {
        edge[0][warp][0] = BE[0];
        edge[0][warp][1] = BP[0];
      }
      named_sync(threads);
    }
    for (int i = 0; i < steps; ++i) {
      fetch();
      double rE = __shfl_down_sync(FULL, BE[0], 1), rP = __shfl_down_sync(FULL, BP[0], 1);
      if (lane == 31) {
        const bool last = warp == W - 1;
        rE = last ? NO_PATH : edge[i & 1][warp + 1][0];
        rP = last ? NO_PATH : edge[i & 1][warp + 1][1];
      }
      cp_async_wait_ring();
      const float* src = my_ring + (i % RING) * slot;
      const double f = src[0];
      double e[J + 1];
#pragma unroll
      for (int j = 0; j <= J; ++j) e[j] = src[1 + j];
      double nP[J], nE[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const double uE = j + 1 < J ? BE[j + 1] : rE, uP = (j + 1 < J ? BP[j + 1] : rP) + f;
        const double stay = BE[j] + e[j];
        nP[j] = lse2(stay, BP[j] + f);
        nE[j] = lse4(stay, uE + e[j + 1] + c[j + 1], uP + c[j + 1], uP + d[j + 1]);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        BP[j] = nP[j];
        BE[j] = nE[j];
      }
      store(p.beta, steps - 1 - i, BP, BE);
      if (W > 1) {
        if (lane == 0) {
          edge[(i + 1) & 1][warp][0] = BE[0];
          edge[(i + 1) & 1][warp][1] = BP[0];
        }
        named_sync(threads);
      }
    }
  }
}

// grid (T / BWD_FRAMES, B): a CTA a row's BWD_FRAMES frames, a warp a frame at a time
__global__ void __launch_bounds__(BWD_WARPS * 32)
    ctc_bwd_kernel(const int64_t* __restrict__ y, const int64_t* __restrict__ z_sl, const int64_t* __restrict__ y_sl,
                   const double* __restrict__ alpha, const double* __restrict__ beta, const float* __restrict__ g,
                   float* __restrict__ d_lp, int T, int N, int K, int blank) {
  extern __shared__ int ism[];
  int* head = ism;        // [K]: the first position of the row's labels with class k, or -1
  int* lab = head + K;    // [N]: the row's labels
  int* next = lab + N;    // [N]: the next position with the same label, or -1
  float* post = reinterpret_cast<float*>(next + N);  // [BWD_WARPS][N]: a frame's emit posteriors times the sum
  const int b = blockIdx.y, t0 = blockIdx.x * BWD_FRAMES, t_end = min(t0 + BWD_FRAMES, T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int steps = clamp_len(z_sl[b], T), ls = clamp_len(y_sl[b], N);
  float* dlb = d_lp + (int64_t)b * T * K;
  if (t0 >= steps) {  // every frame of the tile lies past the row's length
    for (int64_t i = (int64_t)t0 * K + threadIdx.x; i < (int64_t)t_end * K; i += blockDim.x) dlb[i] = 0.0f;
    return;
  }
  const int64_t* yb = y + (int64_t)b * N;
  for (int k = threadIdx.x; k < K; k += blockDim.x) head[k] = -1;
  for (int n = threadIdx.x; n < ls; n += blockDim.x) lab[n] = (int)yb[n];
  __syncthreads();
  // positions past ls have no path to the loss (beta is -1e300 there): only n < ls enter the lists
  for (int n = threadIdx.x; n < ls; n += blockDim.x) {
    const int l = lab[n];
    int prev = n - 1;
    while (prev >= 0 && lab[prev] != l) --prev;
    if (prev < 0 && l >= 0 && l < K) head[l] = n;
    int nx = n + 1;
    while (nx < ls && lab[nx] != l) ++nx;
    next[n] = nx < ls ? nx : -1;
  }
  __syncthreads();

  const double gb = g[b];
  const int S = 2 * N + 1, live = 2 * ls + 1;  // live state i: phi_i for i <= ls, then emit_{i - ls - 1}
  float* pw = post + warp * N;
  for (int t = t0 + warp; t < t_end; t += BWD_WARPS) {
    float* row = dlb + (int64_t)t * K;
    if (t >= steps) {
      for (int k = lane; k < K; k += 32) row[k] = 0.0f;
      continue;
    }
    const int64_t r = ((int64_t)b * (T + 1) + t + 1) * S;  // the states after frame t
    const double* ar = alpha + r;
    const double* br = beta + r;
    double m = NO_PATH;
    for (int i = lane; i < live; i += 32) {
      const int col = i <= ls ? i : N + i - ls;
      m = dmax(m, ar[col] + br[col]);
    }
    m = warp_max(m);
    double s = 0.0, s_blank = 0.0;
    for (int i = lane; i < live; i += 32) {
      const int col = i <= ls ? i : N + i - ls;
      const double q = fast_exp(ar[col] + br[col] - m);
      s += q;
      if (i <= ls) {
        s_blank += q;
      } else {
        pw[i - ls - 1] = (float)q;
      }
    }
    s = warp_sum(s);
    s_blank = warp_sum(s_blank);
    __syncwarp();
    const double scale = -gb / s;
    for (int k = lane; k < K; k += 32) {
      double v = k == blank ? s_blank : 0.0;
      for (int n = head[k]; n >= 0; n = next[n]) v += pw[n];
      row[k] = (float)(scale * v);
    }
    __syncwarp();
  }
}

bool valid(int B, int T, int N, int K, int blank) {
  return B >= 1 && T >= 1 && N >= 1 && N <= MAX_LABELS && K >= 1 && K <= MAX_K && blank >= 0 && blank < K;
}

// a kernel above 48 KB of dynamic shared memory must say so first
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return smem > 48 * 1024 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
}

void (*fwd_kernel(int J))(FwdArgs) {
  switch (J) {
    case 1: return ctc_fwd_kernel<1>;
    case 2: return ctc_fwd_kernel<2>;
    case 3: return ctc_fwd_kernel<3>;
    default: return ctc_fwd_kernel<4>;
  }
}

}  // namespace ctc
}  // namespace blvm

// lp (B, T, K) float32, y (B, N) int64, z_sl and y_sl (B,) int64, all on the card. Writes nll (B,) float32; with alpha
// and beta ((B, T + 1, 2N + 1) float64 each, phi then emit, the live states before every frame and after the last)
// save mode, else both null; trace null, or TRACE_SIZE int64 sums (Stage above).
extern "C" int blvm_ctc_loss(const void* lp, const void* y, const void* z_sl, const void* y_sl, void* nll, void* alpha,
                             void* beta, void* trace, int B, int T, int N, int K, int blank, float log_eps,
                             void* stream) {
  using namespace blvm;
  if (!ctc::valid(B, T, N, K, blank) || (alpha == nullptr) != (beta == nullptr)) return (int)cudaErrorInvalidValue;
  const int positions = N + 1;
  const int J = positions <= 128 ? (positions + 31) / 32 : 4;
  const int W = positions <= 128 ? 1 : (positions + 127) / 128;
  const int threads = 32 * W;
  const size_t smem = sizeof(double) * N + sizeof(float) * ctc::RING * threads * (J + 2);
  void (*kernel)(ctc::FwdArgs) = ctc::fwd_kernel(J);
  cudaError_t err = ctc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ctc::FwdArgs p{static_cast<const float*>(lp), static_cast<const int64_t*>(y), static_cast<const int64_t*>(z_sl),
                 static_cast<const int64_t*>(y_sl), static_cast<float*>(nll), static_cast<double*>(alpha),
                 static_cast<double*>(beta), static_cast<long long*>(trace), T, N, K, blank, W, (double)log_eps};
  kernel<<<dim3(B, alpha ? 2 : 1), threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// alpha and beta of blvm_ctc_loss's save mode and g (B,), the gradient of each row's loss: writes d_lp (B, T, K).
extern "C" int blvm_ctc_loss_bwd(const void* y, const void* z_sl, const void* y_sl, const void* alpha,
                                 const void* beta, const void* g, void* d_lp, int B, int T, int N, int K, int blank,
                                 void* stream) {
  using namespace blvm;
  if (!ctc::valid(B, T, N, K, blank)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (K + 2 * N) + sizeof(float) * ctc::BWD_WARPS * N;
  cudaError_t err = ctc::allow_smem(ctc::ctc_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ctc::ctc_bwd_kernel<<<dim3((T + ctc::BWD_FRAMES - 1) / ctc::BWD_FRAMES, B), ctc::BWD_WARPS * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(y), static_cast<const int64_t*>(z_sl), static_cast<const int64_t*>(y_sl),
      static_cast<const double*>(alpha), static_cast<const double*>(beta), static_cast<const float*>(g),
      static_cast<float*>(d_lp), T, N, K, blank);
  return (int)cudaGetLastError();
}
