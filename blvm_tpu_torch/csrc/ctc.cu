// K13 and K13-bwd: the CTC loss of the ASR probe and its gradient, optax's recursion, on sm_90a.
//
// Replaces no TPU kernel: the JAX package calls optax.ctc_loss (blvm_tpu/models/lstm_asr.py:80), a lax.scan that XLA
// compiles. It was added because PyTorch's own CUDA CTC loss copies host-made offset and length tensors to the card
// from pageable memory, which synchronizes the stream several times a call: the host waited on the card in the middle
// of every train step of the probe. This kernel takes its lengths from device tensors and never waits. It computes
// optax's recursion (ctc_loss_with_forward_probs) step for step, log_epsilon included, so it gives optax's values on
// every row: where the labels cannot fit the frames it returns optax's finite ~1e5, where PyTorch returns inf.
//
// Per row b, with N padded labels y, repeat[n] = (y[n] == y[n + 1]) (0 at n = N - 1), the states phi[0..N] (blank
// after n labels) and emit[0..N-1] (emitting label n), from phi = [0, eps, ...], emit = eps (eps = log_epsilon), for
// each frame t < z_sl[b] (lae = logaddexp, f = lp[t, blank], e_n = lp[t, y[n]]):
//   a_n   = n == 0 ? phi_0 : lae(phi_n, emit_{n-1} + eps repeat[n-1])
//   emit' = lae(a_n + e_n, emit_n + e_n)
//   phi'  = n == 0 ? a_0 + f : lae(a_n + f, emit_{n-1} + f + eps (1 - repeat[n-1]))
// frames at or past z_sl keep the state; the loss is -L[y_sl], L_n = n == 0 ? phi_0 : lae(phi_n, emit_{n-1}).
// lp (B, T, K) are log-probabilities (log_softmax of the logits; the gradient of the logits follows from K13-bwd's
// gradient of lp through log_softmax's backward).
//
// What bounds it: the T dependent steps of each row, a barrier each (the work, 2N + 1 logaddexps a step, is
// small); a CTA a row, thread n owning phi_n and emit_n, the state double-buffered in shared memory. The states are
// kept in double: they reach thousands of nats, where a float's rounding (~2e-4 at 3000) walks over the frames and
// the gradient's exp(state - state) factors inherit it; the kernel is bound by its barriers, not its arithmetic. The
// forward in save mode writes the state before every frame (and the final one), (B, T + 1, N + 1) and (B, T + 1, N)
// doubles, so that K13-bwd never replays the chain.
//
// K13-bwd: reverse-mode of the same recursion, frame by frame from z_sl - 1 down, thread n owning the adjoints of
// phi_n and emit_n: each frame recomputes a_n, emit' and phi' from the saved state, passes the adjoints back through
// the logaddexps (d lae(x, y) / dx = exp(x - lae(x, y))), sends emit_{n-1}'s share to thread n - 1 through shared
// memory, and adds the emission and blank adjoints into the frame's row of d lp (K values in shared memory, then one
// coalesced store). Rows of d lp at or past z_sl are zero.

#include "common.cuh"

namespace blvm {
namespace ctc {

constexpr int MAX_THREADS = 1024;  // N + 1 states a row
constexpr int MAX_K = 4096;        // classes of a frame's gradient row (doubles) in shared memory

// a length clamped into [0, hi]
__device__ __forceinline__ int clamp_len(int64_t v, int hi) { return v < 0 ? 0 : (v > hi ? hi : (int)v); }

__device__ __forceinline__ double lae(double x, double y) {
  const double m = fmax(x, y);
  return m + log1p(exp(-fabs(x - y)));
}

__global__ void ctc_fwd_kernel(const float* __restrict__ lp, const int64_t* __restrict__ y,
                               const int64_t* __restrict__ z_sl, const int64_t* __restrict__ y_sl,
                               float* __restrict__ nll, double* __restrict__ phi_out, double* __restrict__ emit_out,
                               int T, int N, int K, int blank, double log_eps) {
  extern __shared__ double smem[];
  double* phi = smem;               // [2][N + 1]
  double* emit = phi + 2 * (N + 1);  // [2][N], at least one slot
  const int b = blockIdx.x, n = threadIdx.x;
  const bool live = n <= N;
  const int64_t* yb = y + (int64_t)b * N;
  const int steps = clamp_len(z_sl[b], T);
  const int label = live && n < N ? (int)yb[n] : 0;
  // optax's repeat[n - 1]: labels n - 1 and n alike (0 at n = N, its pad column)
  const double rep = live && n > 0 && n < N && yb[n - 1] == yb[n] ? 1.0 : 0.0;
  double P = n == 0 ? 0.0 : log_eps, E = log_eps;
  if (live) {
    phi[n] = P;
    if (n < N) emit[n] = E;
  }
  __syncthreads();
  const float* lpb = lp + (int64_t)b * T * K;
  for (int t = 0; t < steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    if (live) {
      const double Em1 = n > 0 ? emit[cur * N + n - 1] : log_eps;
      if (phi_out) {
        phi_out[((int64_t)b * (T + 1) + t) * (N + 1) + n] = P;
        if (n < N) emit_out[((int64_t)b * (T + 1) + t) * N + n] = E;
      }
      const double f = lpb[(int64_t)t * K + blank];
      const double a = n == 0 ? P : lae(P, Em1 + log_eps * rep);
      const double newP = n == 0 ? a + f : lae(a + f, Em1 + f + log_eps * (1.0 - rep));
      double newE = E;
      if (n < N) {
        const double e = lpb[(int64_t)t * K + label];
        newE = lae(a + e, E + e);
      }
      P = newP;
      E = newE;
      phi[nxt * (N + 1) + n] = P;
      if (n < N) emit[nxt * N + n] = E;
    }
    __syncthreads();
  }
  const int cur = steps & 1;
  if (live && phi_out) {
    phi_out[((int64_t)b * (T + 1) + steps) * (N + 1) + n] = P;
    if (n < N) emit_out[((int64_t)b * (T + 1) + steps) * N + n] = E;
  }
  const int ls = clamp_len(y_sl[b], N);
  if (n == ls) nll[b] = (float)(-(n == 0 ? P : lae(P, emit[cur * N + n - 1])));
}

__global__ void ctc_bwd_kernel(const float* __restrict__ lp, const int64_t* __restrict__ y,
                               const int64_t* __restrict__ z_sl, const int64_t* __restrict__ y_sl,
                               const double* __restrict__ phi_in, const double* __restrict__ emit_in,
                               const float* __restrict__ g, float* __restrict__ d_lp, int T, int N, int K, int blank,
                               double log_eps) {
  extern __shared__ double smem[];
  double* row = smem;           // [K]: this frame's gradient of lp
  double* share = row + K;      // [N + 1]: thread n's adjoint share for emit_{n-1}
  const int b = blockIdx.x, n = threadIdx.x;
  const bool live = n <= N;
  const int64_t* yb = y + (int64_t)b * N;
  const int steps = clamp_len(z_sl[b], T);
  const int label = live && n < N ? (int)yb[n] : 0;
  const double rep = live && n > 0 && n < N && yb[n - 1] == yb[n] ? 1.0 : 0.0;
  const float* lpb = lp + (int64_t)b * T * K;
  float* dlb = d_lp + (int64_t)b * T * K;
  for (int64_t i = (int64_t)steps * K + n; i < (int64_t)T * K; i += blockDim.x) dlb[i] = 0.0f;

  // the adjoints of the final state: loss = -L[y_sl]
  const double gb = g[b];
  const int ls = clamp_len(y_sl[b], N);
  double gP = 0.0, gE = 0.0;
  if (live) share[n] = 0.0;
  __syncthreads();
  if (live && n == ls) {
    const double P = phi_in[((int64_t)b * (T + 1) + steps) * (N + 1) + n];
    if (n == 0) {
      gP = -gb;
    } else {
      const double Em1 = emit_in[((int64_t)b * (T + 1) + steps) * N + n - 1];
      const double L = lae(P, Em1);
      gP = -gb * exp(P - L);
      share[n] = -gb * exp(Em1 - L);
    }
  }
  __syncthreads();
  if (live && n < N) gE += share[n + 1];
  __syncthreads();

  for (int t = steps - 1; t >= 0; --t) {
    for (int k = n; k < K; k += blockDim.x) row[k] = 0.0;
    __syncthreads();
    double contrib = 0.0;
    if (live) {
      const int64_t s = (int64_t)b * (T + 1) + t;
      const double P = phi_in[s * (N + 1) + n];
      const double E = n < N ? emit_in[s * N + n] : 0.0;
      const double Em1 = n > 0 ? emit_in[s * N + n - 1] : log_eps;
      const double f = lpb[(int64_t)t * K + blank];
      const double c = log_eps * rep, d = log_eps * (1.0 - rep);
      const double a = n == 0 ? P : lae(P, Em1 + c);
      double ga = 0.0, gf = 0.0, gE_new = 0.0;
      if (n < N) {
        const double e = lpb[(int64_t)t * K + label];
        const double newE = lae(a + e, E + e);
        ga += gE * exp(a + e - newE);
        gE_new = gE * exp(E + e - newE);
        atomicAdd(&row[label], gE);
      }
      if (n == 0) {
        ga += gP;
      } else {
        const double newP = lae(a + f, Em1 + f + d);
        ga += gP * exp(a + f - newP);
        contrib += gP * exp(Em1 + f + d - newP);
      }
      gf = gP;
      double gP_new;
      if (n == 0) {
        gP_new = ga;
      } else {
        gP_new = ga * exp(P - a);
        contrib += ga * exp(Em1 + c - a);
      }
      atomicAdd(&row[blank], gf);
      gP = gP_new;
      gE = gE_new;
      share[n] = contrib;
    }
    __syncthreads();
    if (live && n < N) gE += share[n + 1];
    for (int k = n; k < K; k += blockDim.x) dlb[(int64_t)t * K + k] = (float)row[k];
    __syncthreads();
  }
}

int threads_for(int N) { return ((N + 1 + 31) / 32) * 32; }

bool valid(int B, int T, int N, int K, int blank) {
  return B >= 1 && T >= 1 && N >= 1 && N + 1 <= MAX_THREADS && K >= 1 && K <= MAX_K && blank >= 0 && blank < K;
}

}  // namespace ctc
}  // namespace blvm

// lp (B, T, K) float32, y (B, N) int64, z_sl and y_sl (B,) int64, all on the card. Writes nll (B,) float32; phi_out
// (B, T + 1, N + 1) and emit_out (B, T + 1, N) float64 for the backward, or null.
extern "C" int blvm_ctc_loss(const void* lp, const void* y, const void* z_sl, const void* y_sl, void* nll,
                             void* phi_out, void* emit_out, int B, int T, int N, int K, int blank, float log_eps,
                             void* stream) {
  using namespace blvm;
  if (!ctc::valid(B, T, N, K, blank) || (phi_out && !emit_out)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * (2 * (N + 1) + 2 * N);
  ctc::ctc_fwd_kernel<<<B, ctc::threads_for(N), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int64_t*>(y), static_cast<const int64_t*>(z_sl),
      static_cast<const int64_t*>(y_sl), static_cast<float*>(nll), static_cast<double*>(phi_out),
      static_cast<double*>(emit_out), T, N, K, blank, (double)log_eps);
  return (int)cudaGetLastError();
}

// The saved states of blvm_ctc_loss and g (B,), the gradient of each row's loss: writes d_lp (B, T, K).
extern "C" int blvm_ctc_loss_bwd(const void* lp, const void* y, const void* z_sl, const void* y_sl,
                                 const void* phi_in, const void* emit_in, const void* g, void* d_lp, int B, int T, int N,
                                 int K, int blank, float log_eps, void* stream) {
  using namespace blvm;
  if (!ctc::valid(B, T, N, K, blank)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(double) * (K + N + 1);
  ctc::ctc_bwd_kernel<<<B, ctc::threads_for(N), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const int64_t*>(y), static_cast<const int64_t*>(z_sl),
      static_cast<const int64_t*>(y_sl), static_cast<const double*>(phi_in), static_cast<const double*>(emit_in),
      static_cast<const float*>(g), static_cast<float*>(d_lp), T, N, K, blank, (double)log_eps);
  return (int)cudaGetLastError();
}
