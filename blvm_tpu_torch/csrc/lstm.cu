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
//
// The kernels and their launch live in lstm_common.cuh, which K6 (bilstm.cu) shares with a direction axis;
// K5 is its one-direction case.

#include "lstm_common.cuh"

namespace blvm {
namespace lstm {

template <typename T>
int run_fwd(const void* xw, const void* w_hh, const void* b_hh, const void* mask, const void* h0, const void* c0,
            void* out, void* h_n, void* c_n, void* gates, void* h_prev, void* c_prev, int B, int Tn, int H,
            cudaStream_t stream) {
  static int cache[MAX_H + 1] = {0};
  return launch<1>(lstm_fwd_kernel<T, 1>, cache, fwd_smem, B, H, stream, static_cast<const T*>(xw),
                   static_cast<const T*>(w_hh), static_cast<const T*>(b_hh), static_cast<const float*>(mask),
                   static_cast<const T*>(h0), static_cast<const T*>(c0), static_cast<T*>(out), static_cast<T*>(h_n),
                   static_cast<T*>(c_n), static_cast<T*>(gates), static_cast<T*>(h_prev), static_cast<T*>(c_prev), B,
                   Tn, H);
}

template <typename T>
int run_bwd(const void* w_hh, const void* mask, const void* gates, const void* c_prev, const void* d_out,
            const void* d_h_n, const void* d_c_n, void* d_gates, void* d_h0, void* d_c0, int B, int Tn, int H,
            cudaStream_t stream) {
  static int cache[MAX_H + 1] = {0};
  return launch<1>(lstm_bwd_kernel<T, 1>, cache, bwd_smem, B, H, stream, static_cast<const T*>(w_hh),
                   static_cast<const float*>(mask), static_cast<const T*>(gates), static_cast<const T*>(c_prev),
                   static_cast<const T*>(d_out), static_cast<const T*>(d_h_n), static_cast<const T*>(d_c_n),
                   static_cast<T*>(d_gates), static_cast<T*>(d_h0), static_cast<T*>(d_c0), B, Tn, H);
}

bool valid(int B, int T, int H, int dtype) { return valid(B, T, H) && (dtype == kFloat32 || dtype == kBFloat16); }

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
