// K6 and K6-bwd: one layer of the bidirectional masked LSTM, both directions in one launch, forward and
// backward through time, on sm_90a.
//
// Replaces the one lax.scan of blvm_tpu/modules/lstm_block.py LSTMBlock._fused_bidirectional (:82-130), which
// the JAX package shaped by hand for the TPU: both directions' input projections are one time-parallel product
// outside the scan, and the scan carries a (2, B, H) state. Per step s, direction d and row b, with t = s for
// d = 0 and t = T - 1 - s for d = 1 (direction 1 consumes the whole padded sequence reversed, padding first):
//   gates = xw[b, t, d] + h W_hh[d] + b_hh[d]   (gate order i, f, g, o)
//   c_new = sigmoid(f) c + sigmoid(i) tanh(g);  h_new = sigmoid(o) tanh(c_new)
//   h = m h_new + (1 - m) h;  c = m c_new + (1 - m) c;  out[b, t, d] = h_new m,   m = mask[b, t]
// from h = c = 0. Direction 1 reads xw, the mask and its output slot at t = T - 1 - s on its step s, so no
// flipped copy of x, of the mask or of the output is ever made, and its output lands where the JAX block's
// flip back puts it. Tensors are batch-first and contiguous: xw (B, T, 8H) holds direction d's 4H gate
// columns at column offset 4 d H (one product x [W_ih[0] | W_ih[1]]); out (B, T, 2H) holds direction d at
// column offset d H (the directions concatenated, which the next layer's one product reads as it is);
// W_hh (2, H, 4H), b_hh (2, 4H), mask (B, T) float32 or null (all ones). f32 only: the probe has no bf16.
//
// What bounds it. At the probe's run spec (H = 256, 30000 frames a --batch_len 120 s batch, both directions)
// the products are 2 x 2 x 30000 x H x 4H = 31.5 GFLOP (0.47 ms at 67 TFLOP/s) and the compulsory bytes
// ~0.3 GB (0.09 ms), but each direction is a serial chain of (B, H) x (H, 4H) products: each step's latency
// (the product from shared memory, a barrier, the exchange of h) sets the pace, not bytes or operations.
//
// The design is K5's (csrc/lstm.cu) with a direction axis, and so is the code: lstm_common.cuh's kernels with
// D = 2, in f32. A thread-block cluster of NC = 8 CTAs serves one direction and a group of BG of its rows, so it
// keeps that direction's W_hh columns resident (2 H^2 bytes a CTA: 128 KB at H = 256); a cluster never mixes
// directions. The clusters of both directions go in one launch, BG the least that keeps them all resident (at
// most 8); a larger batch runs in waves, as clusters never wait on each other. For training the forward also
// writes the activated gates (B, T, 8H) and the carried (h, c) before each step (B, T, 2H each), at the step's
// own time index, so dW_hh[d] = h_prev[:, :, d]^T d_gates[:, :, d] sums over the same (b, t) rows for both
// directions.
//
// K6-bwd runs each direction's chain in reverse (direction 0 from t = T - 1 down, direction 1 from t = 0 up) on
// the same grid and writes d gates into one (B, T, 8H) gradient. A masked step passes dh and dc through
// unchanged. dx, dW_ih, dW_hh and the biases' gradients are cuBLAS products of d gates, left to the wrapper.

#include "lstm_common.cuh"

// gates, h_prev, c_prev: null for inference; else (B, T, 8H), (B, T, 2H), (B, T, 2H), all written.
extern "C" int blvm_bilstm_recurrence(const void* xw, const void* w_hh, const void* b_hh, const void* mask, void* out,
                                      void* gates, void* h_prev, void* c_prev, int B, int T, int H, void* stream) {
  using namespace blvm;
  if (!lstm::valid(B, T, H) || (gates && (!h_prev || !c_prev))) return (int)cudaErrorInvalidValue;
  static int cache[lstm::MAX_H + 1] = {0};
  const float* none = nullptr;  // no initial state in, no final state out
  return lstm::launch<2>(lstm::lstm_fwd_kernel<float, 2>, cache, lstm::fwd_smem, B, H,
                         static_cast<cudaStream_t>(stream), static_cast<const float*>(xw),
                         static_cast<const float*>(w_hh), static_cast<const float*>(b_hh),
                         static_cast<const float*>(mask), none, none, static_cast<float*>(out), (float*)nullptr,
                         (float*)nullptr, static_cast<float*>(gates), static_cast<float*>(h_prev),
                         static_cast<float*>(c_prev), B, T, H);
}

// d_out (B, T, 2H) the gradient of out; writes d_gates (B, T, 8H), the gradient of xw.
extern "C" int blvm_bilstm_recurrence_bwd(const void* w_hh, const void* mask, const void* gates, const void* c_prev,
                                          const void* d_out, void* d_gates, int B, int T, int H, void* stream) {
  using namespace blvm;
  if (!lstm::valid(B, T, H)) return (int)cudaErrorInvalidValue;
  static int cache[lstm::MAX_H + 1] = {0};
  const float* none = nullptr;  // no final state's gradient in, no initial state's out
  return lstm::launch<2>(lstm::lstm_bwd_kernel<float, 2>, cache, lstm::bwd_smem, B, H,
                         static_cast<cudaStream_t>(stream), static_cast<const float*>(w_hh),
                         static_cast<const float*>(mask), static_cast<const float*>(gates),
                         static_cast<const float*>(c_prev), static_cast<const float*>(d_out), none, none,
                         static_cast<float*>(d_gates), (float*)nullptr, (float*)nullptr, B, T, H);
}
