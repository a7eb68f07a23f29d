// K7: the masked GRU recurrence over all T steps of a sequence batch, f32, on sm_90a.
//
// Replaces the lax.scan step of blvm_tpu/modules/recurrent.py GRU.__call__ (:177-187), which the JAX
// package shaped by hand for the TPU (the input projection x W_ih + b_ih of every step outside the scan,
// the carry masked). Per step t, for a row of the batch (gate order r, z, n; xw = x W_ih + b_ih, computed
// outside by one cuBLAS GEMM):
//   gh = h W_hh + b_hh;  r = sigmoid(xw_r + gh_r);  z = sigmoid(xw_z + gh_z);  n = tanh(xw_n + r gh_n)
//   h_new = (1 - z) n + z h;  h = m h_new + (1 - m) h;  out_t = h_new m
// The mask is any 0/1 pattern: the SRNN's backward GRU runs over a full flip of the sequence, so its zeros
// lead and the state holds h0 until the valid frames begin. Tensors are batch-first and contiguous: xw
// (B, T, 3H), W_hh (H, 3H), b_hh (3H), mask (B, T) float32 or null (all ones), h0 (B, H); outputs out
// (B, T, H) and h_n (B, H); state (2, B, H) is scratch, the carried state double-buffered between steps.
// In save mode (the forward of a train step) it also writes, for every row-step, what K7-bwd (gru_bwd.cu)
// reads: save (B, T, 5H) = [the state entering the step, r, z, n, hn = h W_hn + b_hn]; the outputs are the
// same bits as without it.
//
// What bounds it. At the SRNN test pass's shape (B = 6, T = 1125 stacks, H = 512, f32) the products are
// 2 B T H 3H ~ 10.6 GFLOP (~0.16 ms at 67 TFLOP/s), the compulsory bytes ~0.1 GB (~0.03 ms), but the
// T steps form a serial chain of (B, H) x (H, 3H) products: the latency of a step (staging h, the
// product, the exchange of h across the card) sets the pace, not bytes or operations.
//
// The design. K5's scheme (an 8-CTA cluster keeping all of W_hh in shared memory, h through distributed
// shared memory) stops at H = 256: at H = 512 W_hh is 3 MB of f32, 192 KB a CTA even on a 16-CTA cluster,
// which leaves too little shared memory for h and the partial sums. So K7 takes K8's scheme
// (vrnn_common.cuh): one persistent cooperative launch for all T steps, one CTA an SM, each CTA owning
// whole hidden units and keeping their r, z, n columns of W_hh (3 H U floats, ~24 KB at H = 512 on 132
// SMs) in shared memory for the whole launch. A step stages h_{t-1} (the rows of the batch, 8 a pass)
// from L2, each warp reduces whole columns (lanes split K, shuffles sum), the CTA finishes its units'
// gates, writes out_t and the new state to the other half of `state` through L2, and a grid-wide
// barrier ends the step. The step's side inputs (xw of the CTA's units and the mask) are issued before
// the staging loads, so their latency hides behind it. No tensor cores: the JAX step is f32.

#include "vrnn_common.cuh"

namespace blvm {
namespace gru {

using vrnn::BC;
using vrnn::NT;

struct Params {
  const float* xw;
  const float* w_hh;
  const float* b_hh;
  const float* mask;  // null: all ones
  const float* h0;
  float* out;
  float* h_n;
  float* save;   // null, or (B, T, 5H): h_{t-1}, r, z, n, hn of every row-step
  float* state;  // 2 x B x H: the state after step t lies in half (t + 1) & 1
  unsigned int* barrier;
  int B, T, H;
};

__global__ void __launch_bounds__(NT, 1) gru_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, G = 3 * H;
  const int ulo = vrnn::part_lo(H, cta, NB), nu = vrnn::part_lo(H, cta + 1, NB) - ulo;

  vrnn::Stage st;  // the r, z, n columns of W_hh for units [ulo, ulo + nu)
  st.K = H;
  st.nseg = 3;
  for (int g = 0; g < 3; ++g) st.seg[g] = vrnn::make_seg(p.w_hh, p.b_hh, G, g * H + ulo, nu, 0);
  st.ncols = 3 * nu;
  float* cursor = smem;
  st.ws = cursor;
  cursor += (size_t)st.ncols * H;
  st.bs = cursor;
  cursor += st.ncols;
  float* act = cursor;  // BC x H: h_{t-1} of the pass's rows
  cursor += (size_t)BC * H;
  float* res = cursor;  // 3 nu x BC
  cursor += (size_t)st.ncols * BC;
  float* side = cursor;  // BC x nu x 4: xw of the r, z, n gates and the mask

  int first = 0;  // a thread copies rows k of a segment's few columns, all loads first
  for (int i = 0; i < st.nseg; ++i) {
    const vrnn::Seg& sg = st.seg[i];
    float* ws = st.ws + (size_t)first * H;
    for (int j0 = 0; j0 < sg.n; j0 += 4) {
      for (int k = tid; k < H; k += NT) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = j0 + j < sg.n ? __ldg(sg.w + (int64_t)k * sg.ld + sg.col0 + j0 + j) : 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j0 + j < sg.n) ws[(size_t)(j0 + j) * H + k] = v[j];
      }
    }
    for (int j = tid; j < sg.n; j += NT) st.bs[first + j] = __ldg(sg.b + sg.col0 + j);
    first += sg.n;
  }
  __syncthreads();

  unsigned int target = 0;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? p.h0 : p.state + (size_t)(t & 1) * B * H;
    float* h_next = p.state + (size_t)((t + 1) & 1) * B * H;
    for (int b0 = 0; b0 < B; b0 += BC) {
      float sv[2];  // xw of the r, z, n gates and the mask of (row, unit) pairs, issued first
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = tid + i * NT, g = q % 4, u = (q / 4) % nu, row = b0 + q / (4 * nu);
        sv[i] = 0.0f;
        if (q < BC * nu * 4 && row < B) {
          const int64_t rt = (int64_t)row * T + t;
          if (g == 3)
            sv[i] = p.mask ? __ldg(p.mask + rt) : 1.0f;
          else
            sv[i] = __ldg(p.xw + rt * G + g * H + ulo + u);
        }
      }
      vrnn::load_stage(act, h_in, nullptr, H, H, b0, B);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (tid + i * NT < BC * nu * 4) side[tid + i * NT] = sv[i];
      __syncthreads();
      vrnn::stage_products(st, act, res);
      __syncthreads();
      for (int idx = tid; idx < nu * BC; idx += NT) {
        const int u = idx / BC, b = idx % BC, row = b0 + b;
        if (row >= B) continue;
        const float* sd = side + (b * nu + u) * 4;
        float gh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) gh[g] = res[(g * nu + u) * BC + b] + st.bs[g * nu + u];
        const float h = act[b * H + ulo + u], m = sd[3];
        const float r = sigmoidf(sd[0] + gh[0]);
        const float z = sigmoidf(sd[1] + gh[1]);
        const float n = tanhf(__fadd_rn(sd[2], __fmul_rn(r, gh[2])));
        const float h_new = __fadd_rn(__fmul_rn(1.0f - z, n), __fmul_rn(z, h));
        const float h_kept = __fadd_rn(__fmul_rn(m, h_new), __fmul_rn(1.0f - m, h));
        const int64_t o = (int64_t)row * H + ulo + u;
        __stcg(p.out + ((int64_t)row * T + t) * H + ulo + u, __fmul_rn(h_new, m));
        __stcg(h_next + o, h_kept);
        if (t == T - 1) p.h_n[o] = h_kept;
        if (p.save) {
          float* sv = p.save + ((int64_t)row * T + t) * 5 * H + ulo + u;
          __stcs(sv, h);
          __stcs(sv + H, r);
          __stcs(sv + 2 * H, z);
          __stcs(sv + 3 * H, n);
          __stcs(sv + 4 * H, gh[2]);
        }
      }
      __syncthreads();
    }
    if (t + 1 < T) vrnn::grid_sync(p.barrier, target);
  }
}

// shared memory of a CTA when the H units are cut into NB parts (the largest part, mu units)
size_t smem_bytes(int NB, int H) {
  const size_t mu = (H + NB - 1) / NB;
  return (3 * mu * H + 3 * mu + (size_t)BC * H + 3 * mu * BC + 4 * mu * BC) * sizeof(float);
}

}  // namespace gru
}  // namespace blvm

// K7. xw (B, T, 3H), w_hh (H, 3H), b_hh (3H), mask (B, T) float32 or null, h0 (B, H); out (B, T, H), h_n
// (B, H); save: null, or (B, T, 5H) (see Params); state: 2 B H floats of scratch; barrier: one uint32
// (zeroed here). The grid is one CTA an SM, or one a unit where H is below the card's SM count. Returns a
// cudaError_t: cudaErrorInvalidValue for shapes it does not take (more than 2 NT / (4 BC) = 16 units a CTA,
// whose side inputs its threads fetch two each), cudaErrorCooperativeLaunchTooLarge when the grid's columns
// of W_hh cannot all be resident.
extern "C" int blvm_gru_recurrence(const void* xw, const void* w_hh, const void* b_hh, const void* mask,
                                   const void* h0, void* out, void* h_n, void* save, void* state, void* barrier,
                                   int B, int T, int H, void* stream) {
  using namespace blvm::gru;
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static blvm::vrnn::LaunchCache cache;
  cudaError_t err = blvm::vrnn::query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int NB = cache.sms < H ? cache.sms : H;
  if (4 * ((H + NB - 1) / NB) * BC > 2 * NT) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(NB, H);
  err = blvm::vrnn::prepare_cooperative(cache, (const void*)gru_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.xw = static_cast<const float*>(xw);
  p.w_hh = static_cast<const float*>(w_hh);
  p.b_hh = static_cast<const float*>(b_hh);
  p.mask = static_cast<const float*>(mask);
  p.h0 = static_cast<const float*>(h0);
  p.out = static_cast<float*>(out);
  p.h_n = static_cast<float*>(h_n);
  p.save = static_cast<float*>(save);
  p.state = static_cast<float*>(state);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.B = B;
  p.T = T;
  p.H = H;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)gru_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
