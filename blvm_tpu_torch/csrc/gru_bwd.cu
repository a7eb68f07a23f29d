// K7-bwd: the masked GRU recurrence's backward through all T steps of a sequence batch, f32, on sm_90a.
//
// Replaces the autodiff backward of the lax.scan over blvm_tpu/modules/recurrent.py GRU.__call__ (:177-187)
// that the JAX train step computes (the SRNN runs it twice a step: for d, and for a over the full flip). From
// what K7 saved (gru.cu, save mode: the state entering each step, r, z, n, hn = h W_hn + b_hn) and the
// gradients of its outputs, it runs the chain in reverse, from step T - 1 to 0, with dh the gradient of the
// state leaving step t (d h_n at the last step, else carried from step t + 1) and m the step's mask:
//   dh_new = m (dh + d out_t);  dn = dh_new (1 - z);  dz = dh_new (h_{t-1} - n)
//   d pre_n = dn (1 - n^2);  d pre_z = dz z (1 - z);  d pre_r = d pre_n hn r (1 - r)
//   d gi = [d pre_r, d pre_z, d pre_n]   (the gradient of xw = x W_ih + b_ih)
//   d gh = [d pre_r, d pre_z, d pre_n r] (the gradient of h W_hh + b_hh: r multiplies hn)
//   dh_{t-1} = (1 - m) dh + dh_new z + d gh W_hh^T
// The state is frozen where the mask is 0, so dh passes such a step unchanged: the a GRU's flipped mask has
// its zeros first, and dh reaches d a_0 through them. It writes d gi and d gh of every step and dh0; the
// wrapper turns d gh into dW_hh = sum h_{t-1}^T d gh and db_hh with cuBLAS (sums over B T rows).
//
// What bounds it. At the SRNN train step's shape (B = 19, T ~ 1000 stacks, H = 512, f32) the product
// d gh W_hh^T is 2 B T 3H H ~ 30 GFLOP (~0.45 ms at 67 TFLOP/s) and the compulsory bytes ~0.7 GB (~0.2 ms),
// but the T steps are a serial chain of (B, 3H) x (3H, H) products: the latency of a step sets the pace.
//
// The design is K8-bwd's (vrnn_cell_bwd.cu) on K7's grid (vrnn_common.cuh): one persistent cooperative
// launch, one CTA an SM. The product sums over W_hh's 3H outputs, so each CTA owns whole *input* units, its
// ~H/132 rows of W_hh (3H floats each, ~24 KB at H = 512) resident in shared memory, and the dh of its units
// never leaves it. A step is two stages and one grid barrier: (1) each CTA's units, every row: the
// elementwise backward above, d gi and d gh stored through L2; the barrier; (2) d gh of the step's rows
// staged from L2 (8 rows a pass, 3H floats a row), each warp reduces whole rows of W_hh, and the CTA adds
// the products to its units' (1 - m) dh + dh_new z. The next step's stage 1 writes another step's d gh, so
// no barrier follows stage 2. Given a trace buffer, the first CTA adds up the SM cycles of each stage's
// phases (inputs in, products, finish and store, barrier), as K7-K9 do. No tensor cores: the JAX step is f32.

#include "vrnn_common.cuh"

namespace blvm {
namespace gru_bwd {

using vrnn::BC;
using vrnn::NPHASES;
using vrnn::NT;

constexpr int NSTAGES = 2;  // the trace holds NSTAGES x NPHASES sums, then the loop's cycles and nanoseconds

struct Params {
  const float* w_hh;  // (H, 3H)
  const float* mask;  // (B, T) or null: all ones
  const float* save;  // (B, T, 5H): K7's save mode
  const float* d_out;  // (B, T, H) or null: zero
  const float* d_hn;   // (B, H) or null: zero
  float* d_gi;  // (B, T, 3H)
  float* d_gh;  // (B, T, 3H)
  float* d_h0;  // (B, H)
  unsigned int* barrier;
  long long* trace;
  int B, T, H;
};

__global__ void __launch_bounds__(NT, 1) gru_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  const int NB = gridDim.x, cta = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, G = 3 * H;
  const int ulo = vrnn::part_lo(H, cta, NB), nu = vrnn::part_lo(H, cta + 1, NB) - ulo;

  vrnn::Stage st;  // rows [ulo, ulo + nu) of W_hh: input units
  st.K = G;
  st.nseg = 1;
  st.seg[0] = vrnn::make_seg(p.w_hh, nullptr, G, ulo, nu, 0);
  st.ncols = nu;
  float* cursor = smem;
  st.ws = cursor;
  cursor += (size_t)nu * G;
  st.bs = nullptr;
  float* act = cursor;  // BC x 3H: d gh of the pass's rows
  cursor += (size_t)BC * G;
  float* res = cursor;  // nu x BC
  cursor += (size_t)nu * BC;
  float* dh_c = cursor;  // B x nu: dh of this CTA's units, leaving the step being run
  cursor += (size_t)B * nu;
  float* dh_k = cursor;  // B x nu: (1 - m) dh + dh_new z, from stage 1 to stage 2

  for (int j = 0; j < nu; ++j)  // rows of W_hh, coalesced along the row
    for (int k = tid; k < G; k += NT) st.ws[(size_t)j * G + k] = __ldg(p.w_hh + (int64_t)(ulo + j) * G + k);
  for (int i = tid; i < B * nu; i += NT) dh_c[i] = p.d_hn ? __ldg(p.d_hn + (int64_t)(i / nu) * H + ulo + i % nu) : 0.0f;
  __syncthreads();

  unsigned int target = 0;
  long long* const trace = cta == 0 && tid == 0 ? p.trace : nullptr;
  const long long ns_begin = trace ? vrnn::now_ns() : 0, cycles_begin = trace ? clock64() : 0;
  long long mark = cycles_begin;
  auto tick = [&](int stage, int phase) {  // after a CTA barrier: the phase's cycles as CTA 0 sees them
    if (trace) {
      const long long t_ = clock64();
      trace[stage * NPHASES + phase] += t_ - mark;
      mark = t_;
    }
  };

  const int64_t W = (int64_t)5 * H;
  for (int t = T - 1; t >= 0; --t) {
    // stage 1: the elementwise backward of this CTA's units, every row
    for (int idx = tid; idx < B * nu; idx += NT) {
      const int row = idx / nu, unit = ulo + idx % nu;
      const int64_t rt = (int64_t)row * T + t;
      const float* sv = p.save + rt * W + unit;
      const float hp = __ldg(sv), r = __ldg(sv + H), z = __ldg(sv + 2 * H), n = __ldg(sv + 3 * H);
      const float hn = __ldg(sv + 4 * H);
      const float m = p.mask ? __ldg(p.mask + rt) : 1.0f;
      const float dout = p.d_out ? __ldg(p.d_out + rt * H + unit) : 0.0f;
      const float dh = dh_c[idx];
      const float dh_new = m * (dh + dout);
      const float dn = dh_new * (1.0f - z);
      const float dz = dh_new * (hp - n);
      const float dpn = dn * (1.0f - n * n);
      const float dpz = dz * z * (1.0f - z);
      const float dpr = dpn * hn * r * (1.0f - r);
      float* gi = p.d_gi + rt * G + unit;
      float* gh = p.d_gh + rt * G + unit;
      __stcs(gi, dpr);
      __stcs(gi + H, dpz);
      __stcs(gi + 2 * H, dpn);
      __stcg(gh, dpr);
      __stcg(gh + H, dpz);
      __stcg(gh + 2 * H, dpn * r);
      dh_k[idx] = (1.0f - m) * dh + dh_new * z;
    }
    __syncthreads();
    tick(0, 2);
    vrnn::grid_sync(p.barrier, target);
    tick(0, 3);

    // stage 2: dh_{t-1} of this CTA's units = dh_k + d gh W_hh^T, rows [b0, b0 + BC) a pass
    for (int b0 = 0; b0 < B; b0 += BC) {
      vrnn::load_stage(act, p.d_gh + (int64_t)t * G, nullptr, (int64_t)T * G, G, b0, B);
      __syncthreads();
      tick(1, 0);
      vrnn::stage_products(st, act, res);
      __syncthreads();
      tick(1, 1);
      for (int idx = tid; idx < nu * BC; idx += NT) {
        const int u = idx / BC, b = idx % BC, row = b0 + b;
        if (row < B) dh_c[row * nu + u] = dh_k[row * nu + u] + res[u * BC + b];
      }
      __syncthreads();
      tick(1, 2);
    }
  }
  for (int i = tid; i < B * nu; i += NT) p.d_h0[(int64_t)(i / nu) * H + ulo + i % nu] = dh_c[i];
  if (trace) {
    trace[NSTAGES * NPHASES] += clock64() - cycles_begin;
    trace[NSTAGES * NPHASES + 1] += vrnn::now_ns() - ns_begin;
  }
}

// shared memory of a CTA when the H units are cut into NB parts (the largest part, mu units)
size_t smem_bytes(int NB, int B, int H) {
  const size_t mu = (H + NB - 1) / NB;
  return (mu * 3 * H + (size_t)BC * 3 * H + mu * BC + 2 * (size_t)B * mu) * sizeof(float);
}

}  // namespace gru_bwd
}  // namespace blvm

// K7-bwd. w_hh (H, 3H); mask (B, T) float32 or null (all ones); save (B, T, 5H): K7's save buffer; d_out (B,
// T, H) and d_hn (B, H): the gradients of K7's outputs, each null for zero. Writes d_gi and d_gh (B, T, 3H),
// every step's gradients of xw and of h W_hh + b_hh, and d_h0 (B, H). barrier: one uint32 (zeroed here);
// trace: null, or 10 int64 sums the kernel adds to (the SM cycles of each stage's four phases as CTA 0 sees
// them, then the loop's cycles and nanoseconds). The grid is K7's: one CTA an SM, or one a unit where H is
// below the card's SM count. Returns a cudaError_t: cudaErrorInvalidValue for shapes it does not take,
// cudaErrorCooperativeLaunchTooLarge when the grid's rows of W_hh cannot all be resident.
extern "C" int blvm_gru_recurrence_bwd(const void* w_hh, const void* mask, const void* save, const void* d_out,
                                       const void* d_hn, void* d_gi, void* d_gh, void* d_h0, void* barrier,
                                       void* trace, int B, int T, int H, void* stream) {
  using namespace blvm::gru_bwd;
  if (B < 1 || T < 1 || H < 1 || !w_hh || !save || !d_gi || !d_gh || !d_h0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static blvm::vrnn::LaunchCache cache;
  cudaError_t err = blvm::vrnn::query_device(cache);
  if (err != cudaSuccess) return (int)err;
  const int NB = cache.sms < H ? cache.sms : H;
  const size_t smem = smem_bytes(NB, B, H);
  err = blvm::vrnn::prepare_cooperative(cache, (const void*)gru_bwd_kernel, smem, NB);
  if (err != cudaSuccess) return (int)err;

  Params p;
  p.w_hh = static_cast<const float*>(w_hh);
  p.mask = static_cast<const float*>(mask);
  p.save = static_cast<const float*>(save);
  p.d_out = static_cast<const float*>(d_out);
  p.d_hn = static_cast<const float*>(d_hn);
  p.d_gi = static_cast<float*>(d_gi);
  p.d_gh = static_cast<float*>(d_gh);
  p.d_h0 = static_cast<float*>(d_h0);
  p.barrier = static_cast<unsigned int*>(barrier);
  p.trace = static_cast<long long*>(trace);
  p.B = B;
  p.T = T;
  p.H = H;
  err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)gru_bwd_kernel, dim3(NB), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
