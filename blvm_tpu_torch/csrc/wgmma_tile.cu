// The warpgroup tile of wgmma_bf16.cuh alone: one warpgroup computes D (64 x N, f32) = A (64 x K) B (K x N) from
// bf16 operands in device memory, through the header's shared-memory layout, descriptors and wgmma forms. It
// replaces no TPU kernel: it exists so that a test on the card holds the tile, in each operand layout the kernels
// use, to a plain product before any kernel relies on it (tests/_torch/test_torch_kernels_cuda.py). One launch
// of one CTA; nothing bounds it but its launch.

#include "wgmma_bf16.cuh"

namespace blvm {
namespace {

using bf = __nv_bfloat16;
constexpr int M = 64, THREADS = 128, MAX_K = 192, MAX_N = 192;
constexpr size_t SMEM = sizeof(bf) * ((size_t)M * MAX_K + (size_t)MAX_K * MAX_N);

// A: (64, K) row-major (K-major) or, with TRANS_A, (K, 64) row-major (M-major); B: (K, N) row-major (N-major, the
// only B layout the kernels use). A_REGS: A read from shared memory into mma.sync A fragments first.
template <int N, int K, int TRANS_A, bool A_REGS>
__global__ void __launch_bounds__(THREADS) tile_kernel(const bf* __restrict__ a, const bf* __restrict__ b,
                                                       float* __restrict__ d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf* sa = reinterpret_cast<bf*>(smem_raw);
  bf* sb = sa + M * MAX_K;
  const int tid = threadIdx.x;
  if (TRANS_A)
    wgmma::load_tile<M>(sa, K, [&](int r, int c) { return a + (size_t)r * M + c; }, a, tid, THREADS);
  else
    wgmma::load_tile<K>(sa, M, [&](int r, int c) { return a + (size_t)r * K + c; }, a, tid, THREADS);
  wgmma::load_tile<N>(sb, K, [&](int r, int c) { return b + (size_t)r * N + c; }, b, tid, THREADS);
  cp_async_commit();
  cp_async_wait_all();
  wgmma::fence_async_smem();
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  wgmma::fence_operand(acc);
  wgmma::fence();
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const uint64_t db = wgmma::desc_mn(sb, N, ks);
    if constexpr (A_REGS) {
      const char* base = reinterpret_cast<const char*>(sa);
      const int r = 16 * warp + g, k = 16 * ks + 2 * q;
      auto at = [&](int rr, int kk) {
        return *reinterpret_cast<const uint32_t*>(base + ((rr >> 3) * (K >> 3) + (kk >> 3)) * 128 + (rr & 7) * 16 +
                                                  (kk & 7) * 2);
      };
      const uint32_t fa[4] = {at(r, k), at(r + 8, k), at(r, k + 8), at(r + 8, k + 8)};
      wgmma::fence();  // the fragment registers were written since the last wgmma
      wgmma::mma_rs_n192<1>(acc, fa, db, ks > 0);
    } else {
      const uint64_t da = TRANS_A ? wgmma::desc_mn(sa, M, ks) : wgmma::desc_k(sa, K, ks);
      if constexpr (N == 96)
        wgmma::mma_ss_n96<TRANS_A, 1>(acc, da, db, ks > 0);
      else
        wgmma::mma_ss_n192<TRANS_A, 1>(acc, da, db, ks > 0);
    }
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[(16 * warp + g + 8 * (e >> 1)) * N + 8 * j + 2 * q + (e & 1)] = acc[4 * j + e];
}

template <int N, int K, int TRANS_A, bool A_REGS>
int launch_k(const void* a, const void* b, void* d, cudaStream_t stream) {
  auto kernel = tile_kernel<N, K, TRANS_A, A_REGS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, THREADS, SMEM, stream>>>(static_cast<const bf*>(a), static_cast<const bf*>(b), static_cast<float*>(d));
  return (int)cudaGetLastError();
}

// K is a template argument, so that the k-steps unroll as they do in the kernels that use the tile
template <int N, int TRANS_A, bool A_REGS>
int launch(const void* a, const void* b, void* d, int K, cudaStream_t stream) {
  switch (K) {
    case 16: return launch_k<N, 16, TRANS_A, A_REGS>(a, b, d, stream);
    case 64: return launch_k<N, 64, TRANS_A, A_REGS>(a, b, d, stream);
    case 192: return launch_k<N, 192, TRANS_A, A_REGS>(a, b, d, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace blvm

// D (64, n) float32 = A B in bf16 with f32 accumulation, on one warpgroup. a: (64, k) bf16, or (k, 64) with
// trans_a; b: (k, n); a_regs: A taken from registers (n = 192, trans_a = 0). n is 96 or 192, k 16, 64 or 192;
// every pointer 16-byte aligned. cudaErrorInvalidValue otherwise.
extern "C" int blvm_wgmma_tile(const void* a, const void* b, void* d, int n, int k, int trans_a, int a_regs,
                               void* stream) {
  using namespace blvm;
  if ((k != 16 && k != 64 && k != 192) || ((uintptr_t)a | (uintptr_t)b | (uintptr_t)d) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_regs) {
    if (n != 192 || trans_a) return (int)cudaErrorInvalidValue;
    return launch<192, 0, true>(a, b, d, k, st);
  }
  if (n == 96) return trans_a ? launch<96, 1, false>(a, b, d, k, st) : launch<96, 0, false>(a, b, d, k, st);
  if (n == 192) return trans_a ? launch<192, 1, false>(a, b, d, k, st) : launch<192, 0, false>(a, b, d, k, st);
  return (int)cudaErrorInvalidValue;
}
