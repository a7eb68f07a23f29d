// What the two persistent frame loops share: K12 (stcn_decode.cu, STCN) and K4's resident route
// (wavenet_decode.cu, WaveNet in bf16 at C = 96). Each runs a whole generation in one launch, its CTAs
// co-resident, and hands values from CTA to CTA through global memory with:
//
//   - tagged words: a 64-bit word holds a 32-bit payload (a float, or two bf16) in its low half and a tag
//     in its high half, stored and loaded as one single-copy-atomic access (st/ld .relaxed.gpu). A
//     consumer spins on the words it reads until each carries the tag of the stage it waits for, so the
//     wait and the input's load are one round trip through L2 and no fence or flag is needed: a word's
//     payload and its tag arrive together.
//   - bounded waits: every spin (on tagged words, the grid barrier, an mbarrier) gives up once it has waited
//     limit_ns nanoseconds by the global timer (%globaltimer), records an error code in the launch's status
//     word and returns false; every other CTA's spin sees the status word and gives up too, so a fault ends the
//     launch in about one limit instead of hanging the card. The wrapper reads the status word once after
//     the launch.
//   - bulk copies (cp.async.bulk) of weights into shared memory that complete on an mbarrier: the
//     resident weights once a launch, and K12's ring of streamed weight chunks;
//   - between the CTAs of a cluster (K4), asynchronous stores (st.async) into the consumer's shared memory,
//     each completing its bytes on the consumer's mbarrier, which the consumer arms each frame with the bytes
//     it expects and waits on at cluster scope.
#pragma once

#include "common.cuh"

namespace blvm {
namespace decode {

// the status word's codes (0: the launch finished)
enum Status : int { kOk = 0, kTimeout = 1 };

struct Watch {
  int* status;        // the launch's status word, zeroed by the wrapper
  long long limit_ns;  // how long one wait may spin, in nanoseconds of the global timer
};

__device__ __forceinline__ long long now_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void fail(const Watch& w, int code) { atomicCAS(w.status, 0, code); }

__device__ __forceinline__ int status_of(const Watch& w) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(w.status) : "memory");
  return v;
}

// One spin of a bounded wait: false (and the status word set) once the wait has spun past its limit or
// another CTA has failed. Each spin reads the global timer (a register read; a wait that is already met never
// spins), every 128th also the status word; `deadline` starts at 0 and is set on the first spin.
__device__ __forceinline__ bool keep_waiting(const Watch& w, long long& deadline, int& spins) {
  const long long now = now_ns();
  if (deadline == 0) deadline = now + w.limit_ns;
  if (now > deadline) {
    fail(w, kTimeout);
    return false;
  }
  return (++spins & 127) != 0 || status_of(w) == kOk;
}

__device__ __forceinline__ unsigned long long tagged(uint32_t payload, uint32_t tag) {
  return ((unsigned long long)tag << 32) | payload;
}
__device__ __forceinline__ void publish(unsigned long long* p, uint32_t payload, uint32_t tag) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(tagged(payload, tag)) : "memory");
}
__device__ __forceinline__ void publish(unsigned long long* p, float v, uint32_t tag) { publish(p, __float_as_uint(v), tag); }
__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t tag_of(unsigned long long v) { return (uint32_t)(v >> 32); }

// This thread's share of n tagged words (i = threadIdx.x, + blockDim.x, ...): word i at addr(i) must
// carry want(i); sink(i, payload) takes each. All loads of a batch are in flight together and only the
// words not yet tagged are loaded again. False on a timeout (the status word is set).
template <int BATCH, class Addr, class Want, class Sink>
__device__ __forceinline__ bool gather(int n, Addr addr, Want want, Sink sink, const Watch& w) {
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * blockDim.x) {
    unsigned long long v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * blockDim.x;
      v[j] = i < n ? peek(addr(i)) : 0ull;
    }
    long long deadline = 0;
    int spins = 0;
    for (;;) {
      bool ready = true;
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < n && tag_of(v[j]) != want(i)) ready = false;
      }
      if (ready) break;
      if (!keep_waiting(w, deadline, spins)) return false;
#pragma unroll
      for (int j = 0; j < BATCH; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < n && tag_of(v[j]) != want(i)) v[j] = peek(addr(i));
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i < n) sink(i, (uint32_t)v[j]);
    }
  }
  return true;
}

// All CTAs of a cooperative launch meet. The CTA's stores are ordered before the arrival by the CTA
// barrier and a gpu-scope release fence; the arrival is a fire-and-forget reduction on one counter; the
// acquire load that sees every arrival orders the CTA's later loads after them. False on a timeout.
__device__ __forceinline__ bool grid_barrier(unsigned int* counter, unsigned int& target, const Watch& w) {
  __syncthreads();
  int failed = 0;
  if (threadIdx.x == 0) {
    target += gridDim.x;
    asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;" ::"l"(counter) : "memory");
    long long deadline = 0;
    int spins = 0;
    for (;;) {
      unsigned int seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(counter) : "memory");
      if ((int)(seen - target) >= 0) break;
      if (!keep_waiting(w, deadline, spins)) {
        failed = 1;
        break;
      }
    }
  }
  return !__syncthreads_or(failed);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

// one thread: an mbarrier for `count` arrivals, visible to the async proxy before any copy names it
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one thread: the barrier's arrival for this phase, expecting `bytes` of copies to complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// one thread: `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to shared memory,
// completing on `bar`, in pieces of at most 64 KB
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  for (unsigned off = 0; off < bytes; off += 65536u) {
    const unsigned n = bytes - off < 65536u ? bytes - off : 65536u;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
            smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_addr(bar))
        : "memory");
  }
}

// every thread: until phase `parity` of `bar` has completed; false on a timeout
__device__ __forceinline__ bool mbar_wait(uint64_t* bar, unsigned parity, const Watch& w) {
  long long deadline = 0;
  int spins = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return true;
    if (!keep_waiting(w, deadline, spins)) return false;
  }
}

// every thread: until phase `parity` of `bar` has completed, acquiring at cluster scope what the CTAs whose
// release arrivals completed it stored (into this CTA's shared memory); false on a timeout
__device__ __forceinline__ bool mbar_wait_cluster(uint64_t* bar, unsigned parity, const Watch& w) {
  long long deadline = 0;
  int spins = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\tmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return true;
    if (!keep_waiting(w, deadline, spins)) return false;
  }
}

// the shared::cluster address of `p`'s offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t remote(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// an asynchronous store into another CTA's shared memory (shared::cluster addresses) that completes its bytes on
// that CTA's mbarrier `bar`: 4 bytes, or a pair of floats
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr), "r"(v),
               "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float v0, float v1, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];" ::"r"(addr),
               "f"(v0), "f"(v1), "r"(bar)
               : "memory");
}

// The co-residency a persistent launch needs: NB CTAs of `threads` threads and `smem` bytes of dynamic
// shared memory each, one wave. cudaErrorCooperativeLaunchTooLarge when they do not all fit.
inline cudaError_t prepare_persistent(const void* kernel, int threads, size_t smem, int NB) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return (long long)per_sm * sms < NB ? cudaErrorCooperativeLaunchTooLarge : cudaSuccess;
}

}  // namespace decode
}  // namespace blvm
