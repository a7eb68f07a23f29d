// Warpgroup bf16 tensor-core helpers for Hopper (sm_90a): wgmma.mma_async (four warps, 64 rows of A, f32
// accumulators in registers, B and optionally A read from shared memory by descriptor), its fence / commit / wait,
// the shared-memory layout the descriptors describe, and cp.async copies into it. The tile of the WaveNet block's
// backward (residual_glu_bwd.cu: pass A, the weight gradients, pass B) and of the fused stack (wavenet_stack.cu).
//
// Layout (no swizzle, wgmma's "interleave" mode). An operand is stored as 8 x 8 core matrices of bf16, each 128
// contiguous bytes: 8 "outer" rows of 16 bytes, each row 8 consecutive "inner" elements. The inner dimension is the
// one that lies contiguous in device memory, so one 16-byte cp.async moves one core-matrix row and nothing is
// transposed on the way in:
//   K-major operand   (A rows x k, or B as [n][k]):  inner = k,          outer = the M or N index;
//   MN-major operand  (A as [k][m], or B as [k][n]): inner = the M or N index, outer = k;
// wgmma reads an MN-major operand transposed (TRANS = 1, bf16 only). Core matrices are laid inner-group fastest:
// element (outer, inner) of a tile INNER wide lies at byte
//   ((outer / 8) * (INNER / 8) + inner / 8) * 128 + (outer % 8) * 16 + (inner % 8) * 2,
// so neighbouring core matrices along the inner dimension are 128 bytes apart and along the outer INNER * 16. A
// descriptor names the stride between core matrices along K (the leading byte offset) and along M or N (the stride
// byte offset); a k16 step moves its start two core matrices along K. A is read K-major or MN-major, B N-major only
// (the one B form the tile test holds to a plain product): weights that lie [n][k] are staged transposed
// (store_transposed).
//
// Fragments: lane (g = lane / 4, q = lane % 4) of warp w of the warpgroup holds in d[4 j + e] the accumulator of row
// 16 w + g + 8 (e / 2), column 8 j + 2 q + e % 2 (mma.sync's m16n8 C fragment, tile j); an A operand in registers is
// mma.sync's m16n8k16 A fragment of the warp's 16 rows. Before wgmma reads shared memory written by the threads'
// own stores or cp.async, fence_async_smem() and a barrier; before it reads or writes registers touched since the
// last wgmma, fence().
#pragma once

#include "mma_bf16.cuh"

namespace blvm {
namespace wgmma {

// byte offset of element (outer, inner) in a core-matrix tile INNER elements wide (a multiple of 8)
__host__ __device__ constexpr int offset(int outer, int inner, int INNER) {
  return ((outer >> 3) * (INNER >> 3) + (inner >> 3)) * 128 + (outer & 7) * 16 + (inner & 7) * 2;
}

// the 64-bit shared-memory matrix descriptor: start address, leading (K) and stride (M / N) byte offsets, no swizzle
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
}
// K-major tile INNER = K wide: K steps 128 bytes apart, M / N groups K * 16; k-step ks starts 256 ks bytes in
__device__ __forceinline__ uint64_t desc_k(const void* tile, int K, int ks) {
  return desc(static_cast<const char*>(tile) + 256 * ks, 128, 16 * K);
}
// MN-major tile INNER = MN wide (the M or N extent stored): K groups MN * 16 apart, M / N groups 128; k-step ks
// starts 2 MN * 16 ks bytes in
__device__ __forceinline__ uint64_t desc_mn(const void* tile, int MN, int ks) {
  return desc(static_cast<const char*>(tile) + 32 * MN * ks, 16 * MN, 128);
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// shared-memory writes of the generic proxy (st.shared, cp.async) made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// keeps the compiler from moving accesses of the accumulators across a wgmma or its wait
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// a barrier of the 128 threads of warpgroup wg (named barrier 1 + wg; 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); }

// Copy a rows x INNER tile into the core-matrix layout at dst, one 16-byte cp.async a core-matrix row, by the
// `nthreads` threads numbered `tid`. Eight threads in a row take the same 16 bytes of eight consecutive rows (eight
// distinct shared-memory bank groups), a warp four neighbouring chunks of those rows. src(r, col) gives the address
// of element (r, col) in device memory (16-byte aligned, col a multiple of 8), or null for 8 elements that read as
// 0; `any` is a valid address the zero-filling copies name (they read nothing).
template <int INNER, typename Src>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int rows, Src src, const __nv_bfloat16* any, int tid,
                                          int nthreads) {
  constexpr int NCH = INNER / 8;
  for (int i = tid; i < rows * NCH; i += nthreads) {
    const int r = (i & 7) + 8 * (i / (8 * NCH)), v = (i >> 3) % NCH;
    const __nv_bfloat16* p = src(r, 8 * v);
    cp_async16(reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(dst) + offset(r, 8 * v, INNER)),
               p ? p : any, p != nullptr);
  }
}

// Copy a rows x INNER tile out of the core-matrix layout at src into device memory, 16 bytes a thread and a step
// (load_tile's mapping: no bank conflicts, whole 32-byte sectors), by the `nthreads` threads numbered `tid`. dst(r,
// col) gives the address of element (r, col), or null for a row that is not written.
template <int INNER, typename Dst>
__device__ __forceinline__ void store_tile(const __nv_bfloat16* src, int rows, Dst dst, int tid, int nthreads) {
  constexpr int NCH = INNER / 8;
  for (int i = tid; i < rows * NCH; i += nthreads) {
    const int r = (i & 7) + 8 * (i / (8 * NCH)), v = (i >> 3) % NCH;
    __nv_bfloat16* p = dst(r, 8 * v);
    if (p)
      *reinterpret_cast<uint4*>(p) =
          *reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(src) + offset(r, 8 * v, INNER));
  }
}

// a bf16 pair (4 bytes) into element (r, col) of a core-matrix tile INNER wide (col even): eight rows of a fragment
// land in eight bank groups
template <int INNER>
__device__ __forceinline__ void put2(__nv_bfloat16* tile, int r, int col, uint32_t v) {
  *reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(tile) + offset(r, col, INNER)) = v;
}
template <int INNER>
__device__ __forceinline__ float2 get2(const __nv_bfloat16* tile, int r, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(reinterpret_cast<const char*>(tile) + offset(r, col, INNER)));
}

// Store 8 consecutive elements of one device-memory row, loaded as 16 bytes, into an MN-major tile transposed from
// how it lies: element u goes to (outer0 + u, inner) of a tile INNER wide. For weights that lie [n][k] in device
// memory and are read as B (K x N): staged once, where the kernel starts, with plain stores.
template <int INNER>
__device__ __forceinline__ void store_transposed(__nv_bfloat16* dst, int outer0, int inner, uint4 v) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
  char* base = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int u = 0; u < 8; ++u) *reinterpret_cast<__nv_bfloat16*>(base + offset(outer0 + u, inner, INNER)) = e[u];
}

// D (64 x 96, f32) = A B (+ D if scale_d): A (64 x 16) and B (16 x 96) bf16 in shared memory, by descriptor
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void mma_ss_n96(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// D (64 x 192, f32) = A B (+ D if scale_d): A (64 x 16) and B (16 x 192) bf16 in shared memory, by descriptor
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void mma_ss_n192(float (&d)[96], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// D (64 x 192, f32) = A B (+ D if scale_d): A (64 x 16) bf16 in registers (mma.sync's A fragment, a warp's 16
// rows), B (16 x 192) in shared memory, by descriptor
template <int TRANS_B>
__device__ __forceinline__ void mma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, %102;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}


}  // namespace wgmma
}  // namespace blvm
