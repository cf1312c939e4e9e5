// Hopper warpgroup MMA (wgmma) pieces shared by conv_chain.cu and
// convnext_chain.cu, for sm_90a, in inline PTX.
//
// Operands in shared memory are K-major and unswizzled (layout type 0,
// INTERLEAVE): the unit is the core matrix, 8 rows (of M or N) x 8 bf16
// along K, 128 contiguous bytes (row r at byte 16 * r).  A k16 step reads
// two core matrices along K for each 8-row group.  The descriptor holds
//   start address >> 4                    bits [0, 14)
//   LBO >> 4: bytes from the k0-7 core matrix to the k8-15 one   [16, 30)
//   SBO >> 4: bytes from one 8-row group to the next             [32, 46)
// (CuTe's canonical K-major INTERLEAVE layout ((8,n),2):((1,SBO),LBO) in
// 16-byte units).  Both kernels keep a matrix [K][N] in shared memory as
// [K/8][N][8] (pack_kmajor in the wrappers): LBO = 16 N, SBO = 128, and
// k-step s starts at byte 32 N s.
//
// Accumulators start from the first product (scale_d = 0): code that writes
// an accumulator between a wgmma and its wait makes ptxas serialize every
// wgmma of the function (C7515), and zeroing one is such code.
//
// Accumulators: m64nN gives each thread N/2 floats; warp w of the
// warpgroup holds rows 16 w + lane/4 (+8), element 4 j + e is column
// 8 j + 2 (lane % 4) + (e & 1) of row lane/4 + 8 (e >> 1).  Columns
// [16 k, 16 k + 16) of that layout, packed to bf16 pairs, are exactly the
// A fragment of a k16 step (wgmma_rs_*): registers (4k, 4k+1), (4k+2,
// 4k+3), (4k+4, 4k+5), (4k+6, 4k+7).

#ifndef RVDD_WGMMA_CUH_
#define RVDD_WGMMA_CUH_

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// descriptor of a K-major unswizzled operand starting at shared address addr
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// orders earlier register writes (accumulators, A fragments) and shared
// memory before the wgmma that follow
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// makes shared-memory writes of this thread (st.shared, cp.async) visible
// to the async proxy that wgmma reads through; call before the barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across a
// wgmma.wait (the asm statements of the MMA do not name it there)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for an A fragment: keeps its registers from being reused until
// the wait that ends the wgmma reading them
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// synchronises the 128 threads of warpgroup g (named barrier 1 + g)
__device__ __forceinline__ void bar_warpgroup(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}

// named barrier `id` of `n` threads: bar_sync waits until n threads have
// arrived (this one included), bar_arrive counts this thread and goes on.
// Both order the memory accesses before them for the threads that wait.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// gives registers back (dec) or takes them (inc): every thread of the
// warpgroup then has at most N; in a warp-specialized kernel, once per role
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 16-byte asynchronous copy global -> shared, through L1 (neighbouring
// threads read neighbouring 16 bytes of one line in turns)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Phase clocks for rvdd_tpu_torch/probe.py: built with -DRVDD_PHASE_CLOCKS,
// a thread of each CTA adds the cycles of each phase of its tiles to
// g_phase_clocks[0..6) and the tile count to g_phase_clocks[7]; without the
// flag PHASE_CLOCK(...) is empty.  A kernel of three phases uses slots 0-2;
// a warp-specialized one gives its producer slots 0-2 and its consumers 3-5.
#ifdef RVDD_PHASE_CLOCKS
#define PHASE_CLOCK(...) __VA_ARGS__
constexpr int PHASE_SLOTS = 8;
__device__ unsigned long long g_phase_clocks[PHASE_SLOTS];
// from the calling thread: ph to slots [base, base + 3), tiles to slot 7
__device__ __forceinline__ void phase_clocks_add_at(const long long (&ph)[3], int base, int tiles) {
  for (int i = 0; i < 3; ++i) atomicAdd(&g_phase_clocks[base + i], (unsigned long long)ph[i]);
  if (tiles) atomicAdd(&g_phase_clocks[PHASE_SLOTS - 1], (unsigned long long)tiles);
}
__device__ __forceinline__ void phase_clocks_add(const long long (&ph)[3], int tiles) {
  if (threadIdx.x == 0) phase_clocks_add_at(ph, 0, tiles);
}
#else
#define PHASE_CLOCK(...)
#endif

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 16] = A[64 x 16] * B[16 x 16] (+ D if scale_d), A and B in shared
// memory (K-major)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] = A[64 x 16] * B[16 x 32] (+ D if scale_d), A and B in shared
// memory (K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 48] = A[64 x 16] * B[16 x 48] (+ D if scale_d), A and B in shared
// memory (K-major)
__device__ __forceinline__ void wgmma_ss_n48(float (&d)[24], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 96] = A[64 x 16] * B[16 x 96] (+ D if scale_d), A and B in shared
// memory (K-major)
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 16] = A[64 x 16] * B[16 x 16] (+ D if scale_d), A from registers (the m16k16
// fragment of mma.sync, per warp of the warpgroup), B in shared memory
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 32] = A[64 x 16] * B[16 x 32] (+ D if scale_d), A from registers, B in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 48] = A[64 x 16] * B[16 x 48] (+ D if scale_d), A from registers (the m16k16
// fragment of mma.sync, per warp of the warpgroup), B in shared memory
__device__ __forceinline__ void wgmma_rs_n48(float (&d)[24], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace wg

#ifdef RVDD_PHASE_CLOCKS
// copies the phase clocks to host[0..8) and zeroes them; returns a cudaError_t
extern "C" int rvdd_phase_clocks(void* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, wg::g_phase_clocks, sizeof(wg::g_phase_clocks));
  const unsigned long long zero[wg::PHASE_SLOTS] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(wg::g_phase_clocks, zero, sizeof(zero));
  return (int)e;
}
#endif

#endif  // RVDD_WGMMA_CUH_
