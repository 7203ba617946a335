// Shared-memory staging for the redesigned kernels (flash_fwd.cu and the
// prefill path of quant_matmul.cu): asynchronous 16-byte copies from global
// to shared memory (cp.async, Ampere and later), ldmatrix loads of
// mma.sync fragments, and warpgroup products (wgmma, sm_90a) with A from
// registers and B from shared memory; for the warp-specialized kernels
// (B1 at head dim 256, the int8 matmul at decode) TMA copies behind
// mbarriers, `setmaxnreg` and named barriers.
//
// A ring of S stages is filled with cp.async: each stage's copies form one
// commit group, `cp_async_wait<S - 2>()` plus a barrier makes the oldest
// stage visible while the newer ones are still in flight.
//
// Tiles of 16-bit elements are stored row-major with each row padded by 16
// bytes (row strides of 144 or 272 bytes). ldmatrix reads 8 rows of 16
// bytes at the same column; with the pad those rows start in 8 different
// 16-byte bank groups, so the reads are free of bank conflicts without an
// XOR swizzle.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-fills when !ok (no bytes
// are read then, but `src` must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (through L1: .cg takes 16-byte
// copies only); zero-fills when !ok, as cp_async16
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i holds this thread's (row lane / 4, column pair lane % 4)
// of matrix i: the A fragment of a 16x16 tile, or the B fragments of two
// n-tiles, of mma.sync m16n8k16
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// as ldsm_x4, transposed: register i holds rows 2 (lane % 4) and
// 2 (lane % 4) + 1 of column lane / 4 of matrix i (B fragments from a
// row-major [k][n] tile)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// --- wgmma (sm_90a) ----------------------------------------------------

// Shared-memory operand layout, K-major with the 128-byte swizzle: a tile
// of rows of 64 bf16 (128 bytes) in 1024-byte atoms of 8 rows, 16-byte
// chunk c of row r stored at chunk c ^ (r % 8) of the row. One warp's
// 16-byte copies of whole rows then hit 8 distinct bank groups, and wgmma
// reads the layout natively. Atoms must be 1024-byte aligned; a 16-deep k
// step advances the descriptor's start by 32 bytes.
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 1024;

__device__ __forceinline__ int sw128_offset(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// descriptor of a K-major, 128-byte-swizzled operand starting at p: stride
// between 8-row groups 1024 bytes, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// generic-proxy writes to shared memory (st.shared, cp.async) become
// visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
  #pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] (+)= A . B, m64n128k16: A (64 x 16 bf16) from registers, in
// mma.sync m16n8k16's A layout for each warp's 16 rows; B (16 x 128 bf16)
// K-major in shared memory (descriptor b); f32 accumulators; with
// accumulate == 0 the old d is ignored
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// --- TMA, mbarriers, warp specialization (sm_90) -------------------------

// shared-memory barriers (mbarrier): a ring's full barrier completes when a
// stage's bytes have landed (the producer's one arrive with the byte count,
// then the copies' own), its empty barrier when its consumers have read it
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// mbarrier initialization made visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// cuTensorMapEncodeTiled through the runtime (no link against libcuda),
// looked up once in each library that includes this header (static: the
// lookup's own static stays inside the library)
static inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// boxes of a tensor map (a CUtensorMap in parameter, constant or global
// memory) into dst, completing on bar: 1-d at (x), 2-d at (inner, outer),
// 4-d at (x0, x1, x2, x3), innermost first
__device__ __forceinline__ void tma_1d(void* dst, const void* map, int x,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_2d(void* dst, const void* map, int inner,
                                       int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer),
      "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_4d(void* dst, const void* map, int x0,
                                       int x1, int x2, int x3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x0), "r"(x1), "r"(x2),
      "r"(x3), "r"(smem_addr(bar))
      : "memory");
}

// a warpgroup's register budget, raised (consumers) or lowered (a
// producer) from the launch's even share; every thread of the warpgroup
// executes it
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// a barrier of `threads` threads on named barrier `id` (1-15; 0 is
// __syncthreads'): wait for the others, or only add this warp's arrival
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- thread-block clusters ---------------------------------------------

// The two halves of a cluster barrier, apart. A CTA may write into another
// CTA's shared memory only once that one has started: every thread arrives
// at its kernel's start and waits before its first remote store.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// opt a kernel into more than 48 KB of dynamic shared memory, once
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace tiles
