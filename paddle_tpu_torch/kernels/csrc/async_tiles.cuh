// Shared-memory staging for the redesigned kernels (flash_fwd.cu and the
// prefill path of quant_matmul.cu): asynchronous 16-byte copies from global
// to shared memory (cp.async, Ampere and later), ldmatrix loads of
// mma.sync fragments, and the shared-memory descriptors, fences and waits
// of warpgroup products (wgmma, sm_90a; the products themselves are in
// flash_common.cuh); for the warp-specialized kernels
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

// 16 bytes global -> shared, of which the first n (0 to 16) are read and
// the rest zero-filled (cp.async's source size; no bytes read at n 0, but
// `src` must still be a valid address)
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src,
                                             int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// the 16 bytes of shared memory from any byte address p (as five 4-byte
// reads from p rounded down to 4, funnel-shifted)
__device__ __forceinline__ uint4 lds128_at(const unsigned char* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const uint32_t sh = 8 * static_cast<uint32_t>(a & 3);
  const uint32_t w0 = q[0], w1 = q[1], w2 = q[2], w3 = q[3], w4 = q[4];
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

// the 4 bytes of shared memory from any byte address p
__device__ __forceinline__ uint32_t lds32_at(const unsigned char* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  return __funnelshift_r(q[0], q[1], 8 * static_cast<uint32_t>(a & 3));
}

// A row of int8 weights K bytes long has no 16-byte stride where K % 16 !=
// 0: byte k of row r sits at w + r K + k. The ragged loaders copy, for
// each row, the 16-byte-aligned span that holds the stage's kBytes of it
// (kBytes / 16 + 1 chunks, from the row's first byte rounded down to 16),
// by 16-byte cp.async as for aligned rows, and the products read the row
// from its offset in the span, `span_offset`: the same for every stage, as
// a stage starts at a multiple of 16. Chunks past the end of w are
// zero-filled (a chunk is read only up to it); bytes past K in a row are
// the next row's, which meet the zeros x holds there.
__device__ __forceinline__ int span_offset(const void* w, long long at) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(w) + at) & 15);
}

// kRows rows' spans of kBytes bytes from byte k0 (a multiple of 16) of row
// r0 of w [rows, K], copied by threads t = 0 .. kN - 1 into rows kStride
// bytes apart at dst; rows from `rows` on zero-filled
template <int kRows, int kBytes, int kStride, int kN>
__device__ __forceinline__ void copy_spans(unsigned char* dst,
                                           const int8_t* w, long long r0,
                                           int rows, int K, int k0,
                                           const int8_t* end, int t) {
  constexpr int kChunks = kBytes / 16 + 1;
  static_assert(kChunks * 16 <= kStride, "a span fits a staged row");
  constexpr int kAll = kRows * kChunks;
  #pragma unroll 6
  for (int j = 0; j < (kAll + kN - 1) / kN; ++j) {
    const int i = t + j * kN;
    if (kAll % kN != 0 && i >= kAll) break;
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const uintptr_t a =
        (reinterpret_cast<uintptr_t>(w + (r0 + r) * K + k0) & ~uintptr_t{15}) +
        16 * c;
    const long long left = reinterpret_cast<uintptr_t>(end) - a;
    const int n = r >= rows || left <= 0 ? 0 : left < 16 ? int(left) : 16;
    cp_async16_n(dst + r * kStride + 16 * c,
                 n ? reinterpret_cast<const void*>(a) : w, n);
  }
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

// 8 bytes global -> shared, as cp_async4
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// G bytes (16, 8, 4 or 2; dst and src aligned to it) global -> shared,
// zero-filled when !ok: 4 bytes and up asynchronously (cp.async), 2
// through a register (the store waits for its load)
template <int G>
__device__ __forceinline__ void copy_granule(void* dst, const void* src,
                                             bool ok) {
  static_assert(G == 16 || G == 8 || G == 4 || G == 2, "a copy granule");
  if constexpr (G == 16) {
    cp_async16(dst, src, ok);
  } else if constexpr (G == 8) {
    cp_async8(dst, src, ok);
  } else if constexpr (G == 4) {
    cp_async4(dst, src, ok);
  } else {
    *static_cast<uint16_t*>(dst) =
        ok ? *static_cast<const uint16_t*>(src) : uint16_t{0};
  }
}

// kRows rows of kRowBytes bytes (row r at src + r ld) global -> shared in
// granules of G bytes, copied by threads t = 0 .. kN - 1, granule (r, off)
// to dst + at(r, off); zeros from row `rows` and from byte `bytes` of a
// row on (G divides ld and bytes, so no granule straddles either). Trip
// counts and shifts are compile-time: the ragged loaders' copies must cost
// a few instructions each, as one warp issues a stage's thousands of them.
template <int G, int kRows, int kRowBytes, int kN, typename At>
__device__ __forceinline__ void copy_rows(unsigned char* dst,
                                          const unsigned char* src,
                                          long long ld, int rows, int bytes,
                                          int t, At at) {
  constexpr int kPer = kRowBytes / G;  // granules a row
  constexpr int kAll = kRows * kPer;
  #pragma unroll 8
  for (int j = 0; j < (kAll + kN - 1) / kN; ++j) {
    const int i = t + j * kN;
    if (kAll % kN != 0 && i >= kAll) break;
    const int r = i / kPer;
    const int off = (i % kPer) * G;
    const bool ok = r < rows && off < bytes;
    copy_granule<G>(dst + at(r, off), ok ? src + r * ld + off : src, ok);
  }
}

// copy_rows at the granule g (copy_granule_of of rows of 2-byte or wider
// elements: 2 at least) known only at run time
template <int kRows, int kRowBytes, int kN, typename At>
__device__ __forceinline__ void copy_rows_by(int g, unsigned char* dst,
                                             const unsigned char* src,
                                             long long ld, int rows,
                                             int bytes, int t, At at) {
  switch (g) {
    case 16:
      copy_rows<16, kRows, kRowBytes, kN>(dst, src, ld, rows, bytes, t, at);
      break;
    case 8:
      copy_rows<8, kRows, kRowBytes, kN>(dst, src, ld, rows, bytes, t, at);
      break;
    case 4:
      copy_rows<4, kRows, kRowBytes, kN>(dst, src, ld, rows, bytes, t, at);
      break;
    default:
      copy_rows<2, kRows, kRowBytes, kN>(dst, src, ld, rows, bytes, t, at);
  }
}

// the widest granule (16 down to 2 bytes) that a row of `row_bytes` from
// base `p` keeps aligned at every row (rows of 2-byte or wider elements)
inline int copy_granule_of(const void* p, long long row_bytes) {
  int g = 16;
  while (g > 2 && ((reinterpret_cast<uintptr_t>(p) |
                    static_cast<uintptr_t>(row_bytes)) &
                   (g - 1)))
    g >>= 1;
  return g;
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
// one arrival on `bar` once every cp.async this thread issued before has
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
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
