// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu)
// and of the int8 matmul's products (quant_matmul.cu).
//
// The dense forward's products at D 64/128 run on mma.sync m16n8k16 (bf16
// in, f32 accumulate); the backward's, the segment forward's and the
// forward's at D 256 and above run on wgmma, whose accumulators come back
// in the same C layout. Fragment layouts,
// with gid = lane / 4 and tig = lane % 4:
// - A (16 x 16, row-major): a0 (row gid, cols 2tig, 2tig+1), a1 (row
//   gid+8, same cols), a2 (row gid, cols 2tig+8, +9), a3 (row gid+8, same);
// - B (16 x 8, "col"): b0 (rows 2tig, 2tig+1 of column gid), b1 (rows
//   2tig+8, +9);
// - C (16 x 8): c0, c1 (row gid, cols 2tig, 2tig+1), c2, c3 (row gid+8).
// So the C fragments of n-tiles 2kc and 2kc+1 are the A fragment of
// k-chunk kc: a product's f32 result feeds the next product from
// registers, rounded to bf16 (pack_f32).
//
// B1-B3 at D 64/128 also take fp16 (the `.f16` forms of the wgmma
// helpers below, T = __half) and float32 as three bf16 pieces each
// (`split_bf16x3`): a product of two split operands keeps the six terms
// whose pieces' indices sum to at most 2 (`term_a`, `term_b`).
//
// The segment branch's pair classification lives in flash_seg.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "async_tiles.cuh"

namespace flash {

constexpr int kRows = 64;      // folded (position, head) rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr float kBig = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// raise a kernel's dynamic shared memory opt-in to `bytes` when a launch
// needs more than allowed before (`allowed` keeps the kernel's level): the
// segment branch's tile lists grow with the sequence
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes,
                                      int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

// element strides of a [B, S, H, D] operand whose D axis is contiguous
struct Strides {
  long long b, s, h;
  __device__ __forceinline__ long long at(int bi, int si, int hi) const {
    return bi * b + si * s + hi * h;
  }
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// true for fp16, whose wgmma forms are `.f16` (bf16 otherwise)
template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// two floats -> a pair of T (bf16 or fp16), `lo` in the low half
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_f32(lo, hi);
  }
}

// A fragment of k-chunk kc from the C fragments of n-tiles 2kc, 2kc+1
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// x as three bf16 pieces, each what the pieces before it leave of x,
// rounded to nearest: b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 -
// b1). Each difference is exact in float32 and the last one has at most
// 8 significant bits, so b0 + b1 + b2 == x for every x whose last bit
// lies above bf16's least subnormal (flash_attention.py's
// `split_bf16x3_plain` is the same rule)
__device__ __forceinline__ void split_bf16x3(float x,
                                             __nv_bfloat16 (&b)[3]) {
  b[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(b[0]);
  b[1] = __float2bfloat16_rn(r);
  b[2] = __float2bfloat16_rn(r - __bfloat162float(b[1]));
}

// The terms of a product of two operands of P pieces, t = first_term(P)
// .. 5: piece term_a(t) of A times piece term_b(t) of B. At P 3 the six
// pairs whose indices sum to at most 2, the small ones first and b0 b0
// last (the dropped terms are ~2^-24 of the product); at P 1 b0 b0 alone.
__host__ __device__ constexpr int first_term(int P) { return P == 1 ? 5 : 0; }
__host__ __device__ constexpr int term_a(int t) {
  return t < 3 ? t : (t == 4 ? 1 : 0);
}
__host__ __device__ constexpr int term_b(int t) {
  return t < 3 ? 2 - t : (t == 3 ? 1 : 0);
}

// the A fragments of k-chunk kc of each of the P pieces (a[p][kc]) from
// the f32 C fragments of n-tiles 2kc, 2kc+1: rounded to T at P 1 (as
// acc_to_a), split into three bf16 pieces at P 3
template <typename T, int P, int N>
__device__ __forceinline__ void acc_to_pieces(uint32_t (&a)[P][N][4],
                                              int kc, const float lo[4],
                                              const float hi[4]) {
  if constexpr (P == 1) {
    acc_to_a<T>(a[0][kc], lo, hi);
  } else {
    const float x[8] = {lo[0], lo[1], lo[2], lo[3],
                        hi[0], hi[1], hi[2], hi[3]};
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_bfloat16 e[3], o[3];
      split_bf16x3(x[2 * j], e);
      split_bf16x3(x[2 * j + 1], o);
      #pragma unroll
      for (int p = 0; p < P; ++p) {
        __nv_bfloat162 v = __halves2bfloat162(e[p], o[p]);
        a[p][kc][j] = *reinterpret_cast<uint32_t*>(&v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma (sm_90a)
// ---------------------------------------------------------------------------

// Tiles that wgmma reads are stored with the 128-byte swizzle of
// async_tiles.cuh: a tile of `rows` rows of D bf16 is D / 64 blocks of
// [rows][64] (128-byte rows in 1024-byte atoms of 8), block after block;
// wgmma reads it K-major (kstep_desc) or MN-major (desc_mn_sw128). The
// byte offset of 16-byte chunk c8 (elements 8 c8 .. 8 c8 + 7) of a row:
template <int kTileRows>
__device__ __forceinline__ int swz(int row, int c8) {
  return (c8 >> 3) * kTileRows * 128 + tiles::sw128_offset(row, c8 & 7);
}

// the descriptor of k step kc (16 of the D columns) of a swizzled tile of
// kTileRows rows, starting at row r0 (a multiple of 8)
template <int kTileRows>
__device__ __forceinline__ uint64_t kstep_desc(const unsigned char* tile,
                                               int r0, int kc) {
  return tiles::wgmma_desc_sw128(tile + (kc >> 2) * kTileRows * 128 +
                                 r0 * 128 + (kc & 3) * 32);
}

// The wgmma helpers that B2 and B3 at D 64/128 call take the element type
// T (bf16 or fp16): the two forms differ only in the type names, so each
// is one macro expanded with "bf16" or "f16".

// d[16] (+)= A . B, m64n32k16: A (64 x 16 bf16) from registers in
// mma.sync's A layout for each warp's 16 rows; B (32 x 16) K-major in
// shared memory, 128-byte swizzle (descriptor b); accumulate == 0
// ignores the old d
#define FLASH_RS_N32(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), \
        "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_RS_N32("f16");
  else
    FLASH_RS_N32("bf16");
}
#undef FLASH_RS_N32

// d[32] (+)= A . B, m64n64k16: as wgmma_rs_n32 over 64 columns of B
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[8] (+)= A . B, m64n16k16: A (64 x 16 bf16) and B (16 x 16) K-major in
// shared memory, 128-byte swizzle (descriptors a, b): float32's S over a
// 16-key stage at D 256 (three pieces a product)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[16] (+)= A . B, m64n32k16: A (64 x 16) and B (32 x 16) K-major in
// shared memory, 128-byte swizzle (descriptors a, b)
#define FLASH_SS_N32(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15}, " \
      "%16, %17, p, 1, 1, 0, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_SS_N32("f16");
  else
    FLASH_SS_N32("bf16");
}
#undef FLASH_SS_N32

// d[32] (+)= A . B, m64n64k16: A (64 x 16) and B (64 x 16) K-major in
// shared memory, as wgmma_ss_n32
#define FLASH_SS_N64(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_SS_N64("f16");
  else
    FLASH_SS_N64("bf16");
}
#undef FLASH_SS_N64

// d[64] (+)= A . B, m64n128k16: A (64 x 16) K-major in shared memory
// (descriptor a); B (16 x 128) MN-major, its N columns contiguous
// (desc_mn_sw128, descriptor b)
__device__ __forceinline__ void wgmma_ss_t_n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[96] (+)= A . B, m64n192k16, as wgmma_ss_t_n128
__device__ __forceinline__ void wgmma_ss_t_n192(float (&d)[96], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[128] (+)= A . B, m64n256k16, as wgmma_ss_t_n128
__device__ __forceinline__ void wgmma_ss_t_n256(float (&d)[128], uint64_t a,
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B over N = W columns, both from shared memory, B MN-major:
// B3's dK and dV above head dim 256 (one slice of W columns)
template <int W>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[W / 2], uint64_t a,
                                           uint64_t b, int accumulate) {
  if constexpr (W == 192) wgmma_ss_t_n192(d, a, b, accumulate);
  else wgmma_ss_t_n256(d, a, b, accumulate);
}

// d[64] (+)= A . B, m64n128k16: A from registers as in wgmma_rs_n32; B
// (128 x 16) K-major in shared memory (B7's prefill: the token chunk)
#define FLASH_RS_N128(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), \
        "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_RS_N128("f16");
  else
    FLASH_RS_N128("bf16");
}
#undef FLASH_RS_N128

// d[32] (+)= A . B, m64n64k16: A from registers as in wgmma_rs_n32; B
// (16 x 64) MN-major, its N columns contiguous (desc_mn_sw128)
#define FLASH_RS_T_N64(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), \
        "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_t_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_RS_T_N64("f16");
  else
    FLASH_RS_T_N64("bf16");
}
#undef FLASH_RS_T_N64

// d[64] (+)= A . B, m64n128k16, as wgmma_rs_t_n64
#define FLASH_RS_T_N128(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), \
        "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_t_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_RS_T_N128("f16");
  else
    FLASH_RS_T_N128("bf16");
}
#undef FLASH_RS_T_N128

// d[128] (+)= A . B, m64n256k16, as wgmma_rs_t_n64 (B1 at D 256: O += P V)
#define FLASH_RS_T_N256(TY) \
  asm volatile( \
      "{\n" \
      ".reg .pred p;\n" \
      "setp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{" \
      "%0, %1, %2, %3, %4, %5, %6, %7, " \
      "%8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, " \
      "%24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, " \
      "%40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, " \
      "%56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, " \
      "%72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, " \
      "%88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, " \
      "%104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n" \
      "}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), \
        "r"(accumulate))

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_t_n256(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  if constexpr (kIsHalf<T>)
    FLASH_RS_T_N256("f16");
  else
    FLASH_RS_T_N256("bf16");
}
#undef FLASH_RS_T_N256

// descriptor of an MN-major operand (N contiguous) stored as the swizzled
// tiles above: 8-row groups along K 1024 bytes apart (SBO), 64-column
// blocks along N `block_bytes` apart (LBO); 128-byte swizzle
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p,
                                                  int block_bytes) {
  return static_cast<uint64_t>((tiles::smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(block_bytes >> 4) << 16) |
         (static_cast<uint64_t>(tiles::kAtomBytes >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= A . B over N = D columns with B MN-major: the products that take
// a tile transposed (dQ += dS K, dV += P^T dO, dK += dS^T Q)
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int accumulate) {
  if constexpr (D == 64) wgmma_rs_t_n64<T>(d, a, b, accumulate);
  else if constexpr (D == 128) wgmma_rs_t_n128<T>(d, a, b, accumulate);
  else wgmma_rs_t_n256<T>(d, a, b, accumulate);
}

// keeps A fragments that an in-flight wgmma reads live until the wait
// that retires it (else the register allocator may hand their registers
// to other values while the product still reads them)
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
  #pragma unroll
  for (int i = 0; i < N; ++i)
    #pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// fence_frags for every piece's fragments
template <int P, int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[P][N][4]) {
  #pragma unroll
  for (int p = 0; p < P; ++p) fence_frags(a[p]);
}

// wgmma's m64nN accumulator, d[4 j + 2 h + e] = (row 16 w + gid + 8 h,
// column 8 j + 2 tig + e) for warp w, is mma.sync's C fragment of n-tile
// j: the [N / 8][4] arrays below are viewed flat
template <int kNT>
__device__ __forceinline__ float (&flat(float (&x)[kNT][4]))[kNT * 4] {
  return *reinterpret_cast<float(*)[kNT * 4]>(&x[0][0]);
}

}  // namespace flash
