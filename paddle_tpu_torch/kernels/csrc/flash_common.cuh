// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// Both products of every kernel run on mma.sync m16n8k16 (bf16 in, f32
// accumulate). Fragment layouts, with gid = lane / 4 and tig = lane % 4:
// - A (16 x 16, row-major): a0 (row gid, cols 2tig, 2tig+1), a1 (row
//   gid+8, same cols), a2 (row gid, cols 2tig+8, +9), a3 (row gid+8, same);
// - B (16 x 8, "col"): b0 (rows 2tig, 2tig+1 of column gid), b1 (rows
//   2tig+8, +9);
// - C (16 x 8): c0, c1 (row gid, cols 2tig, 2tig+1), c2, c3 (row gid+8).
// So the C fragments of n-tiles 2kc and 2kc+1 are the A fragment of
// k-chunk kc: a product's f32 result feeds the next product from
// registers, rounded to bf16 (pack_f32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kRows = 64;      // folded (position, head) rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNeg = -1e30f;
constexpr float kBig = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// A fragment of k-chunk kc from the C fragments of n-tiles 2kc, 2kc+1
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

// A fragment of k-chunk kc from a row-major [16 rows x ...] bf16 tile
// (`rows` points at the tile's first row, `stride` elements apart)
__device__ __forceinline__ void smem_a(uint32_t a[4],
                                       const __nv_bfloat16* rows, int stride,
                                       int kc, int gid, int tig) {
  #pragma unroll
  for (int reg = 0; reg < 4; ++reg) {
    const int r = gid + 8 * (reg & 1);
    const int col = kc * 16 + tig * 2 + ((reg >> 1) << 3);
    a[reg] = *reinterpret_cast<const uint32_t*>(rows + r * stride + col);
  }
}

// c[nt] += A . X^T over n-tiles of 8 rows of X (row-major [rows][D] in
// shared memory): B[k][n] = X[n][k], so each B register is one u32 read
__device__ __forceinline__ void mma_abt(float c[4], const uint32_t a[4],
                                        const __nv_bfloat16* x, int stride,
                                        int nt, int kc, int gid, int tig) {
  const __nv_bfloat16* p = x + (nt * 8 + gid) * stride + kc * 16 + tig * 2;
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(p),
           *reinterpret_cast<const uint32_t*>(p + 8));
}

// c += A . X over the d-tile dt of X (row-major [k rows][D] in shared
// memory, k-chunk kc): B[k][n] = X[k][n], gathered from two rows per
// register
__device__ __forceinline__ void mma_ab(float c[4], const uint32_t a[4],
                                       const __nv_bfloat16* x, int stride,
                                       int dt, int kc, int gid, int tig) {
  const __nv_bfloat16* p = x + (kc * 16 + tig * 2) * stride + dt * 8 + gid;
  mma_bf16(c, a, pack_raw(p[0], p[stride]),
           pack_raw(p[8 * stride], p[9 * stride]));
}

}  // namespace flash
