// Shared pieces of the paged-decode kernels for Hopper (sm_90a): the
// per-page route's cluster kernel (paged_decode.cu: B4 on bf16 pools, B5
// on int8 pools) and the split route's for long tables
// (paged_decode_split.cu: B6, B6q).
//
// Both take one query token per slot against that slot's pages of a
// shared pool: q [B, Hq, D] bf16; k_pool/v_pool [NB, bs, Hk, D] bf16, or
// int8 with k_scale/v_scale [NB, bs, Hk] f32 (one scale per row and kv
// head); block_tables [B, MBPS] int32; seq_lens [B] int32; out [B, Hq, D]
// bf16. Positions >= seq_len are masked; seq_len == 0 gives zeros. An int8
// row is dequantized as bf16(f32(q8) * scale) before the dot products, as
// the JAX package's `_deq` casts to the query's dtype.

#pragma once

#include "async_tiles.cuh"
#include "flash_common.cuh"

namespace paged {

using flash::pack_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes global -> shared, asynchronously; zero-fills when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tiles::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 8 int8 values and their row's scale -> 8 bf16 of q * scale, each product
// rounded once from f32 then to bf16. int8 -> f32 is exact and avoids the
// quarter-rate conversion unit (as in quant_matmul.cu): (q + 128) as the
// low byte of 2^23's f32 pattern is 2^23 + q + 128, and subtracting
// 2^23 + 128 leaves q.
__device__ __forceinline__ uint4 dequant8(uint2 u, float scale) {
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
  uint4 r;
  uint32_t* o = reinterpret_cast<uint32_t*>(&r);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = w[i >> 1];
    const int byte = (i & 1) * 2;
    const float lo = __uint_as_float(__byte_perm(x, 0x4B000000u,
                                                 0x7650 + byte));
    const float hi = __uint_as_float(__byte_perm(x, 0x4B000000u,
                                                 0x7651 + byte));
    o[i] = pack_f32((lo - kMagic) * scale, (hi - kMagic) * scale);
  }
  return r;
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

}  // namespace paged
