// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu).
//
// The forward's products run on mma.sync m16n8k16 (bf16 in, f32
// accumulate); the backward's run on wgmma, whose accumulators come back
// in the same C layout. Fragment layouts, with gid = lane / 4 and
// tig = lane % 4:
// - A (16 x 16, row-major): a0 (row gid, cols 2tig, 2tig+1), a1 (row
//   gid+8, same cols), a2 (row gid, cols 2tig+8, +9), a3 (row gid+8, same);
// - B (16 x 8, "col"): b0 (rows 2tig, 2tig+1 of column gid), b1 (rows
//   2tig+8, +9);
// - C (16 x 8): c0, c1 (row gid, cols 2tig, 2tig+1), c2, c3 (row gid+8).
// So the C fragments of n-tiles 2kc and 2kc+1 are the A fragment of
// k-chunk kc: a product's f32 result feeds the next product from
// registers, rounded to bf16 (pack_f32).

//
// The segment branch (the Pallas bodies' `has_seg`, varlen attention):
// query i sees key j when their segment ids are equal and, if causal, when
// q_pos[i] >= kv_pos[j]; the global causal diagonal plays no part. Each
// kernel is a template on kSeg; kSeg = false compiles the dense kernel as
// it was. Ids and positions are int32 [B, S], contiguous. A (query block,
// key tile) pair whose [min, max] id ranges do not overlap holds no equal
// ids, whatever the ids are, so the forward's segment branch skips it: the
// wrapper hands the ranges of every 64-key tile, and `live_tiles` compacts
// the tiles a CTA must visit into shared memory. (The backward classifies
// pairs by id and position bounds: flash_bwd.cu.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace flash {

constexpr int kRows = 64;      // folded (position, head) rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr float kNeg = -1e30f;
constexpr float kBig = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the segment branch's inputs; all NULL on the dense branch
struct Seg {
  const int* qseg;     // [B, Sq]
  const int* kseg;     // [B, Sk]
  const int* qpos;     // [B, Sq]
  const int* kpos;     // [B, Sk]
  const int2* qrange;  // unused: NULL (the forward reads kv ranges only)
  const int2* krange;  // [B, ceil(Sk / 64)] (min, max) of kv ids
};

// shared ints `live_tiles` and `id_range` use as scratch
constexpr int kScratchInts = 2 * (kThreads / 32);

// [min, max] of ids[0, n) (1 <= n <= kThreads) to every thread of the CTA
__device__ __forceinline__ int2 id_range(const int* __restrict__ ids, int n,
                                         int* scratch) {
  const int warp = threadIdx.x >> 5;
  int lo = INT_MAX, hi = INT_MIN;
  if (threadIdx.x < n) lo = hi = ids[threadIdx.x];
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if ((threadIdx.x & 31) == 0) {
    scratch[warp] = lo;
    scratch[kThreads / 32 + warp] = hi;
  }
  __syncthreads();
  int2 r = make_int2(INT_MAX, INT_MIN);
  #pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    r.x = min(r.x, scratch[w]);
    r.y = max(r.y, scratch[kThreads / 32 + w]);
  }
  __syncthreads();  // scratch is free again
  return r;
}

// The tiles t in [0, n) whose id range overlaps [lo, hi], in order, into
// `list`; returns their count to every thread. Called by all kThreads
// threads; the list is complete and visible when it returns.
__device__ __forceinline__ int live_tiles(const int2* __restrict__ ranges,
                                          int n, int lo, int hi, int* list,
                                          int* scratch) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int t = base + threadIdx.x;
    bool live = false;
    if (t < n) {
      const int2 r = ranges[t];
      live = r.x <= hi && lo <= r.y;
    }
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) scratch[warp] = __popc(m);
    __syncthreads();
    int at = count, total = 0;
    #pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? scratch[w] : 0;
      total += scratch[w];
    }
    if (live) list[at + __popc(m & ((1u << lane) - 1u))] = t;
    __syncthreads();  // the list's writes land; scratch is reused
    count += total;
  }
  return count;
}

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

// A fragment of k-chunk kc from the C fragments of n-tiles 2kc, 2kc+1
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

}  // namespace flash
