// The segment branch of the flash kernels (the Pallas bodies' `has_seg`,
// varlen attention), shared by the forward (flash_fwd.cu) and the
// backward (flash_bwd.cu).
//
// Query i sees key j when their segment ids are equal and, if causal, when
// q_pos[i] >= kv_pos[j]; the global causal diagonal plays no part. Ids and
// positions are int32 [B, S], contiguous. Every kernel classifies each
// (query block, key tile) pair from [id min, id max, position min,
// position max] bounds (`pair_class`): skip when the id ranges do not
// overlap or, causal, when every query position lies before every key
// position; full (no mask) when block and tile hold one id between them
// and, causal, the block's first position is not before the tile's last;
// masked otherwise. A first small launch writes the bounds of every
// 64-token tile into a workspace (`tile_bounds_kernel`, one warp a tile);
// a CTA reduces its own block's (`block_bounds`) and compacts the pairs it
// must walk into a list in shared memory (`live_pairs`), each entry
// flagged full or masked. The plain rule is flash_attention.py's
// `tile_bounds` and `pair_classes`.

#pragma once

#include "flash_common.cuh"

namespace flash {

// shared ints of `block_bounds` and `live_pairs` in a CTA of kT threads
template <int kT>
constexpr int seg_scratch() {
  return 4 * (kT / 32);
}
constexpr int kSegScratch = seg_scratch<kThreads>();
// a list entry's flags: the pair needs no mask; the pair (masked) holds
// one id on both sides, so only positions need comparing (`live_pairs`
// sets it only when asked)
constexpr int kFull = 1 << 30;
constexpr int kOneId = 1 << 29;

// pair classes (flash_attention.py: pair_classes holds the same rule)
constexpr int kSkip = 0;
constexpr int kMasked = 1;
constexpr int kFullPair = 2;

// the segment branch's inputs; all NULL on the dense branch. Bounds are
// four rows (id min, id max, position min, position max) over the 64-token
// tiles of a batch row, [B, 4, tiles].
struct Seg {
  const int* qseg;   // [B, Sq]
  const int* kseg;   // [B, Sk]
  const int* qpos;   // [B, Sq]
  const int* kpos;   // [B, Sk]
  const int* qb;     // [B, 4, ceil(Sq / 64)] (dK/dV only; NULL else)
  const int* kb;     // [B, 4, ceil(Sk / 64)]
};

// tile t's bounds from one batch row's [4, n] rows
__device__ __forceinline__ int4 bounds_at(const int* __restrict__ rows,
                                          int n, int t) {
  return make_int4(rows[t], rows[n + t], rows[2 * n + t], rows[3 * n + t]);
}

// The class of a (query block, key tile) pair from their bounds: skip when
// no entry can be visible whatever the ids and positions inside are, full
// when every entry is, masked otherwise.
__device__ __forceinline__ int pair_class(int4 q, int4 k, int causal) {
  if (q.x > k.y || k.x > q.y) return kSkip;  // no id in common
  if (causal && q.w < k.z) return kSkip;     // every query before every key
  const bool one_id = q.x == q.y && k.x == k.y && q.x == k.x;
  return one_id && (!causal || q.z >= k.w) ? kFullPair : kMasked;
}

// (id min, id max, position min, position max) of ids/pos[0, n),
// 1 <= n <= kT, to every thread of the CTA (of kT threads)
template <int kT = kThreads>
__device__ __forceinline__ int4 block_bounds(const int* __restrict__ ids,
                                             const int* __restrict__ pos,
                                             int n, int* scratch) {
  constexpr int kWarps = kT / 32;
  const int warp = threadIdx.x >> 5;
  int a = INT_MAX, b = INT_MIN, c = INT_MAX, d = INT_MIN;
  if (threadIdx.x < n) {
    a = b = ids[threadIdx.x];
    c = d = pos[threadIdx.x];
  }
  a = __reduce_min_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  c = __reduce_min_sync(0xffffffffu, c);
  d = __reduce_max_sync(0xffffffffu, d);
  if ((threadIdx.x & 31) == 0) {
    scratch[warp] = a;
    scratch[kWarps + warp] = b;
    scratch[2 * kWarps + warp] = c;
    scratch[3 * kWarps + warp] = d;
  }
  __syncthreads();
  int4 r = make_int4(INT_MAX, INT_MIN, INT_MAX, INT_MIN);
  #pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    r.x = min(r.x, scratch[w]);
    r.y = max(r.y, scratch[kWarps + w]);
    r.z = min(r.z, scratch[2 * kWarps + w]);
    r.w = max(r.w, scratch[3 * kWarps + w]);
  }
  __syncthreads();  // scratch is free again
  return r;
}

// The tiles t in [0, n) of `bounds` (one batch row's [4, n]) that pair
// with `mine` (the query side when kMineIsQ), in order, into `list` as
// t | kFull (no mask needed) or t, with kMarkOneId also | kOneId on a
// masked pair whose block and tile hold one id between them; returns
// their count to every thread. Called by all kT threads of the CTA; the
// list is complete and visible when it returns.
template <bool kMineIsQ, bool kMarkOneId = false, int kT = kThreads>
__device__ __forceinline__ int live_pairs(const int* __restrict__ bounds,
                                          int n, int4 mine, int causal,
                                          int* list, int* scratch) {
  constexpr int kWarps = kT / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int base = 0; base < n; base += kT) {
    const int t = base + threadIdx.x;
    int cls = kSkip;
    int flags = 0;
    if (t < n) {
      const int4 other = bounds_at(bounds, n, t);
      cls = kMineIsQ ? pair_class(mine, other, causal)
                     : pair_class(other, mine, causal);
      if (kMarkOneId && mine.x == mine.y && other.x == other.y &&
          mine.x == other.x)
        flags = kOneId;
    }
    const bool live = cls != kSkip;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (lane == 0) scratch[warp] = __popc(m);
    __syncthreads();
    int at = count, total = 0;
    #pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? scratch[w] : 0;
      total += scratch[w];
    }
    if (live)
      list[at + __popc(m & ((1u << lane) - 1u))] =
          t | (cls == kFullPair ? kFull : flags);
    __syncthreads();  // the list's writes land; scratch is reused
    count += total;
  }
  return count;
}

// One side's tokens for `tile_bounds_kernel`: ids and positions [B, S],
// and the bounds it writes, [B, 4, ceil(S / 64)]
struct Side {
  const int* ids;
  const int* pos;
  int* out;
  int S;
};

// [id min, id max, position min, position max] of every 64-token tile of
// one or two sides (b.out NULL: one), as four rows per batch row; one warp
// a tile, the ragged last tile padded with its own last token. The plain
// version is flash_attention.py's tile_bounds.
__global__ void __launch_bounds__(kThreads)
tile_bounds_kernel(Side a, Side b, int B) {
  const int na = (a.S + kBK - 1) / kBK;
  const int nb = b.out ? (b.S + kBK - 1) / kBK : 0;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * (na + nb)) return;  // the whole warp
  const bool first = w < B * na;
  const Side s = first ? a : b;
  const int n = first ? na : nb;
  const int i = first ? w : w - B * na;
  const int bi = i / n;
  const int t = i % n;
  const int* ids = s.ids + static_cast<size_t>(bi) * s.S;
  const int* pos = s.pos + static_cast<size_t>(bi) * s.S;
  int lo = INT_MAX, hi = INT_MIN, plo = INT_MAX, phi = INT_MIN;
  #pragma unroll
  for (int j = lane; j < kBK; j += 32) {
    const int x = min(t * kBK + j, s.S - 1);
    lo = min(lo, ids[x]);
    hi = max(hi, ids[x]);
    plo = min(plo, pos[x]);
    phi = max(phi, pos[x]);
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  plo = __reduce_min_sync(0xffffffffu, plo);
  phi = __reduce_max_sync(0xffffffffu, phi);
  if (lane == 0) {
    int* o = s.out + static_cast<size_t>(bi) * 4 * n + t;
    o[0] = lo;
    o[n] = hi;
    o[2 * n] = plo;
    o[3 * n] = phi;
  }
}

// launch `tile_bounds_kernel` on the stream of the launch that reads them
inline cudaError_t launch_bounds(Side a, Side b, int B, cudaStream_t st) {
  const long long tiles =
      static_cast<long long>(B) *
      ((a.S + kBK - 1) / kBK + (b.out ? (b.S + kBK - 1) / kBK : 0));
  const long long blocks = (tiles + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  tile_bounds_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      a, b, B);
  return cudaGetLastError();
}

}  // namespace flash
