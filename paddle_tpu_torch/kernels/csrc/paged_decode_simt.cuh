// Paged-decode attention on the CUDA cores, for every query dtype, head
// dim and GQA group (sm_90a). Compiled once per query dtype, in three
// sources built in parallel (paged_decode_simt_{f32,f16,bf16}.cu: 34
// instantiations each, float and int8 pools), each with its own C entry.
//
// Replaces the Pallas TPU kernels `_decode_kernel` (float pools),
// `_decode_kernel_q` (int8 pools) and their chunked branch
// `_decode_kernel_chunked` (paddle_tpu/kernels/pallas/paged_attention.py:
// 133, :156, :186) for the operands the tensor-core kernels
// (paged_decode.cu, paged_decode_split.cu: bf16 queries, head dims 64 and
// 128, groups 1, 2, 4 and 8) do not take: float32 and fp16 models, head
// dims such as 80 or 256, groups such as 16. The JAX package's wrappers
// take all of these.
//
// One query token per slot attends that slot's pages of a shared pool:
// q [B, Hq, D] (float32, fp16 or bf16); k_pool/v_pool [NB, bs, Hk, D] of
// q's dtype, or int8 with k_scale/v_scale [NB, bs, Hk] f32; block_tables
// [B, MBPS] int32; seq_lens [B] int32; out [B, Hq, D] in q's dtype.
// Positions >= seq_len are masked; seq_len == 0 gives zeros. An int8 row
// is dequantized as T(f32(q8) * scale), as the JAX package's `_deq` casts
// to the query's dtype. Logits and sums in float32; P is rounded to T
// before P V, and l sums the float32 P.
//
// What bounds it: bytes. A key row of a kv head costs 4 G D flops (Q K and
// P V) against 2 D s bytes (s the element size): G/2 flop/byte for float32
// pools, G for fp16/bf16, about 2 G for int8, against the CUDA cores' 20
// (67 TFLOP/s over 3.35 TB/s). The first design (a CTA a slot and query
// head, element loads) read each row G times, walked a long table in one
// CTA and kept few loads in flight: 0.08 ms at a 0.0026 ms bound.
//
// Design (`simt_decode_plan` in kernels/paged_attention.py picks every
// size below from shapes alone, before the launch):
// - Grid (B, Hk Gs, C) in clusters of C CTAs (C <= 16; above 8 the
//   non-portable size), one cluster per (slot, kv head, group split). A
//   CTA holds `heads` = ceil(G / Gs) query heads of the kv head (Gs > 1
//   only past 8 heads, or where heads x ceil(D / 32) would pass 64
//   accumulators a lane), so each K/V row is read once per kv head. Rank
//   r takes the contiguous share [r s, r s + s) of the slot's live pages,
//   s = ceil(live / C).
// - Each CTA runs 4 warps. It reads seq_len and the query rows (8 loads
//   in flight a thread), then its share of the table row, once. `warps`
//   of them stream the share in blocks of `rows` key rows (block j to
//   warp j % warps), each through its own ring of 1-3 stages filled with
//   cp.async copies of the K and V rows of the kv head (and an int8 row's
//   two 4-byte scales, strided by Hk), waiting only on its own copies; a
//   share of at most warps x stages blocks is in flight at once. Rows past
//   seq_len are zero-filled and never read from the pool. The copy width
//   is 16 bytes where D s % 16 == 0, else 8 or 4, else element loads.
// - Q K: `lanes_per_key` lanes take one key (rows = 32 / lanes), each a
//   share of its row's 16-byte chunks, converted (int8: dequantized) once
//   and multiplied into every head's float32 sum: each K element is read
//   from shared memory once for all the CTA's heads. Q lies in shared
//   memory as float32, read as broadcast float4s. K rows are padded so a
//   quarter-warp's 16-byte reads hit 8 distinct bank groups.
// - An online softmax per head in the exp2 domain; P (rounded to T) goes
//   through the warp's shared row, and P V runs lane-per-column (columns
//   lane + 32 j), each V element converted once and multiplied into every
//   head's accumulators.
// - The merges: one thread a head computes the warps' weights by their
//   max into a small table, then every thread merges (head, column) pairs
//   and stores the CTA's partial into rank 0's shared memory (distributed
//   shared memory), after a cluster barrier that every CTA arrives at on
//   entry (no store reaches a peer that has not started); one cluster
//   barrier later rank 0 weighs the C partials the same way, in rank
//   order, and writes O / L, zeros where L = 0. No atomics: two calls give
//   the same bits.
//
// What the fixed cost taught (PERF.md §6): Q loaded one element a loop
// trip costs a round trip each, and merges that recompute the weights per
// element in a CTA of 1-2 warps (sized by its blocks) run serially; both
// took most of a short call's time until Q's loads went out together, the
// weights were computed once a head and every CTA ran 4 warps.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "async_tiles.cuh"
#include "simt_common.cuh"

namespace {

namespace cg = cooperative_groups;
using simt::from_f;
using simt::round_to;
using simt::to_f;

constexpr int kMaxWarps = 4;
constexpr int kMaxCluster = 16;   // the non-portable cluster size
constexpr int kMaxAcc = 64;       // heads x columns a lane accumulates
constexpr int kMaxHeads = 8;      // heads a CTA holds
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// What the plan gives, and the shared-memory layout the host derives from
// it (mirrored by `simt_smem_bytes` in kernels/paged_attention.py):
//   block ids of the rank's share [ceil(mbps / C)] int32;
//   Q [GC][dq] f32 (dq = nchunk 16 / s columns, zeros past D and past the
//   CTA's heads);
//   P [W][GC][rows] f32, a row per streaming warp;
//   the merges' weights [W + C + 2][GC] f32;
//   the streaming warps' rings, W x stages stages of K rows
//   [rows][key_stride bytes], V rows [rows][value_stride bytes] and, for
//   int8 pools, K and V scales [rows] f32 each; after the products the
//   same bytes hold the warps' partials (m, l [W][GC], O [W][GC][D] f32);
//   the cluster's slots [C][2 GC + GC D] f32 (m, l, O of each rank), used
//   on rank 0 only.
struct Params {
  const void *q, *kp, *vp;
  const float *ks, *vs;
  const int *tables, *lens;
  void* out;
  int Hk, G, D, bs, mbps;
  int gs, gc;       // group splits, heads a CTA (the last split may hold
                    // fewer)
  int lpk, rows;    // lanes a key, key rows a block (32 / lpk)
  int stages, cw;   // ring stages a warp, copy width in bytes
  int kstride, vstride;  // K and V tile row strides, bytes
  int rowb, nchunk, dq;  // a pool row's bytes, its 16-byte chunks, Q width
  int ws;           // warps that stream (the CTA runs kMaxWarps)
  int off_q, off_p, off_wt, off_ring, off_slots, stage_bytes;
  float scale_log2;
};

inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// fills the layout fields of p; returns the dynamic shared memory in bytes
inline size_t layout(Params& p, int elem, bool quantized, int GC, int W,
                     int C) {
  p.rowb = p.D * elem;
  p.nchunk = (p.rowb + 15) / 16;
  p.dq = p.nchunk * (16 / elem);
  p.rows = 32 / p.lpk;
  const size_t tbl = align16(static_cast<size_t>((p.mbps + C - 1) / C) * 4);
  const size_t q = static_cast<size_t>(GC) * p.dq * 4;
  const size_t pr = static_cast<size_t>(W) * GC * p.rows * 4;
  const size_t wt = align16(static_cast<size_t>(W + C + 2) * GC * 4);
  p.stage_bytes = p.rows * (p.kstride + p.vstride) +
                  (quantized ? 8 * p.rows : 0);
  const size_t rings = static_cast<size_t>(W) * p.stages * p.stage_bytes;
  const size_t partials =
      align16(static_cast<size_t>(W) * GC * (2 + p.D) * 4);
  p.off_q = static_cast<int>(tbl);
  p.off_p = static_cast<int>(tbl + q);
  p.off_wt = static_cast<int>(tbl + q + pr);
  p.off_ring = static_cast<int>(tbl + q + pr + wt);
  const size_t slots_at =
      tbl + q + pr + wt + (rings > partials ? rings : partials);
  p.off_slots = static_cast<int>(slots_at);
  return slots_at + static_cast<size_t>(C) * GC * (2 + p.D) * 4;
}

// cp.async of CW bytes (4, 8 or 16), zero-filled when !ok; 1 and 2 bytes
// by a load and a store
template <int CW>
__device__ __forceinline__ void copy_piece(unsigned char* dst,
                                           const unsigned char* src,
                                           bool ok) {
  if constexpr (CW == 16) {
    tiles::cp_async16(dst, src, ok);
  } else if constexpr (CW == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     tiles::smem_addr(dst)),
                 "l"(src), "r"(ok ? 8 : 0)
                 : "memory");
  } else if constexpr (CW == 4) {
    tiles::cp_async4(dst, src, ok);
  } else if constexpr (CW == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? __ldg(reinterpret_cast<const unsigned short*>(src)) : 0;
  } else {
    *dst = ok ? __ldg(src) : 0;
  }
}

// the lanes copy (row, piece) pairs 32 at a time, consecutive lanes on
// consecutive pieces of a row (a warp's copies of a row are one
// contiguous read); the trip count is uniform, and the row's pool index
// moves to each lane by shuffle
template <int CW>
__device__ __forceinline__ void copy_rows(const unsigned char* kp,
                                          const unsigned char* vp,
                                          unsigned char* kdst,
                                          unsigned char* vdst, long long idx,
                                          int lane, int rows, int rowb,
                                          int kstride, int vstride) {
  const int per = rowb / CW;  // copies a row
  const int total = rows * per;
  int r = lane / per, c = lane - (lane / per) * per;
  const int dr = 32 / per, dc = 32 - (32 / per) * per;
  for (int base = 0; base < total; base += 32) {
    const long long row = __shfl_sync(0xffffffffu, idx, r < rows ? r : 0);
    if (base + lane < total) {
      const bool ok = row >= 0;
      const size_t src = ok ? static_cast<size_t>(row) * rowb + c * CW : 0;
      copy_piece<CW>(kdst + r * kstride + c * CW, kp + src, ok);
      copy_piece<CW>(vdst + r * vstride + c * CW, vp + src, ok);
    }
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// every live row of one block into a stage: lane k (< rows) holds row k's
// index in the pool ((block id bs + position) Hk + kv head), -1 past the
// share's live rows (zero-filled). Not inlined: one copy of it serves
// every instantiation of the kernel.
__device__ __noinline__ void copy_block(const unsigned char* kp,
                                        const unsigned char* vp,
                                        unsigned char* kdst,
                                        unsigned char* vdst, long long idx,
                                        int lane, int rows, int rowb,
                                        int kstride, int vstride, int cw) {
#define PAGED_SIMT_COPY(CW)                                               \
  copy_rows<CW>(kp, vp, kdst, vdst, idx, lane, rows, rowb, kstride, vstride)
  switch (cw) {
    case 16: PAGED_SIMT_COPY(16); break;
    case 8: PAGED_SIMT_COPY(8); break;
    case 4: PAGED_SIMT_COPY(4); break;
    case 2: PAGED_SIMT_COPY(2); break;
    default: PAGED_SIMT_COPY(1);
  }
#undef PAGED_SIMT_COPY
}

// 16 bytes of a K row as float32: int8 rows dequantized as T(f32(q8) sc)
template <typename T, typename P>
__device__ __forceinline__ void unpack(const uint4& raw, float sc,
                                       float (&x)[16 / sizeof(P)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<P, float>::value) {
    #pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same<P, int8_t>::value) {
    #pragma unroll
    for (int i = 0; i < 16; ++i)
      x[i] = round_to<T>(static_cast<float>(static_cast<int8_t>(
                             (w[i >> 2] >> (8 * (i & 3))) & 0xff)) * sc);
  } else if constexpr (std::is_same<P, __half>::value) {
    #pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = __half2float(__ushort_as_half(
          static_cast<unsigned short>(w[i >> 1] >> (16 * (i & 1)))));
  } else {  // bf16: the high half of an f32
    #pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = __uint_as_float((i & 1) ? w[i >> 1] & 0xffff0000u
                                     : w[i >> 1] << 16);
  }
}

template <typename T, typename P>
__device__ __forceinline__ float deq(P x, float sc) {
  if constexpr (std::is_same<P, int8_t>::value)
    return round_to<T>(static_cast<float>(x) * sc);
  else
    return to_f(x);
}

__device__ __forceinline__ float pick(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// T: the query's (and output's) dtype; P: the pools' (T, or int8 with
// scales); NJ: columns a lane owns in P V (D <= 32 NJ); GC: heads a CTA
// holds, rounded up to a power of two (the rest zero queries, never
// stored).
template <typename T, typename P, int NJ, int GC>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_simt_kernel(const Params p) {
  constexpr bool Q = std::is_same<P, int8_t>::value;
  constexpr int E = 16 / sizeof(P);  // pool elements a 16-byte chunk
  static_assert(GC * NJ <= kMaxAcc, "accumulators a lane");
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int nrank = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (nrank > 1) tiles::cluster_arrive();  // waited for before remote stores
  const int b = blockIdx.x;
  const int kvh = blockIdx.y / p.gs;
  const int h0 = (blockIdx.y - kvh * p.gs) * p.gc;  // first head of the CTA
  const int gc = min(p.gc, p.G - h0);
  const int Hq = p.Hk * p.G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int W = p.ws;  // warps that stream; every warp takes fixed work

  int* s_tbl = reinterpret_cast<int*>(smem);
  float* sq = reinterpret_cast<float*>(smem + p.off_q);
  // a warp past W streams nothing (its pointers are never used)
  float* sp = reinterpret_cast<float*>(smem + p.off_p) + warp * GC * p.rows;
  unsigned char* ring = smem + p.off_ring + warp * p.stages * p.stage_bytes;

  // round trip 1: seq_len and the query rows, kQ loads in flight a thread
  // (a load's store waits for it: loads issued one at a time cost a round
  // trip each)
  const int len_in = __ldg(p.lens + b);
  const T* qrow = static_cast<const T*>(p.q) +
                  (static_cast<size_t>(b) * Hq + kvh * p.G + h0) * p.D;
  constexpr int kQ = 8;
  const int nq = GC * p.dq;
  for (int i0 = tid; i0 < nq; i0 += kQ * blockDim.x) {
    float v[kQ];
    #pragma unroll
    for (int u = 0; u < kQ; ++u) {
      const int i = i0 + u * blockDim.x;
      const int g = i / p.dq, d = i - g * p.dq;
      v[u] = i < nq && g < gc && d < p.D ? to_f(qrow[g * p.D + d]) : 0.f;
    }
    #pragma unroll
    for (int u = 0; u < kQ; ++u)
      if (i0 + u * blockDim.x < nq) sq[i0 + u * blockDim.x] = v[u];
  }

  // this rank's share of the live pages
  const int len = min(len_in, p.mbps * p.bs);
  const int live = (len + p.bs - 1) / p.bs;
  const int share = (live + nrank - 1) / nrank;
  const int p_begin = min(rank * share, live);
  const int p_end = min(p_begin + share, live);
  const int nrows = max(min(p_end * p.bs, len) - p_begin * p.bs, 0);

  // round trip 2: the share's block ids
  const int* trow = p.tables + static_cast<size_t>(b) * p.mbps + p_begin;
  for (int i = tid; i < p_end - p_begin; i += blockDim.x)
    s_tbl[i] = __ldg(trow + i);
  // the K rows' tail past D, read by the last chunk and never copied
  const int tail = p.nchunk * 16 - p.rowb;
  for (int i = lane; warp < W && i < p.stages * p.rows * tail; i += 32) {
    const int r = i / tail;  // stage-major rows of this warp's ring
    ring[(r / p.rows) * p.stage_bytes + (r % p.rows) * p.kstride + p.rowb +
         i % tail] = 0;
  }
  __syncthreads();

  const int nblk = (nrows + p.rows - 1) / p.rows;
  const int mine = warp < W && nblk > warp ? (nblk - warp + W - 1) / W : 0;

  // round trip 3: this warp's block i (block warp + W i of the share) into
  // stage i % stages; a group is committed whether or not it copies
  auto issue = [&](int i) {
    if (i < mine) {
      const int r0 = (warp + W * i) * p.rows;
      unsigned char* st = ring + (i % p.stages) * p.stage_bytes;
      unsigned char* vdst = st + p.rows * p.kstride;
      long long idx = -1;
      const int sr = r0 + lane;  // row within the share
      if (lane < p.rows && sr < nrows)
        idx = (static_cast<long long>(s_tbl[sr / p.bs]) * p.bs +
               sr % p.bs) * p.Hk + kvh;
      copy_block(static_cast<const unsigned char*>(p.kp),
                 static_cast<const unsigned char*>(p.vp), st, vdst, idx,
                 lane, p.rows, p.rowb, p.kstride, p.vstride, p.cw);
      if constexpr (Q) {
        float* sks = reinterpret_cast<float*>(vdst + p.rows * p.vstride);
        if (lane < p.rows) {
          tiles::cp_async4(sks + lane, p.ks + (idx >= 0 ? idx : 0),
                           idx >= 0);
          tiles::cp_async4(sks + p.rows + lane, p.vs + (idx >= 0 ? idx : 0),
                           idx >= 0);
        }
      }
    }
    tiles::cp_async_commit();
  };

  const int key = lane / p.lpk;
  const int part = lane - key * p.lpk;
  float m[GC], l[GC], acc[GC][NJ];
  #pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
    #pragma unroll
    for (int j = 0; j < NJ; ++j) acc[g][j] = 0.f;
  }

  for (int i = 0; i < p.stages; ++i) issue(i);
  for (int i = 0; i < mine; ++i) {
    if (p.stages == 1)
      tiles::cp_async_wait<0>();
    else if (p.stages == 2)
      tiles::cp_async_wait<1>();
    else
      tiles::cp_async_wait<2>();
    __syncwarp();  // the block is visible to every lane
    const unsigned char* kt = ring + (i % p.stages) * p.stage_bytes;
    const unsigned char* vt = kt + p.rows * p.kstride;
    const float* sks = reinterpret_cast<const float*>(vt +
                                                      p.rows * p.vstride);
    const int nvalid = min(p.rows, nrows - (warp + W * i) * p.rows);

    // S = Q K^T: this lane's chunks of its key's row, every head
    float s[GC];
    #pragma unroll
    for (int g = 0; g < GC; ++g) s[g] = 0.f;
    {
      const unsigned char* krow = kt + key * p.kstride;
      const float ksc = Q ? sks[key] : 1.f;
      for (int c = part; c < p.nchunk; c += p.lpk) {
        float x[E];
        unpack<T, P>(*reinterpret_cast<const uint4*>(krow + c * 16), ksc,
                     x);
        #pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float4* qv =
              reinterpret_cast<const float4*>(sq + g * p.dq + c * E);
          #pragma unroll
          for (int e = 0; e < E / 4; ++e) {
            const float4 y = qv[e];
            s[g] = fmaf(y.x, x[4 * e], s[g]);
            s[g] = fmaf(y.y, x[4 * e + 1], s[g]);
            s[g] = fmaf(y.z, x[4 * e + 2], s[g]);
            s[g] = fmaf(y.w, x[4 * e + 3], s[g]);
          }
        }
      }
    }
    for (int o = 1; o < p.lpk; o <<= 1)
      #pragma unroll
      for (int g = 0; g < GC; ++g)
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], o);

    // online softmax of each head; P (rounded to T) into the warp's row
    const bool valid = key < nvalid;
    #pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float x = valid ? s[g] * p.scale_log2 : kNeg;
      float mx = fmaxf(m[g], x);
      #pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float alpha = exp2f(m[g] - mx);
      // a masked entry is exactly kNeg; with no live key yet mx is kNeg
      // too, and exp2(0) must not count
      const float pk = x == kNeg ? 0.f : exp2f(x - mx);
      l[g] = l[g] * alpha + (part == 0 ? pk : 0.f);
      m[g] = mx;
      #pragma unroll
      for (int j = 0; j < NJ; ++j) acc[g][j] *= alpha;
      if (part == 0) sp[g * p.rows + key] = round_to<T>(pk);
    }
    __syncwarp();  // P is visible to every lane

    // O += P V: columns lane + 32 j of every head
    const float* vsc = sks + p.rows;
    for (int k0 = 0; k0 < nvalid; k0 += 4) {
      float4 pv[GC];
      #pragma unroll
      for (int g = 0; g < GC; ++g)
        pv[g] = *reinterpret_cast<const float4*>(sp + g * p.rows + k0);
      #pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const P* vrow = reinterpret_cast<const P*>(vt + (k0 + kk) *
                                                            p.vstride);
        const float sc = Q ? vsc[k0 + kk] : 1.f;
        float v[NJ];
        #pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          v[j] = d < p.D ? deq<T, P>(vrow[d], sc) : 0.f;
        }
        #pragma unroll
        for (int g = 0; g < GC; ++g) {
          const float w = pick(pv[g], kk);
          #pragma unroll
          for (int j = 0; j < NJ; ++j) acc[g][j] = fmaf(w, v[j], acc[g][j]);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage and P
    issue(i + p.stages);
  }
  tiles::cp_async_wait<0>();
  #pragma unroll
  for (int g = 0; g < GC; ++g)
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);

  // the streaming warps' partials, in the ring bytes (every read of them
  // is done)
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem + p.off_ring);  // [W][GC]
  float* wl = wm + W * GC;                                    // [W][GC]
  float* wo = wl + W * GC;                                    // [W][GC][D]
  if (warp < W) {
    if (lane == 0)
      #pragma unroll
      for (int g = 0; g < GC; ++g) {
        wm[warp * GC + g] = m[g];
        wl[warp * GC + g] = l[g];
      }
    #pragma unroll
    for (int g = 0; g < GC; ++g)
      #pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        if (d < p.D) wo[(warp * GC + g) * p.D + d] = acc[g][j];
      }
  }
  __syncthreads();
  // each head's max over the warps and the warps' weights, one thread a
  // head: wt [W][GC] weights, then the CTA's m and l [GC] each
  float* wt = reinterpret_cast<float*>(smem + p.off_wt);
  if (tid < gc) {
    float M = kNeg;
    for (int w = 0; w < W; ++w) M = fmaxf(M, wm[w * GC + tid]);
    float L = 0.f;
    for (int w = 0; w < W; ++w) {
      const float x = exp2f(wm[w * GC + tid] - M);
      wt[w * GC + tid] = x;
      L += wl[w * GC + tid] * x;
    }
    wt[W * GC + tid] = M;
    wt[(W + 1) * GC + tid] = L;
  }
  __syncthreads();
  // this CTA's partial, the warps merged, stored into its slot in rank
  // 0's shared memory; (head, column) pairs spread over every thread
  const int slot = 2 * GC + GC * p.D;
  float* slots = reinterpret_cast<float*>(smem + p.off_slots);
  float* mine_slot = cluster.map_shared_rank(slots, 0) + rank * slot;
  if (nrank > 1) tiles::cluster_wait();  // rank 0 has started
  if (tid < gc) {
    mine_slot[tid] = wt[W * GC + tid];
    mine_slot[GC + tid] = wt[(W + 1) * GC + tid];
  }
  {
    int g = tid / p.D, d = tid - (tid / p.D) * p.D;
    const int dg = blockDim.x / p.D, dd = blockDim.x - dg * p.D;
    for (; g < gc;) {
      float O = 0.f;
      for (int w = 0; w < W; ++w)
        O += wo[(w * GC + g) * p.D + d] * wt[w * GC + g];
      mine_slot[2 * GC + g * p.D + d] = O;
      g += dg;
      d += dd;
      if (d >= p.D) {
        d -= p.D;
        ++g;
      }
    }
  }
  cluster.sync();  // every rank's partial has landed on rank 0
  if (rank != 0) return;
  // each head's max over the ranks and the ranks' weights (wt [C][GC]),
  // then each head's sum of l (wt [C][GC] past them), one thread a head
  if (tid < gc) {
    float M = kNeg;
    for (int r = 0; r < nrank; ++r) M = fmaxf(M, slots[r * slot + tid]);
    float L = 0.f;
    for (int r = 0; r < nrank; ++r) {
      const float x = exp2f(slots[r * slot + tid] - M);
      wt[r * GC + tid] = x;
      L += slots[r * slot + GC + tid] * x;
    }
    wt[nrank * GC + tid] = L;
  }
  __syncthreads();
  T* o = static_cast<T*>(p.out) +
         (static_cast<size_t>(b) * Hq + kvh * p.G + h0) * p.D;
  {
    int g = tid / p.D, d = tid - (tid / p.D) * p.D;
    const int dg = blockDim.x / p.D, dd = blockDim.x - dg * p.D;
    for (; g < gc;) {
      float O = 0.f;
      for (int r = 0; r < nrank; ++r)
        O += slots[r * slot + 2 * GC + g * p.D + d] * wt[r * GC + g];
      const float L = wt[nrank * GC + g];
      o[g * p.D + d] = from_f<T>(L > 0.f ? O / L : 0.f);
      g += dg;
      d += dd;
      if (d >= p.D) {
        d -= p.D;
        ++g;
      }
    }
  }
}

template <typename T, typename P, int NJ, int GC>
int launch(Params p, int B, int W, int C, cudaStream_t stream) {
  auto kern = decode_simt_kernel<T, P, NJ, GC>;
  p.ws = W;
  const size_t smem = layout(p, static_cast<int>(sizeof(P)),
                             std::is_same<P, int8_t>::value, GC, W, C);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opened = 0;  // dynamic shared memory allowed so far
  if (opened == 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (smem > opened) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opened = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, p.Hk * p.gs, C);
  cfg.blockDim = dim3(32 * kMaxWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of (NJ, GC): NJ the columns a lane owns, ceil(D / 32)
// rounded up to a power of two (at least 2), GC the heads rounded up
// likewise, NJ GC <= kMaxAcc (the unreachable cases name an instantiation
// that exists)
template <typename T, typename P>
int dispatch(const Params& p, int B, int W, int C, cudaStream_t s) {
  const int cols = (p.D + 31) / 32;
  const int nj = cols <= 2 ? 2 : cols <= 4 ? 4 : cols <= 8 ? 8
                 : cols <= 16 ? 16 : 32;
  const int gc = p.gc <= 1 ? 1 : p.gc <= 2 ? 2 : p.gc <= 4 ? 4 : 8;
  if (p.gc > kMaxHeads || nj * gc > kMaxAcc)
    return static_cast<int>(cudaErrorInvalidValue);
#define SIMT_GC(NJ_)                                                     \
  switch (gc) {                                                          \
    case 1: return launch<T, P, NJ_, 1>(p, B, W, C, s);                  \
    case 2: return launch<T, P, NJ_, 2>(p, B, W, C, s);                  \
    case 4: return launch<T, P, NJ_, (NJ_ <= 16 ? 4 : 2)>(p, B, W, C, s); \
    default: return launch<T, P, NJ_, (NJ_ <= 8 ? 8 : 2)>(p, B, W, C, s); \
  }
  switch (nj) {
    case 2: SIMT_GC(2)
    case 4: SIMT_GC(4)
    case 8: SIMT_GC(8)
    case 16: SIMT_GC(16)
    default: SIMT_GC(32)
  }
#undef SIMT_GC
}

// The C entry of query dtype T: quantized (int8 pools with k_scale /
// v_scale, else both null), D <= 1024, the plan's sizes
// (`simt_decode_plan`): cluster C, group splits Gs, heads a CTA, lanes a
// key, warps, stages a warp, copy width, K and V tile row strides (bytes).
template <typename T>
int entry(int quantized, const void* q, const void* k_pool,
          const void* v_pool, const void* k_scale, const void* v_scale,
          const void* tables, const void* lens, void* out, int B, int Hq,
          int Hk, int D, int bs, int mbps, int cluster, int group_splits,
          int heads, int lanes_per_key, int warps, int stages,
          int copy_width, int key_stride, int value_stride, float scale,
          void* stream) {
  const int elem = quantized ? 1 : static_cast<int>(sizeof(T));
  const int rowb = D * elem;
  const int chunks16 = (rowb + 15) / 16 * 16;
  const int G = Hk > 0 ? Hq / Hk : 0;
  if (Hk <= 0 || Hq % Hk != 0 || D <= 0 || D > 1024 || bs <= 0 ||
      mbps < 0 || (quantized != 0) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr) || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 ||
      heads < 1 || group_splits < 1 || heads * group_splits < G ||
      (group_splits - 1) * heads >= G ||
      (lanes_per_key != 1 && lanes_per_key != 2 && lanes_per_key != 4 &&
       lanes_per_key != 8) ||
      warps < 1 || warps > kMaxWarps || stages < 1 || stages > 3 ||
      (copy_width != 1 && copy_width != 2 && copy_width != 4 &&
       copy_width != 8 && copy_width != 16) ||
      rowb % copy_width != 0 || key_stride < chunks16 ||
      key_stride % 16 != 0 || value_stride < chunks16 ||
      value_stride % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  Params p{};
  p.q = q;
  p.kp = k_pool;
  p.vp = v_pool;
  p.ks = static_cast<const float*>(k_scale);
  p.vs = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int*>(tables);
  p.lens = static_cast<const int*>(lens);
  p.out = out;
  p.Hk = Hk;
  p.G = G;
  p.D = D;
  p.bs = bs;
  p.mbps = mbps;
  p.gs = group_splits;
  p.gc = heads;
  p.lpk = lanes_per_key;
  p.stages = stages;
  p.cw = copy_width;
  p.kstride = key_stride;
  p.vstride = value_stride;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return quantized ? dispatch<T, int8_t>(p, B, warps, cluster, s)
                   : dispatch<T, T>(p, B, warps, cluster, s);
}

}  // namespace

// Arguments of each C entry (paged_decode_simt_{f32,f16,bf16}): quantized,
// q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, B, Hq, Hk, D, bs,
// mbps, cluster, group splits, heads, lanes a key, warps, stages, copy
// width, key stride, value stride, scale, stream.
#define PAGED_DECODE_SIMT_ENTRY(NAME, T)                                   \
  extern "C" int NAME(                                                     \
      int quantized, const void* q, const void* k_pool,                    \
      const void* v_pool, const void* k_scale, const void* v_scale,        \
      const void* tables, const void* lens, void* out, int B, int Hq,      \
      int Hk, int D, int bs, int mbps, int cluster, int group_splits,      \
      int heads, int lanes_per_key, int warps, int stages, int copy_width, \
      int key_stride, int value_stride, float scale, void* stream) {      \
    return entry<T>(quantized, q, k_pool, v_pool, k_scale, v_scale,       \
                    tables, lens, out, B, Hq, Hk, D, bs, mbps, cluster,    \
                    group_splits, heads, lanes_per_key, warps, stages,     \
                    copy_width, key_stride, value_stride, scale, stream);  \
  }
