// Paged-decode attention for Hopper (sm_90a): one thread-block cluster per
// (slot, kv head), the slot's live pages split over the cluster.
//
// Replaces the Pallas TPU kernels `_decode_kernel` (bf16 pools) and
// `_decode_kernel_q` (int8 pools) (paddle_tpu/kernels/pallas/
// paged_attention.py:133 and :156).
//
// One query token per slot attends that slot's pages of a shared pool:
// q [B, Hq, D] bf16; k_pool/v_pool [NB, bs, Hk, D] bf16, or int8 with
// k_scale/v_scale [NB, bs, Hk] f32 (one scale per row and kv head);
// block_tables [B, MBPS] int32; seq_lens [B] int32; out [B, Hq, D] bf16.
// Positions >= seq_len are masked; seq_len == 0 gives zeros. An int8 row is
// dequantized as bf16(f32(q8) * scale) before the dot products, as the JAX
// package's `_deq` casts to the query's dtype.
//
// What bounds it on this card: bytes in principle -- each live KV row is
// read once for G = Hq/Hk dot products, far below the ~295 flops/byte
// where the tensor cores would become the limit. At the serving path's
// shape (B 8, Hk 8, tables of 15 pages, at most 240 keys) those bytes take
// about a microsecond, so what the kernel has to cut is latency: dependent
// round trips to memory and idle SMs. One CTA per (slot, kv head) walking
// its pages row group by row group (the first design) made ~60 dependent
// loads for a 240-key slot on 64 of the 132 SMs.
//
// Design:
// - Grid (B, Hk, C), cluster dims (1, 1, C), C <= 8: the C CTAs of a
//   cluster share one (slot, kv head). The wrapper picks C from the grid
//   and the table width (`decode_cluster_plan`: C = 4 at the path's
//   shape, 256 CTAs). Cluster rank r takes the contiguous share
//   [r s, r s + s) of the slot's live pages, s = ceil(live / C), so a short
//   slot's few pages are spread over the cluster too.
// - Two round trips before the products: every CTA reads seq_len and the
//   slot's whole block-table row (into shared memory) at once, then issues
//   cp.async copies for every live row of its share together: 16-byte
//   copies of the head's K and V rows, 4-byte copies of an int8 row's two
//   scales (strided by Hk). Rows past seq_len are zero-filled and never
//   read from the pool (a live page's tail may hold anything). A share
//   longer than the wrapper's chunk (a long table) streams through a
//   two-stage ring of chunks instead.
// - bf16 rows land in tiles padded by 16 bytes a row; int8 rows are staged
//   raw and then dequantized into the same padded bf16 tiles.
// - Both products run on mma.sync m16n8k16 (bf16 in, f32 accumulate): the
//   G query heads are the M side (rows G..15 zero), each warp takes 16-key
//   blocks, ldmatrix (K) and ldmatrix.trans (V) read the padded tiles free
//   of bank conflicts. Each warp keeps an f32 online softmax in the exp2
//   domain; P is rounded to bf16 before P V and l sums the f32 P.
// - The 4 warps' (m, l, O) merge in shared memory by their max; each CTA
//   stores its partial straight into rank 0's shared memory (distributed
//   shared memory, cluster.map_shared_rank: remote stores, no remote
//   round trip), one cluster barrier later rank 0 merges the C partials
//   by their max and writes O / L (zeros where L = 0). Every CTA reaches
//   the barrier, empty shares included; rank 0's slots lie outside the
//   staging bytes, which it may still be reading when the others store.

#include <cooperative_groups.h>

#include "paged_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace paged;
using flash::mma_bf16;
using flash::pack_f32;
using tiles::cp_async16;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::ldsm_x4;
using tiles::ldsm_x4_trans;

constexpr int kMaxCluster = 8;  // the portable cluster size

// Dynamic shared memory, in bytes, for chunks of `rows` key rows (a
// multiple of 16), a table row of `mbps` block ids and `stages` ring
// stages (mirrored by `decode_smem_bytes` in kernels/paged_attention.py):
//   block ids [mbps] int32;
//   bf16 pools: per stage a K tile and a V tile, [rows][D + 8] bf16 each;
//   int8 pools: one dequantized K tile and V tile as above, then per stage
//     K rows and V rows [rows][D] int8 and K and V scales [rows] f32.
// After the products the same bytes hold the warps' partials (m, l
// [kWarps][G], O [kWarps][G][D], f32). Past them lie the cluster's slots,
// [C][2 G + G D] f32 (m, l, O of each rank), used on rank 0 only.
template <int D>
__host__ __device__ constexpr size_t tiles_bytes(int rows) {
  return 2 * static_cast<size_t>(rows) * (D + 8) * 2;
}

template <int D, bool Q>
__host__ __device__ constexpr size_t raw_bytes(int rows) {
  return Q ? static_cast<size_t>(rows) * (2 * D + 8) : 0;
}

template <int D, int G, bool Q>
__host__ __device__ constexpr size_t slots_offset(int rows, int mbps,
                                                  int stages) {
  const size_t staging =
      align16(static_cast<size_t>(mbps) * 4) +
      (Q ? tiles_bytes<D>(rows) + stages * raw_bytes<D, Q>(rows)
         : stages * tiles_bytes<D>(rows));
  const size_t partials = static_cast<size_t>(kWarps) * G * (D + 2) * 4;
  return staging > partials ? staging : partials;
}

template <int D, int G, bool Q>
constexpr size_t smem_bytes(int rows, int mbps, int stages, int C) {
  return slots_offset<D, G, Q>(rows, mbps, stages) +
         static_cast<size_t>(C) * (2 * G + G * D) * 4;
}

// Q: int8 pools with scales (k_scale/v_scale), else bf16 pools.
// cpp: pages per staged chunk.
template <int D, int G, bool Q>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, int Hk, int bs, int mbps,
                    int cpp, float scale_log2) {
  static_assert(G >= 1 && G <= 8, "the G heads fill rows 0..7 of the tile");
  constexpr int kStride = D + 8;               // bf16 per tile row
  constexpr int kKC = D / 16;                  // k-chunks of Q K^T
  constexpr int kDT = D / 8;                   // d-tiles of P V
  constexpr int kRowBytes = D * (Q ? 1 : 2);   // one head's row of a pool
  constexpr int kVecs = kRowBytes / 16;        // 16-byte copies per row
  constexpr int kRowStep = kThreads / kVecs;   // rows copied at once
  constexpr int kSlot = 2 * G + G * D;         // one rank's m, l, O
  extern __shared__ __align__(16) unsigned char smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int nrank = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (nrank > 1) tiles::cluster_arrive();  // waited for before remote stores
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int Hq = Hk * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // query head of this thread's fragment row
  const int tig = lane & 3;
  const int rows = (cpp * bs + 15) & ~15;  // key rows a stage holds

  // round trip 1: the block-table row, seq_len and the query together
  int* s_tbl = reinterpret_cast<int*>(smem);
  const int* trow = tables + static_cast<size_t>(b) * mbps;
  for (int i = tid; i < mbps; i += kThreads) s_tbl[i] = __ldg(trow + i);
  // a length past the table attends the whole table, as the plain version
  const int len = min(__ldg(lens + b), mbps * bs);
  // A fragments of Q (row gid = head kvh G + gid; rows >= G and the
  // tile's rows 8..15 are zero): [kc][0] columns 2 tig, 2 tig + 1 of
  // k-chunk kc, [kc][1] the same + 8
  uint32_t qa[kKC][2];
  {
    const bool ok = gid < G;
    const unsigned* qr = reinterpret_cast<const unsigned*>(
        q + (static_cast<size_t>(b) * Hq + kvh * G + (ok ? gid : 0)) * D +
        tig * 2);
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      qa[kc][0] = ok ? __ldg(qr + kc * 8) : 0u;
      qa[kc][1] = ok ? __ldg(qr + kc * 8 + 4) : 0u;
    }
  }

  // this rank's share of the live pages
  const int live = (len + bs - 1) / bs;
  const int share = (live + nrank - 1) / nrank;
  const int p_begin = min(rank * share, live);
  const int p_end = min(p_begin + share, live);
  const int nchunks = (p_end - p_begin + cpp - 1) / cpp;
  __syncthreads();  // the block ids are in shared memory

  const unsigned char* kp = static_cast<const unsigned char*>(k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(v_pool);
  const size_t tiles_off = align16(static_cast<size_t>(mbps) * 4);
  const size_t raw_off = tiles_off + tiles_bytes<D>(rows);
  // key rows of chunk c that hold live keys (the rest of the stage is
  // zero-filled up to a multiple of 16, or left alone)
  auto chunk_rows = [&](int c) {
    const int page0 = p_begin + c * cpp;
    return min(min(cpp, p_end - page0) * bs, len - page0 * bs);
  };

  // round trip 2: every live row of chunk c into stage buf
  auto stage = [&](int c, int buf) {
    const int page0 = p_begin + c * cpp;
    const int nvalid = chunk_rows(c);
    const int nrows = (nvalid + 15) & ~15;
    unsigned char* dk;
    int dstride;
    if constexpr (Q) {
      dk = smem + raw_off + buf * raw_bytes<D, Q>(rows);
      dstride = D;
    } else {
      dk = smem + tiles_off + buf * tiles_bytes<D>(rows);
      dstride = kStride * 2;
    }
    unsigned char* dv = dk + static_cast<size_t>(rows) * dstride;
    // this thread copies piece tid % kVecs of rows tid / kVecs, then every
    // kRowStep-th row; its row's (page, position) advances with no
    // division per copy
    const int c16 = (tid % kVecs) * 16;
    int r = tid / kVecs;
    int page = r / bs, pos = r % bs;
    for (; r < nrows; r += kRowStep) {
      const bool ok = r < nvalid;
      size_t src = 0;
      if (ok)
        src = ((static_cast<size_t>(s_tbl[page0 + page]) * bs + pos) * Hk +
               kvh) * kRowBytes + c16;
      cp_async16(dk + r * dstride + c16, kp + src, ok);
      cp_async16(dv + r * dstride + c16, vp + src, ok);
      for (pos += kRowStep; pos >= bs; pos -= bs) ++page;
    }
    if constexpr (Q) {
      float* sks = reinterpret_cast<float*>(dv + static_cast<size_t>(rows) *
                                                     D);
      float* svs = sks + rows;
      for (int r = tid; r < nrows; r += kThreads) {
        const bool ok = r < nvalid;
        size_t src = 0;
        if (ok)
          src = (static_cast<size_t>(s_tbl[page0 + r / bs]) * bs + r % bs) *
                    Hk + kvh;
        cp_async4(sks + r, k_scale + src, ok);
        cp_async4(svs + r, v_scale + src, ok);
      }
    }
    cp_async_commit();
  };

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run = kNeg;  // row gid's running max (exp2 domain)
  float l_run = 0.f;   // this thread's part of row gid's sum of P

  if (nchunks > 0) stage(0, 0);
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1;
    if (c + 1 < nchunks) {
      stage(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c is visible to every thread
    const int nvalid = chunk_rows(c);
    const int nblk = (nvalid + 15) >> 4;
    const __nv_bfloat16* tk;
    if constexpr (Q) {
      // dequantize the chunk's rows into the bf16 tiles
      const unsigned char* rk = smem + raw_off + buf * raw_bytes<D, Q>(rows);
      const unsigned char* rv = rk + static_cast<size_t>(rows) * D;
      const float* sks = reinterpret_cast<const float*>(
          rv + static_cast<size_t>(rows) * D);
      const float* svs = sks + rows;
      __nv_bfloat16* wk = reinterpret_cast<__nv_bfloat16*>(smem + tiles_off);
      __nv_bfloat16* wv = wk + rows * kStride;
      for (int i = tid; i < nblk * 16 * (D / 8); i += kThreads) {
        const int r = i / (D / 8);
        const int c8 = (i % (D / 8)) * 8;
        *reinterpret_cast<uint4*>(wk + r * kStride + c8) = dequant8(
            *reinterpret_cast<const uint2*>(rk + r * D + c8), sks[r]);
        *reinterpret_cast<uint4*>(wv + r * kStride + c8) = dequant8(
            *reinterpret_cast<const uint2*>(rv + r * D + c8), svs[r]);
      }
      __syncthreads();
      tk = wk;
    } else {
      tk = reinterpret_cast<const __nv_bfloat16*>(
          smem + tiles_off + buf * tiles_bytes<D>(rows));
    }
    const __nv_bfloat16* tv = tk + rows * kStride;

    for (int blk = warp; blk < nblk; blk += kWarps) {
      // S = Q K^T over 16 keys: n-tiles 0 (keys 0-7) and 1 (keys 8-15)
      float s[2][4] = {};
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const uint32_t a[4] = {qa[kc][0], 0u, qa[kc][1], 0u};
        uint32_t bf[4];
        ldsm_x4(bf, tk + (blk * 16 + (lane & 7) + 8 * (lane >> 4)) * kStride +
                        kc * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[0], a, bf[0], bf[1]);
        mma_bf16(s[1], a, bf[2], bf[3]);
      }
      // online softmax of row gid (c0, c1 of each n-tile); rows past the
      // chunk's live keys are masked
      float mx = m_run;
      #pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = blk * 16 + nt * 8 + tig * 2 + j;
          const float x = r < nvalid ? s[nt][j] * scale_log2 : kNeg;
          s[nt][j] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = exp2f(m_run - mx);
      float rs = 0.f;
      #pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          // a masked entry is exactly kNeg; with no live key yet mx is
          // kNeg too, and exp2(0) must not count
          const float p = s[nt][j] == kNeg ? 0.f : exp2f(s[nt][j] - mx);
          s[nt][j] = p;
          rs += p;
        }
      l_run = l_run * alpha + rs;
      m_run = mx;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[dt][0] *= alpha;
        acc[dt][1] *= alpha;
      }
      // O += P V: P (rounded to bf16) is the A fragment of the 16 keys
      const uint32_t pa[4] = {pack_f32(s[0][0], s[0][1]), 0u,
                              pack_f32(s[1][0], s[1][1]), 0u};
      #pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, tv + (blk * 16 + (lane & 7) +
                                8 * ((lane >> 3) & 1)) * kStride +
                              dp * 16 + 8 * (lane >> 4));
        mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // this stage (and the dequantized tiles) is refilled
  }

  // the warps' partials, in the staging bytes (every read of them is done)
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* wl = wm + kWarps * G;                 // [kWarps][G]
  float* wo = wl + kWarps * G;                 // [kWarps][G][D]
  __syncthreads();  // with no chunk, others may still read s_tbl
  if (gid < G) {
    if (tig == 0) {
      wm[warp * G + gid] = m_run;
      wl[warp * G + gid] = l_run;
    }
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<float2*>(wo + (warp * G + gid) * D + dt * 8 +
                                 tig * 2) = make_float2(acc[dt][0],
                                                        acc[dt][1]);
  }
  __syncthreads();
  // this CTA's partial, the warps merged by their max, stored into its
  // slot in rank 0's shared memory
  const int stages = (mbps + nrank - 1) / nrank > cpp ? 2 : 1;
  float* slots = reinterpret_cast<float*>(
      smem + slots_offset<D, G, Q>(rows, mbps, stages));
  float* mine = cluster.map_shared_rank(slots, 0) + rank * kSlot;
  if (nrank > 1) tiles::cluster_wait();  // rank 0 has started
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float M = kNeg;
    #pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * G + g]);
    float L = 0.f, O = 0.f;
    #pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = exp2f(wm[w * G + g] - M);
      L += wl[w * G + g] * x;
      O += wo[(w * G + g) * D + i % D] * x;
    }
    mine[2 * G + i] = O;
    if (i % D == 0) {
      mine[g] = M;
      mine[G + g] = L;
    }
  }
  cluster.sync();  // every rank's partial has landed on rank 0
  if (rank != 0) return;
  __nv_bfloat16* o = out + (static_cast<size_t>(b) * Hq + kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    float M = kNeg;
    for (int r = 0; r < nrank; ++r) M = fmaxf(M, slots[r * kSlot + g]);
    float L = 0.f, O = 0.f;
    for (int r = 0; r < nrank; ++r) {
      const float x = exp2f(slots[r * kSlot + g] - M);
      L += slots[r * kSlot + G + g] * x;
      O += slots[r * kSlot + 2 * G + i] * x;
    }
    o[i] = __float2bfloat16(L > 0.f ? O / L : 0.f);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *t, *l;
  void* o;
  int B, Hk, bs, mbps, cpp, C;
  float sl2;
  cudaStream_t s;
};

template <int D, int G, bool Q>
int launch(const Args& a) {
  auto kern = paged_decode_kernel<D, G, Q>;
  // two ring stages when a share can exceed one chunk
  const int stages = (a.mbps + a.C - 1) / a.C > a.cpp ? 2 : 1;
  const size_t smem =
      smem_bytes<D, G, Q>((a.cpp * a.bs + 15) & ~15, a.mbps, stages, a.C);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opened = 0;  // dynamic shared memory allowed so far
  if (smem > opened) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opened = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B, a.Hk, a.C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.t), static_cast<const int*>(a.l),
      static_cast<__nv_bfloat16*>(a.o), a.Hk, a.bs, a.mbps, a.cpp, a.sl2);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q>
int dispatch(int Hq, int D, const Args& a) {
  if (a.Hk <= 0 || Hq % a.Hk != 0 || a.bs <= 0 || a.mbps < 0 ||
      a.cpp <= 0 || a.C <= 0 || a.C > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return static_cast<int>(cudaSuccess);
  const int G = Hq / a.Hk;
#define PAGED_G(D_)                                  \
  switch (G) {                                       \
    case 1: return launch<D_, 1, Q>(a);              \
    case 2: return launch<D_, 2, Q>(a);              \
    case 4: return launch<D_, 4, Q>(a);              \
    case 8: return launch<D_, 8, Q>(a);              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (D == 128) PAGED_G(128)
  if (D == 64) PAGED_G(64)
#undef PAGED_G
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lens, void* out, int B, int Hq,
                                 int Hk, int D, int bs, int mbps,
                                 int chunk_pages, int cluster, float scale,
                                 void* stream) {
  const Args a{q,    k_pool, v_pool, nullptr, nullptr,     tables,
               lens, out,    B,      Hk,      bs,          mbps,
               chunk_pages,  cluster, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(Hq, D, a);
}

extern "C" int paged_decode_i8(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* lens, void* out, int B, int Hq,
                               int Hk, int D, int bs, int mbps,
                               int chunk_pages, int cluster, float scale,
                               void* stream) {
  const Args a{q,    k_pool, v_pool, k_scale, v_scale,     tables,
               lens, out,    B,      Hk,      bs,          mbps,
               chunk_pages,  cluster, scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(Hq, D, a);
}
