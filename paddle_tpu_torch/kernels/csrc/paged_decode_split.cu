// Split-KV paged-decode attention for long tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel_chunked`
// (paddle_tpu/kernels/pallas/paged_attention.py:186), on bf16 pools
// (`quantized=False`, B6) and on int8 pools with per-row scales
// (`quantized=True`, B6q). Same function as paged_decode.cu (the layouts
// are in paged_common.cuh).
//
// What bounds it on this card: bytes, as for every decode attention (each
// live KV row is read once for G dot products). At engine A's shape (B 8,
// Hk 8, 128-page tables of 16 rows, lens up to 2048) those bytes take
// about 0.010 ms (bf16) and 0.005 ms (int8) at 3.35 TB/s. What keeps a
// kernel from them is latency and balance: the longest slot's pages must
// stream on many SMs at once, each SM keeping enough rows in flight, and
// the partial results must meet without another launch. The TPU kernel's
// chunking (several pages per sequential grid step) answers a different
// problem, per-step overhead on one core, and is not copied.
//
// Its first design took two launches -- a split kernel walking rows in
// 8-row groups on CUDA cores into f32 partials in global memory, then a
// merge kernel -- and read 0.062 (bf16) and 0.077 ms (int8) at engine A's
// shape; the per-page route's cluster kernel (paged_decode.cu) read 0.030
// and 0.036 there, its CTA-wide chunk loop (every warp waits for the
// slowest copy of a chunk, then for the int8 chunk's dequantization)
// keeping too few rows in flight (NVIDIA H100 80GB HBM3, 700 W).
//
// Design (one launch):
// - Grid (B, Hk, C) in clusters of C CTAs per (slot, kv head) (C <= 16;
//   above 8 the non-portable cluster size), C from the wrapper's
//   `split_cluster_plan`. Rank r takes the contiguous share
//   [r s, r s + s) of the slot's live pages, s = ceil(live / C): engine
//   A's lens are 100-1032 in 2048-token tables, so most of a table is
//   dead and never read.
// - seq_len and the block-table row are read once, into shared memory,
//   with the query's fragments.
// - Each warp streams its own 16-row blocks of the share (blocks w,
//   w + 4, ...), one or two blocks in flight a warp and waiting only on
//   its own copies (__syncwarp, no CTA barrier in the loop): 16-byte copies of
//   the head's K and V rows, 4-byte copies of an int8 row's two scales
//   (strided by Hk). A CTA is small (52 KB of shared memory for bf16
//   pools, 68 KB for int8 at engine A's shape, clusters of 8), so three
//   or four share an SM and most of the 512 CTAs run at once.
//   Rows past seq_len are zero-filled and never read from the pool.
// - bf16 rows land in tiles padded by 16 bytes a row; a warp dequantizes
//   its int8 block's K rows into its own padded bf16 tile before S, and
//   its V rows into the same tile before P V.
// - Both products run on mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//   the G query heads as the M side (rows G..15 zero); ldmatrix (K) and
//   ldmatrix.trans (V) read the padded tiles free of bank conflicts. Each
//   warp keeps an f32 online softmax in the exp2 domain; P is rounded to
//   bf16 before P V and l sums the f32 P.
// - The 4 warps' (m, l, O) merge in shared memory by their max; each CTA
//   stores its partial into rank 0's shared memory (distributed shared
//   memory: remote stores, no remote round trip), one cluster barrier
//   later rank 0 merges the C partials by their max, in rank order, and
//   writes O / L (zeros where L = 0). No atomics, so two calls give the
//   same bits. (Rank 0 reading the others' partials instead, behind a
//   second barrier, saved the slots' shared memory but measured slower.)

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

constexpr int kMaxCluster = 16;  // the non-portable cluster size
constexpr int kBlock = 16;       // key rows a warp takes at a time

// One warp's shared memory (mirrored by `split_smem_bytes` in
// kernels/paged_attention.py): bf16 pools, one 16-row stage of a K and a
// V tile [kBlock][D + 8] bf16; int8 pools, two stages of raw K and V rows
// [kBlock][D] int8 with their f32 scales [kBlock] each, after one bf16
// tile that takes the dequantized K block, then the V block. At engine
// A's shape that lets four bf16 CTAs or three int8 ones share an SM (the
// launch bounds), the fastest of one to three stages a warp at two to
// four CTAs an SM on the H100.
template <int D, bool Q>
struct WarpSmem {
  static constexpr int kStride = D + 8;  // bf16 per tile row
  static constexpr int kTile = kBlock * kStride * 2;
  static constexpr int kRaw = kBlock * (2 * D + 8);
  static constexpr int kStages = Q ? 2 : 1;  // blocks in flight a warp
  static constexpr int kBytes = Q ? kTile + kStages * kRaw
                                  : kStages * 2 * kTile;
};

// Dynamic shared memory: the table row's block ids, then the 4 warps'
// stages; after the products the same bytes hold the warps' partials (m,
// l [kWarps][G], O [kWarps][G][D], f32). Past them lie the cluster's
// slots, [C][2 G + G D] f32 (m, l, O of each rank), used on rank 0 only:
// a rank stores its partial there while rank 0 may still be streaming.
template <int D, int G, bool Q>
__host__ __device__ constexpr size_t slots_at(int mbps) {
  const size_t rings = align16(static_cast<size_t>(mbps) * 4) +
                       static_cast<size_t>(kWarps) * WarpSmem<D, Q>::kBytes;
  const size_t partials = static_cast<size_t>(kWarps) * G * (D + 2) * 4;
  return rings > partials ? rings : partials;
}

template <int D, int G, bool Q>
__global__ void __launch_bounds__(kThreads, Q ? 3 : 4)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const void* __restrict__ k_pool,
                          const void* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          __nv_bfloat16* __restrict__ out, int Hk, int bs,
                          int mbps, float scale_log2) {
  static_assert(G >= 1 && G <= 8, "the G heads fill rows 0..7 of the tile");
  using W = WarpSmem<D, Q>;
  constexpr int kStride = W::kStride;
  constexpr int kKC = D / 16;                  // k-chunks of Q K^T
  constexpr int kDT = D / 8;                   // d-tiles of P V
  constexpr int kRowBytes = D * (Q ? 1 : 2);   // one head's row of a pool
  constexpr int kVecs = kRowBytes / 16;        // 16-byte copies per row
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

  // this rank's share of the live pages, as key rows row0 .. row0 + nrows
  const int live = (len + bs - 1) / bs;
  const int share = (live + nrank - 1) / nrank;
  const int p_begin = min(rank * share, live);
  const int row0 = p_begin * bs;
  const int nrows = max(0, min(min(p_begin + share, live) * bs, len) - row0);
  // this warp's blocks: block warp + kWarps j of the share is its j-th
  const int nblk = (nrows + kBlock - 1) / kBlock;
  const int mine = nblk > warp ? (nblk - warp + kWarps - 1) / kWarps : 0;
  __syncthreads();  // the block ids are in shared memory

  const unsigned char* kp = static_cast<const unsigned char*>(k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(v_pool);
  unsigned char* wbase = smem + align16(static_cast<size_t>(mbps) * 4) +
                         warp * W::kBytes;
  // the warp's stages (bf16 pools: K and V tiles; int8 pools: raw rows
  // and scales, after one bf16 tile)
  constexpr int kS = W::kStages;
  constexpr int kDst = Q ? D : kStride * 2;  // staged row stride, bytes
  unsigned char* raw = wbase + (Q ? W::kTile : 0);  // the stages

  // the copies of the warp's j-th block into stage st
  auto stage = [&](int j, int st) {
    const int r0 = (warp + kWarps * j) * kBlock;  // share-relative
    unsigned char* dk = raw + st * (Q ? W::kRaw : 2 * W::kTile);
    unsigned char* dv = dk + kBlock * kDst;
    for (int i = lane; i < kBlock * kVecs; i += 32) {
      const int r = i / kVecs;
      const int c16 = (i % kVecs) * 16;
      const bool ok = r0 + r < nrows;
      size_t src = 0;
      if (ok) {
        const int key = row0 + r0 + r;
        src = ((static_cast<size_t>(s_tbl[key / bs]) * bs + key % bs) * Hk +
               kvh) * kRowBytes + c16;
      }
      cp_async16(dk + r * kDst + c16, kp + src, ok);
      cp_async16(dv + r * kDst + c16, vp + src, ok);
    }
    if constexpr (Q) {
      float* sks = reinterpret_cast<float*>(dv + kBlock * D);
      if (lane < kBlock) {
        const bool ok = r0 + lane < nrows;
        size_t src = 0;
        if (ok) {
          const int key = row0 + r0 + lane;
          src = (static_cast<size_t>(s_tbl[key / bs]) * bs + key % bs) * Hk +
                kvh;
        }
        cp_async4(sks + lane, k_scale + src, ok);
        cp_async4(sks + kBlock + lane, v_scale + src, ok);
      }
    }
  };
  // an int8 block's K (v 0) or V (v 1) rows in stage st, dequantized into
  // the tile
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(wbase);
  auto dequant = [&](int st, int v) {
    const unsigned char* rows = raw + st * W::kRaw + v * kBlock * D;
    const float* sc = reinterpret_cast<const float*>(
                          raw + st * W::kRaw + 2 * kBlock * D) +
                      v * kBlock;
    for (int i = lane; i < kBlock * (D / 8); i += 32) {
      const int r = i / (D / 8);
      const int c8 = (i % (D / 8)) * 8;
      *reinterpret_cast<uint4*>(tile + r * kStride + c8) = dequant8(
          *reinterpret_cast<const uint2*>(rows + r * D + c8), sc[r]);
    }
    __syncwarp();
  };

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run = kNeg;  // row gid's running max (exp2 domain)
  float l_run = 0.f;   // this thread's part of row gid's sum of P

  #pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < mine) stage(st, st);
    cp_async_commit();
  }
  for (int j = 0; j < mine; ++j) {
    // the stage block j - 1 used is free (the warp passed the __syncwarp
    // after it): block j + kS - 1 goes there
    if (j + kS - 1 < mine) stage(j + kS - 1, (j + kS - 1) % kS);
    cp_async_commit();
    cp_async_wait<kS - 1>();  // this lane's copies of block j have landed
    __syncwarp();             // ... and every lane's
    const int st = j % kS;
    const int nvalid = nrows - (warp + kWarps * j) * kBlock;  // >= 1
    // the block's bf16 K and V tiles (int8 pools: one tile, K then V)
    const __nv_bfloat16* tk =
        Q ? tile : reinterpret_cast<const __nv_bfloat16*>(
                       raw + st * 2 * W::kTile);
    const __nv_bfloat16* tv = Q ? tile : tk + kBlock * kStride;
    if constexpr (Q) dequant(st, 0);

    // S = Q K^T over the block's 16 keys: n-tiles 0 (keys 0-7), 1 (8-15)
    float s[2][4] = {};
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      const uint32_t a[4] = {qa[kc][0], 0u, qa[kc][1], 0u};
      uint32_t bf[4];
      ldsm_x4(bf, tk + ((lane & 7) + 8 * (lane >> 4)) * kStride + kc * 16 +
                      8 * ((lane >> 3) & 1));
      mma_bf16(s[0], a, bf[0], bf[1]);
      mma_bf16(s[1], a, bf[2], bf[3]);
    }
    if constexpr (Q) {
      __syncwarp();  // every lane has read K: the tile takes V
      dequant(st, 1);
    }
    // online softmax of row gid (c0, c1 of each n-tile); rows past the
    // share's live keys are masked
    float mx = m_run;
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nt * 8 + tig * 2 + e;
        const float x = r < nvalid ? s[nt][e] * scale_log2 : kNeg;
        s[nt][e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m_run - mx);
    float rs = 0.f;
    #pragma unroll
    for (int nt = 0; nt < 2; ++nt)
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked entry is exactly kNeg; with no live key yet mx is
        // kNeg too, and exp2(0) must not count
        const float p = s[nt][e] == kNeg ? 0.f : exp2f(s[nt][e] - mx);
        s[nt][e] = p;
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
      ldsm_x4_trans(bf, tv + ((lane & 7) + 8 * ((lane >> 3) & 1)) *
                                 kStride +
                            dp * 16 + 8 * (lane >> 4));
      mma_bf16(acc[2 * dp], pa, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], pa, bf[2], bf[3]);
    }
    __syncwarp();  // every lane is done with the stage and the tiles
  }
  cp_async_wait<0>();

  // the warps' partials, over the rings (every read of them is done)
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][G]
  float* wl = wm + kWarps * G;                 // [kWarps][G]
  float* wo = wl + kWarps * G;                 // [kWarps][G][D]
  __syncthreads();  // other warps may still read s_tbl or their ring
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
  // slot in rank 0's shared memory (remote stores, no remote round trip)
  constexpr int kSlot = 2 * G + G * D;  // one rank's m, l, O
  float* slots = reinterpret_cast<float*>(smem + slots_at<D, G, Q>(mbps));
  float* mine_slot = cluster.map_shared_rank(slots, 0) + rank * kSlot;
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
    mine_slot[2 * G + i] = O;
    if (i % D == 0) {
      mine_slot[g] = M;
      mine_slot[G + g] = L;
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
  int B, Hk, bs, mbps, C;
  float sl2;
  cudaStream_t s;
};

template <int D, int G, bool Q>
int launch(const Args& a) {
  auto kern = paged_decode_split_kernel<D, G, Q>;
  const size_t smem = slots_at<D, G, Q>(a.mbps) +
                      static_cast<size_t>(a.C) * (2 * G + G * D) * 4;
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static bool nonportable = false;  // clusters past 8 CTAs allowed
  if (a.C > 8 && !nonportable) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    nonportable = true;
  }
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
      static_cast<__nv_bfloat16*>(a.o), a.Hk, a.bs, a.mbps, a.sl2);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q>
int dispatch(int Hq, int D, const Args& a) {
  if (a.Hk <= 0 || Hq % a.Hk != 0 || a.bs <= 0 || a.mbps < 0 || a.C <= 0 ||
      a.C > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return static_cast<int>(cudaSuccess);
  const int G = Hq / a.Hk;
#define SPLIT_G(D_)                                  \
  switch (G) {                                       \
    case 1: return launch<D_, 1, Q>(a);              \
    case 2: return launch<D_, 2, Q>(a);              \
    case 4: return launch<D_, 4, Q>(a);              \
    case 8: return launch<D_, 8, Q>(a);              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (D == 128) SPLIT_G(128)
  if (D == 64) SPLIT_G(64)
#undef SPLIT_G
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int paged_decode_split_bf16(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* tables, const void* lens,
                                       void* out, int B, int Hq, int Hk,
                                       int D, int bs, int mbps, int cluster,
                                       float scale, void* stream) {
  const Args a{q,    k_pool, v_pool, nullptr, nullptr, tables,
               lens, out,    B,      Hk,      bs,      mbps,
               cluster,      scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(Hq, D, a);
}

extern "C" int paged_decode_split_i8(const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* tables,
                                     const void* lens, void* out, int B,
                                     int Hq, int Hk, int D, int bs, int mbps,
                                     int cluster, float scale,
                                     void* stream) {
  const Args a{q,    k_pool, v_pool, k_scale, v_scale, tables,
               lens, out,    B,      Hk,      bs,      mbps,
               cluster,      scale * kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(Hq, D, a);
}
