// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV, bf16 in,
// f32 accumulate.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (paddle_tpu/kernels/pallas/flash_attention.py:358, :408), the two halves
// of the custom VJP of the flash forward (flash_fwd.cu). Both recompute
// P = exp(S * scale - LSE) from the forward's LSE, masked to 0, and use
// Delta = rowsum(dO * O), which the wrapper computes before the launch:
//   dP = dO V^T,  dS = P * (dP - Delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO,
// with P and dS rounded to bf16 before the products that take them.
// Inputs: q/dO [B, Sq, Hq, D], k/v [B, Sk, Hk, D] bf16, read through their
// batch, sequence and head strides (the head dim contiguous, the others
// multiples of 8 elements); LSE and Delta f32 [B, Hq, Sq]. Outputs dQ
// [B, Sq, Hq, D], dK/dV [B, Sk, Hk, D] bf16, contiguous. D is 64, 128 or
// 256 (the wrapper zero-pads any other D up to 256 to the next of these);
// Hq = G * Hk with G dividing 64. Causal masking is bottom-right aligned
// (query i sees keys j <= i + Sk - Sq); a fully masked row (LSE = +1e30)
// gets P = 0 and zero gradients. With segment ids (the Pallas bodies'
// `has_seg` branch, :382 and :435) a query sees a key of its own segment
// and, if causal, of a position not after its own (flash_seg.cuh); a
// row no key is visible to gets dQ = 0 and a key no row sees dK = dV = 0.
//
// What bounds it on this card: at training lengths (S ~ 1024) the work is
// the recomputed products -- 3 (dQ) and 4 (dK/dV) of 2 * Sq * Sk * D flops
// per head, halved for causal -- against a few MB of inputs read once, so
// tensor-core throughput bounds both kernels, not bytes. The tensor cores
// stay fed only if the tile loads, the operand reads and the softmax
// recompute hide behind the products.
//
// Design (the TPU's two-kernel split, kept on purpose: no atomics, so two
// launches on the same inputs give the same bits):
// - Tiles stream through a two-stage cp.async ring with one barrier a
//   step, as in the forward (async_tiles.cuh): once step n's tile is
//   visible to every thread (so step n - 1's is consumed), step n + 1's
//   copies go out and overlap step n's products.
// - Every product is one warpgroup's wgmma (sm_90a): the CTA's 4 warps
//   are the 64 rows of its m64 tiles, and every tile that wgmma reads is
//   stored with the 128-byte swizzle (`swz`), so wgmma reads it straight
//   from shared memory. S and dP read the staged tile K-major (the head
//   dim along k); dQ += dS K, dV += P^T dO and dK += dS^T Q read the same
//   tiles MN-major (the head dim along n: `desc_mn_sw128`), so no tile is
//   stored twice or transposed. The f32 accumulators of S and dP come back
//   in mma.sync's C layout, where P and dS are computed, rounded to bf16
//   and turned into the next product's A fragments in registers (as the
//   forward feeds P V). Each product is retired before its sub-step ends.
// - flash_bwd_dq: one CTA owns 64 folded rows (the G query heads of one kv
//   head x 64/G positions, as the forward). Q and dO are staged once, and
//   each warp keeps its 16 rows' fragments in registers: the A operands
//   of S and dP. K/V tiles of 64 keys stream through the ring, up to the
//   causal diagonal, each taken in two halves of 32 keys (S and dP m64n32;
//   dQ m64nD accumulates over the walk). dQ leaves through the warp's own
//   rows of the Q staging area, 16 bytes a store. The grid is 1-d and
//   walks query blocks from the last (the most keys) to the first over
//   every (kv head, batch): the longest CTAs start first.
// - flash_bwd_dkv: one CTA owns one (batch, kv head, 64-key tile) and the
//   query heads g0 .. g0 + G/C - 1 of the group; K and V of the tile stay
//   in shared memory as the A operands of S^T = K Q^T and dP^T = V dO^T
//   (both operands from shared memory). The ring streams (query tile,
//   head) steps: 64 rows of Q and dO with their LSE and Delta (and ids and
//   positions on the segment branch), from the causal diagonal to the end,
//   each taken in two halves of 32 queries. P^T and dS^T
//   become the A fragments of dV += P^T dO and dK += dS^T Q (m64nD),
//   whose f32 accumulators sum over the group's heads; KV is never
//   expanded. At the end the accumulators go to shared memory (row-major
//   f32, over the drained K, V and ring) and leave coalesced.
// - Balance: dK/dV's grid is 1-d, key tile slowest, so the longest CTAs
//   (the first key tiles under causal masking) start first. A grid of few
//   CTAs still leaves a tail (Llama-3-8B at B 1, S 2048: 256 CTAs for 264
//   slots, the first CTA walking 128 steps while the mean walks 66), so
//   the C entry point takes a thread-block cluster of C CTAs per key tile
//   (C a power of two dividing G, at most 8): rank r takes G/C of the
//   heads, and the C partial sums meet in distributed shared memory, each
//   rank summing 64/C keys over the ranks in rank order -- deterministic,
//   no atomics. The wrapper picks C (`dkv_cluster`): 2 for an even G below
//   2048 CTAs, which measured faster than 1 and 4 on the H100 both at
//   Llama's shape (256 CTAs) and at an 8192-token packed row (1024).
// - The mask runs only where one is needed. Dense: dQ masks a tile that
//   crosses the diagonal of the CTA's first row or the end of the keys
//   (keys past Sk are zero-filled, and exp of a very small LSE would
//   overflow there); dK/dV masks a tile that crosses the diagonal (rows
//   past Sq are zero-filled with LSE 0 and Delta 0: P = 1 there but
//   dO = 0 and dS = 0, so they add exact zeros; keys past Sk are never
//   written). Sub-tiles above the diagonal are skipped.
// - The segment branch (kSeg) classifies every (query block, key tile)
//   pair from [id min, id max, position min, position max] bounds
//   (`pair_class`, flash_seg.cuh, shared with the forward's segment
//   branch): a first small launch writes the bounds of every
//   64-token tile into a workspace (`tile_bounds_kernel`, one warp a tile:
//   on the host it took ten PyTorch operations a call, which outlasted
//   the kernel at short packed rows), and dQ reduces its own block's:
//   skip when the id ranges do not overlap or, causal, when every query
//   position lies before every key position; full (no mask) when block
//   and tile hold one id between them and, causal, the block's first
//   position is not before the tile's last; masked otherwise. The CTA
//   compacts the pairs it must walk into a list in shared memory, each
//   entry flagged full or masked. Each staged tile carries its ids and
//   positions beside it for the masked ones.
// - Not yet: TMA, a producer warp, and overlap of one sub-step's products
//   with the next one's softmax recompute inside a CTA (the two CTAs that
//   share an SM overlap each other).
//
// Head dim 256 (`flash_bwd_dq_wide_kernel`, `flash_bwd_dkv_wide_kernel`):
// the JAX package pads any D to a multiple of 128, so it attends at D
// 160-256 (Gemma's heads are 256 wide). At this width a warp's 16 rows of
// one f32 accumulator are 128 registers a thread, so:
// - every product runs on mma.sync m16n8k16 from padded-row tiles
//   (ldmatrix, ldmatrix.trans), and the A fragments of Q, dO, K and V are
//   read from shared memory at each use instead of kept in registers;
// - dK and dV would need 256 accumulator registers together, so one CTA
//   computes one of them: the dK/dV grid is doubled, the dV CTA of a key
//   tile recomputes S^T = K Q^T and accumulates P^T dO, the dK CTA
//   recomputes S^T and dP^T = V dO^T and accumulates dS^T Q. That is five
//   products per (query, key) pair instead of four, and no cluster;
// - the tiles (Q, dO and a two-stage ring of 64-row K/V or Q/dO tiles,
//   rows padded by 16 bytes) take 198 KiB, one CTA an SM.
// The segment branch is the same kernels' kSeg instantiation (the pair
// lists of the narrower kernels). A first version that is right; wgmma at
// this width is later work.

#include <cooperative_groups.h>

#include "async_tiles.cuh"
#include "flash_seg.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace flash;
using tiles::cp_async16;
using tiles::cp_async4;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::ldsm_x4;
using tiles::ldsm_x4_trans;

constexpr int kBQ = 64;        // query rows per step of the dK/dV kernel
constexpr int kStages = 2;     // ring depth
constexpr int kMaxCluster = 8;  // the portable cluster size

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kTile = kBK * D * 2;   // bytes of a swizzled K or V
  static constexpr int kStride = D + 8;       // bf16 per padded Q/dO row
  static constexpr int kQ = kRows * kStride;  // Q or dO, folded rows
  // the K ring, the V ring (1024-byte aligned), then Q and dO
  static constexpr int kBytes = 2 * kStages * kTile + 2 * kQ * 2;
  // the segment branch's ints after those: each stage's kv ids and
  // positions, scratch, then the list of live key tiles (one per tile)
  static constexpr int kSegInts = 2 * kStages * kBK + kSegScratch;
};

// P (masked when kMask), then dS = P (dP - Delta) scale into s, for one
// sub-tile of kNT * 8 keys starting at key `key0` (tile-local `kl0`). kSeg
// masks by the staged ids and positions (tseg, tpos: the tile's) against
// the rows' (qid, qp); otherwise by the end of the keys and the
// bottom-right diagonal.
template <bool kMask, bool kSeg, int kNT>
__device__ __forceinline__ void dq_scores(
    float (&s)[kNT][4], const float (&dp)[kNT][4], const int (&pos)[2],
    const float (&lse2)[2], const float (&dlt)[2], int key0, int kl0, int Sk,
    int causal, int off, float scale_log2, float scale, int tig,
    const int* tseg, const int* tpos, const int (&qid)[2],
    const int (&qp)[2]) {
  #pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = c >> 1;
      float p = exp2f(fmaf(s[nt][c], scale_log2, -lse2[i]));
      if (kMask) {
        const int kl = nt * 8 + tig * 2 + (c & 1);
        const int key = key0 + kl;
        bool ok;
        if constexpr (kSeg)
          ok = key < Sk && tseg[kl0 + kl] == qid[i] &&
               (!causal || qp[i] >= tpos[kl0 + kl]);
        else
          ok = key < Sk && (!causal || key <= pos[i] + off);
        if (!ok) p = 0.f;
      }
      s[nt][c] = p * (dp[nt][c] - dlt[i]) * scale;
    }
  }
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int B, int Sq, int Sk,
                    int Hq, int Hk, int causal, float scale,
                    float scale_log2, Strides qs, Strides ks, Strides vs,
                    Strides dos, Seg seg) {
  using L = DqSmem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kKC = D / 16;     // k-chunks over the head dim
  constexpr int kDT = D / 8;      // n-tiles over the head dim
  // keys per sub-step (S, dP m64n32): 64 at D 64 gave wrong dQ on every
  // CTA that walks two or more key tiles, for a reason not found
  constexpr int kSub = 32;
  constexpr int kSNT = kSub / 8;  // n-tiles over a sub-step's keys
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;               // [stage] swizzled [kBK][D]
  unsigned char* sV = sK + kStages * L::kTile;
  __nv_bfloat16* sQ =
      reinterpret_cast<__nv_bfloat16*>(sV + kStages * L::kTile);
  __nv_bfloat16* sD = sQ + L::kQ;             // dO
  // segment branch only: [stage][kBK] kv ids, then positions, scratch and
  // the live tile list
  int* sKseg = reinterpret_cast<int*>(sD + L::kQ);
  int* sKpos = sKseg + kStages * kBK;
  int* sScratch = sKpos + kStages * kBK;
  int* sList = sScratch + kSegScratch;

  const int G = Hq / Hk;
  const int bq = kRows / G;  // query positions per CTA
  const int nqb = (Sq + bq - 1) / bq;
  // 1-d grid: (kv head, batch) fastest, query blocks from the last
  const int hb = blockIdx.x % (Hk * B);
  const int kvh = hb % Hk;
  const int b = hb / Hk;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / (Hk * B)) * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;

  // stage Q and dO: folded row r is (head kvh G + r / bq, position
  // q0 + r % bq)
  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * 8;
    const int pos = q0 + r % bq;
    const int head = kvh * G + r / bq;
    const bool ok = pos < Sq;
    cp_async16(sQ + r * kStride + c, ok ? q + qs.at(b, pos, head) + c : q,
               ok);
    cp_async16(sD + r * kStride + c,
               ok ? dout + dos.at(b, pos, head) + c : dout, ok);
  }
  cp_async_commit();

  // key tiles this CTA walks: up to the diagonal of its last live row;
  // with segments, the list of live pairs (sList)
  const int q_hi = min(q0 + bq, Sq) - 1;
  int ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds(seg.qseg + at, seg.qpos + at,
                                   q_hi + 1 - q0, sScratch);
    ntiles = live_pairs<true>(seg.kb + static_cast<size_t>(b) * 4 * nkt,
                              nkt, mine, causal, sList, sScratch);
  } else {
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    ntiles = (kend + kBK - 1) / kBK;
  }
  // the list entry of the n-th step (the tile, flagged kFull if unmasked)
  auto entry_of = [&](int n) {
    if constexpr (kSeg) return sList[n];
    else return n;
  };

  auto load_kv = [&](int n, int st) {
    const int t = entry_of(n) & (kFull - 1);
    unsigned char* dk = sK + st * L::kTile;
    unsigned char* dv = sV + st * L::kTile;
    if constexpr (kSeg) {  // threads 0-63 copy the ids, 64-127 positions
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                ok);
    }
    for (int i = tid; i < kBK * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int c8 = i % kPieces;
      const int key = t * kBK + r;
      const bool ok = key < Sk;
      cp_async16(dk + swz<kBK>(r, c8),
                 ok ? k + ks.at(b, key, kvh) + 8 * c8 : k, ok);
      cp_async16(dv + swz<kBK>(r, c8),
                 ok ? v + vs.at(b, key, kvh) + 8 * c8 : v, ok);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  // the two rows this thread owns in the mma layout: gid and gid + 8,
  // with their LSE (log2 domain), Delta, and segment id and position
  int pos[2], qid[2], qp[2];
  float lse2[2], dlt[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    const int head = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
    const bool live = pos[i] < Sq;
    const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos[i];
    lse2[i] = live ? lse[row] * kLog2e : kBig;
    dlt[i] = live ? delta[row] : 0.f;
    qid[i] = -2;
    qp[i] = 0;
    if constexpr (kSeg) {
      if (live) {
        const size_t at = static_cast<size_t>(b) * Sq + pos[i];
        qid[i] = seg.qseg[at];
        qp[i] = seg.qpos[at];
      }
    }
  }

  cp_async_wait<kStages - 1>();  // Q and dO have landed
  __syncthreads();
  uint32_t qf[kKC][4], df[kKC][4];
  #pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    const int at = (warp * 16 + (lane & 15)) * kStride + kc * 16 +
                   8 * (lane >> 4);
    ldsm_x4(qf[kc], sQ + at);
    ldsm_x4(df[kc], sD + at);
  }

  // dQ, written by wgmma only (the first product starts it: a non-wgmma
  // write would make ptxas serialize the products), and the A fragments
  // of dS, kept until the product that reads them retires
  float acc[kDT][4];
  uint32_t a_ds[kSub / 16][4];
  bool started = false;

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<kStages - 2>();  // step n's tile has landed
    tiles::fence_proxy_async();    // ... where wgmma reads it
    __syncthreads();  // ... for every thread, and step n - 1's is consumed
    if (n + 1 < ntiles) load_kv(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const unsigned char* tK = sK + st * L::kTile;
    const unsigned char* tV = sV + st * L::kTile;
    const int entry = entry_of(n);
    const int t0 = (entry & (kFull - 1)) * kBK;
    // a tile past the end of the keys is always masked
    bool full_tile;
    if constexpr (kSeg)
      full_tile = (entry & kFull) && t0 + kBK <= Sk;
    else
      full_tile = t0 + kBK <= Sk && !(causal && t0 + kBK - 1 > q0 + off);

    #pragma unroll
    for (int s0 = 0; s0 < kBK; s0 += kSub) {
      // a dense sub-tile no row of the CTA sees adds nothing
      if (!kSeg && (t0 + s0 >= Sk || (causal && t0 + s0 > q_hi + off)))
        continue;
      // S = Q K^T and dP = dO V^T for the CTA's 64 rows x kSub keys: one
      // warpgroup's wgmma, A (Q, dO) from the fragments in registers, B
      // (K, V) from the swizzled tile; each warp gets its 16 rows back in
      // mma.sync's C layout
      float s[kSNT][4], dp[kSNT][4];
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));
      tiles::wgmma_fence();
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_rs_n32(flat(s), qf[kc], kstep_desc<kBK>(tK, s0, kc), kc);
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_rs_n32(flat(dp), df[kc], kstep_desc<kBK>(tV, s0, kc), kc);
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));

      const bool masked =
          !full_tile &&
          (kSeg || t0 + s0 + kSub > Sk ||
           (causal && t0 + s0 + kSub - 1 > q0 + off));
      const int* tseg = sKseg + st * kBK;
      const int* tpos = sKpos + st * kBK;
      if (masked)
        dq_scores<true, kSeg>(s, dp, pos, lse2, dlt, t0 + s0, s0, Sk, causal,
                              off, scale_log2, scale, tig, tseg, tpos, qid,
                              qp);
      else
        dq_scores<false, kSeg>(s, dp, pos, lse2, dlt, t0 + s0, s0, Sk,
                               causal, off, scale_log2, scale, tig, tseg,
                               tpos, qid, qp);

      // dQ += dS(bf16) K: the dS accumulators of n-tiles 2kc, 2kc+1 are
      // the A fragment of k step kc; B is the K tile read MN-major (keys
      // along k, the head dim along n). Retired before the sub-step ends:
      // left in flight across the loop's back edge, its accumulators
      // came out wrong (the compiler may move them there).
      #pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc)
        acc_to_a(a_ds[kc], s[2 * kc], s[2 * kc + 1]);
      tiles::wgmma_fence();
      #pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc)
        wgmma_rs_t<D>(flat(acc),  a_ds[kc],
                      desc_mn_sw128(tK + (s0 + 16 * kc) * 128, kBK * 128),
                      started || kc > 0);
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(acc));
      fence_frags(a_ds);
      started = true;
    }
  }
  if (!started)  // no key tile: dQ is 0
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  cp_async_wait<0>();

  // dQ through the warp's own 16 rows of sQ (only this warp read them)
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* row = sQ + (warp * 16 + gid + 8 * i) * kStride;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
          pack_f32(acc[dt][i * 2], acc[dt][i * 2 + 1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kPieces; i += 32) {
    const int r = warp * 16 + i / kPieces;
    const int c = (i % kPieces) * 8;
    const int p = q0 + r % bq;
    if (p >= Sq) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
    *reinterpret_cast<uint4*>(dq + base + c) =
        *reinterpret_cast<const uint4*>(sQ + r * kStride + c);
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D>
struct DkvSmem {
  static constexpr int kKV = kBK * D * 2;  // bytes of the swizzled K or V
  static constexpr int kQ = kBQ * D * 2;   // bytes of a swizzled Q or dO
  // K, V, then the ring: [stage] Q tiles, [stage] dO tiles (all 1024-byte
  // aligned); [stage] LSE, Delta rows
  static constexpr int kTiles = 2 * kKV + 2 * kStages * kQ;
  static constexpr int kBytes = kTiles + 2 * kStages * kBQ * 4;
  // the f32 dK, dV of the tile ([64][D + 8] each), over K, V and the
  // drained ring
  static constexpr int kAccStride = D + 8;
  static_assert(2 * kBK * kAccStride * 4 <= kTiles, "room for dK, dV");
  // the segment branch's ints after those: each stage's query ids and
  // positions, scratch, then the list of live query tiles
  static constexpr int kSegInts = 2 * kStages * kBQ + kSegScratch;
};

// P^T into s and dS^T into dp for one sub-step of kNT * 8 queries (the
// staged tile's rows r0 ..; tL, tDelta, tseg, tpos point at row r0). The
// two keys this thread owns are key[i] (ids kid, positions kp). kSeg masks
// by ids and positions, else by the bottom-right diagonal; rows past Sq
// and keys past Sk need no mask here (they add zeros or are not written).
template <bool kMask, bool kSeg, int kNT>
__device__ __forceinline__ void dkv_scores(
    float (&s)[kNT][4], float (&dp)[kNT][4], const float* tL,
    const float* tDelta, const int* tseg, const int* tpos, int qpos0,
    const int (&key)[2], const int (&kid)[2], const int (&kp)[2],
    int causal, int off, float scale_log2, float scale, int tig) {
  #pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int r = nt * 8 + tig * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(tL + r);
    const float2 d2 = *reinterpret_cast<const float2*>(tDelta + r);
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = c >> 1;
      const int j = c & 1;
      const float l = (j ? l2.y : l2.x) * kLog2e;
      float p = exp2f(fmaf(s[nt][c], scale_log2, -l));
      if (kMask) {
        bool ok;
        if constexpr (kSeg)
          ok = tseg[r + j] == kid[i] && (!causal || tpos[r + j] >= kp[i]);
        else
          ok = !causal || key[i] <= qpos0 + r + j + off;
        if (!ok) p = 0.f;
      }
      s[nt][c] = p;
      dp[nt][c] = p * (dp[nt][c] - (j ? d2.y : d2.x)) * scale;
    }
  }
}

template <int D, bool kSeg>
// three CTAs an SM at D 64 (at most 168 registers a thread), two at 128
__global__ void __launch_bounds__(kThreads, D == 64 ? 3 : 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int B, int Sq, int Sk,
                     int Hq, int Hk, int causal, float scale,
                     float scale_log2, Strides qs, Strides ks, Strides vs,
                     Strides dos, Seg seg) {
  using L = DkvSmem<D>;
  constexpr int kKC = D / 16;
  constexpr int kDT = D / 8;
  constexpr int kQH = 32;  // queries per sub-step (S^T, dP^T m64n32)
  constexpr int kQNT = kQH / 8;            // n-tiles over a sub-step
  constexpr int kPieces = D / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sK = smem;                  // swizzled [kBK][D]
  unsigned char* sV = sK + L::kKV;
  unsigned char* sQ = sV + L::kKV;           // [stage] swizzled [kBQ][D]
  unsigned char* sD = sQ + kStages * L::kQ;  // [stage] dO
  float* sL = reinterpret_cast<float*>(sD + kStages * L::kQ);  // [stage]
  float* sDelta = sL + kStages * kBQ;                          // [stage]
  int* sQseg = reinterpret_cast<int*>(sDelta + kStages * kBQ);  // segments
  int* sQpos = sQseg + kStages * kBQ;
  int* sScratch = sQpos + kStages * kBQ;
  int* sList = sScratch + kSegScratch;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = Hq / Hk;
  const int Gc = G / C;  // heads of this rank: g0 .. g0 + Gc - 1
  const int g0 = rank * Gc;
  // 1-d grid: cluster rank fastest, then kv head, batch, key tile
  const int rest = blockIdx.x / C;
  const int kvh = rest % Hk;
  const int b = (rest / Hk) % B;
  const int kt = rest / (Hk * B);
  const int k0 = kt * kBK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;
  const int nqt = (Sq + kBQ - 1) / kBQ;

  for (int i = tid; i < kBK * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c8 = i % kPieces;
    const int key = k0 + r;
    const bool ok = key < Sk;
    cp_async16(sK + swz<kBK>(r, c8),
               ok ? k + ks.at(b, key, kvh) + 8 * c8 : k, ok);
    cp_async16(sV + swz<kBK>(r, c8),
               ok ? v + vs.at(b, key, kvh) + 8 * c8 : v, ok);
  }
  cp_async_commit();

  // query tiles to walk: from the first that sees key k0 to the end; with
  // segments, the list of live pairs (sList)
  int qt0 = 0, ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const int4 mine =
        bounds_at(seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, kt);
    ntiles = live_pairs<false>(seg.qb + static_cast<size_t>(b) * 4 * nqt,
                               nqt, mine, causal, sList, sScratch);
  } else {
    qt0 = (causal ? max(0, k0 - off) : 0) / kBQ;
    ntiles = max(0, nqt - qt0);
  }
  const int nsteps = ntiles * Gc;
  auto entry_of = [&](int t) {
    if constexpr (kSeg) return sList[t];
    else return qt0 + t;
  };

  // step n: query tile n / Gc, head kvh G + g0 + n % Gc
  auto load_q = [&](int n, int st) {
    const int q0 = (entry_of(n / Gc) & (kFull - 1)) * kBQ;
    const int head = kvh * G + g0 + n % Gc;
    unsigned char* dq_ = sQ + st * L::kQ;
    unsigned char* dd = sD + st * L::kQ;
    for (int i = tid; i < kBQ * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int c8 = i % kPieces;
      const int pos = q0 + r;
      const bool ok = pos < Sq;
      cp_async16(dq_ + swz<kBQ>(r, c8),
                 ok ? q + qs.at(b, pos, head) + 8 * c8 : q, ok);
      cp_async16(dd + swz<kBQ>(r, c8),
                 ok ? dout + dos.at(b, pos, head) + 8 * c8 : dout, ok);
    }
    // threads 0-63 copy LSE, 64-127 Delta (0 past Sq); on the segment
    // branch also the rows' ids and positions
    const int r = tid % kBQ;
    const int pos = q0 + r;
    const bool ok = pos < Sq;
    const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos;
    const float* src = tid < kBQ ? lse : delta;
    cp_async4((tid < kBQ ? sL : sDelta) + st * kBQ + r,
              ok ? src + row : src, ok);
    if constexpr (kSeg) {
      const int* isrc = tid < kBQ ? seg.qseg : seg.qpos;
      cp_async4((tid < kBQ ? sQseg : sQpos) + st * kBQ + r,
                ok ? isrc + static_cast<size_t>(b) * Sq + pos : isrc, ok);
    }
  };
  if (nsteps > 0) load_q(0, 0);
  cp_async_commit();

  // the two keys this thread owns in the mma layout, with their segment
  // ids and positions (segment branch)
  int key[2], kid[2], kp[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + gid + 8 * i;
    kid[i] = -1;
    kp[i] = 0;
    if constexpr (kSeg) {
      if (key[i] < Sk) {
        kid[i] = seg.kseg[static_cast<size_t>(b) * Sk + key[i]];
        kp[i] = seg.kpos[static_cast<size_t>(b) * Sk + key[i]];
      }
    }
  }

  // dK, dV, written by wgmma only (as dQ above), and the A fragments of
  // P^T and dS^T, kept until the products that read them retire
  float dka[kDT][4], dva[kDT][4];
  uint32_t a_p[kQH / 16][4], a_ds[kQH / 16][4];
  bool started = false;

  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait<kStages - 2>();  // step n's tiles (and K/V) have landed
    tiles::fence_proxy_async();    // ... where wgmma reads them
    __syncthreads();
    if (n + 1 < nsteps) load_q(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const unsigned char* tQ = sQ + st * L::kQ;
    const unsigned char* tD = sD + st * L::kQ;
    const int entry = entry_of(n / Gc);
    const int q0 = (entry & (kFull - 1)) * kBQ;
    bool full_tile;
    if constexpr (kSeg)
      full_tile = entry & kFull;
    else
      full_tile = !(causal && k0 + kBK - 1 > q0 + off);

    #pragma unroll 1
    for (int r0 = 0; r0 < kBQ; r0 += kQH) {
      // a dense sub-step whose rows are all past Sq, or see no key of the
      // tile, adds nothing
      if (!kSeg && (q0 + r0 >= Sq ||
                    (causal && q0 + r0 + kQH - 1 + off < k0)))
        continue;
      // S^T = K Q^T and dP^T = V dO^T for the tile's 64 keys x kQH rows:
      // one warpgroup's wgmma with both operands in shared memory (K, V
      // as A; the staged Q, dO rows as B); each warp gets its 16 keys back
      // in mma.sync's C layout
      float s[kQNT][4], dp[kQNT][4];
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));
      tiles::wgmma_fence();
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_ss_n32(flat(s), kstep_desc<kBK>(sK, 0, kc),
                     kstep_desc<kBQ>(tQ, r0, kc), kc);
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_ss_n32(flat(dp), kstep_desc<kBK>(sV, 0, kc),
                     kstep_desc<kBQ>(tD, r0, kc), kc);
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));

      const bool masked =
          !full_tile && (kSeg || (causal && k0 + kBK - 1 > q0 + r0 + off));
      const float* tL = sL + st * kBQ + r0;
      const float* tDl = sDelta + st * kBQ + r0;
      const int* tseg = sQseg + st * kBQ + r0;
      const int* tpos = sQpos + st * kBQ + r0;
      if (masked)
        dkv_scores<true, kSeg>(s, dp, tL, tDl, tseg, tpos, q0 + r0, key,
                               kid, kp, causal, off, scale_log2, scale,
                               tig);
      else
        dkv_scores<false, kSeg>(s, dp, tL, tDl, tseg, tpos, q0 + r0, key,
                                kid, kp, causal, off, scale_log2, scale,
                                tig);

      // dV += P^T(bf16) dO and dK += dS^T(bf16) Q: A from the P^T and
      // dS^T accumulators, B the staged dO and Q rows read MN-major
      // (queries along k, the head dim along n); retired before the
      // sub-step ends, as dQ's
      #pragma unroll
      for (int kc = 0; kc < kQH / 16; ++kc) {
        acc_to_a(a_p[kc], s[2 * kc], s[2 * kc + 1]);
        acc_to_a(a_ds[kc], dp[2 * kc], dp[2 * kc + 1]);
      }
      tiles::wgmma_fence();
      #pragma unroll
      for (int kc = 0; kc < kQH / 16; ++kc) {
        const int at = (r0 + 16 * kc) * 128;
        wgmma_rs_t<D>(flat(dva), a_p[kc], desc_mn_sw128(tD + at, kBQ * 128),
                      started || kc > 0);
        wgmma_rs_t<D>(flat(dka), a_ds[kc],
                      desc_mn_sw128(tQ + at, kBQ * 128), started || kc > 0);
      }
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(dka));
      tiles::fence_regs(flat(dva));
      fence_frags(a_p);
      fence_frags(a_ds);
      started = true;
    }
  }
  if (!started)  // no query row: dK = dV = 0
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        dka[dt][c] = 0.f;
        dva[dt][c] = 0.f;
      }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with K, V and the ring

  // the tile's f32 dK, dV, row-major over K, V and the drained ring
  constexpr int kAS = L::kAccStride;
  float* fK = reinterpret_cast<float*>(smem);
  float* fV = fK + kBK * kAS;
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + gid + 8 * i;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<float2*>(fK + row * kAS + col) =
          make_float2(dka[dt][i * 2], dka[dt][i * 2 + 1]);
      *reinterpret_cast<float2*>(fV + row * kAS + col) =
          make_float2(dva[dt][i * 2], dva[dt][i * 2 + 1]);
    }
  }
  if (C > 1)
    cluster.sync();  // every rank's partial sums are in place
  else
    __syncthreads();

  // rank r sums keys [r 64/C, (r + 1) 64/C) over the ranks, in rank order,
  // and stores them 8 bytes (4 bf16) at a time
  const int rows = kBK / C;
  constexpr int kQuads = D / 4;
  for (int i = tid; i < 2 * rows * kQuads; i += kThreads) {
    const int which = i / (rows * kQuads);  // 0: dK, 1: dV
    const int row = rank * rows + (i % (rows * kQuads)) / kQuads;
    const int col = (i % kQuads) * 4;
    const int kj = k0 + row;
    if (kj >= Sk) continue;
    const float* mine = (which ? fV : fK) + row * kAS + col;
    float4 sum = *reinterpret_cast<const float4*>(
        C > 1 ? cluster.map_shared_rank(mine, 0) : mine);
    for (int rr = 1; rr < C; ++rr) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(mine, rr));
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    __nv_bfloat16* out = (which ? dv : dk) +
                         ((static_cast<size_t>(b) * Sk + kj) * Hk + kvh) * D +
                         col;
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack_f32(sum.x, sum.y), pack_f32(sum.z, sum.w));
  }
  if (C > 1) cluster.sync();  // no rank leaves while another reads it
}

// ---------------------------------------------------------------------------
// head dim 256: mma.sync kernels over padded-row tiles
// ---------------------------------------------------------------------------

template <int D>
struct WideSmem {
  static constexpr int kStride = D + 8;          // bf16 per padded row
  static constexpr int kTile = kBK * kStride;    // one 64-row tile (bf16)
  // dQ: Q, dO, then the K ring and the V ring; dK/dV: K, V, then the Q
  // ring and the dO ring (and [stage] LSE, Delta rows)
  static constexpr int kBytes = 6 * kTile * 2;
  static_assert(kBQ == kBK, "one tile shape for both sides");
};

// S (16 rows of `a_rows` x kNT*8 rows of `b_rows`, both padded-row tiles
// [row][kStride], contracted over D): the A fragments read from shared
// memory at each k step
template <int D, int kNT>
__device__ __forceinline__ void wide_product(float (&s)[kNT][4],
                                             const __nv_bfloat16* a_rows,
                                             const __nv_bfloat16* b_rows,
                                             int lane) {
  constexpr int kStride = D + 8;
  #pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
  #pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, a_rows + (lane & 15) * kStride + kc * 16 + 8 * (lane >> 4));
    #pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, b_rows + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kStride +
                      kc * 16 + 8 * ((lane >> 3) & 1));
      mma_bf16(s[2 * np], a, bf[0], bf[1]);
      mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
    }
  }
}

// acc [16 rows x D] += X (bf16 of the kNT*8-column C fragments `x`) @
// `rows` (kNT*8 rows of a padded-row tile, the head dim along n)
template <int D, int kNT>
__device__ __forceinline__ void wide_accumulate(float (&acc)[D / 8][4],
                                                const float (&x)[kNT][4],
                                                const __nv_bfloat16* rows,
                                                int lane) {
  constexpr int kStride = D + 8;
  #pragma unroll
  for (int kc = 0; kc < kNT / 2; ++kc) {
    uint32_t a[4];
    acc_to_a(a, x[2 * kc], x[2 * kc + 1]);
    #pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, rows + (kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   kStride +
                            dp * 16 + 8 * (lane >> 4));
      mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

// a warp's 16 rows of a [16 x D] f32 accumulator to bf16 rows `out_row(r)`
// (r 0..15), through the warp's own 16 padded rows `stage`
template <int D, typename OutRow>
__device__ __forceinline__ void wide_store(const float (&acc)[D / 8][4],
                                           __nv_bfloat16* stage, int lane,
                                           OutRow out_row) {
  constexpr int kStride = D + 8;
  constexpr int kPieces = D / 8;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* row = stage + (gid + 8 * i) * kStride;
    #pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
          pack_f32(acc[dt][i * 2], acc[dt][i * 2 + 1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kPieces; i += 32) {
    __nv_bfloat16* dst = out_row(i / kPieces);
    if (dst == nullptr) continue;
    const int c = (i % kPieces) * 8;
    *reinterpret_cast<uint4*>(dst + c) =
        *reinterpret_cast<const uint4*>(stage + (i / kPieces) * kStride + c);
  }
}

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int B, int Sq,
                         int Sk, int Hq, int Hk, int causal, float scale,
                         float scale_log2, Strides qs, Strides ks,
                         Strides vs, Strides dos, Seg seg) {
  using L = WideSmem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kDT = D / 8;
  constexpr int kSub = 32;        // keys per sub-step
  constexpr int kSNT = kSub / 8;
  constexpr int kPieces = D / 8;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(wide_smem);
  __nv_bfloat16* sD = sQ + L::kTile;                // dO
  __nv_bfloat16* sK = sD + L::kTile;                // [stage] K tiles
  __nv_bfloat16* sV = sK + kStages * L::kTile;      // [stage] V tiles
  int* sKseg = reinterpret_cast<int*>(wide_smem + L::kBytes);
  int* sKpos = sKseg + kStages * kBK;
  int* sScratch = sKpos + kStages * kBK;
  int* sList = sScratch + kSegScratch;

  const int G = Hq / Hk;
  const int bq = kRows / G;
  const int nqb = (Sq + bq - 1) / bq;
  const int hb = blockIdx.x % (Hk * B);
  const int kvh = hb % Hk;
  const int b = hb / Hk;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / (Hk * B)) * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;

  for (int i = tid; i < kRows * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * 8;
    const int pos = q0 + r % bq;
    const int head = kvh * G + r / bq;
    const bool ok = pos < Sq;
    cp_async16(sQ + r * kStride + c, ok ? q + qs.at(b, pos, head) + c : q,
               ok);
    cp_async16(sD + r * kStride + c,
               ok ? dout + dos.at(b, pos, head) + c : dout, ok);
  }
  cp_async_commit();

  const int q_hi = min(q0 + bq, Sq) - 1;
  int ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds(seg.qseg + at, seg.qpos + at,
                                   q_hi + 1 - q0, sScratch);
    ntiles = live_pairs<true>(seg.kb + static_cast<size_t>(b) * 4 * nkt,
                              nkt, mine, causal, sList, sScratch);
  } else {
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    ntiles = (kend + kBK - 1) / kBK;
  }
  auto entry_of = [&](int n) {
    if constexpr (kSeg) return sList[n];
    else return n;
  };

  auto load_kv = [&](int n, int st) {
    const int t = entry_of(n) & (kFull - 1);
    __nv_bfloat16* dk = sK + st * L::kTile;
    __nv_bfloat16* dv = sV + st * L::kTile;
    if constexpr (kSeg) {
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                ok);
    }
    for (int i = tid; i < kBK * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int c = (i % kPieces) * 8;
      const int key = t * kBK + r;
      const bool ok = key < Sk;
      cp_async16(dk + r * kStride + c, ok ? k + ks.at(b, key, kvh) + c : k,
                 ok);
      cp_async16(dv + r * kStride + c, ok ? v + vs.at(b, key, kvh) + c : v,
                 ok);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  int pos[2], qid[2], qp[2];
  float lse2[2], dlt[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    const int head = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
    const bool live = pos[i] < Sq;
    const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos[i];
    lse2[i] = live ? lse[row] * kLog2e : kBig;
    dlt[i] = live ? delta[row] : 0.f;
    qid[i] = -2;
    qp[i] = 0;
    if constexpr (kSeg) {
      if (live) {
        const size_t at = static_cast<size_t>(b) * Sq + pos[i];
        qid[i] = seg.qseg[at];
        qp[i] = seg.qpos[at];
      }
    }
  }
  const __nv_bfloat16* my_q = sQ + warp * 16 * kStride;
  const __nv_bfloat16* my_do = sD + warp * 16 * kStride;

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<kStages - 2>();  // step n's tile (and Q, dO) have landed
    __syncthreads();  // ... for every thread, and step n - 1's is consumed
    if (n + 1 < ntiles) load_kv(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const __nv_bfloat16* tK = sK + st * L::kTile;
    const __nv_bfloat16* tV = sV + st * L::kTile;
    const int entry = entry_of(n);
    const int t0 = (entry & (kFull - 1)) * kBK;
    bool full_tile;
    if constexpr (kSeg)
      full_tile = (entry & kFull) && t0 + kBK <= Sk;
    else
      full_tile = t0 + kBK <= Sk && !(causal && t0 + kBK - 1 > q0 + off);

    #pragma unroll 1
    for (int s0 = 0; s0 < kBK; s0 += kSub) {
      if (!kSeg && (t0 + s0 >= Sk || (causal && t0 + s0 > q_hi + off)))
        continue;
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x kSub keys
      float s[kSNT][4], dp[kSNT][4];
      wide_product<D>(s, my_q, tK + s0 * kStride, lane);
      wide_product<D>(dp, my_do, tV + s0 * kStride, lane);
      const bool masked =
          !full_tile &&
          (kSeg || t0 + s0 + kSub > Sk ||
           (causal && t0 + s0 + kSub - 1 > q0 + off));
      const int* tseg = sKseg + st * kBK;
      const int* tpos = sKpos + st * kBK;
      if (masked)
        dq_scores<true, kSeg>(s, dp, pos, lse2, dlt, t0 + s0, s0, Sk, causal,
                              off, scale_log2, scale, tig, tseg, tpos, qid,
                              qp);
      else
        dq_scores<false, kSeg>(s, dp, pos, lse2, dlt, t0 + s0, s0, Sk,
                               causal, off, scale_log2, scale, tig, tseg,
                               tpos, qid, qp);
      // dQ += dS(bf16) K
      wide_accumulate<D>(acc, s, tK + s0 * kStride, lane);
    }
  }
  cp_async_wait<0>();

  // dQ through the warp's own 16 rows of sQ (only this warp read them)
  const int r0 = warp * 16;
  wide_store<D>(acc, sQ + r0 * kStride, lane, [&](int r) {
    const int p = q0 + (r0 + r) % bq;
    return p < Sq ? dq + ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G +
                          (r0 + r) / bq) * D
                  : nullptr;
  });
}

// one CTA a (key tile, batch, kv head, which): which 0 accumulates dV, 1 dK
template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wide_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int B, int Sq,
                          int Sk, int Hq, int Hk, int causal, float scale,
                          float scale_log2, Strides qs, Strides ks,
                          Strides vs, Strides dos, Seg seg) {
  using L = WideSmem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kDT = D / 8;
  constexpr int kQH = 32;  // queries per sub-step
  constexpr int kQNT = kQH / 8;
  constexpr int kPieces = D / 8;
  extern __shared__ __align__(16) unsigned char wide_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(wide_smem);
  __nv_bfloat16* sV = sK + L::kTile;
  __nv_bfloat16* sQ = sV + L::kTile;            // [stage] Q tiles
  __nv_bfloat16* sD = sQ + kStages * L::kTile;  // [stage] dO tiles
  float* sL = reinterpret_cast<float*>(wide_smem + L::kBytes);  // [stage]
  float* sDelta = sL + kStages * kBQ;
  int* sQseg = reinterpret_cast<int*>(sDelta + kStages * kBQ);
  int* sQpos = sQseg + kStages * kBQ;
  int* sScratch = sQpos + kStages * kBQ;
  int* sList = sScratch + kSegScratch;

  const int which = blockIdx.x & 1;  // 0: dV, 1: dK
  const int rest = blockIdx.x >> 1;
  const int kvh = rest % Hk;
  const int b = (rest / Hk) % B;
  const int kt = rest / (Hk * B);
  const int k0 = kt * kBK;
  const int G = Hq / Hk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;
  const int nqt = (Sq + kBQ - 1) / kBQ;

  for (int i = tid; i < kBK * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * 8;
    const int key = k0 + r;
    const bool ok = key < Sk;
    cp_async16(sK + r * kStride + c, ok ? k + ks.at(b, key, kvh) + c : k,
               ok);
    if (which)
      cp_async16(sV + r * kStride + c, ok ? v + vs.at(b, key, kvh) + c : v,
                 ok);
  }
  cp_async_commit();

  int qt0 = 0, ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const int4 mine =
        bounds_at(seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, kt);
    ntiles = live_pairs<false>(seg.qb + static_cast<size_t>(b) * 4 * nqt,
                               nqt, mine, causal, sList, sScratch);
  } else {
    qt0 = (causal ? max(0, k0 - off) : 0) / kBQ;
    ntiles = max(0, nqt - qt0);
  }
  const int nsteps = ntiles * G;
  auto entry_of = [&](int t) {
    if constexpr (kSeg) return sList[t];
    else return qt0 + t;
  };

  // step n: query tile n / G, head kvh G + n % G
  auto load_q = [&](int n, int st) {
    const int q0 = (entry_of(n / G) & (kFull - 1)) * kBQ;
    const int head = kvh * G + n % G;
    __nv_bfloat16* dq_ = sQ + st * L::kTile;
    __nv_bfloat16* dd = sD + st * L::kTile;
    for (int i = tid; i < kBQ * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int c = (i % kPieces) * 8;
      const int pos = q0 + r;
      const bool ok = pos < Sq;
      cp_async16(dq_ + r * kStride + c,
                 ok ? q + qs.at(b, pos, head) + c : q, ok);
      cp_async16(dd + r * kStride + c,
                 ok ? dout + dos.at(b, pos, head) + c : dout, ok);
    }
    const int r = tid % kBQ;
    const int pos = q0 + r;
    const bool ok = pos < Sq;
    const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos;
    const float* src = tid < kBQ ? lse : delta;
    cp_async4((tid < kBQ ? sL : sDelta) + st * kBQ + r,
              ok ? src + row : src, ok);
    if constexpr (kSeg) {
      const int* isrc = tid < kBQ ? seg.qseg : seg.qpos;
      cp_async4((tid < kBQ ? sQseg : sQpos) + st * kBQ + r,
                ok ? isrc + static_cast<size_t>(b) * Sq + pos : isrc, ok);
    }
  };
  if (nsteps > 0) load_q(0, 0);
  cp_async_commit();

  int key[2], kid[2], kp[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + gid + 8 * i;
    kid[i] = -1;
    kp[i] = 0;
    if constexpr (kSeg) {
      if (key[i] < Sk) {
        kid[i] = seg.kseg[static_cast<size_t>(b) * Sk + key[i]];
        kp[i] = seg.kpos[static_cast<size_t>(b) * Sk + key[i]];
      }
    }
  }
  const __nv_bfloat16* my_k = sK + warp * 16 * kStride;
  const __nv_bfloat16* my_v = sV + warp * 16 * kStride;

  float acc[kDT][4];  // dV (which 0) or dK (which 1) of the warp's keys
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (n + 1 < nsteps) load_q(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const __nv_bfloat16* tQ = sQ + st * L::kTile;
    const __nv_bfloat16* tD = sD + st * L::kTile;
    const int entry = entry_of(n / G);
    const int q0 = (entry & (kFull - 1)) * kBQ;
    bool full_tile;
    if constexpr (kSeg)
      full_tile = entry & kFull;
    else
      full_tile = !(causal && k0 + kBK - 1 > q0 + off);

    #pragma unroll 1
    for (int r0 = 0; r0 < kBQ; r0 += kQH) {
      if (!kSeg && (q0 + r0 >= Sq ||
                    (causal && q0 + r0 + kQH - 1 + off < k0)))
        continue;
      // S^T = K Q^T (and, for dK, dP^T = V dO^T): the warp's 16 keys x
      // kQH queries
      float s[kQNT][4], dp[kQNT][4];
      wide_product<D>(s, my_k, tQ + r0 * kStride, lane);
      if (which) {
        wide_product<D>(dp, my_v, tD + r0 * kStride, lane);
      } else {
        #pragma unroll
        for (int nt = 0; nt < kQNT; ++nt)
          #pragma unroll
          for (int c = 0; c < 4; ++c) dp[nt][c] = 0.f;
      }
      const bool masked =
          !full_tile && (kSeg || (causal && k0 + kBK - 1 > q0 + r0 + off));
      const float* tL = sL + st * kBQ + r0;
      const float* tDl = sDelta + st * kBQ + r0;
      const int* tseg = sQseg + st * kBQ + r0;
      const int* tpos = sQpos + st * kBQ + r0;
      if (masked)
        dkv_scores<true, kSeg>(s, dp, tL, tDl, tseg, tpos, q0 + r0, key,
                               kid, kp, causal, off, scale_log2, scale,
                               tig);
      else
        dkv_scores<false, kSeg>(s, dp, tL, tDl, tseg, tpos, q0 + r0, key,
                                kid, kp, causal, off, scale_log2, scale,
                                tig);
      // dV += P^T(bf16) dO, or dK += dS^T(bf16) Q
      if (which)
        wide_accumulate<D>(acc, dp, tQ + r0 * kStride, lane);
      else
        wide_accumulate<D>(acc, s, tD + r0 * kStride, lane);
    }
  }
  cp_async_wait<0>();

  // through the warp's own 16 rows of sK (only this warp read them)
  const int r0 = warp * 16;
  __nv_bfloat16* out = which ? dk : dv;
  wide_store<D>(acc, sK + r0 * kStride, lane, [&](int r) {
    const int kj = k0 + r0 + r;
    return kj < Sk ? out + ((static_cast<size_t>(b) * Sk + kj) * Hk + kvh) * D
                   : nullptr;
  });
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hk, causal, cluster;
  float scale, sl2;
  Strides qs, ks, vs, dos;
  Seg seg;
  cudaStream_t s;
};

template <int D, bool kSeg>
cudaError_t launch_dq(const Args& a) {
  static int allowed = 48 * 1024;  // the default needs no opt-in
  using L = DqSmem<D>;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nkt) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dq_kernel<D, kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int bq = kRows / (a.Hq / a.Hk);
  const long long ctas =
      static_cast<long long>((a.Sq + bq - 1) / bq) * a.Hk * a.B;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<D, kSeg><<<static_cast<unsigned>(ctas), kThreads,
                                 smem, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.B, a.Sq, a.Sk, a.Hq,
      a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.seg);
  return cudaGetLastError();
}

template <int D, bool kSeg>
cudaError_t launch_dkv(const Args& a) {
  static int allowed = 48 * 1024;
  using L = DkvSmem<D>;
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nqt) * 4 : 0);
  auto kern = flash_bwd_dkv_kernel<D, kSeg>;
  const cudaError_t e = allow_dynamic_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const long long ctas = static_cast<long long>((a.Sk + kBK - 1) / kBK) *
                         a.B * a.Hk * a.cluster;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (a.cluster == 1) {
    kern<<<static_cast<unsigned>(ctas), kThreads, smem, a.s>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.B, a.Sq, a.Sk,
        a.Hq, a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos,
        a.seg);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, kern, a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.B,
      a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs,
      a.dos, a.seg);
  if (le != cudaSuccess) return le;
  return cudaGetLastError();
}

template <int D, bool kSeg>
cudaError_t launch_dq_wide(const Args& a) {
  static int allowed = 48 * 1024;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int smem = WideSmem<D>::kBytes +
                   (kSeg ? (2 * kStages * kBK + kSegScratch + nkt) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dq_wide_kernel<D, kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int bq = kRows / (a.Hq / a.Hk);
  const long long ctas =
      static_cast<long long>((a.Sq + bq - 1) / bq) * a.Hk * a.B;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_wide_kernel<D, kSeg><<<static_cast<unsigned>(ctas),
                                      kThreads, smem, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.B, a.Sq, a.Sk, a.Hq,
      a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.seg);
  return cudaGetLastError();
}

template <int D, bool kSeg>
cudaError_t launch_dkv_wide(const Args& a) {
  static int allowed = 48 * 1024;
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  const int smem = WideSmem<D>::kBytes + 2 * kStages * kBQ * 4 +
                   (kSeg ? (2 * kStages * kBQ + kSegScratch + nqt) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dkv_wide_kernel<D, kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  const long long ctas =
      static_cast<long long>((a.Sk + kBK - 1) / kBK) * a.B * a.Hk * 2;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dkv_wide_kernel<D, kSeg><<<static_cast<unsigned>(ctas),
                                       kThreads, smem, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.B, a.Sq, a.Sk,
      a.Hq, a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.seg);
  return cudaGetLastError();
}

bool bad_group(int Hq, int Hk) {
  return Hk <= 0 || Hq % Hk != 0 || kRows % (Hq / Hk) != 0;
}

// the segment pointers of the C entry points: all NULL (dense) or all
// given, with the bounds arrays the kernel reads
bool bad_seg(const Seg& seg, bool need_qb) {
  if (!seg.qseg) return false;
  return !(seg.kseg && seg.qpos && seg.kpos && seg.kb &&
           (seg.qb || !need_qb));
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int Sq, int Sk,
               int Hq, int Hk, int causal, float scale, long long qsb,
               long long qss, long long qsh, long long ksb, long long kss,
               long long ksh, long long vsb, long long vss, long long vsh,
               long long dsb, long long dss, long long dsh, void* stream) {
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.cluster = 1;
  a.scale = scale;
  a.sl2 = scale * kLog2e;
  a.qs = Strides{qsb, qss, qsh};
  a.ks = Strides{ksb, kss, ksh};
  a.vs = Strides{vsb, vss, vsh};
  a.dos = Strides{dsb, dss, dsh};
  a.s = static_cast<cudaStream_t>(stream);
  return a;
}

}  // namespace

// q_seg, kv_seg, q_pos, kv_pos and kv_bounds are NULL on the dense branch;
// otherwise all five are given. kv_bounds is a workspace, int32
// [B, 4, ceil(Sk / 64)], that a first launch fills with the rows id min,
// id max, position min, position max of the 64-key tiles.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* q_seg,
    const void* kv_seg, const void* q_pos, const void* kv_pos,
    void* kv_bounds, int B, int Sq, int Sk, int Hq, int Hk, int D,
    int causal, float scale, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, Hq, Hk, causal,
                     scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb,
                     dss, dsh, stream);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.seg = Seg{static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(kv_pos), nullptr,
               static_cast<const int*>(kv_bounds)};
  if (bad_group(Hq, Hk) || bad_seg(a.seg, false))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0 || Hk <= 0) return static_cast<int>(cudaSuccess);
  if (D != 256 && D != 128 && D != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (a.seg.qseg) {
    e = launch_bounds(Side{a.seg.kseg, a.seg.kpos,
                           static_cast<int*>(kv_bounds), Sk},
                      Side{}, B, a.s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (D == 256)
    e = a.seg.qseg ? launch_dq_wide<256, true>(a)
                   : launch_dq_wide<256, false>(a);
  else if (D == 128)
    e = a.seg.qseg ? launch_dq<128, true>(a) : launch_dq<128, false>(a);
  else if (D == 64)
    e = a.seg.qseg ? launch_dq<64, true>(a) : launch_dq<64, false>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

// as flash_bwd_dq_bf16, with the workspace q_bounds (NULL on the dense
// branch; [B, 4, ceil(Sq / 64)]) before kv_bounds, both filled by one
// first launch, and the cluster size C after causal: the C CTAs of a
// cluster share one key tile and split the G query heads of its group (C
// a power of two dividing G, at most 8)
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* q_seg, const void* kv_seg, const void* q_pos,
    const void* kv_pos, void* q_bounds, void* kv_bounds, int B,
    int Sq, int Sk, int Hq, int Hk, int D, int causal, int cluster,
    float scale, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, Hq, Hk, causal,
                     scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb,
                     dss, dsh, stream);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.cluster = cluster;
  a.seg = Seg{static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(kv_pos),
               static_cast<const int*>(q_bounds),
               static_cast<const int*>(kv_bounds)};
  if (bad_group(Hq, Hk) || bad_seg(a.seg, true) || cluster <= 0 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      (Hq / Hk) % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sk <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if ((D != 256 && D != 128 && D != 64) || (D == 256 && cluster != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (a.seg.qseg) {
    e = launch_bounds(
        Side{a.seg.qseg, a.seg.qpos, static_cast<int*>(q_bounds), Sq},
        Side{a.seg.kseg, a.seg.kpos, static_cast<int*>(kv_bounds), Sk}, B,
        a.s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (D == 256)
    e = a.seg.qseg ? launch_dkv_wide<256, true>(a)
                   : launch_dkv_wide<256, false>(a);
  else if (D == 128)
    e = a.seg.qseg ? launch_dkv<128, true>(a) : launch_dkv<128, false>(a);
  else if (D == 64)
    e = a.seg.qseg ? launch_dkv<64, true>(a) : launch_dkv<64, false>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}
