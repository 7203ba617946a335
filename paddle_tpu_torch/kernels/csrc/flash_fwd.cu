// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (paddle_tpu/kernels/pallas/flash_attention.py:281, with its causal
// `_block_mask` at :245). Its LSE output is what the backward kernels
// (flash_bwd.cu) recompute P from.
//
// Computes O = softmax(Q K^T * scale + mask) V on the Paddle layout
// q [B, Sq, Hq, D], k/v [B, Sk, Hk, D] (bf16, read through their batch,
// sequence and head strides; the head dim is contiguous), writing
// O [B, Sq, Hq, D] bf16 and LSE [B, Hq, Sq] f32, both contiguous. Causal
// masking is bottom-right aligned (query i sees keys j <= i + Sk - Sq); a
// fully masked row gives O = 0 and LSE = +1e30. D is 64, 128 or 256 (the
// wrapper zero-pads any other D up to 256 to the next of these).
//
// With segment ids (the Pallas body's `has_seg` branch, :305, the mask of
// `_block_mask` at :257) a query sees a key of its own segment and, if
// causal, of a position not after its own (flash_seg.cuh).
//
// What bounds it on this card: the two products, 4 D flops per visible
// (query, key) pair and head, against q/k/v/o bytes read or written once.
// At Llama-3-8B's prefill (S up to 1024, 32 query heads over 8 kv heads of
// 128) the operations (0.009 ms at S 1024); at GPT-2 medium's training
// shape (B 8, S 1024, H 16, D 64) the two about even (bytes 0.020 ms,
// operations 0.017 ms). Either way the kernel's own limit is keeping the
// tensor cores fed: K/V loads, fragment reads and the softmax must hide
// behind the products.
//
// Design:
// - One CTA of 4 warps owns 64 "folded" rows: the G query heads that share
//   one kv head, for 64/G consecutive query positions. Each K/V tile
//   staged in shared memory serves all of them, and KV is never expanded
//   for GQA. (128 rows on 8 warps, and 128 rows as two m-tiles per warp,
//   both measured slower on the H100 at the main path's shapes: fewer
//   CTAs per SM to hide latency, and 255 registers a thread.)
// - Q is copied once into shared memory with cp.async; each warp takes its
//   16 rows' A fragments with ldmatrix and keeps them in registers. The
//   same rows of shared memory later stage the warp's O for 16-byte
//   coalesced stores.
// - 64-key K/V tiles stream through a two-stage cp.async ring with one
//   barrier per tile: as soon as tile j is visible to every thread (which
//   also means tile j - 1 is consumed), tile j + 1's copies go out and
//   overlap tile j's products. Rows are padded by 16 bytes, so ldmatrix
//   (K: B fragments of Q K^T) and ldmatrix.trans (V: B fragments of P V,
//   four per instruction) read without bank conflicts. q/k/v are read in
//   place through their strides (multiples of 8 elements: every copy is
//   16-byte aligned); keys past Sk and rows past Sq are zero-filled.
// - Both products run on mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//   online softmax is f32 in the exp2 domain; P is rounded to bf16 before
//   P V, as the Pallas kernel casts P to V's dtype.
// - The mask is evaluated only on tiles that cross the causal diagonal or
//   the end of the keys; tiles above the diagonal are never loaded.
// - The grid walks query blocks from the last (most keys under causal
//   masking) to the first, so the longest CTAs start first.
// - Not yet: wgmma and TMA for the dense branch; its products stay on
//   mma.sync.
//
// Head dim 256 (the Pallas kernel pads any D to a multiple of 128, so the
// JAX package attends at D 160-256; Gemma's heads are 256 wide): both
// branches run the dense branch's mma.sync kernel, the segment branch as
// its kSeg instantiation, which walks the compacted pair list of the
// segment kernel below and masks by ids and positions. What it had to
// give up: the f32 O accumulator of 16 rows x 256 is 128 registers a
// thread, so Q's A fragments (64 more) are not kept in registers but read
// from shared memory with ldmatrix at every key tile (16 more ldmatrix a
// tile beside the 128 of K and V); Q and a two-stage K/V ring of 64-key
// tiles padded rows take 165 KiB of shared memory, one CTA an SM. A
// first version that is right; wgmma at this width (m64n256 accumulators
// over two warpgroups) is later work.//
// The segment branch is a kernel of its own, `flash_fwd_seg_kernel`:
// - What held its first version back (1.46 ms at an 8192-token packed row
//   of Llama-3-8B width, 3.9x `varlen_attn`): it skipped a key tile by id
//   range only, so inside a segment it walked every tile above the causal
//   diagonal, masked every tile it walked, stayed on mma.sync, and took
//   the tiles' id ranges from several PyTorch operations on the host.
// - Now it walks (query block, key tile) pairs by class, as the backward
//   does (flash_seg.cuh): one small launch writes every 64-key tile's
//   [id min, id max, position min, position max] into a workspace on the
//   card, each CTA reduces its own block's bounds (its 64/G positions,
//   none past Sq) and compacts the pairs it must walk into a list in
//   shared memory. A pair is skipped when the id ranges do not overlap
//   or, causal, when every query lies before every key; a FULL pair (one
//   id, every query after every key) runs without the mask.
// - The mask runs on MASKED pairs and on any tile that reaches past Sk:
//   the ragged last tile's bounds are padded with its last token, so a
//   FULL tile can still hold zero-filled keys. It is the costliest part of
//   a masked step after the products, so it does no more than it must: a
//   masked pair whose block and tile hold one id (a causal diagonal
//   inside one sequence) compares positions only, and a thread reads the
//   ids and positions of its two adjacent keys as one 8-byte load, once
//   for both of its rows.
// - Both products run on wgmma, one warpgroup's m64 over the CTA's 64
//   folded rows. K and V tiles stream through a two-stage cp.async ring
//   in the 128-byte swizzle; Q is staged in the second stage (read into
//   registers before that stage's first tile lands) and O leaves through
//   the first. S = Q K^T takes Q's A fragments from registers and reads K
//   K-major; O += P V takes P from registers (RS form: S's C fragments
//   rounded to bf16) and reads V MN-major (`desc_mn_sw128`), so V is
//   neither stored twice nor transposed. Each step handles one 64-key
//   tile: S (m64n64 products at D 128, two m64n32 halves at D 64), one
//   online-softmax update, then P V into a fresh accumulator that the
//   running O takes in one FMA a value (O = O alpha + PV): nothing but
//   wgmma writes a wgmma accumulator, so ptxas need not serialize the
//   products. Each product is retired before the next begins; the two
//   CTAs an SM holds overlap each other's softmax and products.
// - Each staged tile carries its 64 kv ids and positions (4-byte cp.async
//   in the tile's commit group) for the masked ones; each row keeps its
//   query's id and position in registers.
// - Tried on the H100 and not kept: three and four ring stages, 32-key
//   steps, and 128 rows a CTA as two warpgroups sharing each tile (one
//   CTA an SM, warpgroups in lock step, 255 registers): none was faster.

#include "async_tiles.cuh"
#include "flash_seg.cuh"

namespace {

using namespace flash;
using tiles::cp_async16;
using tiles::cp_async4;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::ldsm_x4;
using tiles::ldsm_x4_trans;

constexpr int kFThreads = 128;  // 4 warps x 16 rows
constexpr int kFRows = 64;      // folded rows per CTA
constexpr int kStages = 2;      // K/V ring depth of the dense branch

template <int D>
struct FwdSmem {
  static constexpr int kStride = D + 8;  // bf16 per padded row
  static constexpr int kQ = kFRows * kStride;
  static constexpr int kKV = kBK * kStride;  // one K or V tile
  static constexpr int kBytes = (kQ + 2 * kStages * kKV) * 2;
};

// mask (when kMask), scale and online softmax of one 64-key tile; s holds P
// (unnormalized, f32) afterwards, acc and the running max/sum are rescaled.
// The mask is the end of the keys and the bottom-right causal diagonal,
// or with kSeg the tile's staged ids and positions (tseg, tpos) against
// the rows' (qid, qp).
template <bool kMask, bool kSeg, int kDT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kBK / 8][4], float (&acc)[kDT][4], float (&m_run)[2],
    float (&l_run)[2], const int (&pos)[2], int t0, int Sk, int causal,
    int off, float scale_log2, int tig, const int* tseg, const int* tpos,
    const int (&qid)[2], const int (&qp)[2]) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m_run[i];
    #pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      #pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[nt][i * 2 + j] * scale_log2;
        if (kMask) {
          const int kl = nt * 8 + tig * 2 + j;
          const int key = t0 + kl;
          bool out;
          if constexpr (kSeg)
            out = key >= Sk || tseg[kl] != qid[i] ||
                  (causal && tpos[kl] > qp[i]);
          else
            out = key >= Sk || (causal && key > pos[i] + off);
          if (out) x = kNeg;
        }
        s[nt][i * 2 + j] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m_run[i] - mx);
    float rs = 0.f;
    #pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      #pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float x = s[nt][i * 2 + j];
        // a masked entry is exactly kNeg; in a row with no visible key yet
        // mx is kNeg too, and exp2(0) must not count
        const float p = (kMask && x == kNeg) ? 0.f : exp2f(x - mx);
        s[nt][i * 2 + j] = p;
        rs += p;
      }
    }
    l_run[i] = l_run[i] * alpha + rs;
    m_run[i] = mx;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][i * 2] *= alpha;
      acc[dt][i * 2 + 1] *= alpha;
    }
  }
}

// the dense branch, and at D 256 the segment branch too (kSeg)
template <int D, bool kSeg>
__global__ void __launch_bounds__(kFThreads, D > 128 ? 1 : 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int Hk, int causal,
                 float scale_log2, Strides qs, Strides ks, Strides vs,
                 Seg seg) {
  using L = FwdSmem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kKC = D / 16;     // k-chunks of the QK^T product
  constexpr int kDT = D / 8;      // n-tiles of the PV product
  constexpr int kNT = kBK / 8;    // n-tiles of the QK^T product
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  // Q's A fragments stay in registers up to D 128; at D 256 the O
  // accumulator needs them, and each tile reads Q from shared memory
  constexpr bool kQRegs = D <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + L::kQ;             // [stage][kBK][kStride]
  __nv_bfloat16* sV = sK + kStages * L::kKV;  // [stage][kBK][kStride]
  // kSeg only: [stage][kBK] kv ids, then positions, scratch, pair list
  int* sKseg = reinterpret_cast<int*>(smem_raw + L::kBytes);
  int* sKpos = sKseg + kStages * kBK;
  int* sScratch = sKpos + kStages * kBK;
  int* sList = sScratch + kSegScratch;

  const int G = Hq / Hk;
  const int bq = kFRows / G;  // query positions per CTA
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;  // last block first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // row within the 8-row half of the mma tile
  const int tig = lane & 3;   // column pair within the tile
  const int off = Sk - Sq;

  // stage Q: folded row r is (head kvh G + r / bq, position q0 + r % bq)
  for (int i = tid; i < kFRows * kPieces; i += kFThreads) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * 8;
    const int pos = q0 + r % bq;
    const bool ok = pos < Sq;
    cp_async16(sQ + r * kStride + c,
               ok ? q + qs.at(b, pos, kvh * G + r / bq) + c : q, ok);
  }
  cp_async_commit();

  // keys this CTA can see: up to the diagonal of its last live row; with
  // segments, the compacted list of live (block, tile) pairs
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
  // the list entry of the t-th step: the tile, flagged kFull if unmasked
  auto entry_of = [&](int t) {
    if constexpr (kSeg) return sList[t];
    else return t;
  };

  auto load_kv = [&](int n, int st) {
    const int t = entry_of(n) & (kFull - 1);
    __nv_bfloat16* dk = sK + st * L::kKV;
    __nv_bfloat16* dv = sV + st * L::kKV;
    if constexpr (kSeg) {  // threads 0-63 copy the ids, 64-127 positions
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                ok);
    }
    for (int i = tid; i < kBK * kPieces; i += kFThreads) {
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
  #pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ntiles) load_kv(st, st);
    cp_async_commit();
  }

  // the two rows this thread owns in the mma layout: gid and gid + 8,
  // with (kSeg) their query's segment id and position
  int pos[2], head[2], qid[2], qp[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    head[i] = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
    qid[i] = -2;
    qp[i] = 0;
    if constexpr (kSeg) {
      if (pos[i] < Sq) {
        const size_t at = static_cast<size_t>(b) * Sq + pos[i];
        qid[i] = seg.qseg[at];
        qp[i] = seg.qpos[at];
      }
    }
  }

  cp_async_wait<kStages - 1>();  // Q has landed (tiles may be in flight)
  __syncthreads();
  const __nv_bfloat16* qrow =
      sQ + (warp * 16 + (lane & 15)) * kStride + 8 * (lane >> 4);
  uint32_t qf[kQRegs ? kKC : 1][4];
  if constexpr (kQRegs) {
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc) ldsm_x4(qf[kc], qrow + kc * 16);
  }

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();  // ... for every thread, and tile t - 1 is consumed
    if (t + kStages - 1 < ntiles)
      load_kv(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const int st = t % kStages;
    const __nv_bfloat16* tK = sK + st * L::kKV;
    const __nv_bfloat16* tV = sV + st * L::kKV;
    const int entry = entry_of(t);
    const int t0 = (entry & (kFull - 1)) * kBK;

    // S = Q K^T for this warp's 16 rows x 64 keys; one ldmatrix.x4 gives
    // the B fragments of two 8-key n-tiles
    float s[kNT][4];
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      uint32_t qa[4];
      if constexpr (!kQRegs) ldsm_x4(qa, qrow + kc * 16);
      const uint32_t* a = kQRegs ? qf[kQRegs ? kc : 0] : qa;
      #pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, tK + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kStride +
                        kc * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // only tiles that reach past Sk or above the first row's diagonal (or,
    // kSeg, pairs not classed full) need the mask
    bool masked;
    if constexpr (kSeg)
      masked = !(entry & kFull) || t0 + kBK > Sk;
    else
      masked = t0 + kBK > Sk || (causal && t0 + kBK - 1 > q0 + off);
    const int* tseg = sKseg + st * kBK;
    const int* tpos = sKpos + st * kBK;
    if (masked)
      softmax_tile<true, kSeg>(s, acc, m_run, l_run, pos, t0, Sk, causal,
                               off, scale_log2, tig, tseg, tpos, qid, qp);
    else
      softmax_tile<false, kSeg>(s, acc, m_run, l_run, pos, t0, Sk, causal,
                                off, scale_log2, tig, tseg, tpos, qid, qp);

    // O += P V: the S accumulator layout of n-tiles 2kc and 2kc+1 is the
    // A-operand layout of k-chunk kc; ldmatrix.trans gives the B fragments
    // of two 8-wide d-tiles
    #pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
      #pragma unroll
      for (int dp = 0; dp < kDT / 2; ++dp) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, tV + (kc * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                   kStride +
                              dp * 16 + 8 * (lane >> 4));
        mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // finalize: full row sums across the quad, normalize into the warp's own
  // 16 rows of sQ (only this warp read them), LSE from the owning threads
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* row = sQ + (warp * 16 + gid + 8 * i) * kStride;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
          pack_f32(acc[dt][i * 2] * inv, acc[dt][i * 2 + 1] * inv);
    if (tig == 0 && pos[i] < Sq) {
      lse[(static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i]] =
          l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : kBig;
    }
  }
  __syncwarp();
  // the warp's 16 rows of O, 16 bytes a lane per store
  for (int i = lane; i < 16 * kPieces; i += 32) {
    const int r = warp * 16 + i / kPieces;
    const int c = (i % kPieces) * 8;
    const int p = q0 + r % bq;
    if (p >= Sq) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
    *reinterpret_cast<uint4*>(o + base + c) =
        *reinterpret_cast<const uint4*>(sQ + r * kStride + c);
  }
}

// ---------------------------------------------------------------------------
// the segment branch
// ---------------------------------------------------------------------------

template <int D>
struct SegSmem {
  static constexpr int kStages = 2;          // ring depth
  static constexpr int kTile = kBK * D * 2;  // bytes of a swizzled K or V
  static constexpr int kStage = 2 * kTile;   // a stage: K, then V
  static constexpr int kStride = D + 8;      // bf16 per padded Q / O row
  // Q is staged in the last stage (read into registers before that
  // stage's first tile is loaded) and O leaves through the first one
  static_assert(kFRows * kStride * 2 <= kStage, "Q fits a stage");
  static constexpr int kBytes = kStages * kStage;
  // the ints after the ring: each stage's kv ids and positions, scratch,
  // then the list of live pairs (one per key tile)
  static constexpr int kInts = 2 * kStages * kBK + kSegScratch;
};

template <int D>
__global__ void __launch_bounds__(kFThreads, 2)
flash_fwd_seg_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int Hq, int Hk, int causal,
                     float scale_log2, Strides qs, Strides ks, Strides vs,
                     Seg seg) {
  using L = SegSmem<D>;
  constexpr int kS = L::kStages;
  constexpr int kStride = L::kStride;
  constexpr int kKC = D / 16;          // k steps of S over the head dim
  constexpr int kDT = D / 8;           // n-tiles of O over the head dim
  constexpr int kNT = kBK / 8;         // 8-key n-tiles of S
  constexpr int kPC = kBK / 16;        // k steps of P V
  constexpr int kPieces = D / 8;       // 16-byte pieces per row
  extern __shared__ __align__(1024) unsigned char seg_smem[];
  unsigned char* smem_raw = seg_smem;
  // stage st: swizzled K [kBK][D] at smem_raw + st kStage, V after it
  __nv_bfloat16* sQ =  // Q, then the last stage's tiles
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (kS - 1) * L::kStage);
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* sKseg = reinterpret_cast<int*>(smem_raw + L::kBytes);  // [stage][kBK]
  int* sKpos = sKseg + kS * kBK;                              // [stage][kBK]
  int* sScratch = sKpos + kS * kBK;
  int* sList = sScratch + kSegScratch;

  const int G = Hq / Hk;
  const int bq = kFRows / G;  // query positions per CTA
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  // stage Q: folded row r is (head kvh G + r / bq, position q0 + r % bq)
  for (int i = tid; i < kFRows * kPieces; i += kFThreads) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * 8;
    const int pos = q0 + r % bq;
    const bool ok = pos < Sq;
    cp_async16(sQ + r * kStride + c,
               ok ? q + qs.at(b, pos, kvh * G + r / bq) + c : q, ok);
  }
  cp_async_commit();

  // the pairs this CTA walks: its block's bounds over its live positions
  // (none past Sq) against every key tile's, from the workspace
  const int q_hi = min(q0 + bq, Sq) - 1;
  const int nkt = (Sk + kBK - 1) / kBK;
  const size_t at = static_cast<size_t>(b) * Sq + q0;
  const int4 mine = block_bounds(seg.qseg + at, seg.qpos + at, q_hi + 1 - q0,
                                 sScratch);
  const int npairs = live_pairs<true, true>(
      seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, mine, causal, sList,
      sScratch);

  auto load_kv = [&](int n, int st) {
    const int t = sList[n] & (kOneId - 1);
    unsigned char* dk = smem_raw + st * L::kStage;
    unsigned char* dv = dk + L::kTile;
    {  // threads 0-63 copy the ids, 64-127 the positions
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                ok);
    }
    for (int i = tid; i < kBK * kPieces; i += kFThreads) {
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
  #pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < npairs) load_kv(st, st);
    cp_async_commit();
  }

  // the two rows this thread owns in the mma layout: gid and gid + 8,
  // with their query's segment id and position
  int pos[2], head[2], qid[2], qp[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    head[i] = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
    qid[i] = -2;
    qp[i] = 0;
    if (pos[i] < Sq) {
      qid[i] = seg.qseg[at + r % bq];
      qp[i] = seg.qpos[at + r % bq];
    }
  }

  cp_async_wait<kS - 1>();  // Q has landed (tiles may be in flight)
  __syncthreads();
  uint32_t qf[kKC][4];
  #pragma unroll
  for (int kc = 0; kc < kKC; ++kc)
    ldsm_x4(qf[kc], sQ + (warp * 16 + (lane & 15)) * kStride + kc * 16 +
                        8 * (lane >> 4));

  // O in plain registers (mma.sync's C layout: [dt][2 i + e] is row
  // gid + 8 i, column 8 dt + 2 tig + e); each step's P V lands in a fresh
  // wgmma accumulator first
  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums
  uint32_t a_p[kPC][4];         // P's A fragments, live until P V retires

  for (int n = 0; n < npairs; ++n) {
    cp_async_wait<kS - 2>();     // pair n's tile has landed
    tiles::fence_proxy_async();  // ... where wgmma reads it
    // ... for every thread, pair n - 1's is consumed and (n 0) every warp
    // holds its Q fragments: the stage it leaves is refilled
    __syncthreads();
    if (n + kS - 1 < npairs) load_kv(n + kS - 1, (n + kS - 1) % kS);
    cp_async_commit();
    const int st = n % kS;
    const unsigned char* tK = smem_raw + st * L::kStage;
    const unsigned char* tV = tK + L::kTile;
    const int* tseg = sKseg + st * kBK;
    const int* tpos = sKpos + st * kBK;
    const int entry = sList[n];
    const int t0 = (entry & (kOneId - 1)) * kBK;
    const int kvalid = Sk - t0;  // keys of the tile before Sk
    // a FULL pair needs no mask unless its tile reaches past the keys; a
    // masked pair of one id compares positions only
    const bool by_pos = causal && !(entry & kFull);
    const bool by_id = !(entry & (kFull | kOneId));
    const bool masked = by_pos || by_id || kvalid < kBK;

    // S = Q K^T for the CTA's 64 rows x the tile's 64 keys: A (Q) from
    // the fragments in registers, B (K) K-major from the swizzled tile;
    // [8-key n-tile][C fragment]. At D 128 one m64n64 product a k step
    // (half the wgmma instructions of two m64n32 halves, and faster); at
    // D 64 the m64n64 form gave wrong S on the H100, as 64-key sub-steps
    // gave wrong dQ in the backward (cause not found), so D 64 keeps the
    // two m64n32 halves, which pass the GPU tests.
    float s[kNT][4];
    tiles::fence_regs(flat(s));
    tiles::wgmma_fence();
    if constexpr (D == 128) {
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_rs_n64(flat(s), qf[kc], kstep_desc<kBK>(tK, 0, kc), kc);
    } else {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        float (&sh)[kNT / 2][4] =
            *reinterpret_cast<float(*)[kNT / 2][4]>(&s[h * kNT / 2]);
        #pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          wgmma_rs_n32(flat(sh), qf[kc], kstep_desc<kBK>(tK, 32 * h, kc),
                       kc);
      }
    }
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));

    // scale and mask: [nt][2 i + j] is row gid + 8 i (i 0, 1) and key
    // 8 nt + 2 tig + j, whose id and position the thread reads once for
    // both rows, two keys a load
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int kl = nt * 8 + tig * 2;
      int2 kid = make_int2(0, 0), kps = make_int2(0, 0);
      if (by_id) kid = *reinterpret_cast<const int2*>(tseg + kl);
      if (by_pos) kps = *reinterpret_cast<const int2*>(tpos + kl);
      #pragma unroll
      for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[nt][i * 2 + j] * scale_log2;
          if (masked &&
              (kl + j >= kvalid ||
               (by_id && (j ? kid.y : kid.x) != qid[i]) ||
               (by_pos && (j ? kps.y : kps.x) > qp[i])))
            x = kNeg;
          s[nt][i * 2 + j] = x;
        }
    }

    // online softmax of rows gid (i 0) and gid + 8 (i 1) over the tile
    float alpha[2];
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
      #pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        #pragma unroll
        for (int j = 0; j < 2; ++j) mx = fmaxf(mx, s[nt][i * 2 + j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(m_run[i] - mx);
      float rs = 0.f;
      #pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float x = s[nt][i * 2 + j];
          // a masked entry is exactly kNeg; in a row with no visible key
          // yet mx is kNeg too, and exp2(0) must not count
          const float p = (masked && x == kNeg) ? 0.f : exp2f(x - mx);
          s[nt][i * 2 + j] = p;
          rs += p;
        }
      l_run[i] = l_run[i] * alpha[i] + rs;
      m_run[i] = mx;
    }

    // PV = P(bf16) V: the C fragments of n-tiles 2kc, 2kc+1 are the A
    // fragment of k step kc; B is the V tile read MN-major (keys along
    // k, the head dim along n)
    #pragma unroll
    for (int kc = 0; kc < kPC; ++kc)
      acc_to_a(a_p[kc], s[2 * kc], s[2 * kc + 1]);
    float pv[kDT][4];
    tiles::fence_regs(flat(pv));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kPC; ++kc)
      wgmma_rs_t<D>(flat(pv), a_p[kc],
                    desc_mn_sw128(tV + 16 * kc * 128, kBK * 128), kc > 0);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(pv));
    fence_frags(a_p);
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[dt][c] = fmaf(acc[dt][c], alpha[c >> 1], pv[dt][c]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // finalize as the dense branch: O through the warp's own 16 rows of the
  // first stage
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* row = sO + (warp * 16 + gid + 8 * i) * kStride;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
          pack_f32(acc[dt][i * 2] * inv, acc[dt][i * 2 + 1] * inv);
    if (tig == 0 && pos[i] < Sq) {
      lse[(static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i]] =
          l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : kBig;
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * kPieces; i += 32) {
    const int r = warp * 16 + i / kPieces;
    const int c = (i % kPieces) * 8;
    const int p = q0 + r % bq;
    if (p >= Sq) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
    *reinterpret_cast<uint4*>(o + base + c) =
        *reinterpret_cast<const uint4*>(sO + r * kStride + c);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  int B, Sq, Sk, Hq, Hk, causal;
  float sl2;
  Strides qs, ks, vs;
  Seg seg;
  int* kv_bounds;  // the segment branch's workspace
  cudaStream_t s;
};

// the mma.sync kernel: the dense branch at every D, and at D 256 (kSeg)
// the segment branch, after one launch of the key tiles' bounds
template <int D, bool kSeg>
cudaError_t launch_dense(const Args& a) {
  static int allowed = 0;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int bytes = FwdSmem<D>::kBytes +
                    (kSeg ? (2 * kStages * kBK + kSegScratch + nkt) * 4 : 0);
  cudaError_t e =
      allow_dynamic_smem(flash_fwd_kernel<D, kSeg>, bytes, allowed);
  if (e != cudaSuccess) return e;
  if (kSeg) {
    e = launch_bounds(Side{a.seg.kseg, a.seg.kpos, a.kv_bounds, a.Sk},
                      Side{}, a.B, a.s);
    if (e != cudaSuccess) return e;
  }
  const int bq = kFRows / (a.Hq / a.Hk);
  const dim3 grid((a.Sq + bq - 1) / bq, a.Hk, a.B);
  flash_fwd_kernel<D, kSeg><<<grid, kFThreads, bytes, a.s>>>(
      a.q, a.k, a.v, a.o, a.lse, a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.sl2,
      a.qs, a.ks, a.vs, a.seg);
  return cudaGetLastError();
}

// one launch writes the key tiles' bounds into the workspace, then the
// segment kernel reads them
template <int D>
cudaError_t launch_seg(const Args& a) {
  static int allowed = 0;
  using L = SegSmem<D>;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int bytes = L::kBytes + (L::kInts + nkt) * 4;
  cudaError_t e =
      allow_dynamic_smem(flash_fwd_seg_kernel<D>, bytes, allowed);
  if (e != cudaSuccess) return e;
  e = launch_bounds(Side{a.seg.kseg, a.seg.kpos, a.kv_bounds, a.Sk},
                    Side{}, a.B, a.s);
  if (e != cudaSuccess) return e;
  const int bq = kFRows / (a.Hq / a.Hk);
  const dim3 grid((a.Sq + bq - 1) / bq, a.Hk, a.B);
  flash_fwd_seg_kernel<D><<<grid, kFThreads, bytes, a.s>>>(
      a.q, a.k, a.v, a.o, a.lse, a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.sl2,
      a.qs, a.ks, a.vs, a.seg);
  return cudaGetLastError();
}

}  // namespace

// q_seg, kv_seg, q_pos, kv_pos and kv_bounds are NULL on the dense branch;
// otherwise all five are given. kv_bounds is a workspace, int32
// [B, 4, ceil(Sk / 64)], that a first launch fills with the rows id min,
// id max, position min, position max of the 64-key tiles.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* q_seg,
                              const void* kv_seg, const void* q_pos,
                              const void* kv_pos, void* kv_bounds, int B,
                              int Sq, int Sk, int Hq, int Hk, int D,
                              int causal, float scale, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || kFRows % (Hq / Hk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hk = Hk;
  a.causal = causal;
  a.sl2 = scale * kLog2e;
  a.qs = Strides{qsb, qss, qsh};
  a.ks = Strides{ksb, kss, ksh};
  a.vs = Strides{vsb, vss, vsh};
  a.seg = Seg{static_cast<const int*>(q_seg),
              static_cast<const int*>(kv_seg),
              static_cast<const int*>(q_pos),
              static_cast<const int*>(kv_pos), nullptr,
              static_cast<const int*>(kv_bounds)};
  a.kv_bounds = static_cast<int*>(kv_bounds);
  a.s = static_cast<cudaStream_t>(stream);
  const bool segmented = a.seg.qseg != nullptr;
  if (segmented && !(a.seg.kseg && a.seg.qpos && a.seg.kpos && a.kv_bounds))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D != 256 && D != 128 && D != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t e;
  if (D == 256)
    e = segmented ? launch_dense<256, true>(a) : launch_dense<256, false>(a);
  else if (D == 128)
    e = segmented ? launch_seg<128>(a) : launch_dense<128, false>(a);
  else
    e = segmented ? launch_seg<64>(a) : launch_dense<64, false>(a);
  return static_cast<int>(e);
}
