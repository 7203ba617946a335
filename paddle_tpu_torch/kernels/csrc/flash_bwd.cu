// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV, bf16 in
// (at D 64/128 also fp16, and float32 as three bf16 pieces), f32
// accumulate.
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
// [B, Sq, Hq, D], dK/dV [B, Sk, Hk, D] bf16, contiguous. D is 64, 128,
// 256 or a multiple of 128 above 256 (the wrapper zero-pads any other D to
// the next of these, as the Pallas kernel pads D to a multiple of 128);
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
// fp16 and float32 at D 64/128: the same two kernels, template arguments
// T (element type) and P (pieces). fp16 (T = __half, P = 1) is the bf16
// design on wgmma's `.f16` forms, P and dS rounded to fp16 (the Pallas
// kernels cast P to dO's dtype and dS to q's). float32 (P = 3) takes each
// operand as three bf16 pieces b0 = bf16(x), b1 = bf16(x - b0), b2 =
// bf16(x - b0 - b1), whose sum is x (`split_bf16x3_kernel`, a
// bytes-bound pass the wrapper runs on q, k, v and dO first: 4 bytes read
// and 6 written an element). Each of S, dP, dQ, dK and dV is the six
// products of pieces whose indices sum to at most 2, the small ones first
// and b0 b0 last, into one f32 accumulator (the three dropped are ~2^-24
// of the product); P and dS are split in registers where the bf16 kernels
// round them; dQ, dK and dV leave in float32.
// - What bounds it: the tensor cores at 989 / 6 = 165 TFLOP/s of float32
//   products, 2.5x the CUDA cores' 67 (flash_simt.cu, which keeps the
//   head dims above 128).
// - Why bf16 pieces and not TF32 (3xTF32): wgmma reads an operand from
//   shared memory transposed (MN-major) only for 16-bit types, and dQ +=
//   dS K, dK += dS^T Q and dV += P^T dO read K, Q and dO MN-major, so tf32
//   would need K-major copies of those tiles. The pieces keep the bf16
//   layout and descriptors as they are.
// - Three pieces triple every staged tile and A fragment: at P 3 dQ's Q
//   and dO stay in shared memory and wgmma reads them there (SS), and a
//   ring stage holds half a tile, 32 keys (dQ) or queries (dK/dV): 192
//   KiB of shared memory at D 128 (one CTA an SM), 96 KiB at D 64 (two).
//   The pair class, the masks and the cluster split of dK/dV are the bf16
//   kernels'.
//
// Head dim 256 (`flash_bwd_dq_256_kernel`, `flash_bwd_dkv_256_kernel`;
// Gemma's heads are 256 wide, and the wrapper pads D 129-255 to it). A
// warp's 16 rows of one f32 accumulator 256 wide are 128 registers a
// thread, so one warpgroup cannot hold dQ beside S and dP, nor dK and dV
// together. Each CTA runs two warpgroups (256 threads) and splits the
// head dim's accumulators between them by columns:
// - B2: one CTA owns 64 folded rows as at D 64/128. Q and dO are staged
//   once (swizzled, 64 KiB), K/V tiles stream through a two-stage ring
//   (128 KiB). Warpgroup w computes S and dP for keys 32w .. 32w + 31 of
//   the tile over all 64 rows (m64n32, both operands from shared memory),
//   P and dS in registers, and writes dS as bf16 into a swizzled [64][64]
//   tile (8 KiB); after one barrier each warpgroup runs dQ[:, 128w ..] +=
//   dS K[:, 128w ..] (m64n128, A the whole dS from shared memory, B the K
//   tile MN-major): 64 accumulator registers a thread.
// - B3: one CTA owns one 64-key tile and both dK and dV: four products a
//   (query, key) pair and S^T once. K and V stay staged (64 KiB), (query
//   tile, head) steps stream Q and dO through the ring (128 KiB);
//   warpgroup w computes S^T and dP^T for queries 32w .. 32w + 31, P^T
//   and dS^T go to shared memory as bf16
//   (8 KiB each), and each warpgroup accumulates the 128-column half w of
//   both dV += P^T dO and dK += dS^T Q: 128 accumulator registers.
// The key (or query) split keeps the two warpgroups' work equal in every
// phase and passes only what the products read (P and dS in bf16, each
// rounded once, from f32 P and dP as at D 64/128); splitting S and dP
// between the warpgroups instead would pass P or dP across before dS
// could be formed. 200 KiB (B2) and 209 KiB (B3) of shared memory: one CTA
// an SM. B3 takes the cluster of the narrower kernel (C ranks split the
// group's heads; the f32 partial sums, 132 KiB, land over the drained
// rings and meet in distributed shared memory in rank order): at B 1,
// Hk 4, S 2048 its grid is 128 CTAs, one wave, and without the split the
// first key tile's CTA walks twice the mean's steps. With C 1 the sums
// leave as bf16 rows instead (the f32 path read 8 % slower at a
// 512-CTA packed row on the H100). The segment branch
// is the kSeg instantiation (the pair lists of the kernels above, reduced
// over 256 threads).
//
// Head dims above 256 (`flash_bwd_dq_xl_kernel`, `flash_bwd_dkv_xl_kernel`;
// D a multiple of 128, as the Pallas kernel pads it): whole 64-row tiles
// of D 512 do not fit (Q 64 KiB, a two-stage K ring 128 KiB, V more), so
// the contraction over the head dim streams in chunks.
// - B2: each CTA owns one 128-column slice of dQ and walks its key tiles
//   chunk by chunk: a ring stage holds one chunk of Q, dO, K and V (64
//   KiB), S and dP sum over the chunks in wgmma accumulators, and the
//   slice's own chunk comes last, so dQ += dS K reads its K chunk from the
//   stage it is already in. The CTAs of one row block recompute S and dP
//   each, identically: D / 128 times the products of S and dP, and no
//   atomics. A first version that is right, not a fast one.
// - B3 applies the D 256 kernel's layout to wider slices: a CTA of two
//   warpgroups owns a slice of up to 256 columns of dK and dV (a multiple
//   of 64; 192 + 192 at D 384, 256 + 256 at D 512, three of 256 at D 640,
//   the last half past D), so S^T and dP^T are recomputed ceil(D / 256)
//   times, not D / 64 as when a CTA owned 64 columns (1.717 ms at D 384,
//   2.779 at D 512 on the H100). Per step S^T and dP^T are computed once
//   a CTA, split between the warpgroups by queries; their contraction
//   over D takes the chunks outside the slice through the ring (K, V, Q
//   and dO, 32 KiB a stage) and then the slice's own from the key tile's
//   K/V slices, resident, and the step's Q/dO slices, loaded while the
//   step's first chunks are worked on. Only bf16 P^T and dS^T cross
//   between the warpgroups; warpgroup 0 accumulates dV and warpgroup 1 dK
//   over the whole slice (m64n192 or m64n256, both operands from shared
//   memory). 208 KiB of shared memory at W 256: one CTA an SM.
//
#include <cooperative_groups.h>

#include <algorithm>

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

constexpr int kBQ = 64;        // query rows per step of the dK/dV kernel
constexpr int kStages = 2;     // ring depth
constexpr int kMaxCluster = 8;  // the portable cluster size

// the element type of a kernel's outputs: the inputs' at P 1, float32 when
// the inputs are three bf16 pieces of float32 operands
template <typename T, int P>
using OutT = std::conditional_t<P == 1, T, float>;

// element strides between the P pieces of q, k, v and dO (0 at P 1): the
// pieces of a float32 operand are [3, B, S, H, D] bf16, contiguous
struct PieceStrides {
  long long q, k, v, d;
};

// keys (dQ) or queries (dK/dV) a ring stage holds: a whole 64-row tile
// at P 1, half of one at P 3 (three pieces of every tile would not fit two
// stages beside the resident operands at D 128)
template <int P>
constexpr int kStageRows = P == 1 ? kBK : kBK / 2;

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D, int P = 1>
struct DqSmem {
  static constexpr int kKeys = kStageRows<P>;   // keys a ring stage
  static constexpr int kPiece = kKeys * D * 2;  // bytes of a swizzled piece
  static constexpr int kTile = P * kPiece;      // a stage's K (or V) pieces
  static constexpr int kStride = D + 8;         // P 1: elements a Q/dO row
  // Q or dO, folded rows: padded rows at P 1 (read once into registers),
  // P swizzled pieces at P 3 (wgmma reads them from shared memory)
  static constexpr int kQ = P == 1 ? kRows * kStride : P * kRows * D;
  // the K ring, the V ring (1024-byte aligned), then Q and dO
  static constexpr int kBytes = 2 * kStages * kTile + 2 * kQ * 2;
  // the segment branch's ints after those: each stage's kv ids and
  // positions, scratch, then the list of live key tiles (one per tile)
  static constexpr int kSegInts = 2 * kStages * kKeys + kSegScratch;
};

// P (masked when kMask), then dS = P (dP - Delta) scale into s, for one
// sub-tile of kNT * 8 keys starting at key `key0` (`kl0` into the staged
// ids and positions). kSeg masks by the staged ids and positions (tseg,
// tpos: the stage's) against the rows' (qid, qp); otherwise by the end of
// the keys and the bottom-right diagonal.
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

// T: the element type of q, k, v, dO (bf16 or fp16); P: 1, or 3 when they
// are the three bf16 pieces of float32 operands (every product then the
// six terms of first_term(3) .. 5, dS split in registers, dQ float32)
template <typename T, int P, int D, bool kSeg>
__global__ void __launch_bounds__(kThreads, P == 1 || D == 64 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    OutT<T, P>* __restrict__ dq, int B, int Sq, int Sk,
                    int Hq, int Hk, int causal, float scale,
                    float scale_log2, Strides qs, Strides ks, Strides vs,
                    Strides dos, PieceStrides pc, Seg seg) {
  using L = DqSmem<D, P>;
  constexpr int kStride = L::kStride;
  constexpr int kKeys = L::kKeys;
  constexpr int kHalves = kBK / kKeys;  // ring stages a key tile
  constexpr int kKC = D / 16;     // k-chunks over the head dim
  constexpr int kDT = D / 8;      // n-tiles over the head dim
  // keys per sub-step (S, dP m64n32): 64 at D 64 gave wrong dQ on every
  // CTA that walks two or more key tiles, for a reason not found
  constexpr int kSub = 32;
  constexpr int kSNT = kSub / 8;  // n-tiles over a sub-step's keys
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  constexpr int kT0 = first_term(P);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;               // [stage] K pieces
  unsigned char* sV = sK + kStages * L::kTile;
  T* sQ = reinterpret_cast<T*>(sV + kStages * L::kTile);
  T* sD = sQ + L::kQ;                         // dO
  // segment branch only: [stage][kKeys] kv ids, then positions, scratch
  // and the live tile list
  int* sKseg = reinterpret_cast<int*>(sD + L::kQ);
  int* sKpos = sKseg + kStages * kKeys;
  int* sScratch = sKpos + kStages * kKeys;
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
  // q0 + r % bq); at P 3 each piece swizzled, piece p at p kRows D
  if constexpr (P == 1) {
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
  } else {
    for (int i = tid; i < P * kRows * kPieces; i += kThreads) {
      const int p = i / (kRows * kPieces);
      const int r = (i / kPieces) % kRows;
      const int c8 = i % kPieces;
      const int pos = q0 + r % bq;
      const int head = kvh * G + r / bq;
      const bool ok = pos < Sq;
      const int at = p * kRows * D * 2 + swz<kRows>(r, c8);
      cp_async16(reinterpret_cast<unsigned char*>(sQ) + at,
                 ok ? q + p * pc.q + qs.at(b, pos, head) + 8 * c8 : q, ok);
      cp_async16(reinterpret_cast<unsigned char*>(sD) + at,
                 ok ? dout + p * pc.d + dos.at(b, pos, head) + 8 * c8 : dout,
                 ok);
    }
  }
  cp_async_commit();

  // key tiles this CTA walks: up to the diagonal of its last live row;
  // with segments, the list of live pairs (sList); kHalves ring steps a
  // tile (dense: none past the last key a row sees)
  const int q_hi = min(q0 + bq, Sq) - 1;
  int nsteps;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds(seg.qseg + at, seg.qpos + at,
                                   q_hi + 1 - q0, sScratch);
    nsteps = kHalves *
             live_pairs<true>(seg.kb + static_cast<size_t>(b) * 4 * nkt,
                              nkt, mine, causal, sList, sScratch);
  } else {
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    nsteps = (kend + kKeys - 1) / kKeys;
  }
  // the list entry of the n-th tile (the tile, flagged kFull if unmasked)
  auto entry_of = [&](int n) {
    if constexpr (kSeg) return sList[n];
    else return n;
  };
  // the first key of ring step n
  auto key_of = [&](int n) {
    return (entry_of(n / kHalves) & (kFull - 1)) * kBK +
           (n % kHalves) * kKeys;
  };

  auto load_kv = [&](int n, int st) {
    const int kb0 = key_of(n);
    unsigned char* dk = sK + st * L::kTile;
    unsigned char* dv = sV + st * L::kTile;
    if constexpr (kSeg) {  // threads 0 .. kKeys - 1 copy the ids, the
      if (P == 1 || tid < 2 * kKeys) {  // next kKeys the positions
        const int i = tid % kKeys;
        const int key = kb0 + i;
        const bool ok = key < Sk;
        const int* src = tid < kKeys ? seg.kseg : seg.kpos;
        int* dst = (tid < kKeys ? sKseg : sKpos) + st * kKeys;
        cp_async4(dst + i,
                  ok ? src + static_cast<size_t>(b) * Sk + key : src, ok);
      }
    }
    for (int i = tid; i < P * kKeys * kPieces; i += kThreads) {
      const int p = P == 1 ? 0 : i / (kKeys * kPieces);
      const int r = P == 1 ? i / kPieces : (i / kPieces) % kKeys;
      const int c8 = i % kPieces;
      const int key = kb0 + r;
      const bool ok = key < Sk;
      const int at = p * L::kPiece + swz<kKeys>(r, c8);
      cp_async16(dk + at, ok ? k + p * pc.k + ks.at(b, key, kvh) + 8 * c8 : k,
                 ok);
      cp_async16(dv + at, ok ? v + p * pc.v + vs.at(b, key, kvh) + 8 * c8 : v,
                 ok);
    }
  };
  if (nsteps > 0) load_kv(0, 0);
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
  // P 1: each warp keeps its 16 rows' Q and dO fragments in registers, the
  // A operands of S and dP (at P 3 wgmma reads them from shared memory)
  uint32_t qf[P == 1 ? kKC : 1][4], df[P == 1 ? kKC : 1][4];
  if constexpr (P == 1) {
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      const int at = (warp * 16 + (lane & 15)) * kStride + kc * 16 +
                     8 * (lane >> 4);
      ldsm_x4(qf[kc], sQ + at);
      ldsm_x4(df[kc], sD + at);
    }
  }
  const unsigned char* pQ = reinterpret_cast<const unsigned char*>(sQ);
  const unsigned char* pD = reinterpret_cast<const unsigned char*>(sD);

  // dQ, written by wgmma only (the first product starts it: a non-wgmma
  // write would make ptxas serialize the products), and the A fragments
  // of dS (each piece's), kept until the product that reads them retires
  float acc[kDT][4];
  uint32_t a_ds[P][kSub / 16][4];
  bool started = false;

  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait<kStages - 2>();  // step n's tile has landed
    tiles::fence_proxy_async();    // ... where wgmma reads it
    __syncthreads();  // ... for every thread, and step n - 1's is consumed
    if (n + 1 < nsteps) load_kv(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const unsigned char* tK = sK + st * L::kTile;
    const unsigned char* tV = sV + st * L::kTile;
    const int entry = entry_of(n / kHalves);
    const int t0 = (entry & (kFull - 1)) * kBK;
    const int kb0 = key_of(n);
    // a tile past the end of the keys is always masked
    bool full_tile;
    if constexpr (kSeg)
      full_tile = (entry & kFull) && t0 + kBK <= Sk;
    else
      full_tile = t0 + kBK <= Sk && !(causal && t0 + kBK - 1 > q0 + off);

    #pragma unroll
    for (int s0 = 0; s0 < kKeys; s0 += kSub) {
      const int key0 = kb0 + s0;
      // a dense sub-tile no row of the CTA sees adds nothing
      if (!kSeg && (key0 >= Sk || (causal && key0 > q_hi + off)))
        continue;
      // S = Q K^T and dP = dO V^T for the CTA's 64 rows x kSub keys: one
      // warpgroup's wgmma, A (Q, dO) from the fragments in registers (P
      // 1) or the staged pieces (P 3), B (K, V) from the swizzled stage;
      // each warp gets its 16 rows back in mma.sync's C layout
      float s[kSNT][4], dp[kSNT][4];
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));
      tiles::wgmma_fence();
      if constexpr (P == 1) {
        #pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          wgmma_rs_n32<T>(flat(s), qf[kc], kstep_desc<kBK>(tK, s0, kc), kc);
        #pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          wgmma_rs_n32<T>(flat(dp), df[kc], kstep_desc<kBK>(tV, s0, kc),
                          kc);
      } else {
        #pragma unroll
        for (int t = kT0; t < 6; ++t)
          #pragma unroll
          for (int kc = 0; kc < kKC; ++kc)
            wgmma_ss_n32(flat(s),
                         kstep_desc<kRows>(pQ + term_a(t) * kRows * D * 2,
                                           0, kc),
                         kstep_desc<kKeys>(tK + term_b(t) * L::kPiece, s0,
                                           kc),
                         t > kT0 || kc > 0);
        #pragma unroll
        for (int t = kT0; t < 6; ++t)
          #pragma unroll
          for (int kc = 0; kc < kKC; ++kc)
            wgmma_ss_n32(flat(dp),
                         kstep_desc<kRows>(pD + term_a(t) * kRows * D * 2,
                                           0, kc),
                         kstep_desc<kKeys>(tV + term_b(t) * L::kPiece, s0,
                                           kc),
                         t > kT0 || kc > 0);
      }
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));

      const bool masked =
          !full_tile &&
          (kSeg || key0 + kSub > Sk || (causal && key0 + kSub - 1 > q0 + off));
      const int* tseg = sKseg + st * kKeys;
      const int* tpos = sKpos + st * kKeys;
      if (masked)
        dq_scores<true, kSeg>(s, dp, pos, lse2, dlt, key0, s0, Sk, causal,
                              off, scale_log2, scale, tig, tseg, tpos, qid,
                              qp);
      else
        dq_scores<false, kSeg>(s, dp, pos, lse2, dlt, key0, s0, Sk, causal,
                               off, scale_log2, scale, tig, tseg, tpos, qid,
                               qp);

      // dQ += dS K: the dS accumulators of n-tiles 2kc, 2kc+1 are the A
      // fragment (each piece's) of k step kc; B is the K stage read
      // MN-major (keys along k, the head dim along n). Retired before the
      // sub-step ends: left in flight across the loop's back edge, its
      // accumulators came out wrong (the compiler may move them there).
      #pragma unroll
      for (int kc = 0; kc < kSub / 16; ++kc)
        acc_to_pieces<T>(a_ds, kc, s[2 * kc], s[2 * kc + 1]);
      tiles::wgmma_fence();
      #pragma unroll
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kSub / 16; ++kc)
          wgmma_rs_t<D, T>(
              flat(acc), a_ds[term_a(t)][kc],
              desc_mn_sw128(tK + term_b(t) * L::kPiece +
                                (s0 + 16 * kc) * 128,
                            kKeys * 128),
              started || t > kT0 || kc > 0);
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

  if constexpr (P == 1) {
    // dQ through the warp's own 16 rows of sQ (only this warp read them)
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* row = sQ + (warp * 16 + gid + 8 * i) * kStride;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
            pack2<T>(acc[dt][i * 2], acc[dt][i * 2 + 1]);
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
  } else {
    // float32 dQ rows over the drained K ring, then out 16 bytes a store
    constexpr int kFS = D + 4;  // floats a staged row
    static_assert(kRows * kFS * 4 <= kStages * L::kTile, "room for dQ");
    float* f = reinterpret_cast<float*>(smem_raw);
    __syncthreads();  // every warp is done with the ring
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = f + (warp * 16 + gid + 8 * i) * kFS;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(row + dt * 8 + tig * 2) =
            make_float2(acc[dt][i * 2], acc[dt][i * 2 + 1]);
    }
    __syncthreads();
    constexpr int kQuads = D / 4;
    for (int i = tid; i < kRows * kQuads; i += kThreads) {
      const int r = i / kQuads;
      const int c = (i % kQuads) * 4;
      const int p = q0 + r % bq;
      if (p >= Sq) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
      *reinterpret_cast<float4*>(dq + base + c) =
          *reinterpret_cast<const float4*>(f + r * kFS + c);
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D, int P = 1>
struct DkvSmem {
  static constexpr int kQs = kStageRows<P>;  // queries a ring stage
  static constexpr int kKV = kBK * D * 2;    // bytes of a swizzled K or V piece
  static constexpr int kQ = kQs * D * 2;     // ... of a Q or dO piece
  // K, V (P pieces each), then the ring: [stage][piece] Q tiles, [stage]
  // [piece] dO tiles (all 1024-byte aligned); [stage] LSE, Delta rows
  static constexpr int kTiles = 2 * P * kKV + 2 * kStages * P * kQ;
  static constexpr int kBytes = kTiles + 2 * kStages * kQs * 4;
  // the f32 dK, dV of the tile ([64][D + 8] each), over K, V and the
  // drained ring
  static constexpr int kAccStride = D + 8;
  static_assert(2 * kBK * kAccStride * 4 <= kTiles, "room for dK, dV");
  // the segment branch's ints after those: each stage's query ids and
  // positions, scratch, then the list of live query tiles
  static constexpr int kSegInts = 2 * kStages * kQs + kSegScratch;
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

// T, P as flash_bwd_dq_kernel's; at P 3 dK and dV are float32
template <typename T, int P, int D, bool kSeg>
// P 1: three CTAs an SM at D 64 (at most 168 registers a thread), two at
// 128; P 3: two at D 64, one at 128 (197 KiB of shared memory)
__global__ void __launch_bounds__(kThreads,
                                  P == 1 ? (D == 64 ? 3 : 2)
                                         : (D == 64 ? 2 : 1))
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     OutT<T, P>* __restrict__ dk, OutT<T, P>* __restrict__ dv,
                     int B, int Sq, int Sk, int Hq, int Hk, int causal,
                     float scale, float scale_log2, Strides qs, Strides ks,
                     Strides vs, Strides dos, PieceStrides pc, Seg seg) {
  using L = DkvSmem<D, P>;
  constexpr int kQs = L::kQs;
  constexpr int kHalves = kBQ / kQs;  // ring steps a (query tile, head)
  constexpr int kKC = D / 16;
  constexpr int kDT = D / 8;
  constexpr int kQH = 32;  // queries per sub-step (S^T, dP^T m64n32)
  constexpr int kQNT = kQH / 8;            // n-tiles over a sub-step
  constexpr int kPieces = D / 8;
  constexpr int kT0 = first_term(P);
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sK = smem;                      // P swizzled [kBK][D]
  unsigned char* sV = sK + P * L::kKV;
  unsigned char* sQ = sV + P * L::kKV;           // [stage][piece] [kQs][D]
  unsigned char* sD = sQ + kStages * P * L::kQ;  // [stage][piece] dO
  float* sL = reinterpret_cast<float*>(sD + kStages * P * L::kQ);  // [stage]
  float* sDelta = sL + kStages * kQs;                              // [stage]
  int* sQseg = reinterpret_cast<int*>(sDelta + kStages * kQs);  // segments
  int* sQpos = sQseg + kStages * kQs;
  int* sScratch = sQpos + kStages * kQs;
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

  for (int i = tid; i < P * kBK * kPieces; i += kThreads) {
    const int p = P == 1 ? 0 : i / (kBK * kPieces);
    const int r = P == 1 ? i / kPieces : (i / kPieces) % kBK;
    const int c8 = i % kPieces;
    const int key = k0 + r;
    const bool ok = key < Sk;
    const int at = p * L::kKV + swz<kBK>(r, c8);
    cp_async16(sK + at, ok ? k + p * pc.k + ks.at(b, key, kvh) + 8 * c8 : k,
               ok);
    cp_async16(sV + at, ok ? v + p * pc.v + vs.at(b, key, kvh) + 8 * c8 : v,
               ok);
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
  const int nsteps = ntiles * Gc * kHalves;
  auto entry_of = [&](int t) {
    if constexpr (kSeg) return sList[t];
    else return qt0 + t;
  };

  // step n: query tile n / (Gc kHalves), head kvh G + g0 + n / kHalves %
  // Gc, its queries from n % kHalves kQs
  auto load_q = [&](int n, int st) {
    const int m = n / kHalves;
    const int qb0 = (entry_of(m / Gc) & (kFull - 1)) * kBQ +
                    (n % kHalves) * kQs;
    const int head = kvh * G + g0 + m % Gc;
    unsigned char* dq_ = sQ + st * P * L::kQ;
    unsigned char* dd = sD + st * P * L::kQ;
    for (int i = tid; i < P * kQs * kPieces; i += kThreads) {
      const int p = P == 1 ? 0 : i / (kQs * kPieces);
      const int r = P == 1 ? i / kPieces : (i / kPieces) % kQs;
      const int c8 = i % kPieces;
      const int pos = qb0 + r;
      const bool ok = pos < Sq;
      const int at = p * L::kQ + swz<kQs>(r, c8);
      cp_async16(dq_ + at,
                 ok ? q + p * pc.q + qs.at(b, pos, head) + 8 * c8 : q, ok);
      cp_async16(dd + at,
                 ok ? dout + p * pc.d + dos.at(b, pos, head) + 8 * c8 : dout,
                 ok);
    }
    // threads 0 .. kQs - 1 copy LSE, the next kQs Delta (0 past Sq); on
    // the segment branch also the rows' ids and positions
    if (P == 1 || tid < 2 * kQs) {
      const int r = tid % kQs;
      const int pos = qb0 + r;
      const bool ok = pos < Sq;
      const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos;
      const float* src = tid < kQs ? lse : delta;
      cp_async4((tid < kQs ? sL : sDelta) + st * kQs + r,
                ok ? src + row : src, ok);
      if constexpr (kSeg) {
        const int* isrc = tid < kQs ? seg.qseg : seg.qpos;
        cp_async4((tid < kQs ? sQseg : sQpos) + st * kQs + r,
                  ok ? isrc + static_cast<size_t>(b) * Sq + pos : isrc, ok);
      }
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
  // P^T and dS^T (each piece's), kept until the products that read them
  // retire
  float dka[kDT][4], dva[kDT][4];
  uint32_t a_p[P][kQH / 16][4], a_ds[P][kQH / 16][4];
  bool started = false;

  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait<kStages - 2>();  // step n's tiles (and K/V) have landed
    tiles::fence_proxy_async();    // ... where wgmma reads them
    __syncthreads();
    if (n + 1 < nsteps) load_q(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const unsigned char* tQ = sQ + st * P * L::kQ;
    const unsigned char* tD = sD + st * P * L::kQ;
    const int entry = entry_of(n / kHalves / Gc);
    const int q0 = (entry & (kFull - 1)) * kBQ;
    const int qb0 = q0 + (n % kHalves) * kQs;
    bool full_tile;
    if constexpr (kSeg)
      full_tile = entry & kFull;
    else
      full_tile = !(causal && k0 + kBK - 1 > q0 + off);

    #pragma unroll 1
    for (int r0 = 0; r0 < kQs; r0 += kQH) {
      const int qr = qb0 + r0;  // the sub-step's first query
      // a dense sub-step whose rows are all past Sq, or see no key of the
      // tile, adds nothing
      if (!kSeg && (qr >= Sq || (causal && qr + kQH - 1 + off < k0)))
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
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          wgmma_ss_n32<T>(flat(s),
                          kstep_desc<kBK>(sK + term_a(t) * L::kKV, 0, kc),
                          kstep_desc<kQs>(tQ + term_b(t) * L::kQ, r0, kc),
                          t > kT0 || kc > 0);
      #pragma unroll
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          wgmma_ss_n32<T>(flat(dp),
                          kstep_desc<kBK>(sV + term_a(t) * L::kKV, 0, kc),
                          kstep_desc<kQs>(tD + term_b(t) * L::kQ, r0, kc),
                          t > kT0 || kc > 0);
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));

      const bool masked =
          !full_tile && (kSeg || (causal && k0 + kBK - 1 > qr + off));
      const float* tL = sL + st * kQs + r0;
      const float* tDl = sDelta + st * kQs + r0;
      const int* tseg = sQseg + st * kQs + r0;
      const int* tpos = sQpos + st * kQs + r0;
      if (masked)
        dkv_scores<true, kSeg>(s, dp, tL, tDl, tseg, tpos, qr, key, kid, kp,
                               causal, off, scale_log2, scale, tig);
      else
        dkv_scores<false, kSeg>(s, dp, tL, tDl, tseg, tpos, qr, key, kid,
                                kp, causal, off, scale_log2, scale, tig);

      // dV += P^T dO and dK += dS^T Q: A from the P^T and dS^T
      // accumulators (each piece's), B the staged dO and Q rows read
      // MN-major (queries along k, the head dim along n); retired before
      // the sub-step ends, as dQ's
      #pragma unroll
      for (int kc = 0; kc < kQH / 16; ++kc) {
        acc_to_pieces<T>(a_p, kc, s[2 * kc], s[2 * kc + 1]);
        acc_to_pieces<T>(a_ds, kc, dp[2 * kc], dp[2 * kc + 1]);
      }
      tiles::wgmma_fence();
      #pragma unroll
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kQH / 16; ++kc) {
          const int at = (r0 + 16 * kc) * 128;
          const int go = started || t > kT0 || kc > 0;
          wgmma_rs_t<D, T>(flat(dva), a_p[term_a(t)][kc],
                           desc_mn_sw128(tD + term_b(t) * L::kQ + at,
                                         kQs * 128),
                           go);
          wgmma_rs_t<D, T>(flat(dka), a_ds[term_a(t)][kc],
                           desc_mn_sw128(tQ + term_b(t) * L::kQ + at,
                                         kQs * 128),
                           go);
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
  // and stores them 4 elements at a time
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
    OutT<T, P>* out = (which ? dv : dk) +
                      ((static_cast<size_t>(b) * Sk + kj) * Hk + kvh) * D +
                      col;
    if constexpr (P == 1)
      *reinterpret_cast<uint2*>(out) =
          make_uint2(pack2<T>(sum.x, sum.y), pack2<T>(sum.z, sum.w));
    else
      *reinterpret_cast<float4*>(out) = sum;
  }
  if (C > 1) cluster.sync();  // no rank leaves while another reads it
}

// ---------------------------------------------------------------------------
// head dim 256: two warpgroups, every product on wgmma
// ---------------------------------------------------------------------------

constexpr int kT2 = 2 * kThreads;              // two warpgroups
constexpr int kScratch2 = seg_scratch<kT2>();  // block_bounds, live_pairs

// the 4-byte pair of bf16 at (row, col), col even, of a swizzled tile of
// 64-column rows
__device__ __forceinline__ uint32_t* swz_pair(unsigned char* tile, int row,
                                              int col) {
  return reinterpret_cast<uint32_t*>(
      tile + tiles::sw128_offset(row, col >> 3) + (col & 7) * 2);
}

// a warp's C fragments of kNT 8-column n-tiles (its 16 rows from row0),
// rounded to bf16, into a swizzled [64][64] tile at column c0: where the
// other warpgroup's products read them
template <int kNT>
__device__ __forceinline__ void put_pairs(unsigned char* tile,
                                          const float (&x)[kNT][4], int row0,
                                          int c0, int gid, int tig) {
  #pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    #pragma unroll
    for (int i = 0; i < 2; ++i)
      *swz_pair(tile, row0 + gid + 8 * i, c0 + nt * 8 + 2 * tig) =
          pack_f32(x[nt][2 * i], x[nt][2 * i + 1]);
}

// a warpgroup's [64 x 128] f32 accumulator (m64n128: warp w's 16 rows)
// into columns c0 .. c0 + 127 of a padded bf16 staging area [64][kSS]
template <int kSS>
__device__ __forceinline__ void stage_half(__nv_bfloat16* stage,
                                           const float (&acc)[16][4],
                                           int warp, int c0, int gid,
                                           int tig) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* row = stage + (warp * 16 + gid + 8 * i) * kSS + c0;
    #pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
          pack_f32(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
}

struct Dq256Smem {
  static constexpr int D = 256;
  static constexpr int kTile = kBK * D * 2;  // a swizzled [64][256] tile
  // Q, dO, the K ring, the V ring, then dS (a swizzled [64][64]); all
  // 1024-byte aligned
  static constexpr int kQ = 0;
  static constexpr int kDo = kTile;
  static constexpr int kK = 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kDS = kV + kStages * kTile;
  static constexpr int kBytes = kDS + kBK * 128;
  // the segment branch's ints after those: each stage's kv ids and
  // positions, scratch, then the list of live key tiles
  static constexpr int kSegInts = 2 * kStages * kBK + kScratch2;
  // dQ leaves through padded bf16 rows over the K ring
  static constexpr int kSS = D + 8;
  static_assert(kRows * kSS * 2 <= kStages * kTile, "room for dQ");
};

template <bool kSeg>
__global__ void __launch_bounds__(kT2, 1)
flash_bwd_dq_256_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int B, int Sq,
                        int Sk, int Hq, int Hk, int causal, float scale,
                        float scale_log2, Strides qs, Strides ks,
                        Strides vs, Strides dos, Seg seg) {
  using L = Dq256Smem;
  constexpr int D = L::D;
  constexpr int kKC = D / 16;     // k steps of S and dP
  constexpr int kHalf = kBK / 2;  // keys of one warpgroup's S and dP
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sQ = smem_raw + L::kQ;
  unsigned char* sD = smem_raw + L::kDo;
  unsigned char* sK = smem_raw + L::kK;  // [stage] swizzled [kBK][D]
  unsigned char* sV = smem_raw + L::kV;
  unsigned char* sDS = smem_raw + L::kDS;
  int* sKseg = reinterpret_cast<int*>(smem_raw + L::kBytes);
  int* sKpos = sKseg + kStages * kBK;
  int* sScratch = sKpos + kStages * kBK;
  int* sList = sScratch + kScratch2;

  const int G = Hq / Hk;
  const int bq = kRows / G;
  const int nqb = (Sq + bq - 1) / bq;
  const int hb = blockIdx.x % (Hk * B);
  const int kvh = hb % Hk;
  const int b = hb / Hk;
  const int q0 = (nqb - 1 - static_cast<int>(blockIdx.x) / (Hk * B)) * bq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;           // warpgroup
  const int warp = (tid >> 5) & 3;   // warp of the warpgroup: 16 rows
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;
  const int kofs = wg * kHalf;       // this warpgroup's keys of a tile

  // stage Q and dO, swizzled: folded row r is (head kvh G + r / bq,
  // position q0 + r % bq)
  for (int i = tid; i < kRows * kPieces; i += kT2) {
    const int r = i / kPieces;
    const int c8 = i % kPieces;
    const int pos = q0 + r % bq;
    const int head = kvh * G + r / bq;
    const bool ok = pos < Sq;
    cp_async16(sQ + swz<kRows>(r, c8),
               ok ? q + qs.at(b, pos, head) + 8 * c8 : q, ok);
    cp_async16(sD + swz<kRows>(r, c8),
               ok ? dout + dos.at(b, pos, head) + 8 * c8 : dout, ok);
  }
  cp_async_commit();

  const int q_hi = min(q0 + bq, Sq) - 1;
  int ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds<kT2>(seg.qseg + at, seg.qpos + at,
                                        q_hi + 1 - q0, sScratch);
    ntiles = live_pairs<true, false, kT2>(
        seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, mine, causal, sList,
        sScratch);
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
    unsigned char* dk = sK + st * L::kTile;
    unsigned char* dv = sV + st * L::kTile;
    if (kSeg && tid < 2 * kBK) {  // threads 0-63 the ids, 64-127 positions
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                ok);
    }
    for (int i = tid; i < kBK * kPieces; i += kT2) {
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

  // the two rows this thread owns in the wgmma layout (the same in both
  // warpgroups), with their LSE (log2 domain), Delta, id and position
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

  // dQ[:, 128 wg .. 128 wg + 127], written by wgmma only
  float acc[16][4];
  bool started = false;

  for (int n = 0; n < ntiles; ++n) {
    cp_async_wait<kStages - 2>();  // step n's tile (and Q, dO) landed
    tiles::fence_proxy_async();    // ... where wgmma reads it
    // ... for every thread; step n - 1's tile and dS are consumed
    __syncthreads();
    if (n + 1 < ntiles) load_kv(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const unsigned char* tK = sK + st * L::kTile;
    const unsigned char* tV = sV + st * L::kTile;
    const int entry = entry_of(n);
    const int t0 = (entry & (kFull - 1)) * kBK;
    bool full_tile;
    if constexpr (kSeg)
      full_tile = (entry & kFull) && t0 + kBK <= Sk;
    else
      full_tile = t0 + kBK <= Sk && !(causal && t0 + kBK - 1 > q0 + off);

    // S = Q K^T and dP = dO V^T for the 64 rows x this warpgroup's 32
    // keys: both operands from shared memory
    float s[kHalf / 8][4], dp[kHalf / 8][4];
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n32(flat(s), kstep_desc<kRows>(sQ, 0, kc),
                   kstep_desc<kBK>(tK, kofs, kc), kc);
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n32(flat(dp), kstep_desc<kRows>(sD, 0, kc),
                   kstep_desc<kBK>(tV, kofs, kc), kc);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));

    const bool masked =
        !full_tile && (kSeg || t0 + kofs + kHalf > Sk ||
                       (causal && t0 + kofs + kHalf - 1 > q0 + off));
    const int* tseg = sKseg + st * kBK;
    const int* tpos = sKpos + st * kBK;
    if (masked)
      dq_scores<true, kSeg>(s, dp, pos, lse2, dlt, t0 + kofs, kofs, Sk,
                            causal, off, scale_log2, scale, tig, tseg, tpos,
                            qid, qp);
    else
      dq_scores<false, kSeg>(s, dp, pos, lse2, dlt, t0 + kofs, kofs, Sk,
                             causal, off, scale_log2, scale, tig, tseg, tpos,
                             qid, qp);
    // dS (bf16) of both halves meets in shared memory
    put_pairs(sDS, s, warp * 16, kofs, gid, tig);
    tiles::fence_proxy_async();
    __syncthreads();

    // dQ[:, 128 wg ..] += dS(bf16) K[:, 128 wg ..]: A the whole dS
    // (keys along k), B the tile's two 64-column blocks of this half read
    // MN-major
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      wgmma_ss_t_n128(flat(acc), kstep_desc<kRows>(sDS, 0, kc),
                      desc_mn_sw128(tK + 2 * wg * kBK * 128 + 16 * kc * 128,
                                    kBK * 128),
                      started || kc > 0);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(acc));
    started = true;
  }
  if (!started)  // no key tile: dQ is 0
    #pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sK);
  stage_half<L::kSS>(stage, acc, warp, 128 * wg, gid, tig);
  __syncthreads();
  for (int i = tid; i < kRows * kPieces; i += kT2) {
    const int r = i / kPieces;
    const int c = (i % kPieces) * 8;
    const int p = q0 + r % bq;
    if (p >= Sq) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
    *reinterpret_cast<uint4*>(dq + base + c) =
        *reinterpret_cast<const uint4*>(stage + r * L::kSS + c);
  }
}

struct Dkv256Smem {
  static constexpr int D = 256;
  static constexpr int kTile = kBK * D * 2;  // a swizzled [64][256] tile
  // K, V, the Q ring, the dO ring, P^T and dS^T (swizzled [64][64] each),
  // all 1024-byte aligned, then [stage] LSE and Delta rows
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kQ = 2 * kTile;
  static constexpr int kDo = kQ + kStages * kTile;
  static constexpr int kPT = kDo + kStages * kTile;
  static constexpr int kDST = kPT + kBK * 128;
  static constexpr int kRowsAt = kDST + kBK * 128;
  static constexpr int kBytes = kRowsAt + 2 * kStages * kBQ * 4;
  // the segment branch's ints after those: each stage's query ids and
  // positions, scratch, then the list of live query tiles
  static constexpr int kSegInts = 2 * kStages * kBQ + kScratch2;
  // the f32 dK, dV of the tile ([64][D + 8] each) over the drained rings,
  // P^T, dS^T and the rows
  static constexpr int kAccStride = D + 8;
  static_assert(2 * kBK * kAccStride * 4 <= kBytes - kQ, "room for dK, dV");
};

// one CTA a (key tile, batch, kv head, cluster rank): dK and dV together,
// each warpgroup a 128-column half of both, over G / C of the group's
// heads; the C ranks' partial sums meet in distributed shared memory as
// at D 64/128
template <bool kSeg>
__global__ void __launch_bounds__(kT2, 1)
flash_bwd_dkv_256_kernel(const __nv_bfloat16* __restrict__ q,
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
  using L = Dkv256Smem;
  constexpr int D = L::D;
  constexpr int kKC = D / 16;
  constexpr int kQH = kBQ / 2;  // queries of one warpgroup's S^T and dP^T
  constexpr int kPieces = D / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sK = smem + L::kK;
  unsigned char* sV = smem + L::kV;
  unsigned char* sQ = smem + L::kQ;    // [stage] swizzled [kBQ][D]
  unsigned char* sD = smem + L::kDo;   // [stage] dO
  unsigned char* sPT = smem + L::kPT;  // P^T, [key][query]
  unsigned char* sDST = smem + L::kDST;
  float* sL = reinterpret_cast<float*>(smem + L::kRowsAt);  // [stage]
  float* sDelta = sL + kStages * kBQ;
  int* sQseg = reinterpret_cast<int*>(smem + L::kBytes);
  int* sQpos = sQseg + kStages * kBQ;
  int* sScratch = sQpos + kStages * kBQ;
  int* sList = sScratch + kScratch2;

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
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int qofs = wg * kQH;  // this warpgroup's queries of a step

  for (int i = tid; i < kBK * kPieces; i += kT2) {
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

  int qt0 = 0, ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const int4 mine =
        bounds_at(seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, kt);
    ntiles = live_pairs<false, false, kT2>(
        seg.qb + static_cast<size_t>(b) * 4 * nqt, nqt, mine, causal, sList,
        sScratch);
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
    unsigned char* dq_ = sQ + st * L::kTile;
    unsigned char* dd = sD + st * L::kTile;
    for (int i = tid; i < kBQ * kPieces; i += kT2) {
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
    if (tid < 2 * kBQ) {
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
    }
  };
  if (nsteps > 0) load_q(0, 0);
  cp_async_commit();

  // the two keys this thread owns (the same in both warpgroups)
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

  // dK, dV [:, 128 wg .. 128 wg + 127], written by wgmma only
  float dka[16][4], dva[16][4];
  bool started = false;

  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait<kStages - 2>();
    tiles::fence_proxy_async();
    __syncthreads();
    if (n + 1 < nsteps) load_q(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const unsigned char* tQ = sQ + st * L::kTile;
    const unsigned char* tD = sD + st * L::kTile;
    const int entry = entry_of(n / Gc);
    const int q0 = (entry & (kFull - 1)) * kBQ;
    bool full_tile;
    if constexpr (kSeg)
      full_tile = entry & kFull;
    else
      full_tile = !(causal && k0 + kBK - 1 > q0 + off);

    // S^T = K Q^T and dP^T = V dO^T: the tile's 64 keys x this
    // warpgroup's 32 queries, both operands from shared memory
    float s[kQH / 8][4], dp[kQH / 8][4];
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n32(flat(s), kstep_desc<kBK>(sK, 0, kc),
                   kstep_desc<kBQ>(tQ, qofs, kc), kc);
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n32(flat(dp), kstep_desc<kBK>(sV, 0, kc),
                   kstep_desc<kBQ>(tD, qofs, kc), kc);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));

    const bool masked =
        !full_tile && (kSeg || (causal && k0 + kBK - 1 > q0 + qofs + off));
    const float* tL = sL + st * kBQ + qofs;
    const float* tDl = sDelta + st * kBQ + qofs;
    const int* tseg = sQseg + st * kBQ + qofs;
    const int* tpos = sQpos + st * kBQ + qofs;
    if (masked)
      dkv_scores<true, kSeg>(s, dp, tL, tDl, tseg, tpos, q0 + qofs, key,
                             kid, kp, causal, off, scale_log2, scale, tig);
    else
      dkv_scores<false, kSeg>(s, dp, tL, tDl, tseg, tpos, q0 + qofs, key,
                              kid, kp, causal, off, scale_log2, scale, tig);
    // P^T and dS^T (bf16) of both halves meet in shared memory
    put_pairs(sPT, s, warp * 16, qofs, gid, tig);
    put_pairs(sDST, dp, warp * 16, qofs, gid, tig);
    tiles::fence_proxy_async();
    __syncthreads();

    // dV[:, 128 wg ..] += P^T(bf16) dO[:, 128 wg ..] and dK[:, 128 wg ..]
    // += dS^T(bf16) Q[:, 128 wg ..]: A the whole P^T / dS^T (queries
    // along k), B the staged rows' two 64-column blocks of this half read
    // MN-major
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kBQ / 16; ++kc) {
      const int at = 2 * wg * kBQ * 128 + 16 * kc * 128;
      wgmma_ss_t_n128(flat(dva), kstep_desc<kBK>(sPT, 0, kc),
                      desc_mn_sw128(tD + at, kBQ * 128), started || kc > 0);
      wgmma_ss_t_n128(flat(dka), kstep_desc<kBK>(sDST, 0, kc),
                      desc_mn_sw128(tQ + at, kBQ * 128), started || kc > 0);
    }
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(dka));
    tiles::fence_regs(flat(dva));
    started = true;
  }
  if (!started)  // no query row: dK = dV = 0
    #pragma unroll
    for (int dt = 0; dt < 16; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        dka[dt][c] = 0.f;
        dva[dt][c] = 0.f;
      }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the rings, P^T and dS^T

  if (C == 1) {  // the whole group's sums: bf16 rows over the rings
    constexpr int kSS = D + 8;
    __nv_bfloat16* stK = reinterpret_cast<__nv_bfloat16*>(sQ);
    __nv_bfloat16* stV = stK + kBK * kSS;
    stage_half<kSS>(stK, dka, warp, 128 * wg, gid, tig);
    stage_half<kSS>(stV, dva, warp, 128 * wg, gid, tig);
    __syncthreads();
    for (int i = tid; i < 2 * kBK * kPieces; i += kT2) {
      const int which = i / (kBK * kPieces);  // 0: dK, 1: dV
      const int r = (i % (kBK * kPieces)) / kPieces;
      const int c = (i % kPieces) * 8;
      const int kj = k0 + r;
      if (kj >= Sk) continue;
      __nv_bfloat16* out =
          (which ? dv : dk) +
          ((static_cast<size_t>(b) * Sk + kj) * Hk + kvh) * D + c;
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(
          (which ? stV : stK) + r * kSS + c);
    }
    return;
  }

  // the tile's f32 dK, dV (this rank's heads), row-major over the rings
  constexpr int kAS = L::kAccStride;
  float* fK = reinterpret_cast<float*>(sQ);
  float* fV = fK + kBK * kAS;
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + gid + 8 * i;
    #pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      const int col = 128 * wg + dt * 8 + tig * 2;
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
  for (int i = tid; i < 2 * rows * kQuads; i += kT2) {
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
// head dims above 256: the contraction over the head dim streamed in chunks
// ---------------------------------------------------------------------------

constexpr int kXWq = 128;  // dQ columns a CTA of B2 owns: one chunk
constexpr int kXWkv = 64;  // columns of one chunk of B3's ring

// B2: a ring stage holds one chunk of Q and dO (the CTA's 64 folded rows)
// and of K and V (a key tile), each a swizzled [64][kXWq]
struct DqXlSmem {
  static constexpr int kChunk = kBK * kXWq * 2;
  static constexpr int kStage = 4 * kChunk;
  static constexpr int kBytes = kStages * kStage;
  static constexpr int kSegInts = 2 * kStages * kBK + kSegScratch;
  static constexpr int kSS = kXWq + 8;  // dQ's padded staging rows
};

template <bool kSeg>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_xl_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int B, int Sq,
                       int Sk, int Hq, int Hk, int D, int causal,
                       float scale, float scale_log2, Strides qs,
                       Strides ks, Strides vs, Strides dos, Seg seg) {
  using L = DqXlSmem;
  constexpr int kKC = kXWq / 16;     // k steps of S and dP in a chunk
  constexpr int kCP = kXWq / 8;      // 16-byte pieces of a chunk's row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  int* sKseg = reinterpret_cast<int*>(smem_raw + L::kBytes);
  int* sKpos = sKseg + kStages * kBK;
  int* sScratch = sKpos + kStages * kBK;
  int* sList = sScratch + kSegScratch;

  const int nch = D / kXWq;
  const int G = Hq / Hk;
  const int bq = kRows / G;
  const int nqb = (Sq + bq - 1) / bq;
  // 1-d grid: slice fastest, then (kv head, batch), query blocks from the
  // last
  const int sl = blockIdx.x % nch;
  const int rest = blockIdx.x / nch;
  const int hb = rest % (Hk * B);
  const int kvh = hb % Hk;
  const int b = hb / Hk;
  const int q0 = (nqb - 1 - rest / (Hk * B)) * bq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;

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
  const int nitems = ntiles * nch;

  // item n: chunk (sl + 1 + n % nch) % nch of key tile n / nch, so the
  // slice's own chunk comes last: its K chunk is the one dQ needs
  auto load = [&](int n, int st) {
    const int t = entry_of(n / nch) & (kFull - 1);
    const int j = n % nch;
    const int c0 = ((sl + 1 + j) % nch) * kXWq;
    unsigned char* base = smem_raw + st * L::kStage;
    if (kSeg && j == nch - 1) {  // the tile's ids and positions
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                ok);
    }
    for (int i = tid; i < kBK * kCP; i += kThreads) {
      const int r = i / kCP;
      const int c8 = i % kCP;
      const int o = swz<kBK>(r, c8);
      const int pos = q0 + r % bq;
      const int head = kvh * G + r / bq;
      const bool okq = pos < Sq;
      cp_async16(base + o, okq ? q + qs.at(b, pos, head) + c0 + 8 * c8 : q,
                 okq);
      cp_async16(base + L::kChunk + o,
                 okq ? dout + dos.at(b, pos, head) + c0 + 8 * c8 : dout,
                 okq);
      const int key = t * kBK + r;
      const bool okk = key < Sk;
      cp_async16(base + 2 * L::kChunk + o,
                 okk ? k + ks.at(b, key, kvh) + c0 + 8 * c8 : k, okk);
      cp_async16(base + 3 * L::kChunk + o,
                 okk ? v + vs.at(b, key, kvh) + c0 + 8 * c8 : v, okk);
    }
  };
  if (nitems > 0) load(0, 0);
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

  // S and dP sum over a tile's chunks; dQ[:, slice] is written by wgmma
  // only; dS's A fragments live until the product that reads them retires
  float s[kBK / 8][4], dp[kBK / 8][4], acc[kXWq / 8][4];
  uint32_t a_ds[kBK / 16][4];
  bool started = false;

  for (int n = 0; n < nitems; ++n) {
    cp_async_wait<kStages - 2>();
    tiles::fence_proxy_async();
    __syncthreads();
    if (n + 1 < nitems) load(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const int j = n % nch;
    const unsigned char* tQ = smem_raw + st * L::kStage;
    const unsigned char* tD = tQ + L::kChunk;
    const unsigned char* tK = tD + L::kChunk;
    const unsigned char* tV = tK + L::kChunk;

    // S += Q_c K_c^T and dP += dO_c V_c^T over this chunk's columns
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n64(flat(s), kstep_desc<kBK>(tQ, 0, kc),
                   kstep_desc<kBK>(tK, 0, kc), j > 0 || kc > 0);
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n64(flat(dp), kstep_desc<kBK>(tD, 0, kc),
                   kstep_desc<kBK>(tV, 0, kc), j > 0 || kc > 0);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));
    if (j != nch - 1) continue;

    const int entry = entry_of(n / nch);
    const int t0 = (entry & (kFull - 1)) * kBK;
    bool masked;
    if constexpr (kSeg)
      masked = !(entry & kFull) || t0 + kBK > Sk;
    else
      masked = t0 + kBK > Sk || (causal && t0 + kBK - 1 > q0 + off);
    const int* tseg = sKseg + st * kBK;
    const int* tpos = sKpos + st * kBK;
    if (masked)
      dq_scores<true, kSeg>(s, dp, pos, lse2, dlt, t0, 0, Sk, causal, off,
                            scale_log2, scale, tig, tseg, tpos, qid, qp);
    else
      dq_scores<false, kSeg>(s, dp, pos, lse2, dlt, t0, 0, Sk, causal, off,
                             scale_log2, scale, tig, tseg, tpos, qid, qp);

    // dQ[:, slice] += dS(bf16) K_slice: the slice's chunk is this item's
    #pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      acc_to_a(a_ds[kc], s[2 * kc], s[2 * kc + 1]);
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      wgmma_rs_t_n128(flat(acc), a_ds[kc],
                      desc_mn_sw128(tK + 16 * kc * 128, kBK * 128),
                      started || kc > 0);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(acc));
    fence_frags(a_ds);
    started = true;
  }
  if (!started)
    #pragma unroll
    for (int dt = 0; dt < kXWq / 8; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  cp_async_wait<0>();
  __syncthreads();

  // the slice through the warp's own 16 padded rows over the ring
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  stage_half<L::kSS>(stage, acc, warp, 0, gid, tig);
  __syncwarp();
  for (int i = lane; i < 16 * kCP; i += 32) {
    const int r = warp * 16 + i / kCP;
    const int c = (i % kCP) * 8;
    const int p = q0 + r % bq;
    if (p >= Sq) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D +
        sl * kXWq;
    *reinterpret_cast<uint4*>(dq + base + c) =
        *reinterpret_cast<const uint4*>(stage + r * L::kSS + c);
  }
}

// B3: a CTA owns a slice of W columns (W up to 256, a multiple of 64) of dK
// and dV; kXWkv-column chunks stream through the ring
struct DkvXlChunks {
  static constexpr int kBlk = kBK * kXWkv * 2;  // a swizzled [64][64] chunk
  static constexpr int kStage = 4 * kBlk;       // K, V, Q and dO chunks
};

template <int W>
struct DkvXlSmem {
  static constexpr int kBlk = DkvXlChunks::kBlk;
  static constexpr int kSlice = W / kXWkv * kBlk;  // a swizzled [64][W]
  // the key tile's K and V slices (resident), the step's Q and dO slices,
  // the ring of other chunks, P^T and dS^T; all 1024-byte aligned; then
  // the step's LSE and Delta rows
  static constexpr int kKs = 0;
  static constexpr int kVs = kKs + kSlice;
  static constexpr int kQs = kVs + kSlice;
  static constexpr int kDs = kQs + kSlice;
  static constexpr int kRing = kDs + kSlice;
  static constexpr int kPT = kRing + kStages * DkvXlChunks::kStage;
  static constexpr int kDST = kPT + kBlk;
  static constexpr int kRowsAt = kDST + kBlk;
  static constexpr int kBytes = kRowsAt + 2 * kBQ * 4;
  // the segment branch's ints after those: the step's query ids and
  // positions, scratch, then the list of live query tiles
  static constexpr int kSegInts = 2 * kBQ + kScratch2;
  // dV (warpgroup 0) and dK (1) leave as padded bf16 rows over the Q and
  // dO slices and the ring
  static constexpr int kSS = W + 8;
  static_assert(2 * kBK * kSS * 2 <= kPT - kQs, "room for dK, dV");
};

// One CTA a (slice of W columns, key tile, batch, kv head), over the
// whole group; two warpgroups. Per (query tile, head) step, S^T and dP^T
// (64 keys x 64 queries) are computed once and split by queries: each
// warpgroup takes 32 (m64n32, both operands from shared memory), summing
// over the head dim's chunks: first the chunks outside the slice, which
// stream through the ring, then the slice's own from the resident K/V
// slice and the step's Q/dO slice. P^T and dS^T then cross as bf16
// through two swizzled tiles, and warpgroup 0 runs dV[:, slice] += P^T dO
// and warpgroup 1 dK[:, slice] += dS^T Q (m64nW, both from shared memory,
// the slices MN-major). A slice past D (the last one, where W does not
// divide D) is zero-filled there and not written.
template <int W, bool kSeg>
__global__ void __launch_bounds__(kT2, 1)
flash_bwd_dkv_xl_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int B, int Sq,
                        int Sk, int Hq, int Hk, int D, int causal,
                        float scale, float scale_log2, Strides qs,
                        Strides ks, Strides vs, Strides dos, Seg seg) {
  using L = DkvXlSmem<W>;
  constexpr int kWC = W / kXWkv;     // chunks of a slice
  constexpr int kCP = kXWkv / 8;     // 16-byte pieces of a chunk's row
  constexpr int kSP = W / 8;         // 16-byte pieces of a slice's row
  constexpr int kKC = kXWkv / 16;    // k steps of a chunk
  constexpr int kQH = kBQ / 2;       // queries of one warpgroup's S^T
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sKs = smem + L::kKs;
  unsigned char* sVs = smem + L::kVs;
  unsigned char* sQs = smem + L::kQs;
  unsigned char* sDs = smem + L::kDs;
  unsigned char* sRing = smem + L::kRing;  // [stage] K, V, Q, dO chunks
  unsigned char* sPT = smem + L::kPT;      // P^T, [key][query]
  unsigned char* sDST = smem + L::kDST;
  float* sL = reinterpret_cast<float*>(smem + L::kRowsAt);
  float* sDelta = sL + kBQ;
  int* sQseg = reinterpret_cast<int*>(smem + L::kBytes);
  int* sQpos = sQseg + kBQ;
  int* sScratch = sQpos + kBQ;
  int* sList = sScratch + kScratch2;

  const int nch = D / kXWkv;
  const int nsl = (D + W - 1) / W;
  // 1-d grid: slice fastest, then kv head, batch, key tile
  const int sl = blockIdx.x % nsl;
  const int rest = blockIdx.x / nsl;
  const int kvh = rest % Hk;
  const int b = (rest / Hk) % B;
  const int kt = rest / (Hk * B);
  const int k0 = kt * kBK;
  const int c_lo = sl * kWC;                // the slice's first chunk
  const int c_n = min(kWC, nch - c_lo);     // its chunks before D
  const int nf = nch - c_n;                 // chunks outside it, > 0
  const int G = Hq / Hk;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;
  const int nqt = (Sq + kBQ - 1) / kBQ;
  const int qofs = wg * kQH;  // this warpgroup's queries of a step

  int qt0 = 0, ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const int4 mine =
        bounds_at(seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, kt);
    ntiles = live_pairs<false, false, kT2>(
        seg.qb + static_cast<size_t>(b) * 4 * nqt, nqt, mine, causal, sList,
        sScratch);
  } else {
    qt0 = (causal ? max(0, k0 - off) : 0) / kBQ;
    ntiles = max(0, nqt - qt0);
  }
  auto entry_of = [&](int t) {
    if constexpr (kSeg) return sList[t];
    else return qt0 + t;
  };
  // step n: query tile n / G, head kvh G + n % G
  const int nsteps = ntiles * G;
  const int nitems = nsteps * nf;  // chunks through the ring
  auto step_q0 = [&](int n) {
    return (entry_of(n / G) & (kFull - 1)) * kBQ;
  };

  // item f: the f % nf-th chunk outside the slice, of step f / nf
  auto load_chunk = [&](int f, int st) {
    const int n = f / nf;
    const int j = f % nf;
    const int c0 = (j < c_lo ? j : j + c_n) * kXWkv;
    const int q0 = step_q0(n);
    const int head = kvh * G + n % G;
    unsigned char* base = sRing + st * DkvXlChunks::kStage;
    for (int i = tid; i < kBK * kCP; i += kT2) {
      const int r = i / kCP;
      const int c8 = i % kCP;
      const int o = swz<kBK>(r, c8);
      const int key = k0 + r;
      const bool okk = key < Sk;
      cp_async16(base + o, okk ? k + ks.at(b, key, kvh) + c0 + 8 * c8 : k,
                 okk);
      cp_async16(base + L::kBlk + o,
                 okk ? v + vs.at(b, key, kvh) + c0 + 8 * c8 : v, okk);
      const int pos = q0 + r;
      const bool okq = pos < Sq;
      cp_async16(base + 2 * L::kBlk + o,
                 okq ? q + qs.at(b, pos, head) + c0 + 8 * c8 : q, okq);
      cp_async16(base + 3 * L::kBlk + o,
                 okq ? dout + dos.at(b, pos, head) + c0 + 8 * c8 : dout,
                 okq);
    }
  };
  // step n's Q and dO slices, LSE and Delta (0 past Sq), and on the
  // segment branch the rows' ids and positions
  auto load_slice = [&](int n) {
    const int q0 = step_q0(n);
    const int head = kvh * G + n % G;
    for (int i = tid; i < kBQ * kSP; i += kT2) {
      const int r = i / kSP;
      const int c8 = i % kSP;
      const int col = sl * W + 8 * c8;
      const int pos = q0 + r;
      const bool ok = pos < Sq && col < D;
      cp_async16(sQs + swz<kBQ>(r, c8),
                 ok ? q + qs.at(b, pos, head) + col : q, ok);
      cp_async16(sDs + swz<kBQ>(r, c8),
                 ok ? dout + dos.at(b, pos, head) + col : dout, ok);
    }
    if (tid < 2 * kBQ) {  // threads 0-63 LSE, 64-127 Delta
      const int r = tid % kBQ;
      const int pos = q0 + r;
      const bool ok = pos < Sq;
      const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos;
      const float* src = tid < kBQ ? lse : delta;
      cp_async4((tid < kBQ ? sL : sDelta) + r, ok ? src + row : src, ok);
      if constexpr (kSeg) {
        const int* isrc = tid < kBQ ? seg.qseg : seg.qpos;
        cp_async4((tid < kBQ ? sQseg : sQpos) + r,
                  ok ? isrc + static_cast<size_t>(b) * Sq + pos : isrc, ok);
      }
    }
  };
  // commit groups, in order: the first chunk; the K/V slices with step 0's
  // slice; then one a ring item (the next chunk, which after a step's
  // last chunk is the next step's first) and one after each step's
  // products (the next step's slice). A step's first chunk is the newest
  // group but one (its slice came after it); every later chunk the
  // newest; the slice the newest but one.
  if (nitems > 0) load_chunk(0, 0);
  cp_async_commit();
  for (int i = tid; i < kBK * kSP; i += kT2) {
    const int r = i / kSP;
    const int c8 = i % kSP;
    const int col = sl * W + 8 * c8;
    const int key = k0 + r;
    const bool ok = key < Sk && col < D;
    cp_async16(sKs + swz<kBK>(r, c8), ok ? k + ks.at(b, key, kvh) + col : k,
               ok);
    cp_async16(sVs + swz<kBK>(r, c8), ok ? v + vs.at(b, key, kvh) + col : v,
               ok);
  }
  if (nsteps > 0) load_slice(0);
  cp_async_commit();

  // the two keys this thread owns (the same in both warpgroups)
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

  // warpgroup 0: dV[:, slice]; 1: dK[:, slice]; written by wgmma only
  float acc[W / 8][4];
  bool started = false;
  int f = 0;  // the ring item

  for (int n = 0; n < nsteps; ++n) {
    // S^T and dP^T: the tile's 64 keys x this warpgroup's 32 queries,
    // summed over the chunks outside the slice
    float s[kQH / 8][4], dp[kQH / 8][4];
    for (int j = 0; j < nf; ++j, ++f) {
      if (j == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      tiles::fence_proxy_async();
      __syncthreads();  // item f is visible; item f - 1 is consumed
      if (f + 1 < nitems) load_chunk(f + 1, (f + 1) % kStages);
      cp_async_commit();
      const unsigned char* tK = sRing + (f % kStages) * DkvXlChunks::kStage;
      const unsigned char* tV = tK + L::kBlk;
      const unsigned char* tQ = tV + L::kBlk;
      const unsigned char* tD = tQ + L::kBlk;
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));
      tiles::wgmma_fence();
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_ss_n32(flat(s), kstep_desc<kBK>(tK, 0, kc),
                     kstep_desc<kBQ>(tQ, qofs, kc), j > 0 || kc > 0);
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc)
        wgmma_ss_n32(flat(dp), kstep_desc<kBK>(tV, 0, kc),
                     kstep_desc<kBQ>(tD, qofs, kc), j > 0 || kc > 0);
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(s));
      tiles::fence_regs(flat(dp));
    }

    // ... and over the slice's own chunks
    cp_async_wait<1>();  // the step's slice (the next chunk may fly)
    tiles::fence_proxy_async();
    __syncthreads();
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kWC * kKC; ++kc)
      wgmma_ss_n32(flat(s), kstep_desc<kBK>(sKs, 0, kc),
                   kstep_desc<kBQ>(sQs, qofs, kc), 1);
    #pragma unroll
    for (int kc = 0; kc < kWC * kKC; ++kc)
      wgmma_ss_n32(flat(dp), kstep_desc<kBK>(sVs, 0, kc),
                   kstep_desc<kBQ>(sDs, qofs, kc), 1);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));
    tiles::fence_regs(flat(dp));

    const int entry = entry_of(n / G);
    const int q0 = (entry & (kFull - 1)) * kBQ;
    bool masked;
    if constexpr (kSeg)
      masked = !(entry & kFull);
    else
      masked = causal && k0 + kBK - 1 > q0 + qofs + off;
    if (masked)
      dkv_scores<true, kSeg>(s, dp, sL + qofs, sDelta + qofs, sQseg + qofs,
                             sQpos + qofs, q0 + qofs, key, kid, kp, causal,
                             off, scale_log2, scale, tig);
    else
      dkv_scores<false, kSeg>(s, dp, sL + qofs, sDelta + qofs,
                              sQseg + qofs, sQpos + qofs, q0 + qofs, key,
                              kid, kp, causal, off, scale_log2, scale, tig);
    // P^T and dS^T (bf16) of both halves meet in shared memory
    put_pairs(sPT, s, warp * 16, qofs, gid, tig);
    put_pairs(sDST, dp, warp * 16, qofs, gid, tig);
    tiles::fence_proxy_async();
    __syncthreads();

    // dV[:, slice] += P^T dO_slice (warpgroup 0), dK[:, slice] += dS^T
    // Q_slice (1): A the whole P^T / dS^T (queries along k), B the slice
    // read MN-major
    const unsigned char* tA = wg ? sDST : sPT;
    const unsigned char* tB = wg ? sQs : sDs;
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kBQ / 16; ++kc)
      wgmma_ss_t<W>(flat(acc), kstep_desc<kBK>(tA, 0, kc),
                    desc_mn_sw128(tB + 16 * kc * 128, kBQ * 128),
                    started || kc > 0);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(acc));
    started = true;
    __syncthreads();  // the slices, P^T and dS^T are consumed
    if (n + 1 < nsteps) load_slice(n + 1);
    cp_async_commit();
  }
  if (!started)  // no query row: dK = dV = 0
    #pragma unroll
    for (int dt = 0; dt < W / 8; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the slices and the ring

  // dV (warpgroup 0) and dK (1) as bf16 rows, then out 16 bytes a store,
  // none past Sk or D
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(sQs);
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat16* row =
        stage + (wg * kBK + warp * 16 + gid + 8 * i) * L::kSS;
    #pragma unroll
    for (int dt = 0; dt < W / 8; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
          pack_f32(acc[dt][2 * i], acc[dt][2 * i + 1]);
  }
  __syncthreads();
  for (int i = tid; i < 2 * kBK * kSP; i += kT2) {
    const int which = i / (kBK * kSP);  // 0: dV, 1: dK
    const int r = (i % (kBK * kSP)) / kSP;
    const int c = (i % kSP) * 8;
    const int kj = k0 + r;
    const int col = sl * W + c;
    if (kj >= Sk || col >= D) continue;
    __nv_bfloat16* out = (which ? dk : dv) +
                         ((static_cast<size_t>(b) * Sk + kj) * Hk + kvh) * D +
                         col;
    *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(
        stage + (which * kBK + r) * L::kSS + c);
  }
}

// ---------------------------------------------------------------------------
// the split pass: float32 operands as three bf16 pieces
// ---------------------------------------------------------------------------

// x [B, S, H, D] float32, read through its (batch, seq, head) strides in
// elements with a unit innermost stride -> out [3, B, S, H, Dp] bf16,
// contiguous: piece p of every element (split_bf16x3), columns D .. Dp - 1
// zero (the head dim padded as the bf16 route pads it). Two columns a
// thread; bytes bound: 4 read and 6 written an element.
__global__ void __launch_bounds__(256)
split_bf16x3_kernel(const float* __restrict__ x,
                    __nv_bfloat16* __restrict__ out, long long rows, int S,
                    int H, int D, int Dp, Strides xs) {
  const int pairs = Dp / 2;
  const long long n = rows * pairs;
  const long long piece = rows * Dp;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / pairs;
    const int c = static_cast<int>(i - row * pairs) * 2;
    const long long bs = row / H;
    const float* src = x + xs.at(static_cast<int>(bs / S),
                                 static_cast<int>(bs % S),
                                 static_cast<int>(row % H));
    __nv_bfloat16 e[3], o[3];
    split_bf16x3(c < D ? src[c] : 0.f, e);
    split_bf16x3(c + 1 < D ? src[c + 1] : 0.f, o);
    __nv_bfloat16* dst = out + row * Dp + c;
    #pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<__nv_bfloat162*>(dst + p * piece) =
          __halves2bfloat162(e[p], o[p]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// q, k, v, dout and the outputs as the bf16 kernels take them; the fp16
// and three-piece launches cast them to their own types
struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hk, D, causal, cluster;
  float scale, sl2;
  Strides qs, ks, vs, dos;
  PieceStrides pc;
  Seg seg;
  cudaStream_t s;
};

template <typename T, int P, int D, bool kSeg>
cudaError_t launch_dq(const Args& a) {
  static int allowed = 48 * 1024;  // the default needs no opt-in
  using L = DqSmem<D, P>;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nkt) * 4 : 0);
  auto kern = flash_bwd_dq_kernel<T, P, D, kSeg>;
  const cudaError_t e = allow_dynamic_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const int bq = kRows / (a.Hq / a.Hk);
  const long long ctas =
      static_cast<long long>((a.Sq + bq - 1) / bq) * a.Hk * a.B;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(ctas), kThreads, smem, a.s>>>(
      reinterpret_cast<const T*>(a.q), reinterpret_cast<const T*>(a.k),
      reinterpret_cast<const T*>(a.v), reinterpret_cast<const T*>(a.dout),
      a.lse, a.delta, reinterpret_cast<OutT<T, P>*>(a.dq), a.B, a.Sq, a.Sk,
      a.Hq, a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.pc,
      a.seg);
  return cudaGetLastError();
}

template <typename T, int P, int D, bool kSeg>
cudaError_t launch_dkv(const Args& a) {
  static int allowed = 48 * 1024;
  using L = DkvSmem<D, P>;
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nqt) * 4 : 0);
  auto kern = flash_bwd_dkv_kernel<T, P, D, kSeg>;
  const cudaError_t e = allow_dynamic_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const long long ctas = static_cast<long long>((a.Sk + kBK - 1) / kBK) *
                         a.B * a.Hk * a.cluster;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  const T* q = reinterpret_cast<const T*>(a.q);
  const T* k = reinterpret_cast<const T*>(a.k);
  const T* v = reinterpret_cast<const T*>(a.v);
  const T* dout = reinterpret_cast<const T*>(a.dout);
  OutT<T, P>* dk = reinterpret_cast<OutT<T, P>*>(a.dk);
  OutT<T, P>* dv = reinterpret_cast<OutT<T, P>*>(a.dv);
  if (a.cluster == 1) {
    kern<<<static_cast<unsigned>(ctas), kThreads, smem, a.s>>>(
        q, k, v, dout, a.lse, a.delta, dk, dv, a.B, a.Sq, a.Sk, a.Hq, a.Hk,
        a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.pc, a.seg);
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
      &cfg, kern, q, k, v, dout, a.lse, a.delta, dk, dv, a.B, a.Sq, a.Sk,
      a.Hq, a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.pc,
      a.seg);
  if (le != cudaSuccess) return le;
  return cudaGetLastError();
}

// B2 and B3 at D 64 / 128 in element type T with P pieces, dense or
// segment branch
template <typename T, int P>
cudaError_t launch_dq_tc(const Args& a) {
  const bool sg = a.seg.qseg != nullptr;
  if (a.D == 128)
    return sg ? launch_dq<T, P, 128, true>(a)
              : launch_dq<T, P, 128, false>(a);
  if (a.D == 64)
    return sg ? launch_dq<T, P, 64, true>(a)
              : launch_dq<T, P, 64, false>(a);
  return cudaErrorInvalidValue;
}

template <typename T, int P>
cudaError_t launch_dkv_tc(const Args& a) {
  const bool sg = a.seg.qseg != nullptr;
  if (a.D == 128)
    return sg ? launch_dkv<T, P, 128, true>(a)
              : launch_dkv<T, P, 128, false>(a);
  if (a.D == 64)
    return sg ? launch_dkv<T, P, 64, true>(a)
              : launch_dkv<T, P, 64, false>(a);
  return cudaErrorInvalidValue;
}

template <bool kSeg>
cudaError_t launch_dq_256(const Args& a) {
  static int allowed = 48 * 1024;
  using L = Dq256Smem;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nkt) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dq_256_kernel<kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int bq = kRows / (a.Hq / a.Hk);
  const long long ctas =
      static_cast<long long>((a.Sq + bq - 1) / bq) * a.Hk * a.B;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_256_kernel<kSeg><<<static_cast<unsigned>(ctas), kT2, smem,
                                  a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.B, a.Sq, a.Sk, a.Hq,
      a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.seg);
  return cudaGetLastError();
}

template <bool kSeg>
cudaError_t launch_dkv_256(const Args& a) {
  static int allowed = 48 * 1024;
  using L = Dkv256Smem;
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nqt) * 4 : 0);
  auto kern = flash_bwd_dkv_256_kernel<kSeg>;
  const cudaError_t e = allow_dynamic_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  const long long ctas = static_cast<long long>((a.Sk + kBK - 1) / kBK) *
                         a.B * a.Hk * a.cluster;
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  if (a.cluster == 1) {
    kern<<<static_cast<unsigned>(ctas), kT2, smem, a.s>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.B, a.Sq, a.Sk,
        a.Hq, a.Hk, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos,
        a.seg);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(kT2);
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

template <bool kSeg>
cudaError_t launch_dq_xl(const Args& a) {
  static int allowed = 48 * 1024;
  using L = DqXlSmem;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nkt) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dq_xl_kernel<kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  const int bq = kRows / (a.Hq / a.Hk);
  const long long ctas = static_cast<long long>((a.Sq + bq - 1) / bq) *
                         a.Hk * a.B * (a.D / kXWq);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dq_xl_kernel<kSeg><<<static_cast<unsigned>(ctas), kThreads,
                                 smem, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.B, a.Sq, a.Sk, a.Hq,
      a.Hk, a.D, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos, a.seg);
  return cudaGetLastError();
}

// the slice width of B3 above head dim 256: ceil(D / 256) slices, each
// the least multiple of 64 that covers D in that many (192 at D 384, 256
// at D 512 and 640, whose last slice is half past D)
inline int dkv_xl_width(int D) {
  const int nsl = (D + 255) / 256;
  return kXWkv * ((D / kXWkv + nsl - 1) / nsl);
}

template <int W, bool kSeg>
cudaError_t launch_dkv_xl(const Args& a) {
  static int allowed = 48 * 1024;
  using L = DkvXlSmem<W>;
  const int nqt = (a.Sq + kBQ - 1) / kBQ;
  const int smem = L::kBytes + (kSeg ? (L::kSegInts + nqt) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dkv_xl_kernel<W, kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  const long long ctas = static_cast<long long>((a.Sk + kBK - 1) / kBK) *
                         a.B * a.Hk * ((a.D + W - 1) / W);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  flash_bwd_dkv_xl_kernel<W, kSeg><<<static_cast<unsigned>(ctas), kT2,
                                     smem, a.s>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.B, a.Sq, a.Sk,
      a.Hq, a.Hk, a.D, a.causal, a.scale, a.sl2, a.qs, a.ks, a.vs, a.dos,
      a.seg);
  return cudaGetLastError();
}

template <bool kSeg>
cudaError_t launch_dkv_xl(const Args& a) {
  switch (dkv_xl_width(a.D)) {
    case 192: return launch_dkv_xl<192, kSeg>(a);
    case 256: return launch_dkv_xl<256, kSeg>(a);
    default: return cudaErrorInvalidValue;
  }
}

// the head dims the kernels take: 64, 128, 256, and multiples of 128
// above 256 (the contraction streamed in chunks)
bool bad_dim(int D) {
  return !(D == 64 || D == 128 || D == 256 || (D > 256 && D % kXWq == 0));
}

// the element types of the C entry points (0 bf16, 1 fp16, 2 float32 as
// three bf16 pieces): fp16 and the pieces at D 64 and 128 only
bool bad_type(int dtype, int D) {
  return dtype < 0 || dtype > 2 || (dtype > 0 && D != 64 && D != 128);
}

// the strides between pieces of [3, B, S, H, D] operands whose piece-0
// batch strides a holds
PieceStrides pieces_of(const Args& a) {
  return PieceStrides{a.qs.b * a.B, a.ks.b * a.B, a.vs.b * a.B,
                      a.dos.b * a.B};
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
               int Hq, int Hk, int D, int causal, float scale, long long qsb,
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
  a.D = D;
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

// dtype: 0 bf16 (D 64, 128, 256 or a multiple of 128 above), 1 fp16 (D
// 64, 128), 2 float32 as three bf16 pieces (D 64, 128): q, k, v and dout
// then each point at [3, B, S, H, D] bf16, contiguous (split_bf16x3; the
// strides are piece 0's), and the outputs are float32.
// q_seg, kv_seg, q_pos, kv_pos and kv_bounds are NULL on the dense branch;
// otherwise all five are given. kv_bounds is a workspace, int32
// [B, 4, ceil(Sk / 64)], that a first launch fills with the rows id min,
// id max, position min, position max of the 64-key tiles.
extern "C" int flash_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* q_seg,
    const void* kv_seg, const void* q_pos, const void* kv_pos,
    void* kv_bounds, int B, int Sq, int Sk, int Hq, int Hk, int D,
    int causal, float scale, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, Hq, Hk, D,
                     causal, scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                     vsh, dsb, dss, dsh, stream);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.seg = Seg{static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(kv_pos), nullptr,
               static_cast<const int*>(kv_bounds)};
  if (bad_group(Hq, Hk) || bad_seg(a.seg, false) || bad_type(dtype, D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0 || Hk <= 0) return static_cast<int>(cudaSuccess);
  if (bad_dim(D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (a.seg.qseg) {
    e = launch_bounds(Side{a.seg.kseg, a.seg.kpos,
                           static_cast<int*>(kv_bounds), Sk},
                      Side{}, B, a.s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (dtype == 1) return static_cast<int>(launch_dq_tc<__half, 1>(a));
  if (dtype == 2) {
    a.pc = pieces_of(a);
    return static_cast<int>(launch_dq_tc<__nv_bfloat16, 3>(a));
  }
  if (D > 256)
    e = a.seg.qseg ? launch_dq_xl<true>(a) : launch_dq_xl<false>(a);
  else if (D == 256)
    e = a.seg.qseg ? launch_dq_256<true>(a) : launch_dq_256<false>(a);
  else
    e = launch_dq_tc<__nv_bfloat16, 1>(a);
  return static_cast<int>(e);
}

// as flash_bwd_dq (dK and dV as dQ there), with the workspace q_bounds
// (NULL on the dense branch; [B, 4, ceil(Sq / 64)]) before kv_bounds, both
// filled by one first launch, and the cluster size C after causal: the C
// CTAs of a cluster share one key tile and split the G query heads of its
// group (C a power of two dividing G, at most 8)
extern "C" int flash_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* q_seg, const void* kv_seg, const void* q_pos,
    const void* kv_pos, void* q_bounds, void* kv_bounds, int B,
    int Sq, int Sk, int Hq, int Hk, int D, int causal, int cluster,
    float scale, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    void* stream) {
  Args a = make_args(q, k, v, dout, lse, delta, B, Sq, Sk, Hq, Hk, D,
                     causal, scale, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                     vsh, dsb, dss, dsh, stream);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.cluster = cluster;
  a.seg = Seg{static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(kv_pos),
               static_cast<const int*>(q_bounds),
               static_cast<const int*>(kv_bounds)};
  if (bad_group(Hq, Hk) || bad_seg(a.seg, true) || bad_type(dtype, D) ||
      cluster <= 0 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      (Hq / Hk) % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sk <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (bad_dim(D) || (D > 256 && cluster != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (a.seg.qseg) {
    e = launch_bounds(
        Side{a.seg.qseg, a.seg.qpos, static_cast<int*>(q_bounds), Sq},
        Side{a.seg.kseg, a.seg.kpos, static_cast<int*>(kv_bounds), Sk}, B,
        a.s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (dtype == 1) return static_cast<int>(launch_dkv_tc<__half, 1>(a));
  if (dtype == 2) {
    a.pc = pieces_of(a);
    return static_cast<int>(launch_dkv_tc<__nv_bfloat16, 3>(a));
  }
  if (D > 256)
    e = a.seg.qseg ? launch_dkv_xl<true>(a) : launch_dkv_xl<false>(a);
  else if (D == 256)
    e = a.seg.qseg ? launch_dkv_256<true>(a) : launch_dkv_256<false>(a);
  else
    e = launch_dkv_tc<__nv_bfloat16, 1>(a);
  return static_cast<int>(e);
}

// x [B, S, H, D] float32 (batch, seq, head strides in elements, unit
// innermost) -> out [3, B, S, H, Dp] bf16, contiguous: the three pieces of
// every element, the head dim zero-padded to Dp (even, >= D)
extern "C" int flash_split_bf16x3(const void* x, void* out, int B, int S,
                                  int H, int D, int Dp, long long sb,
                                  long long ss, long long sh, void* stream) {
  if (B < 0 || S < 0 || H < 0 || D < 0 || Dp < D || Dp % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * S * H;
  const long long n = rows * (Dp / 2);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = std::min<long long>((n + 255) / 256, 132 * 16);
  split_bf16x3_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<__nv_bfloat16*>(out), rows,
      S, H, D, Dp, Strides{sb, ss, sh});
  return static_cast<int>(cudaGetLastError());
}
