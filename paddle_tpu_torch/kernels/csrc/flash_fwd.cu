// Flash-attention forward for Hopper (sm_90a), bf16, fp16 and float32 (as
// three bf16 pieces) in, f32 softmax.
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
// fully masked row gives O = 0 and LSE = +1e30. D is 64, 128, 256 or a
// multiple of 128 above 256 (the wrapper zero-pads any other D to the next
// of these, as the Pallas kernel pads D to a multiple of 128).
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
// - Not yet: wgmma and TMA for the dense branch at D 64/128; its products
//   stay on mma.sync (D 256 runs `flash_fwd_256_kernel`, below).
//
// Head dim 256 (Gemma's heads are 256 wide; the wrapper pads D 129-255 to
// it): `flash_fwd_256_kernel`, both branches (the segment branch as its
// kSeg instantiation, which walks the compacted pair list of the segment
// kernel below and masks by ids and positions). What it is built around:
// a warp's 16 rows of a 256-wide f32 O accumulator are 128 registers a
// thread, so the mma.sync kernel of D 64/128 could not also keep Q's
// fragments and re-read Q with ldmatrix at every tile, and at 64 rows a
// CTA (one CTA an SM) each staged K/V tile served only 64 rows (0.2038 ms
// at B 1, S 2048, Hq 16, Hk 4, causal, on the H100).
// - 128 folded rows a block over two consumer warpgroups, each owning 64
//   rows and their whole m64n256 O; S on SS-form wgmma (Q staged once,
//   swizzled), P V on RS-form (P from registers, V MN-major).
// - A producer warpgroup feeds a K ring and a V ring by TMA behind
//   mbarriers and hands its registers to the consumers (setmaxnreg 24 /
//   240). Taking the loads off the consumers' path and the barrier they
//   met at every tile out of it took the kernel from 0.159 to 0.108 ms.
// - Each consumer issues S(n + 1) with P(n) V(n) and runs the softmax of
//   S(n + 1) under P(n) V(n); the consumers take turns at the tensor
//   cores (named barriers), FA3's schedule. Loops are peeled so that no
//   wgmma sits in a divergent path (ptxas serialized them there, C7518).
// - Causal without segments, each CTA walks two blocks, the j-th from the
//   end and the j-th from the start: every CTA walks about as many tiles
//   and the grid is one wave (0.108 -> 0.075 ms; non-causal read 51 % of
//   its bound while causal read 32 % before the pairing).
//
// Head dims above 256 (`flash_fwd_xl_kernel`, both branches; D a multiple
// of 128): whole 64-row tiles do not fit (at D 512 Q is 64 KiB and a
// two-stage K/V ring 256 KiB), so each CTA owns one 128-column slice of O
// and S = Q K^T streams through the ring one 128-column chunk of Q and K
// at a time, summing in a wgmma accumulator (m64n64, both operands from
// shared memory); the slice's own chunk comes last and brings V's slice,
// for O += P V after the dense kernel's softmax step. The CTAs of a row
// block compute the same S, m and l (D / 128 times the products of S);
// the first slice writes LSE. A first version that is right, not a fast
// one.
//
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

//
// float32 and fp16 at D 64/128 (`flash_fwd_tc_kernel<T, P, D, kSeg>`,
// both branches; the same Pallas body for q's other dtypes). What bounds
// them: the products, as in bf16; on the CUDA cores (flash_simt.cu,
// which keeps the backward above D 128) float32 could not pass 67
// TFLOP/s.
// - fp16 (T __half, P 1): the segment kernel's layout above on the `.f16`
//   forms of the wgmma helpers, dense and segment branch alike: Q's
//   fragments in registers, 64-key stages, S in m64n32 halves, P rounded
//   to fp16 before P V (the reference casts P to V's dtype). It leaves
//   `flash_fwd_kernel` and the bf16 segment kernel as they were.
// - float32 (P 3): q, k and v arrive as three bf16 pieces each (b0 =
//   bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1), whose sum is x;
//   flash_bwd.cu's split pass), S = Q K^T and O += P V each the six
//   products of pieces whose indices sum to at most 2, small terms first
//   and b0 b0 last, into one f32 accumulator: full float32 precision at
//   989 / 6 = 165 TFLOP/s. P stays float32 (the reference's cast to V's
//   dtype is none) and is split in registers (`acc_to_pieces`). Three
//   pieces of Q as A fragments would take ~96 registers a thread at D 128
//   beside O (64), S and P's pieces, so Q's pieces stay in shared memory
//   (48 KiB at D 128) and S is SS-form wgmma; K and V stream in 32-key
//   stages of three pieces each (48 KiB a stage at D 128): 144 KiB, one
//   CTA an SM (D 64: 72 KiB, two). O leaves as float32 rows staged over
//   the drained ring. The dense walk skips tiles above the causal
//   diagonal and masks only diagonal and ragged steps, as the dense
//   kernel; the segment walk takes the segment kernel's pair list.
//
// float32 and fp16 above D 128 (padded as bf16 is: 129-256 to 256, above
// to the next multiple of 128). Until these, both ran on the CUDA cores
// (flash_simt.cu `fwd_kernel`, float32 FMAs at 67 TFLOP/s, Q re-staged a
// scalar at a time for every key tile): 21.6x behind SDPA in fp16 at
// D 160 on the H100.
// - fp16 at D 256: `flash_fwd_256_kernel<__half, kSeg>`, the bf16 kernel
//   with fp16 TMA maps and the `.f16` wgmma forms (192 KiB, unchanged).
// - fp16 above 256: `flash_fwd_xl_kernel<__half, 1, kSeg>`, likewise.
// - float32 at 256: `flash_fwd_tc_kernel<bf16, 3, 256, kSeg>`. Its D 128
//   layout (Q's pieces resident, 32-key stages) would take 96 KiB of Q and
//   192 KiB of ring, over a CTA's 227 KiB; with 16-key stages it takes 192
//   KiB. S is m64n16 `wgmma` (96 products a step, in four independent
//   accumulators), O (128 registers a thread) is rescaled before P V and
//   accumulates in place: no second D-wide accumulator fits.
// - float32 above 256: `flash_fwd_xl_kernel<bf16, 3, kSeg>`, the xl layout
//   on three pieces: Q and K stream by 128-column chunks of three pieces
//   with 32-key steps (192 KiB at every D), O's slice at 64 registers a
//   thread, at the cost of S computed D / 128 times. It served D 256 too
//   in a first version: 2.3x (D 160) and 2.8x (D 256) slower than the tc
//   kernel there on the H100 (PERF.md).

#include <mutex>

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

// mask (when kMask), scale and online softmax of one tile of 8 kNT keys (a
// 64-key tile, or a 32-key step of the three-piece kernel); s holds P
// (unnormalized, f32) afterwards, acc and the running max/sum are rescaled.
// The mask is the end of the keys and the bottom-right causal diagonal,
// or with kSeg the tile's staged ids and positions (tseg, tpos) against
// the rows' (qid, qp).
template <bool kMask, bool kSeg, int kDT, int kNT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[kNT][4], float (&acc)[kDT][4], float (&m_run)[2],
    float (&l_run)[2], const int (&pos)[2], int t0, int Sk, int causal,
    int off, float scale_log2, int tig, const int* tseg, const int* tpos,
    const int (&qid)[2], const int (&qp)[2]) {
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = m_run[i];
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
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
    for (int nt = 0; nt < kNT; ++nt) {
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

// the dense branch at D 64 and 128
template <int D>
__global__ void __launch_bounds__(kFThreads, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int Hk, int causal,
                 float scale_log2, Strides qs, Strides ks, Strides vs) {
  static_assert(D <= 128, "D 256 runs flash_fwd_256_kernel");
  using L = FwdSmem<D>;
  constexpr int kStride = L::kStride;
  constexpr int kKC = D / 16;     // k-chunks of the QK^T product
  constexpr int kDT = D / 8;      // n-tiles of the PV product
  constexpr int kNT = kBK / 8;    // n-tiles of the QK^T product
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + L::kQ;             // [stage][kBK][kStride]
  __nv_bfloat16* sV = sK + kStages * L::kKV;  // [stage][kBK][kStride]

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

  // keys this CTA can see: up to the diagonal of its last live row
  const int q_hi = min(q0 + bq, Sq) - 1;
  const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
  const int ntiles = (kend + kBK - 1) / kBK;

  auto load_kv = [&](int t, int st) {
    __nv_bfloat16* dk = sK + st * L::kKV;
    __nv_bfloat16* dv = sV + st * L::kKV;
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

  // the two rows this thread owns in the mma layout: gid and gid + 8
  int pos[2], head[2];
  const int qid[2] = {0, 0}, qp[2] = {0, 0};  // (the segment branch's)
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    head[i] = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
  }

  cp_async_wait<kStages - 1>();  // Q has landed (tiles may be in flight)
  __syncthreads();
  const __nv_bfloat16* qrow =
      sQ + (warp * 16 + (lane & 15)) * kStride + 8 * (lane >> 4);
  uint32_t qf[kKC][4];
  #pragma unroll
  for (int kc = 0; kc < kKC; ++kc) ldsm_x4(qf[kc], qrow + kc * 16);

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
    const int t0 = t * kBK;

    // S = Q K^T for this warp's 16 rows x 64 keys; one ldmatrix.x4 gives
    // the B fragments of two 8-key n-tiles
    float s[kNT][4];
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      #pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      #pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, tK + (np * 16 + (lane & 7) + 8 * (lane >> 4)) * kStride +
                        kc * 16 + 8 * ((lane >> 3) & 1));
        mma_bf16(s[2 * np], qf[kc], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bf[2], bf[3]);
      }
    }

    // only tiles that reach past Sk or above the first row's diagonal
    // need the mask
    const bool masked =
        t0 + kBK > Sk || (causal && t0 + kBK - 1 > q0 + off);
    if (masked)
      softmax_tile<true, false>(s, acc, m_run, l_run, pos, t0, Sk, causal,
                                off, scale_log2, tig, nullptr, nullptr, qid,
                                qp);
    else
      softmax_tile<false, false>(s, acc, m_run, l_run, pos, t0, Sk, causal,
                                 off, scale_log2, tig, nullptr, nullptr, qid,
                                 qp);

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
// head dim 256: a TMA producer and two wgmma consumers, both branches
// ---------------------------------------------------------------------------

constexpr int kT3 = 3 * kFThreads;             // producer + two consumers
constexpr int kRows2 = 2 * kFRows;             // folded rows per CTA
constexpr int kScratch3 = seg_scratch<kT3>();  // block_bounds, live_pairs
constexpr int kConsumerRegs = 240;             // setmaxnreg budgets
constexpr int kProducerRegs = 24;

struct Fwd256Smem {
  static constexpr int D = 256;
  static constexpr int kBlk = kBK * 64 * 2;   // a swizzled [64][64] box
  static constexpr int kTile = kBK * D * 2;   // a K or V tile: 4 boxes
  // Q ([128][256], swizzled), the K ring, the V ring, each V stage's kv
  // ids and positions (kSeg), then the rings' barriers: full and empty of
  // each K stage, then of each V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kRows2 * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kIds = kV + kStages * kTile;
  static constexpr int kBars = kIds + 2 * kStages * kBK * 4;
  static constexpr int kBytes = kBars + 4 * kStages * 8;
  // the ints after those (kSeg): scratch, then the list of live pairs
  static constexpr int kInts = kScratch3;
};

// A CTA of three warpgroups owns blocks of 128 folded rows (the G query
// heads of a kv head x 128 / G positions): one block, or under causal
// masking without segments two, the j-th from the end and the j-th from
// the start, so every CTA walks about as many key tiles and the grid is
// one wave where one CTA a block was two of unequal CTAs. Warpgroup 0 is
// the producer: one thread keeps a two-stage K ring and a two-stage V
// ring of 64-key tiles filled by TMA (four 64-column boxes a tile,
// 128-byte swizzle; keys past Sk zero-filled), each stage behind a full
// and an empty mbarrier, and gives its registers to the consumers
// (setmaxnreg). Consumer warpgroup c owns rows 64 c .. 64 c + 63 of a
// block, stages them with cp.async, and keeps their whole m64n256 O (128
// registers a thread). Per tile n it issues S(n + 1) = Q K^T (SS-form
// wgmma m64n64, K K-major) and O += P(n) V(n) (RS-form m64n256: P's bf16
// A fragments from registers, V MN-major) in one turn, then runs the
// online softmax of S(n + 1) under P(n) V(n). The consumers take turns
// at the tensor cores on two named barriers, so one's softmax runs under
// the other's products; each releases a stage to the producer once its
// products have read it. kSeg walks the compacted pair list
// (flash_seg.cuh) and masks by the ids and positions that ride in each V
// stage. T is the element type: bf16, or fp16 on the `.f16` wgmma forms
// with P rounded to fp16 before P V (the reference casts P to V's dtype).
template <typename T, bool kSeg>
__global__ void __launch_bounds__(kT3, 1)
flash_fwd_256_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap idmap,
                     const __grid_constant__ CUtensorMap posmap,
                     const T* __restrict__ q, T* __restrict__ o,
                     float* __restrict__ lse,
                     int Sq, int Sk, int Hq, int Hk, int causal,
                     float scale_log2, Strides qs, Seg seg) {
  using L = Fwd256Smem;
  constexpr int D = L::D;
  constexpr int kKC = D / 16;     // k steps of S over the head dim
  constexpr int kNT = kBK / 8;    // 8-key n-tiles of S
  constexpr int kPC = kBK / 16;   // k steps of P V
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  extern __shared__ __align__(1024) unsigned char f256_smem[];
  unsigned char* sQ = f256_smem + L::kQ;
  unsigned char* sK = f256_smem + L::kK;  // [stage] K tile
  unsigned char* sV = f256_smem + L::kV;  // [stage] V tile
  int* sIds = reinterpret_cast<int*>(f256_smem + L::kIds);  // [stage][64]
  int* sPos = sIds + kStages * kBK;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(f256_smem + L::kBars);
  uint64_t* kempty = kfull + kStages;
  uint64_t* vfull = kempty + kStages;
  uint64_t* vempty = vfull + kStages;
  int* sScratch = reinterpret_cast<int*>(f256_smem + L::kBytes);
  int* sList = sScratch + kScratch3;

  const int G = Hq / Hk;
  const int bq = kRows2 / G;  // query positions a block
  const int nqb = (Sq + bq - 1) / bq;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: the producer; 1, 2: consumers
  const int off = Sk - Sq;
  // this CTA's blocks: the last but blockIdx.x, and (paired) the
  // blockIdx.x-th, when that is another one
  const bool paired = !kSeg && causal;
  const int x = blockIdx.x;
  const int j0 = nqb - 1 - x;
  const int units = paired && x < j0 ? 2 : 1;
  auto block_of = [&](int u) { return u == 0 ? j0 : x; };
  // the key tiles block j walks: up to the diagonal of its last live row,
  // or (kSeg) the compacted list of live (block, tile) pairs
  auto tiles_of = [&](int j) {
    const int q_hi = min((j + 1) * bq, Sq) - 1;
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    return (kend + kBK - 1) / kBK;
  };

  if (tid == 0) {
    #pragma unroll
    for (int i = 0; i < kStages; ++i) {
      tiles::mbar_init(kfull + i, 1);
      tiles::mbar_init(vfull + i, 1);
      tiles::mbar_init(kempty + i, 2 * kWarps);  // every consumer warp
      tiles::mbar_init(vempty + i, 2 * kWarps);
    }
    tiles::mbar_init_fence();
  }
  int seg_tiles = 0;
  if constexpr (kSeg) {
    const int q0 = j0 * bq;
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds<kT3>(seg.qseg + at, seg.qpos + at,
                                        min(q0 + bq, Sq) - q0, sScratch);
    seg_tiles = live_pairs<true, false, kT3>(
        seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt, mine, causal, sList,
        sScratch);
  }
  __syncthreads();  // the barriers and the list are in place
  auto ntiles_of = [&](int j) {
    if constexpr (kSeg) return seg_tiles;
    else return tiles_of(j);
  };
  auto tile_of = [&](int n) {
    if constexpr (kSeg) return sList[n];
    else return n;
  };

  if (wg == 0) {
    tiles::regs_dec<kProducerRegs>();
    if (tid != 0) return;
    // ring item g (over the CTA's blocks, in order) fills stage g % 2 of
    // each ring once the consumers have released item g - 2 there
    int g = 0;
    for (int u = 0; u < units; ++u) {
      const int ntiles = ntiles_of(block_of(u));
      for (int n = 0; n < ntiles; ++n, ++g) {
        const int st = g % kStages;
        const uint32_t ph = (g / kStages) & 1;
        const int t = tile_of(n) & (kFull - 1);
        if (g >= kStages) tiles::mbar_wait(kempty + st, ph ^ 1);
        tiles::mbar_expect(kfull + st, L::kTile);
        #pragma unroll
        for (int bx = 0; bx < D / 64; ++bx)
          tiles::tma_4d(sK + st * L::kTile + bx * L::kBlk, &kmap, 64 * bx,
                        kvh, t * kBK, b, kfull + st);
        if (g >= kStages) tiles::mbar_wait(vempty + st, ph ^ 1);
        tiles::mbar_expect(vfull + st, L::kTile + (kSeg ? 2 * kBK * 4 : 0));
        #pragma unroll
        for (int bx = 0; bx < D / 64; ++bx)
          tiles::tma_4d(sV + st * L::kTile + bx * L::kBlk, &vmap, 64 * bx,
                        kvh, t * kBK, b, vfull + st);
        if constexpr (kSeg) {
          tiles::tma_1d(sIds + st * kBK, &idmap, b * Sk + t * kBK,
                        vfull + st);
          tiles::tma_1d(sPos + st * kBK, &posmap, b * Sk + t * kBK,
                        vfull + st);
        }
      }
    }
    return;
  }
  tiles::regs_inc<kConsumerRegs>();

  const int c = wg - 1;  // this consumer's 64 rows of a block
  const int ctid = tid - kFThreads * wg;
  const int warp = ctid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[D / 8][4];  // O, unnormalized
  float m_run[2], l_run[2];  // l: per-thread partial sums
  float s[kNT][4];           // S, then P
  uint32_t a_p[kPC][4];      // P's bf16 A fragments, live until P V retires
  float alpha[1][4];
  int pos[2], head[2], qid[2], qp[2];

  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) tiles::mbar_arrive(bar);
  };
  // the consumers take turns at the tensor cores (named barriers 3 and 4,
  // both warpgroups): each issues its products of a turn, then passes the
  // turn on, so one's softmax runs under the other's products
  auto my_turn = [&]() { tiles::named_sync(3 + c, 2 * kFThreads); };
  auto pass_turn = [&]() { tiles::named_arrive(4 - c, 2 * kFThreads); };
  auto s_product = [&](int g) {
    const int st = g % kStages;
    tiles::mbar_wait(kfull + st, (g / kStages) & 1);
    tiles::fence_regs(flat(s));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      wgmma_ss_n64<T>(flat(s), kstep_desc<kRows2>(sQ, kFRows * c, kc),
                      kstep_desc<kBK>(sK + st * L::kTile, 0, kc), kc > 0);
    tiles::wgmma_commit();
  };
  auto pv_product = [&](int g) {
    tiles::fence_regs(flat(acc));
    tiles::wgmma_fence();
    #pragma unroll
    for (int kc = 0; kc < kPC; ++kc)
      wgmma_rs_t_n256<T>(flat(acc), a_p[kc],
                         desc_mn_sw128(sV + (g % kStages) * L::kTile +
                                           16 * kc * 128,
                                       kBK * 128),
                         1);
    tiles::wgmma_commit();
  };
  auto to_p = [&]() {
    #pragma unroll
    for (int kc = 0; kc < kPC; ++kc)
      acc_to_a<T>(a_p[kc], s[2 * kc], s[2 * kc + 1]);
  };

  if (c == 1) pass_turn();  // consumer 0 takes the first turn
  int g0 = 0;  // ring items of the blocks before this one
  for (int u = 0; u < units; ++u) {
    const int q0 = block_of(u) * bq;
    const int q_hi = min(q0 + bq, Sq) - 1;
    const int ntiles = ntiles_of(block_of(u));
    // stage this consumer's rows of Q: folded row r is (head kvh G + r /
    // bq, position q0 + r % bq); the rows of the block before are out
    if (u > 0) tiles::named_sync(1 + c, kFThreads);
    for (int i = ctid; i < kFRows * kPieces; i += kFThreads) {
      const int r = kFRows * c + i / kPieces;
      const int c8 = i % kPieces;
      const int p = q0 + r % bq;
      const bool ok = p < Sq;
      cp_async16(sQ + swz<kRows2>(r, c8),
                 ok ? q + qs.at(b, p, kvh * G + r / bq) + 8 * c8 : q, ok);
    }
    cp_async_commit();
    // the two rows this thread owns in the wgmma layout: gid and gid + 8
    // of its warp's 16, with (kSeg) their query's segment id and position
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = kFRows * c + warp * 16 + gid + 8 * i;
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
    // at G 1 the consumers hold 64 positions each: the first computes no
    // tile past its own last row's diagonal (it still releases them), and
    // tiles past its first row's need the mask
    const int c_q0 = bq > kFRows ? q0 + kFRows * c : q0;
    int c_tiles = ntiles;
    if (!kSeg && causal && bq > kFRows) {
      const int c_hi = min(c_q0 + kFRows - 1, q_hi);
      c_tiles = min(ntiles,
                    (max(min(Sk, c_hi + off + 1), 0) + kBK - 1) / kBK);
    }
    #pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      #pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
    m_run[0] = m_run[1] = kNeg;
    l_run[0] = l_run[1] = 0.f;
    cp_async_wait<0>();
    tiles::fence_proxy_async();           // Q where wgmma reads it
    tiles::named_sync(1 + c, kFThreads);  // ... for the whole warpgroup

    // masks, scales and exponentiates S of tile n (its ids and positions
    // ride in V stage g0 + n) into P, returning each row's alpha
    auto softmax = [&](int n) {
      const int g = g0 + n;
      const int st = g % kStages;
      tiles::mbar_wait(vfull + st, (g / kStages) & 1);
      const int t0 = (tile_of(n) & (kFull - 1)) * kBK;
      bool masked;
      if constexpr (kSeg)
        masked = !(tile_of(n) & kFull) || t0 + kBK > Sk;
      else
        masked = t0 + kBK > Sk || (causal && t0 + kBK - 1 > c_q0 + off);
      // the mma.sync kernel's softmax step; it rescales its accumulator by
      // alpha, here a [1][4] of ones that comes back as alpha of row gid
      // ([0][0]) and of row gid + 8 ([0][2])
      alpha[0][0] = alpha[0][1] = alpha[0][2] = alpha[0][3] = 1.f;
      if (masked)
        softmax_tile<true, kSeg>(s, alpha, m_run, l_run, pos, t0, Sk, causal,
                                 off, scale_log2, tig, sIds + st * kBK,
                                 sPos + st * kBK, qid, qp);
      else
        softmax_tile<false, kSeg>(s, alpha, m_run, l_run, pos, t0, Sk,
                                  causal, off, scale_log2, tig,
                                  sIds + st * kBK, sPos + st * kBK, qid, qp);
    };

    // tile 0's S and softmax; then per tile n: S(n + 1) and P(n) V(n)
    // issued in one turn, the softmax of S(n + 1) under P(n) V(n); the last
    // tile's P V alone
    my_turn();
    if (c_tiles > 0) {
      s_product(g0);
      pass_turn();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(s));
      release(kempty + g0 % kStages);
      softmax(0);
      to_p();
    } else {
      pass_turn();
    }
    for (int n = 0; n + 1 < c_tiles; ++n) {
      my_turn();
      s_product(g0 + n + 1);
      pv_product(g0 + n);
      pass_turn();
      tiles::wgmma_wait<1>();  // S(n + 1) is done; P(n) V(n) may still run
      tiles::fence_regs(flat(s));
      release(kempty + (g0 + n + 1) % kStages);
      softmax(n + 1);
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(acc));
      fence_frags(a_p);
      release(vempty + (g0 + n) % kStages);
      to_p();
      #pragma unroll
      for (int dt = 0; dt < D / 8; ++dt)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[0][e & 2];
    }
    if (c_tiles > 0) {
      my_turn();
      pv_product(g0 + c_tiles - 1);
      pass_turn();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(acc));
      fence_frags(a_p);
      release(vempty + (g0 + c_tiles - 1) % kStages);
    }
    // tiles past this consumer's rows: released unread, turns passed on
    // (one turn a tile, as above)
    for (int n = c_tiles; n < ntiles; ++n) {
      const int g = g0 + n;
      my_turn();
      pass_turn();
      tiles::mbar_wait(kfull + g % kStages, (g / kStages) & 1);
      release(kempty + g % kStages);
      tiles::mbar_wait(vfull + g % kStages, (g / kStages) & 1);
      release(vempty + g % kStages);
    }
    g0 += ntiles;

    // normalize into this consumer's own rows of the Q tile (swizzled;
    // only it reads them), LSE from the owning threads, then the rows out
    // 16 bytes a lane
    const int row0 = kFRows * c + warp * 16;
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int r = row0 + gid + 8 * i;
      #pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int col = dt * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(sQ + swz<kRows2>(r, col >> 3) +
                                     (col & 7) * 2) =
            pack2<T>(acc[dt][i * 2] * inv, acc[dt][i * 2 + 1] * inv);
      }
      if (tig == 0 && pos[i] < Sq) {
        lse[(static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i]] =
            l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : kBig;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * kPieces; i += 32) {
      const int r = row0 + i / kPieces;
      const int c8 = i % kPieces;
      const int p = q0 + r % bq;
      if (p >= Sq) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
      *reinterpret_cast<uint4*>(o + base + 8 * c8) =
          *reinterpret_cast<const uint4*>(sQ + swz<kRows2>(r, c8));
    }
  }
  if (c == 0) my_turn();  // consumer 1's last pass
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
// head dims above 256 (bf16, fp16, and float32 as three bf16 pieces)
// ---------------------------------------------------------------------------

constexpr int kXW = 128;  // O columns a CTA owns: one chunk of the head dim

// element strides between the pieces of q, k, v (0 at P 1): the pieces of a
// float32 operand are [3, B, S, H, D] bf16, contiguous
struct PieceStrides {
  long long q, k, v;
};

// T: the element type of the staged operands (bf16, __half, or bf16
// pieces); P: 1, or 3 when q, k, v are the three bf16 pieces of float32
// operands (S and P V then the six terms of first_term(3) .. 5, P split in
// registers, O float32)
template <typename T, int P>
using TcOut = std::conditional_t<P == 1, T, float>;

// a ring stage: for each of the P pieces one chunk of Q (the CTA's 64
// folded rows), one of K (a ring step's keys), and V's chunk of the CTA's
// slice (filled on a step's last item only), each a swizzled [rows][kXW]:
// P 1 steps 64 keys (48 KiB a stage), P 3 32 keys (96 KiB a stage, a
// 192 KiB ring)
template <int P>
struct XlSmem {
  static constexpr int kKeys = P == 1 ? kBK : kBK / 2;  // keys a ring step
  static constexpr int kQChunk = kFRows * kXW * 2;  // a piece of Q's chunk
  static constexpr int kKChunk = kKeys * kXW * 2;   // a piece of K's or V's
  static constexpr int kK = P * kQChunk;            // K's pieces in a stage
  static constexpr int kV = kK + P * kKChunk;       // V's pieces
  static constexpr int kStage = kV + P * kKChunk;
  static constexpr int kBytes = kStages * kStage;
  // the segment branch's ints after the ring: each stage's kv ids and
  // positions, scratch, then the list of live pairs (one per key tile)
  static constexpr int kInts = 2 * kStages * kKeys + kSegScratch;
  // O's staging rows over the drained ring: padded rows of T (P 1) or
  // float32 rows (P 3)
  static constexpr int kOS = P == 1 ? kXW + 8 : kXW + 4;
  static_assert(kFRows * kOS * 4 <= kBytes, "O's rows fit the ring");
};

// D a multiple of kXW above 256.
// Whole 64-row tiles do not fit at D 512, so the contraction S = Q K^T
// streams through the ring one chunk of kXW columns at a time (items: a
// ring step's chunks, the slice's own last), summing in the wgmma
// accumulator; after the last chunk the online softmax runs as in the
// dense kernel and O[:, slice] += P V_slice (RS form, V MN-major). Every
// CTA of a row block computes the same S, m and l; the first slice's
// writes LSE. At P 3 (float32: three bf16 pieces of q, k and v, the xl
// layout on pieces) each product is the six terms of the pieces whose
// indices sum to at most 2, P is split in registers and O is float32, as
// in flash_fwd_tc_kernel; Q's and K's chunks of three pieces keep a step
// at 32 keys, so S is recomputed D / kXW times a key as at P 1 (at D 256
// float32 takes flash_fwd_tc_kernel's 16-key stages instead).
template <typename T, int P, bool kSeg>
__global__ void __launch_bounds__(kFThreads, P == 1 ? 2 : 1)
flash_fwd_xl_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, TcOut<T, P>* __restrict__ o,
                    float* __restrict__ lse, int B, int Sq, int Sk, int Hq,
                    int Hk, int D, int causal, float scale_log2, Strides qs,
                    Strides ks, Strides vs, PieceStrides pc, Seg seg) {
  using L = XlSmem<P>;
  constexpr int kKeys = L::kKeys;
  constexpr int kHalves = kBK / kKeys;  // ring steps a key tile
  constexpr int kKC = kXW / 16;         // k steps of S in a chunk
  constexpr int kNT = kKeys / 8;        // 8-key n-tiles of S
  constexpr int kDT = kXW / 8;          // n-tiles of the slice of O
  constexpr int kPC = kKeys / 16;       // k steps of P V
  constexpr int kCP = kXW / 8;          // 16-byte pieces of a chunk's row
  constexpr int kT0 = first_term(P);
  extern __shared__ __align__(1024) unsigned char xl_smem[];
  int* sKseg = reinterpret_cast<int*>(xl_smem + L::kBytes);  // [stage][kKeys]
  int* sKpos = sKseg + kStages * kKeys;
  int* sScratch = sKpos + kStages * kKeys;
  int* sList = sScratch + kSegScratch;

  const int nch = D / kXW;
  const int G = Hq / Hk;
  const int bq = kFRows / G;
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

  // the ring steps: kHalves a key tile up to the diagonal of the block's
  // last live row, or of each live pair of the list
  const int q_hi = min(q0 + bq, Sq) - 1;
  int nsteps;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds(seg.qseg + at, seg.qpos + at,
                                   q_hi + 1 - q0, sScratch);
    nsteps = kHalves *
             live_pairs<true>(seg.kb + static_cast<size_t>(b) * 4 * nkt, nkt,
                              mine, causal, sList, sScratch);
  } else {
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    nsteps = (kend + kKeys - 1) / kKeys;
  }
  // the list entry of the n-th key tile (flagged kFull) and the first key
  // of ring step n
  auto entry_of = [&](int t) {
    if constexpr (kSeg) return sList[t];
    else return t;
  };
  auto key_of = [&](int n) {
    return (entry_of(n / kHalves) & (kFull - 1)) * kBK +
           (n % kHalves) * kKeys;
  };
  const int nitems = nsteps * nch;

  // item n: chunk (sl + 1 + n % nch) % nch of ring step n / nch
  auto load = [&](int n, int st) {
    const int kb0 = key_of(n / nch);
    const int j = n % nch;
    const int c0 = ((sl + 1 + j) % nch) * kXW;
    const bool last = j == nch - 1;
    unsigned char* base = xl_smem + st * L::kStage;
    if constexpr (kSeg) {  // threads 0 .. kKeys - 1 copy the ids, the next
      if (last && tid < 2 * kKeys) {  // kKeys the positions
        const int i = tid % kKeys;
        const int key = kb0 + i;
        const bool ok = key < Sk;
        const int* src = tid < kKeys ? seg.kseg : seg.kpos;
        int* dst = (tid < kKeys ? sKseg : sKpos) + st * kKeys;
        cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                  ok);
      }
    }
    for (int i = tid; i < P * kFRows * kCP; i += kFThreads) {
      const int p = i / (kFRows * kCP);
      const int r = (i / kCP) % kFRows;
      const int c8 = i % kCP;
      const int pos = q0 + r % bq;
      const bool ok = pos < Sq;
      cp_async16(base + p * L::kQChunk + swz<kFRows>(r, c8),
                 ok ? q + p * pc.q + qs.at(b, pos, kvh * G + r / bq) + c0 +
                          8 * c8
                    : q,
                 ok);
    }
    for (int i = tid; i < P * kKeys * kCP; i += kFThreads) {
      const int p = i / (kKeys * kCP);
      const int r = (i / kCP) % kKeys;
      const int c8 = i % kCP;
      const int so = p * L::kKChunk + swz<kKeys>(r, c8);
      const int key = kb0 + r;
      const bool ok = key < Sk;
      cp_async16(base + L::kK + so,
                 ok ? k + p * pc.k + ks.at(b, key, kvh) + c0 + 8 * c8 : k, ok);
      if (last)  // c0 is the slice's own chunk
        cp_async16(base + L::kV + so,
                   ok ? v + p * pc.v + vs.at(b, key, kvh) + c0 + 8 * c8 : v,
                   ok);
    }
  };
  if (nitems > 0) load(0, 0);
  cp_async_commit();

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

  float acc[kDT][4];  // O[:, slice], unnormalized
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};
  float s[kNT][4];          // S, summed over a step's chunks by wgmma
  uint32_t a_p[P][kPC][4];  // P's A fragments, live until P V retires

  for (int n = 0; n < nitems; ++n) {
    cp_async_wait<kStages - 2>();  // item n has landed
    tiles::fence_proxy_async();    // ... where wgmma reads it
    __syncthreads();  // ... for every thread, and item n - 1 is consumed
    if (n + 1 < nitems) load(n + 1, (n + 1) % kStages);
    cp_async_commit();
    const int st = n % kStages;
    const int j = n % nch;
    const unsigned char* tQ = xl_smem + st * L::kStage;
    const unsigned char* tK = tQ + L::kK;
    const unsigned char* tV = tQ + L::kV;

    // S (+)= Q_chunk K_chunk^T: piece term_a(t) of Q against piece
    // term_b(t) of K, both K-major from the swizzled stage
    tiles::fence_regs(flat(s));
    tiles::wgmma_fence();
    #pragma unroll
    for (int t = kT0; t < 6; ++t)
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const uint64_t da =
            kstep_desc<kFRows>(tQ + term_a(t) * L::kQChunk, 0, kc);
        const uint64_t db =
            kstep_desc<kKeys>(tK + term_b(t) * L::kKChunk, 0, kc);
        const int accumulate = j > 0 || t > kT0 || kc > 0;
        if constexpr (kKeys == kBK)
          wgmma_ss_n64<T>(flat(s), da, db, accumulate);
        else
          wgmma_ss_n32<T>(flat(s), da, db, accumulate);
      }
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));
    if (j != nch - 1) continue;

    const int step = n / nch;
    const int entry = entry_of(step / kHalves);
    const int kb0 = key_of(step);
    bool masked;
    if constexpr (kSeg)
      masked = !(entry & kFull) || kb0 + kKeys > Sk;
    else
      masked = kb0 + kKeys > Sk || (causal && kb0 + kKeys - 1 > q0 + off);
    const int* tseg = sKseg + st * kKeys;
    const int* tpos = sKpos + st * kKeys;
    // the dense kernel's softmax step; it rescales its accumulator by
    // alpha, here a [1][4] of ones that comes back as alpha of row gid
    // ([0][0]) and of row gid + 8 ([0][2])
    float alpha[1][4] = {{1.f, 1.f, 1.f, 1.f}};
    if (masked)
      softmax_tile<true, kSeg>(s, alpha, m_run, l_run, pos, kb0, Sk, causal,
                               off, scale_log2, tig, tseg, tpos, qid, qp);
    else
      softmax_tile<false, kSeg>(s, alpha, m_run, l_run, pos, kb0, Sk,
                                causal, off, scale_log2, tig, tseg, tpos, qid,
                                qp);

    // PV = P V_slice into a fresh accumulator (P rounded to T at P 1, as
    // the reference casts P to V's dtype; split into three bf16 pieces at
    // P 3), then O = O alpha + PV
    #pragma unroll
    for (int kc = 0; kc < kPC; ++kc)
      acc_to_pieces<T, P>(a_p, kc, s[2 * kc], s[2 * kc + 1]);
    float pv[kDT][4];
    tiles::fence_regs(flat(pv));
    tiles::wgmma_fence();
    #pragma unroll
    for (int t = kT0; t < 6; ++t)
      #pragma unroll
      for (int kc = 0; kc < kPC; ++kc)
        wgmma_rs_t_n128<T>(flat(pv), a_p[term_a(t)][kc],
                           desc_mn_sw128(tV + term_b(t) * L::kKChunk +
                                             16 * kc * 128,
                                         kKeys * 128),
                           t > kT0 || kc > 0);
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(pv));
    fence_frags(a_p);
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      #pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[dt][c] = fmaf(acc[dt][c], alpha[0][c & 2], pv[dt][c]);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // normalize into the warp's own 16 rows over the ring (P 1: padded rows
  // of T; P 3: float32 rows), LSE from the first slice, then the rows out
  // 16 bytes a store
  float inv[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = l > 0.f ? 1.f / l : 0.f;
    if (sl == 0 && tig == 0 && pos[i] < Sq) {
      lse[(static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i]] =
          l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : kBig;
    }
  }
  if constexpr (P == 1) {
    T* stage = reinterpret_cast<T*>(xl_smem);
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* row = stage + (warp * 16 + gid + 8 * i) * L::kOS;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
            pack2<T>(acc[dt][i * 2] * inv[i], acc[dt][i * 2 + 1] * inv[i]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * kCP; i += 32) {
      const int r = warp * 16 + i / kCP;
      const int c = (i % kCP) * 8;
      const int p = q0 + r % bq;
      if (p >= Sq) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D +
          sl * kXW;
      *reinterpret_cast<uint4*>(o + base + c) =
          *reinterpret_cast<const uint4*>(stage + r * L::kOS + c);
    }
  } else {
    float* f = reinterpret_cast<float*>(xl_smem);
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = f + (warp * 16 + gid + 8 * i) * L::kOS;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(row + dt * 8 + tig * 2) = make_float2(
            acc[dt][i * 2] * inv[i], acc[dt][i * 2 + 1] * inv[i]);
    }
    __syncwarp();
    constexpr int kQuads = kXW / 4;
    for (int i = lane; i < 16 * kQuads; i += 32) {
      const int r = warp * 16 + i / kQuads;
      const int c = (i % kQuads) * 4;
      const int p = q0 + r % bq;
      if (p >= Sq) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D +
          sl * kXW;
      *reinterpret_cast<float4*>(o + base + c) =
          *reinterpret_cast<const float4*>(f + r * L::kOS + c);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 (three bf16 pieces) at D 64/128/256 and fp16 at D 64/128, both
// branches
// ---------------------------------------------------------------------------

// P 3 at D 256: Q's pieces (96 KiB) and two stages of 16 keys (96 KiB)
// fill 192 KiB; 32-key stages would take 288
template <int D, int P>
struct TcSmem {
  static constexpr int kStages = 2;
  static constexpr int kKeys =  // keys a ring stage
      P == 1 ? kBK : D <= 128 ? kBK / 2 : kBK / 4;
  static constexpr int kPiece = kKeys * D * 2;  // a swizzled piece of K or V
  static constexpr int kTile = P * kPiece;      // a stage's K (or V) pieces
  static constexpr int kStage = 2 * kTile;      // K, then V
  static constexpr int kStride = D + 8;         // T a padded Q / O row (P 1)
  // P 1: Q is staged in the last stage (read into registers before that
  // stage's first tile lands) and O leaves through the first, as in the
  // segment kernel; P 3: Q's pieces stay resident after the ring (wgmma
  // reads them from shared memory) and O leaves as float32 rows over the
  // drained ring
  static_assert(P == 3 || kFRows * kStride * 2 <= kStage, "Q fits a stage");
  static_assert(P == 1 || kFRows * (D + 4) * 4 <= kStages * kStage,
                "float32 O fits the ring");
  static constexpr int kQ = P == 1 ? 0 : P * kFRows * D * 2;
  static constexpr int kBytes = kStages * kStage + kQ;
  // the segment branch's ints after those: each stage's kv ids and
  // positions, scratch, then the list of live pairs (one per key tile)
  static constexpr int kInts = 2 * kStages * kKeys + kSegScratch;
};

template <typename T, int P, int D, bool kSeg>
__global__ void __launch_bounds__(kFThreads, P == 1 || D == 64 ? 2 : 1)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, TcOut<T, P>* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int Hq, int Hk,
                    int causal, float scale_log2, Strides qs, Strides ks,
                    Strides vs, PieceStrides pc, Seg seg) {
  using L = TcSmem<D, P>;
  constexpr int kS = L::kStages;
  constexpr int kKeys = L::kKeys;
  constexpr int kHalves = kBK / kKeys;  // ring steps a key tile
  constexpr int kStride = L::kStride;
  constexpr int kKC = D / 16;           // k steps of S over the head dim
  constexpr int kDT = D / 8;            // n-tiles of O over the head dim
  constexpr int kNT = kKeys / 8;        // 8-key n-tiles of a step's S
  constexpr int kPC = kKeys / 16;       // k steps of P V
  constexpr int kPieces = D / 8;        // 16-byte pieces per row
  constexpr int kT0 = first_term(P);
  // at D 256 a second D-wide accumulator would not fit the registers: O
  // is rescaled first and P V accumulates into it
  constexpr bool kInPlace = D > 128;
  extern __shared__ __align__(1024) unsigned char tc_smem[];
  unsigned char* smem_raw = tc_smem;
  // stage st: K's pieces at smem_raw + st kStage, V's after them
  T* sQ = P == 1 ? reinterpret_cast<T*>(smem_raw + (kS - 1) * L::kStage)
                 : reinterpret_cast<T*>(smem_raw + kS * L::kStage);
  int* sKseg = reinterpret_cast<int*>(smem_raw + L::kBytes);  // [stage][kKeys]
  int* sKpos = sKseg + kS * kKeys;                            // [stage][kKeys]
  int* sScratch = sKpos + kS * kKeys;
  int* sList = sScratch + kSegScratch;

  const int G = Hq / Hk;
  const int bq = kFRows / G;  // query positions per CTA
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;  // last block first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;

  // stage Q: folded row r is (head kvh G + r / bq, position q0 + r % bq);
  // padded rows at P 1, each piece swizzled at P 3 (piece p at p kFRows D)
  for (int i = tid; i < P * kFRows * kPieces; i += kFThreads) {
    const int p = i / (kFRows * kPieces);
    const int r = (i / kPieces) % kFRows;
    const int c8 = i % kPieces;
    const int pos = q0 + r % bq;
    const bool ok = pos < Sq;
    const int at = P == 1 ? (r * kStride + 8 * c8) * 2
                          : p * kFRows * D * 2 + swz<kFRows>(r, c8);
    cp_async16(reinterpret_cast<unsigned char*>(sQ) + at,
               ok ? q + p * pc.q + qs.at(b, pos, kvh * G + r / bq) + 8 * c8
                  : q,
               ok);
  }
  cp_async_commit();

  // the key tiles this CTA walks, kHalves ring steps each: up to the
  // diagonal of its last live row, or the list of live pairs (its block's
  // bounds over its live positions against every key tile's)
  const int q_hi = min(q0 + bq, Sq) - 1;
  int nsteps;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const size_t at = static_cast<size_t>(b) * Sq + q0;
    const int4 mine = block_bounds(seg.qseg + at, seg.qpos + at,
                                   q_hi + 1 - q0, sScratch);
    nsteps = kHalves *
             live_pairs<true, true>(seg.kb + static_cast<size_t>(b) * 4 * nkt,
                                    nkt, mine, causal, sList, sScratch);
  } else {
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    nsteps = (kend + kKeys - 1) / kKeys;
  }
  // the list entry of the n-th key tile (flagged kFull / kOneId) and the
  // first key of ring step n
  auto entry_of = [&](int n) {
    if constexpr (kSeg) return sList[n];
    else return n;
  };
  auto key_of = [&](int n) {
    return (entry_of(n / kHalves) & (kOneId - 1)) * kBK +
           (n % kHalves) * kKeys;
  };

  auto load_kv = [&](int n, int st) {
    const int kb0 = key_of(n);
    unsigned char* dk = smem_raw + st * L::kStage;
    unsigned char* dv = dk + L::kTile;
    if constexpr (kSeg) {  // threads 0 .. kKeys - 1 copy the ids, the next
      if (tid < 2 * kKeys) {  // kKeys the positions
        const int i = tid % kKeys;
        const int key = kb0 + i;
        const bool ok = key < Sk;
        const int* src = tid < kKeys ? seg.kseg : seg.kpos;
        int* dst = (tid < kKeys ? sKseg : sKpos) + st * kKeys;
        cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key : src,
                  ok);
      }
    }
    for (int i = tid; i < P * kKeys * kPieces; i += kFThreads) {
      const int p = i / (kKeys * kPieces);
      const int r = (i / kPieces) % kKeys;
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
  #pragma unroll
  for (int st = 0; st < kS - 1; ++st) {
    if (st < nsteps) load_kv(st, st);
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
    if constexpr (kSeg) {
      if (pos[i] < Sq) {
        const size_t at = static_cast<size_t>(b) * Sq + pos[i];
        qid[i] = seg.qseg[at];
        qp[i] = seg.qpos[at];
      }
    }
  }

  cp_async_wait<kS - 1>();  // Q has landed (tiles may be in flight)
  __syncthreads();
  // P 1: each warp keeps its 16 rows' Q fragments in registers (the A
  // operand of S); at P 3 wgmma reads Q's pieces from shared memory
  uint32_t qf[P == 1 ? kKC : 1][4];
  if constexpr (P == 1) {
    #pragma unroll
    for (int kc = 0; kc < kKC; ++kc)
      ldsm_x4(qf[kc], sQ + (warp * 16 + (lane & 15)) * kStride + kc * 16 +
                          8 * (lane >> 4));
  }
  const unsigned char* pQ = reinterpret_cast<const unsigned char*>(sQ);

  // O in plain registers (mma.sync's C layout: [dt][2 i + e] is row
  // gid + 8 i, column 8 dt + 2 tig + e); each step's P V lands in a fresh
  // wgmma accumulator first, as in the segment kernel
  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums
  uint32_t a_p[P][kPC][4];      // P's A fragments, live until P V retires

  for (int n = 0; n < nsteps; ++n) {
    cp_async_wait<kS - 2>();     // step n's keys have landed
    tiles::fence_proxy_async();  // ... where wgmma reads them
    // ... for every thread, step n - 1's are consumed and (n 0) every warp
    // holds its Q fragments: the stage it leaves is refilled
    __syncthreads();
    if (n + kS - 1 < nsteps) load_kv(n + kS - 1, (n + kS - 1) % kS);
    cp_async_commit();
    const int st = n % kS;
    const unsigned char* tK = smem_raw + st * L::kStage;
    const unsigned char* tV = tK + L::kTile;
    const int* tseg = sKseg + st * kKeys;
    const int* tpos = sKpos + st * kKeys;
    const int entry = entry_of(n / kHalves);
    const int kb0 = key_of(n);
    const int kvalid = Sk - kb0;  // keys of the step before Sk
    // dense: a step that reaches past Sk or above the first row's diagonal
    // is masked; segments: as the segment kernel (a FULL pair needs no
    // mask unless it reaches past the keys; a masked pair of one id
    // compares positions only)
    bool by_pos, by_id, masked;
    if constexpr (kSeg) {
      by_pos = causal && !(entry & kFull);
      by_id = !(entry & (kFull | kOneId));
      masked = by_pos || by_id || kvalid < kKeys;
    } else {
      by_pos = by_id = false;
      masked = kvalid < kKeys || (causal && kb0 + kKeys - 1 > q0 + off);
    }

    // S = Q K^T for the CTA's 64 rows x the step's keys, in m64n32 halves:
    // A (Q) from the fragments in registers (P 1) or the staged pieces
    // (P 3), B (K, each piece) K-major from the swizzled stage
    float s[kNT][4];
    tiles::fence_regs(flat(s));
    tiles::wgmma_fence();
    if constexpr (kKeys == 16) {
      // P 3 at D 256: 96 m64n16 products a step. Into one accumulator they
      // would be one dependent chain; four (k steps kc % 4) run side by
      // side and are summed after. Q's 48 descriptors are rebuilt each
      // step from an address the compiler cannot hoist (hoisted, they took
      // 96 registers and spilled).
      float sg[3][8];
      int z = 0;
      asm volatile("" : "+r"(z));
      const unsigned char* pq = pQ + z;
      #pragma unroll
      for (int g = 0; g < 3; ++g) tiles::fence_regs(sg[g]);
      auto ss = [&](float (&d)[8], int t, int kc) {
        wgmma_ss_n16(d, kstep_desc<kFRows>(pq + term_a(t) * kFRows * D * 2,
                                           0, kc),
                     kstep_desc<kKeys>(tK + term_b(t) * L::kPiece, 0, kc),
                     t > kT0 || kc >= 4);
      };
      #pragma unroll
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kKC; kc += 4) {
          ss(flat(s), t, kc);
          ss(sg[0], t, kc + 1);
          ss(sg[1], t, kc + 2);
          ss(sg[2], t, kc + 3);
        }
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      #pragma unroll
      for (int g = 0; g < 3; ++g) tiles::fence_regs(sg[g]);
      tiles::fence_regs(flat(s));
      #pragma unroll
      for (int i = 0; i < 8; ++i)
        flat(s)[i] = (flat(s)[i] + sg[0][i]) + (sg[1][i] + sg[2][i]);
    }
    #pragma unroll
    for (int h = 0; h < kKeys / 32; ++h) {
      float (&sh)[4][4] = *reinterpret_cast<float(*)[4][4]>(&s[4 * h]);
      #pragma unroll
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kKC; ++kc) {
          const uint64_t bk =
              kstep_desc<kKeys>(tK + term_b(t) * L::kPiece, 32 * h, kc);
          if constexpr (P == 1)
            wgmma_rs_n32<T>(flat(sh), qf[kc], bk, kc);
          else
            wgmma_ss_n32(flat(sh),
                         kstep_desc<kFRows>(pQ + term_a(t) * kFRows * D * 2,
                                            0, kc),
                         bk, t > kT0 || kc > 0);
        }
    }
    tiles::wgmma_commit();
    tiles::wgmma_wait<0>();
    tiles::fence_regs(flat(s));

    // scale and mask: [nt][2 i + j] is row gid + 8 i and key 8 nt + 2 tig
    // + j of the step
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int kl = nt * 8 + tig * 2;
      int2 kid = make_int2(0, 0), kps = make_int2(0, 0);
      if (kSeg && by_id) kid = *reinterpret_cast<const int2*>(tseg + kl);
      if (kSeg && by_pos) kps = *reinterpret_cast<const int2*>(tpos + kl);
      #pragma unroll
      for (int i = 0; i < 2; ++i)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          float x = s[nt][i * 2 + j] * scale_log2;
          if (masked) {
            bool out = kl + j >= kvalid;
            if constexpr (kSeg)
              out = out || (by_id && (j ? kid.y : kid.x) != qid[i]) ||
                    (by_pos && (j ? kps.y : kps.x) > qp[i]);
            else
              out = out || (causal && kb0 + kl + j > pos[i] + off);
            if (out) x = kNeg;
          }
          s[nt][i * 2 + j] = x;
        }
    }

    // online softmax of rows gid (i 0) and gid + 8 (i 1) over the step
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

    // PV = P V: the C fragments of n-tiles 2kc, 2kc+1 are the A fragment
    // of k step kc (rounded to fp16 at P 1, as the reference casts P to
    // V's dtype; float32 P split into three pieces at P 3); B is each of
    // V's pieces read MN-major (keys along k, the head dim along n)
    #pragma unroll
    for (int kc = 0; kc < kPC; ++kc)
      acc_to_pieces<T, P>(a_p, kc, s[2 * kc], s[2 * kc + 1]);
    if constexpr (kInPlace) {
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        #pragma unroll
        for (int c = 0; c < 4; ++c) acc[dt][c] *= alpha[c >> 1];
      tiles::fence_regs(flat(acc));
      tiles::wgmma_fence();
      #pragma unroll
      for (int t = kT0; t < 6; ++t)
        #pragma unroll
        for (int kc = 0; kc < kPC; ++kc)
          wgmma_rs_t<D, T>(flat(acc), a_p[term_a(t)][kc],
                           desc_mn_sw128(tV + term_b(t) * L::kPiece +
                                             16 * kc * 128,
                                         kKeys * 128),
                           1);
      tiles::wgmma_commit();
      tiles::wgmma_wait<0>();
      tiles::fence_regs(flat(acc));
      fence_frags(a_p);
      continue;
    }
    float pv[kDT][4];
    tiles::fence_regs(flat(pv));
    tiles::wgmma_fence();
    #pragma unroll
    for (int t = kT0; t < 6; ++t)
      #pragma unroll
      for (int kc = 0; kc < kPC; ++kc)
        wgmma_rs_t<D, T>(flat(pv), a_p[term_a(t)][kc],
                         desc_mn_sw128(tV + term_b(t) * L::kPiece +
                                           16 * kc * 128,
                                       kKeys * 128),
                         t > kT0 || kc > 0);
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

  // finalize: full row sums across the quad, LSE from the owning threads,
  // normalized O through the first stage (P 1: the warp's own 16 rows of
  // T; P 3: float32 rows of the whole CTA), then out 16 bytes a store
  float inv[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = l > 0.f ? 1.f / l : 0.f;
    if (tig == 0 && pos[i] < Sq) {
      lse[(static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i]] =
          l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : kBig;
    }
  }
  if constexpr (P == 1) {
    T* sO = reinterpret_cast<T*>(smem_raw);
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* row = sO + (warp * 16 + gid + 8 * i) * kStride;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<uint32_t*>(row + dt * 8 + tig * 2) =
            pack2<T>(acc[dt][i * 2] * inv[i], acc[dt][i * 2 + 1] * inv[i]);
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
  } else {
    constexpr int kFS = D + 4;  // floats a staged row
    float* f = reinterpret_cast<float*>(smem_raw);
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = f + (warp * 16 + gid + 8 * i) * kFS;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(row + dt * 8 + tig * 2) = make_float2(
            acc[dt][i * 2] * inv[i], acc[dt][i * 2 + 1] * inv[i]);
    }
    __syncthreads();
    constexpr int kQuads = D / 4;
    for (int i = tid; i < kFRows * kQuads; i += kFThreads) {
      const int r = i / kQuads;
      const int c = (i % kQuads) * 4;
      const int p = q0 + r % bq;
      if (p >= Sq) continue;
      const size_t base =
          ((static_cast<size_t>(b) * Sq + p) * Hq + kvh * G + r / bq) * D;
      *reinterpret_cast<float4*>(o + base + c) =
          *reinterpret_cast<const float4*>(f + r * kFS + c);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  int B, Sq, Sk, Hq, Hk, D, causal;
  float sl2;
  Strides qs, ks, vs;
  Seg seg;
  int* kv_bounds;  // the segment branch's workspace
  cudaStream_t s;
};

// the mma.sync kernel: the dense branch at D 64 and 128
template <int D>
cudaError_t launch_dense(const Args& a) {
  static int allowed = 0;
  const int bytes = FwdSmem<D>::kBytes;
  cudaError_t e = allow_dynamic_smem(flash_fwd_kernel<D>, bytes, allowed);
  if (e != cudaSuccess) return e;
  const int bq = kFRows / (a.Hq / a.Hk);
  const dim3 grid((a.Sq + bq - 1) / bq, a.Hk, a.B);
  flash_fwd_kernel<D><<<grid, kFThreads, bytes, a.s>>>(
      a.q, a.k, a.v, a.o, a.lse, a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.sl2,
      a.qs, a.ks, a.vs);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled (async_tiles.cuh)
using tiles::encode_tiled;

// Tensor maps encoded so far, by all that a map encodes (base address,
// dims, strides; the box and swizzle follow from `kind`): a map found here
// is the one the call would encode, and cuTensorMapEncodeTiled costs
// microseconds of host time a call, more than a short launch. PyTorch's
// caching allocator hands the same buffers back call after call, so a
// training step's or a server's maps are found after the first call.
struct MapKey {
  const void* base;
  long long kind;  // 0: kv_map (bf16), 1: int_map, 2: kv_map (fp16)
  long long dims[4];
  long long strides[3];
  bool operator==(const MapKey& o) const {
    if (base != o.base || kind != o.kind) return false;
    for (int i = 0; i < 4; ++i)
      if (dims[i] != o.dims[i]) return false;
    for (int i = 0; i < 3; ++i)
      if (strides[i] != o.strides[i]) return false;
    return true;
  }
};

struct MapCache {
  static constexpr int kSize = 32;  // entries, replaced round robin
  std::mutex mu;
  MapKey keys[kSize];
  CUtensorMap maps[kSize];
  int n = 0, next = 0;
};

// *map for key: from the cache, or encoded by encode(map) and kept
template <typename Encode>
bool cached_map(CUtensorMap* map, const MapKey& key, Encode encode) {
  static MapCache cache;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (int i = 0; i < cache.n; ++i)
    if (cache.keys[i] == key) {
      *map = cache.maps[i];
      return true;
    }
  if (!encode(map)) return false;
  cache.keys[cache.next] = key;
  cache.maps[cache.next] = *map;
  cache.next = (cache.next + 1) % MapCache::kSize;
  if (cache.n < MapCache::kSize) ++cache.n;
  return true;
}

// a [B, S, H, 256] operand of T (bf16 or fp16) read through its strides as
// 4-d boxes of 64 columns x 1 head x 64 positions x 1 batch row, 128-byte
// swizzle, zeros past S
template <typename T>
bool kv_map(CUtensorMap* map, const void* base, int B, int S, int H,
            const Strides& st) {
  const MapKey key = {base, kIsHalf<T> ? 2 : 0, {256, H, S, B},
                      {st.h, st.s, st.b}};
  return cached_map(map, key, [&](CUtensorMap* m) {
    const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[4] = {256, static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                   static_cast<cuuint64_t>(st.s) * 2,
                                   static_cast<cuuint64_t>(st.b) * 2};
    const cuuint32_t box[4] = {64, 1, kBK, 1};
    const cuuint32_t estrides[4] = {1, 1, 1, 1};
    return fn(m,
              kIsHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              4, const_cast<void*>(base), dims, strides, box, estrides,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// n int32 values as 1-d boxes of 64
bool int_map(CUtensorMap* map, const int* base, long long n) {
  const MapKey key = {base, 1, {n, 0, 0, 0}, {0, 0, 0}};
  return cached_map(map, key, [&](CUtensorMap* m) {
    const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {0};
    const cuuint32_t box[1] = {kBK};
    const cuuint32_t estrides[1] = {1};
    return fn(m, CU_TENSOR_MAP_DATA_TYPE_INT32, 1, const_cast<int*>(base),
              dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  });
}

// head dim 256 in T (bf16 or fp16), both branches (kSeg after one launch
// of the key tiles' bounds): 128 folded rows a CTA, K and V through TMA
// tensor maps
template <typename T, bool kSeg>
cudaError_t launch_256(const Args& a) {
  static int allowed = 0;
  using L = Fwd256Smem;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int bytes = L::kBytes + (kSeg ? (L::kInts + nkt) * 4 : 0);
  cudaError_t e =
      allow_dynamic_smem(flash_fwd_256_kernel<T, kSeg>, bytes, allowed);
  if (e != cudaSuccess) return e;
  CUtensorMap kmap, vmap, idmap = {}, posmap = {};
  if (!kv_map<T>(&kmap, a.k, a.B, a.Sk, a.Hk, a.ks) ||
      !kv_map<T>(&vmap, a.v, a.B, a.Sk, a.Hk, a.vs))
    return cudaErrorInvalidValue;
  if (kSeg) {
    if (!int_map(&idmap, a.seg.kseg, static_cast<long long>(a.B) * a.Sk) ||
        !int_map(&posmap, a.seg.kpos, static_cast<long long>(a.B) * a.Sk))
      return cudaErrorInvalidValue;
    e = launch_bounds(Side{a.seg.kseg, a.seg.kpos, a.kv_bounds, a.Sk},
                      Side{}, a.B, a.s);
    if (e != cudaSuccess) return e;
  }
  // causal without segments: two blocks a CTA (the j-th from each end)
  const int bq = kRows2 / (a.Hq / a.Hk);
  const int nqb = (a.Sq + bq - 1) / bq;
  const dim3 grid(!kSeg && a.causal ? (nqb + 1) / 2 : nqb, a.Hk, a.B);
  flash_fwd_256_kernel<T, kSeg><<<grid, kT3, bytes, a.s>>>(
      kmap, vmap, idmap, posmap, reinterpret_cast<const T*>(a.q),
      reinterpret_cast<T*>(a.o), a.lse, a.Sq, a.Sk, a.Hq, a.Hk, a.causal,
      a.sl2, a.qs, a.seg);
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

// above head dim 256: one launch of the key
// tiles' bounds (kSeg), then one CTA a (row block, slice)
template <typename T, int P, bool kSeg>
cudaError_t launch_xl(const Args& a, const PieceStrides& pc) {
  static int allowed = 0;
  using L = XlSmem<P>;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int bytes = L::kBytes + (kSeg ? (L::kInts + nkt) * 4 : 0);
  auto kern = flash_fwd_xl_kernel<T, P, kSeg>;
  cudaError_t e = allow_dynamic_smem(kern, bytes, allowed);
  if (e != cudaSuccess) return e;
  if (kSeg) {
    e = launch_bounds(Side{a.seg.kseg, a.seg.kpos, a.kv_bounds, a.Sk},
                      Side{}, a.B, a.s);
    if (e != cudaSuccess) return e;
  }
  const int bq = kFRows / (a.Hq / a.Hk);
  const long long ctas = static_cast<long long>((a.Sq + bq - 1) / bq) *
                         a.Hk * a.B * (a.D / kXW);
  if (ctas > INT_MAX) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(ctas), kFThreads, bytes, a.s>>>(
      reinterpret_cast<const T*>(a.q), reinterpret_cast<const T*>(a.k),
      reinterpret_cast<const T*>(a.v), reinterpret_cast<TcOut<T, P>*>(a.o),
      a.lse, a.B, a.Sq, a.Sk, a.Hq, a.Hk, a.D, a.causal, a.sl2, a.qs, a.ks,
      a.vs, pc, a.seg);
  return cudaGetLastError();
}

// the float32 (pieces) and fp16 kernel at D 64 / 128 (float32 also 256),
// dense or segment
// branch (kSeg after one launch of the key tiles' bounds)
template <typename T, int P, int D, bool kSeg>
cudaError_t launch_tc(const Args& a, const PieceStrides& pc) {
  static int allowed = 0;
  using L = TcSmem<D, P>;
  const int nkt = (a.Sk + kBK - 1) / kBK;
  const int bytes = L::kBytes + (kSeg ? (L::kInts + nkt) * 4 : 0);
  auto kern = flash_fwd_tc_kernel<T, P, D, kSeg>;
  cudaError_t e = allow_dynamic_smem(kern, bytes, allowed);
  if (e != cudaSuccess) return e;
  if (kSeg) {
    e = launch_bounds(Side{a.seg.kseg, a.seg.kpos, a.kv_bounds, a.Sk},
                      Side{}, a.B, a.s);
    if (e != cudaSuccess) return e;
  }
  const int bq = kFRows / (a.Hq / a.Hk);
  const dim3 grid((a.Sq + bq - 1) / bq, a.Hk, a.B);
  kern<<<grid, kFThreads, bytes, a.s>>>(
      reinterpret_cast<const T*>(a.q), reinterpret_cast<const T*>(a.k),
      reinterpret_cast<const T*>(a.v), reinterpret_cast<TcOut<T, P>*>(a.o),
      a.lse, a.Sq, a.Sk, a.Hq, a.Hk, a.causal, a.sl2, a.qs, a.ks, a.vs, pc,
      a.seg);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_tc(const Args& a, const PieceStrides& pc) {
  const bool sg = a.seg.qseg != nullptr;
  if constexpr (P == 3) {
    if (a.D == 256)
      return sg ? launch_tc<T, P, 256, true>(a, pc)
                : launch_tc<T, P, 256, false>(a, pc);
  }
  if (a.D == 128)
    return sg ? launch_tc<T, P, 128, true>(a, pc)
              : launch_tc<T, P, 128, false>(a, pc);
  if (a.D == 64)
    return sg ? launch_tc<T, P, 64, true>(a, pc)
              : launch_tc<T, P, 64, false>(a, pc);
  return cudaErrorInvalidValue;
}

// the C entry points' arguments; false when the segment pointers are
// neither all NULL nor all given or the GQA group does not divide 64
bool make_args(Args* a, const void* q, const void* k, const void* v, void* o,
               void* lse, const void* q_seg, const void* kv_seg,
               const void* q_pos, const void* kv_pos, void* kv_bounds, int B,
               int Sq, int Sk, int Hq, int Hk, int D, int causal, float scale,
               long long qsb, long long qss, long long qsh, long long ksb,
               long long kss, long long ksh, long long vsb, long long vss,
               long long vsh, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || kFRows % (Hq / Hk) != 0) return false;
  *a = Args{};
  a->q = static_cast<const __nv_bfloat16*>(q);
  a->k = static_cast<const __nv_bfloat16*>(k);
  a->v = static_cast<const __nv_bfloat16*>(v);
  a->o = static_cast<__nv_bfloat16*>(o);
  a->lse = static_cast<float*>(lse);
  a->B = B;
  a->Sq = Sq;
  a->Sk = Sk;
  a->Hq = Hq;
  a->Hk = Hk;
  a->D = D;
  a->causal = causal;
  a->sl2 = scale * kLog2e;
  a->qs = Strides{qsb, qss, qsh};
  a->ks = Strides{ksb, kss, ksh};
  a->vs = Strides{vsb, vss, vsh};
  a->seg = Seg{static_cast<const int*>(q_seg),
               static_cast<const int*>(kv_seg),
               static_cast<const int*>(q_pos),
               static_cast<const int*>(kv_pos), nullptr,
               static_cast<const int*>(kv_bounds)};
  a->kv_bounds = static_cast<int*>(kv_bounds);
  a->s = static_cast<cudaStream_t>(stream);
  return a->seg.qseg == nullptr ||
         (a->seg.kseg && a->seg.qpos && a->seg.kpos && a->kv_bounds);
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
  Args a;
  if (!make_args(&a, q, k, v, o, lse, q_seg, kv_seg, q_pos, kv_pos,
                 kv_bounds, B, Sq, Sk, Hq, Hk, D, causal, scale, qsb, qss,
                 qsh, ksb, kss, ksh, vsb, vss, vsh, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool segmented = a.seg.qseg != nullptr;
  if (!(D == 64 || D == 128 || D == 256 || (D > 256 && D % kXW == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t e;
  using BF = __nv_bfloat16;
  if (D > 256)
    e = segmented ? launch_xl<BF, 1, true>(a, {})
                  : launch_xl<BF, 1, false>(a, {});
  else if (D == 256)
    e = segmented ? launch_256<BF, true>(a) : launch_256<BF, false>(a);
  else if (D == 128)
    e = segmented ? launch_seg<128>(a) : launch_dense<128>(a);
  else
    e = segmented ? launch_seg<64>(a) : launch_dense<64>(a);
  return static_cast<int>(e);
}

// dtype 1: fp16 q, k, v and O; dtype 2: q, k and v each point at three
// bf16 pieces [3, B, S, H, D], contiguous (flash_split_bf16x3; the strides
// are piece 0's), and O is float32. D as flash_fwd_bf16 takes it: fp16 at
// 64/128 on flash_fwd_tc_kernel, 256 on flash_fwd_256_kernel, above on
// flash_fwd_xl_kernel; float32's pieces up to 256 on flash_fwd_tc_kernel,
// above on flash_fwd_xl_kernel (P 3).
extern "C" int flash_fwd_tc(int dtype, const void* q, const void* k,
                            const void* v, void* o, void* lse,
                            const void* q_seg, const void* kv_seg,
                            const void* q_pos, const void* kv_pos,
                            void* kv_bounds, int B, int Sq, int Sk, int Hq,
                            int Hk, int D, int causal, float scale,
                            long long qsb, long long qss, long long qsh,
                            long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh,
                            void* stream) {
  Args a;
  if (!make_args(&a, q, k, v, o, lse, q_seg, kv_seg, q_pos, kv_pos,
                 kv_bounds, B, Sq, Sk, Hq, Hk, D, causal, scale, qsb, qss,
                 qsh, ksb, kss, ksh, vsb, vss, vsh, stream) ||
      (dtype != 1 && dtype != 2) ||
      !(D == 64 || D == 128 || D == 256 || (D > 256 && D % kXW == 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const bool sg = a.seg.qseg != nullptr;
  cudaError_t e;
  if (dtype == 1) {
    if (D <= 128)
      e = launch_tc<__half, 1>(a, {});
    else if (D == 256)
      e = sg ? launch_256<__half, true>(a) : launch_256<__half, false>(a);
    else
      e = sg ? launch_xl<__half, 1, true>(a, {})
             : launch_xl<__half, 1, false>(a, {});
    return static_cast<int>(e);
  }
  const PieceStrides pc = {qsb * B, ksb * B, vsb * B};
  using BF = __nv_bfloat16;
  if (D <= 256)
    e = launch_tc<BF, 3>(a, pc);
  else
    e = sg ? launch_xl<BF, 3, true>(a, pc) : launch_xl<BF, 3, false>(a, pc);
  return static_cast<int>(e);
}
