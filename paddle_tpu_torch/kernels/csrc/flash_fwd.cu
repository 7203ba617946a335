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
// fully masked row gives O = 0 and LSE = +1e30. D is 64 or 128.
//
// With segment ids (the Pallas body's `has_seg` branch, :305, the mask of
// `_block_mask` at :257) a query sees a key of its own segment and, if
// causal, of a position not after its own (flash_common.cuh).
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
// - The segment branch (kSeg): each 64-key tile stages its 64 kv ids and
//   positions beside K/V, by 4-byte cp.async in the same commit group, and
//   each row keeps its query's id and position in registers. The global
//   diagonal does not apply: no `kend`, and the mask runs on every tile.
//   Before the first load the CTA reduces its rows' [min, max] id and
//   compacts the key tiles whose range overlaps it into a list in shared
//   memory (`live_tiles`); the ring walks that list. A packed row of T
//   tokens then costs about sum L_i^2 of tile pairs, not T^2.
// - Not yet: wgmma and TMA; the products stay on mma.sync.

#include "async_tiles.cuh"
#include "flash_common.cuh"

namespace {

using namespace flash;
using tiles::cp_async16;
using tiles::cp_async_commit;
using tiles::cp_async_wait;
using tiles::ldsm_x4;
using tiles::ldsm_x4_trans;

constexpr int kFThreads = 128;  // 4 warps x 16 rows
constexpr int kFRows = 64;      // folded rows per CTA
constexpr int kStages = 2;      // K/V ring depth

template <int D>
struct FwdSmem {
  static constexpr int kStride = D + 8;  // bf16 per padded row
  static constexpr int kQ = kFRows * kStride;
  static constexpr int kKV = kBK * kStride;  // one K or V tile
  static constexpr int kBytes = (kQ + 2 * kStages * kKV) * 2;
  // the segment branch's ints after the ring: each stage's kv ids and
  // positions, scratch, then the list of live key tiles (one per tile)
  static constexpr int kSegInts = 2 * kStages * kBK + kScratchInts;
};

// mask (when kMask), scale and online softmax of one 64-key tile; s holds P
// (unnormalized, f32) afterwards, acc and the running max/sum are rescaled.
// kSeg masks by the tile's staged ids and positions (tseg, tpos) against
// the rows' (qid, qp); otherwise by the bottom-right causal diagonal.
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
          bool hide;
          if constexpr (kSeg)
            hide = key >= Sk || tseg[kl] != qid[i] ||
                   (causal && tpos[kl] > qp[i]);
          else
            hide = key >= Sk || (causal && key > pos[i] + off);
          if (hide) x = kNeg;
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

template <int D, bool kSeg>
__global__ void __launch_bounds__(kFThreads, 2)
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + L::kQ;             // [stage][kBK][kStride]
  __nv_bfloat16* sV = sK + kStages * L::kKV;  // [stage][kBK][kStride]
  // segment branch only: [stage][kBK] kv ids, then positions, scratch and
  // the live tile list
  int* sKseg = reinterpret_cast<int*>(sV + kStages * L::kKV);
  int* sKpos = sKseg + kStages * kBK;
  int* sScratch = sKpos + kStages * kBK;
  int* sList = sScratch + kScratchInts;

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
  // segments, the tiles whose id range overlaps the rows' (sList)
  const int q_hi = min(q0 + bq, Sq) - 1;
  int ntiles;
  if constexpr (kSeg) {
    const int nkt = (Sk + kBK - 1) / kBK;
    const int2 r = id_range(seg.qseg + static_cast<size_t>(b) * Sq + q0,
                            q_hi + 1 - q0, sScratch);
    ntiles = live_tiles(seg.krange + static_cast<size_t>(b) * nkt, nkt, r.x,
                        r.y, sList, sScratch);
  } else {
    const int kend = max(causal ? min(Sk, q_hi + off + 1) : Sk, 0);
    ntiles = (kend + kBK - 1) / kBK;
  }
  // the key tile of the n-th step
  auto tile_of = [&](int n) {
    if constexpr (kSeg) return sList[n];
    else return n;
  };

  auto load_kv = [&](int n, int st) {
    const int t = tile_of(n);
    __nv_bfloat16* dk = sK + st * L::kKV;
    __nv_bfloat16* dv = sV + st * L::kKV;
    if constexpr (kSeg) {  // threads 0-63 copy the ids, 64-127 positions
      const int i = tid % kBK;
      const int key = t * kBK + i;
      const bool ok = key < Sk;
      const int* src = tid < kBK ? seg.kseg : seg.kpos;
      int* dst = (tid < kBK ? sKseg : sKpos) + st * kBK;
      tiles::cp_async4(dst + i, ok ? src + static_cast<size_t>(b) * Sk + key
                                   : src, ok);
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
  // with their query's segment id and position (segment branch)
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
  uint32_t qf[kKC][4];
  #pragma unroll
  for (int kc = 0; kc < kKC; ++kc)
    ldsm_x4(qf[kc], sQ + (warp * 16 + (lane & 15)) * kStride + kc * 16 +
                        8 * (lane >> 4));

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();  // step t's tile has landed
    __syncthreads();  // ... for every thread, and step t - 1's is consumed
    if (t + kStages - 1 < ntiles)
      load_kv(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const int st = t % kStages;
    const __nv_bfloat16* tK = sK + st * L::kKV;
    const __nv_bfloat16* tV = sV + st * L::kKV;

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

    // only tiles that reach past Sk or above the first row's diagonal need
    // the mask; with segments, every tile
    const int t0 = tile_of(t) * kBK;
    if constexpr (kSeg)
      softmax_tile<true, true>(s, acc, m_run, l_run, pos, t0, Sk, causal,
                               off, scale_log2, tig, sKseg + st * kBK,
                               sKpos + st * kBK, qid, qp);
    else if (t0 + kBK > Sk || (causal && t0 + kBK - 1 > q0 + off))
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

template <int D, bool kSeg>
int launch_branch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                  const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                  int B, int Sq, int Sk, int Hq, int Hk, int causal,
                  float scale_log2, Strides qs, Strides ks, Strides vs,
                  const Seg& seg, cudaStream_t st) {
  static int smem_allowed = 0;
  const int bytes =
      FwdSmem<D>::kBytes +
      (kSeg ? (FwdSmem<D>::kSegInts + (Sk + kBK - 1) / kBK) * 4 : 0);
  const cudaError_t err =
      allow_dynamic_smem(flash_fwd_kernel<D, kSeg>, bytes, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bq = kFRows / (Hq / Hk);
  const dim3 grid((Sq + bq - 1) / bq, Hk, B);
  flash_fwd_kernel<D, kSeg><<<grid, kFThreads, bytes, st>>>(
      q, k, v, o, lse, Sq, Sk, Hq, Hk, causal, scale_log2, qs, ks, vs, seg);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B,
           int Sq, int Sk, int Hq, int Hk, int causal, float scale_log2,
           Strides qs, Strides ks, Strides vs, const Seg& seg,
           cudaStream_t st) {
  if (seg.qseg)
    return launch_branch<D, true>(q, k, v, o, lse, B, Sq, Sk, Hq, Hk,
                                  causal, scale_log2, qs, ks, vs, seg, st);
  return launch_branch<D, false>(q, k, v, o, lse, B, Sq, Sk, Hq, Hk, causal,
                                 scale_log2, qs, ks, vs, seg, st);
}

}  // namespace

// q_seg, kv_seg, q_pos, kv_pos and kv_range are NULL on the dense branch;
// otherwise all five are given (flash_common.cuh: Seg)
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* q_seg,
                              const void* kv_seg, const void* q_pos,
                              const void* kv_pos, const void* kv_range,
                              int B, int Sq, int Sk, int Hq, int Hk, int D,
                              int causal, float scale, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || kFRows % (Hq / Hk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto* ll = static_cast<float*>(lse);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const Seg seg{static_cast<const int*>(q_seg),
                static_cast<const int*>(kv_seg),
                static_cast<const int*>(q_pos),
                static_cast<const int*>(kv_pos), nullptr,
                static_cast<const int2*>(kv_range)};
  if (seg.qseg && !(seg.kseg && seg.qpos && seg.kpos && seg.krange))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 128)
    return launch<128>(qq, kk, vv, oo, ll, B, Sq, Sk, Hq, Hk, causal, sl2,
                       qs, ks, vs, seg, s);
  if (D == 64)
    return launch<64>(qq, kk, vv, oo, ll, B, Sq, Sk, Hq, Hk, causal, sl2,
                      qs, ks, vs, seg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
