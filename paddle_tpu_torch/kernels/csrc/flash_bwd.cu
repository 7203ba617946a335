// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV, bf16 in,
// f32 accumulate.
//
// Replaces the Pallas TPU kernels `_dq_kernel` and `_dkv_kernel`
// (paddle_tpu/kernels/pallas/flash_attention.py:358, :408), the two halves
// of the custom VJP of the flash forward (flash_fwd.cu). Both recompute
// P = exp(S * scale - LSE) from the forward's LSE, masked to 0, and use
// Delta = rowsum(dO * O), which the wrapper computes before the launch:
//   dP = dO V^T,  dS = P * (dP - Delta) * scale,
//   dQ = dS K,    dK = dS^T Q,    dV = P^T dO.
// Inputs: q/dO [B, Sq, Hq, D], k/v [B, Sk, Hk, D] bf16, read through their
// batch, sequence and head strides (the head dim contiguous); LSE and Delta
// f32 [B, Hq, Sq]. Outputs dQ [B, Sq, Hq, D], dK/dV [B, Sk, Hk, D] bf16,
// contiguous. D is 64 or 128; Hq = G * Hk with G dividing 64. Causal
// masking is bottom-right aligned (query i sees keys j <= i + Sk - Sq);
// a fully masked row (LSE = +1e30) gets P = 0 and zero gradients. Ragged
// Sq and Sk are masked in the kernels: tiles are zero-filled past the end
// and nothing is padded on the host. With segment ids (the Pallas bodies'
// `has_seg` branch, :382 and :435) a query sees a key of its own segment
// and, if causal, of a position not after its own (flash_common.cuh); P is
// 0 wherever that mask is false, so a row no key is visible to gets dQ = 0
// and a key no row sees gets dK = dV = 0.
//
// What bounds it on this card: at training lengths (S ~ 1024) the work is
// the recomputed products -- 3 (dQ) and 4 (dK/dV) of 2 * Sq * Sk * D flops
// per head, halved for causal -- against a few MB of inputs read once, so
// tensor-core throughput bounds both kernels, not bytes.
//
// Design (the TPU's two-kernel split, kept on purpose: no atomics, so the
// result is deterministic):
// - flash_bwd_dq: one CTA of 4 warps owns 64 folded rows (the G query
//   heads of one kv head x 64/G positions, as the forward). A loop inside
//   the CTA walks 64-key tiles of K and V staged in shared memory, and
//   stops at the causal diagonal. Each warp keeps its 16 rows' Q and dO
//   fragments and its dQ accumulator in registers; S and dP come from
//   mma.sync, dS is rounded to bf16 and fed from registers into dQ += dS K.
//   dQ is written once.
// - flash_bwd_dkv: one CTA owns one (batch, kv head, 64-key tile); K and V
//   of the tile stay in shared memory. A loop walks the query tiles from
//   the causal diagonal to the end and, inside, the G heads of the group:
//   each (tile, head) stages 64 rows of Q and dO (and their LSE, Delta) in
//   shared memory. Each warp owns 16 keys and computes S^T = K Q^T and
//   dP^T = V dO^T, so P^T and dS^T come out as A fragments in registers
//   for dV += P^T dO and dK += dS^T Q, accumulated in f32 and written
//   once. The sum over the group's heads happens in these accumulators;
//   KV is never expanded. Shared memory is 4 tiles of 64 x (D + 8) bf16
//   (37 KB at D 64, 69 KB at D 128, above the 48 KB default, so the
//   kernel is opened up with cudaFuncSetAttribute).
// - The segment branch (kSeg) in both: each staged tile carries its ids
//   and positions in shared memory beside it (64 keys for dQ, 64 query
//   rows for dK/dV), and the rows (dQ) or keys (dK/dV) a thread owns keep
//   theirs in registers. The global diagonal does not apply (no `kend`, no
//   `qstart`); the tiles walked are those whose id range overlaps the
//   CTA's, compacted into a list in shared memory (`live_tiles`).
// - Simple first: no cp.async pipelining, no wgmma/TMA, no fused
//   single-pass backward yet.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per tile of the dK/dV kernel

// the dQ kernel's dynamic shared memory on the segment branch: the tile's
// kv ids and positions, scratch, then the live key tiles' list
constexpr int kDqSegInts = 2 * kBK + kScratchInts;

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int Hq,
                    int Hk, int causal, float scale, float scale_log2,
                    Strides qs, Strides ks, Strides vs, Strides dos,
                    Seg seg) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free reads
  constexpr int kKC = D / 16;     // k-chunks over the head dim
  constexpr int kDT = D / 8;      // n-tiles over the head dim
  constexpr int kNT = kBK / 8;    // n-tiles over a key tile
  __shared__ __align__(16) __nv_bfloat16 sK[kBK * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBK * kStride];
  extern __shared__ int seg_smem[];  // segment branch only
  int* sKseg = seg_smem;
  int* sKpos = sKseg + kBK;
  int* sScratch = sKpos + kBK;
  int* sList = sScratch + kScratchInts;

  const int G = Hq / Hk;
  const int bq = kRows / G;  // query positions per CTA
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;

  // the two rows this thread owns in the mma layout: gid and gid + 8,
  // with their query's segment id and position (segment branch)
  int pos[2], head[2], qid[2], qp[2];
  bool live[2];
  float lse2[2], dlt[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    head[i] = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
    live[i] = pos[i] < Sq;
    const size_t row = (static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i];
    lse2[i] = live[i] ? lse[row] * kLog2e : kBig;
    dlt[i] = live[i] ? delta[row] : 0.f;
    qid[i] = -2;
    qp[i] = 0;
    if constexpr (kSeg) {
      if (live[i]) {
        qid[i] = seg.qseg[static_cast<size_t>(b) * Sq + pos[i]];
        qp[i] = seg.qpos[static_cast<size_t>(b) * Sq + pos[i]];
      }
    }
  }

  // Q and dO fragments for the whole head dim, straight from global memory
  uint32_t qf[kKC][4], df[kKC][4];
  #pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    #pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int i = reg & 1;
      const int col = kc * 16 + tig * 2 + ((reg >> 1) << 3);
      uint32_t qv = 0, dv = 0;
      if (live[i]) {
        qv = *reinterpret_cast<const uint32_t*>(
            q + qs.at(b, pos[i], head[i]) + col);
        dv = *reinterpret_cast<const uint32_t*>(
            dout + dos.at(b, pos[i], head[i]) + col);
      }
      qf[kc][reg] = qv;
      df[kc][reg] = dv;
    }
  }

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

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
    int kend = causal ? min(Sk, q_hi + off + 1) : Sk;
    if (kend < 0) kend = 0;
    ntiles = (kend + kBK - 1) / kBK;
  }

  for (int n = 0; n < ntiles; ++n) {
    int t0 = n * kBK;
    if constexpr (kSeg) t0 = sList[n] * kBK;
    __syncthreads();  // the previous tile is consumed
    if constexpr (kSeg) {  // threads 0-63 stage the ids, 64-127 positions
      const int i = threadIdx.x % kBK;
      const int key = t0 + i;
      const int* src = threadIdx.x < kBK ? seg.kseg : seg.kpos;
      (threadIdx.x < kBK ? sKseg : sKpos)[i] =
          key < Sk ? src[static_cast<size_t>(b) * Sk + key] : 0;
    }
    for (int idx = threadIdx.x; idx < kBK * (D / 8); idx += kThreads) {
      const int row = idx / (D / 8);
      const int c = (idx % (D / 8)) * 8;
      const int key = t0 + row;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (key < Sk) {
        kv4 = *reinterpret_cast<const uint4*>(k + ks.at(b, key, kvh) + c);
        vv4 = *reinterpret_cast<const uint4*>(v + vs.at(b, key, kvh) + c);
      }
      *reinterpret_cast<uint4*>(sK + row * kStride + c) = kv4;
      *reinterpret_cast<uint4*>(sV + row * kStride + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float s[kNT][4], dp[kNT][4];
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = 0.f;
        dp[nt][c] = 0.f;
      }
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        mma_abt(s[nt], qf[kc], sK, kStride, nt, kc, gid, tig);
        mma_abt(dp[nt], df[kc], sV, kStride, nt, kc, gid, tig);
      }
    }

    // P = exp2(S * scale * log2e - LSE * log2e), masked; dS into s
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      #pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const int kl = nt * 8 + tig * 2 + (c & 1);
        const int key = t0 + kl;
        bool ok;
        if constexpr (kSeg)
          ok = live[i] && key < Sk && sKseg[kl] == qid[i] &&
               (!causal || qp[i] >= sKpos[kl]);
        else
          ok = live[i] && key < Sk && (!causal || key <= pos[i] + off);
        const float p = ok ? exp2f(s[nt][c] * scale_log2 - lse2[i]) : 0.f;
        s[nt][c] = p * (dp[nt][c] - dlt[i]) * scale;
      }
    }

    // dQ += dS(bf16) K
    #pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kc], s[2 * kc + 1]);
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        mma_ab(acc[dt], a, sK, kStride, dt, kc, gid, tig);
    }
  }

  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + pos[i]) * Hq + head[i]) * D;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dq + base + col) =
          pack_f32(acc[dt][i * 2], acc[dt][i * 2 + 1]);
    }
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return static_cast<size_t>(2 * kBK + 2 * kBQ) * (D + 8) *
             sizeof(__nv_bfloat16) +
         2 * kBQ * sizeof(float);
}

// the dK/dV kernel's ints after those on the segment branch: the query
// tile's ids and positions, scratch, then the live query tiles' list
constexpr int kDkvSegInts = 2 * kBQ + kScratchInts;

template <int D, bool kSeg>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq,
                     int Hk, int causal, float scale, float scale_log2,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     Seg seg) {
  constexpr int kStride = D + 8;
  constexpr int kKC = D / 16;
  constexpr int kDT = D / 8;
  constexpr int kNQ = kBQ / 8;  // n-tiles over a query tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kBK * kStride;
  __nv_bfloat16* sQ = sV + kBK * kStride;
  __nv_bfloat16* sD = sQ + kBQ * kStride;  // dO
  float* sL = reinterpret_cast<float*>(sD + kBQ * kStride);  // LSE * log2e
  float* sDelta = sL + kBQ;
  int* sQseg = reinterpret_cast<int*>(sDelta + kBQ);  // segment branch
  int* sQpos = sQseg + kBQ;
  int* sScratch = sQpos + kBQ;
  int* sList = sScratch + kScratchInts;

  const int G = Hq / Hk;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int off = Sk - Sq;

  for (int idx = threadIdx.x; idx < kBK * (D / 8); idx += kThreads) {
    const int row = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    const int key = k0 + row;
    uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
    if (key < Sk) {
      kv4 = *reinterpret_cast<const uint4*>(k + ks.at(b, key, kvh) + c);
      vv4 = *reinterpret_cast<const uint4*>(v + vs.at(b, key, kvh) + c);
    }
    *reinterpret_cast<uint4*>(sK + row * kStride + c) = kv4;
    *reinterpret_cast<uint4*>(sV + row * kStride + c) = vv4;
  }

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
  const __nv_bfloat16* kRows16 = sK + warp * 16 * kStride;
  const __nv_bfloat16* vRows16 = sV + warp * 16 * kStride;

  float dka[kDT][4], dva[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) {
      dka[dt][c] = 0.f;
      dva[dt][c] = 0.f;
    }

  // the query tiles to walk: from the first that sees key k0 (its
  // position rounded down to a tile) to the end; with segments, those
  // whose id range overlaps the tile's (sList)
  int qt0 = 0, ntiles;
  if constexpr (kSeg) {
    const int nqt = (Sq + kBQ - 1) / kBQ;
    const int2 r = seg.krange[static_cast<size_t>(b) * gridDim.x +
                              blockIdx.x];
    ntiles = live_tiles(seg.qrange + static_cast<size_t>(b) * nqt, nqt, r.x,
                        r.y, sList, sScratch);
  } else {
    qt0 = (causal ? max(0, k0 - off) : 0) / kBQ;
    ntiles = max(0, (Sq + kBQ - 1) / kBQ - qt0);
  }

  for (int n = 0; n < ntiles; ++n) {
    int q0 = (qt0 + n) * kBQ;
    if constexpr (kSeg) q0 = sList[n] * kBQ;
    for (int g = 0; g < G; ++g) {
      const int head = kvh * G + g;
      __syncthreads();  // K/V staged; the previous Q/dO tile is consumed
      for (int idx = threadIdx.x; idx < kBQ * (D / 8); idx += kThreads) {
        const int row = idx / (D / 8);
        const int c = (idx % (D / 8)) * 8;
        const int pos = q0 + row;
        uint4 q4 = make_uint4(0, 0, 0, 0), d4 = make_uint4(0, 0, 0, 0);
        if (pos < Sq) {
          q4 = *reinterpret_cast<const uint4*>(q + qs.at(b, pos, head) + c);
          d4 = *reinterpret_cast<const uint4*>(dout + dos.at(b, pos, head) +
                                               c);
        }
        *reinterpret_cast<uint4*>(sQ + row * kStride + c) = q4;
        *reinterpret_cast<uint4*>(sD + row * kStride + c) = d4;
      }
      if (threadIdx.x < kBQ) {
        const int pos = q0 + threadIdx.x;
        const size_t row = (static_cast<size_t>(b) * Hq + head) * Sq + pos;
        sL[threadIdx.x] = pos < Sq ? lse[row] * kLog2e : kBig;
        sDelta[threadIdx.x] = pos < Sq ? delta[row] : 0.f;
      } else if (kSeg && threadIdx.x < 2 * kBQ) {
        const int r = threadIdx.x - kBQ;
        const int pos = q0 + r;
        const size_t at = static_cast<size_t>(b) * Sq + pos;
        sQseg[r] = pos < Sq ? seg.qseg[at] : -2;
        sQpos[r] = pos < Sq ? seg.qpos[at] : 0;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 64 rows
      float s[kNQ][4], dp[kNQ][4];
      #pragma unroll
      for (int nt = 0; nt < kNQ; ++nt)
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = 0.f;
          dp[nt][c] = 0.f;
        }
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        uint32_t ak[4], av[4];
        smem_a(ak, kRows16, kStride, kc, gid, tig);
        smem_a(av, vRows16, kStride, kc, gid, tig);
        #pragma unroll
        for (int nt = 0; nt < kNQ; ++nt) {
          mma_abt(s[nt], ak, sQ, kStride, nt, kc, gid, tig);
          mma_abt(dp[nt], av, sD, kStride, nt, kc, gid, tig);
        }
      }

      // P^T into s, dS^T into dp
      #pragma unroll
      for (int nt = 0; nt < kNQ; ++nt) {
        #pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kj = key[c >> 1];
          const int r = nt * 8 + tig * 2 + (c & 1);
          const int pos = q0 + r;
          bool ok;
          if constexpr (kSeg)
            ok = pos < Sq && kj < Sk && sQseg[r] == kid[c >> 1] &&
                 (!causal || sQpos[r] >= kp[c >> 1]);
          else
            ok = pos < Sq && kj < Sk && (!causal || kj <= pos + off);
          const float p = ok ? exp2f(s[nt][c] * scale_log2 - sL[r]) : 0.f;
          s[nt][c] = p;
          dp[nt][c] = p * (dp[nt][c] - sDelta[r]) * scale;
        }
      }

      // dV += P^T(bf16) dO and dK += dS^T(bf16) Q
      #pragma unroll
      for (int kc = 0; kc < kBQ / 16; ++kc) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s[2 * kc], s[2 * kc + 1]);
        acc_to_a(ads, dp[2 * kc], dp[2 * kc + 1]);
        #pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          mma_ab(dva[dt], ap, sD, kStride, dt, kc, gid, tig);
          mma_ab(dka[dt], ads, sQ, kStride, dt, kc, gid, tig);
        }
      }
    }
  }

  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Sk) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sk + key[i]) * Hk + kvh) * D;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(dk + base + col) =
          pack_f32(dka[dt][i * 2], dka[dt][i * 2 + 1]);
      *reinterpret_cast<uint32_t*>(dv + base + col) =
          pack_f32(dva[dt][i * 2], dva[dt][i * 2 + 1]);
    }
  }
}

template <int D, bool kSeg>
cudaError_t launch_dq(dim3 grid, cudaStream_t s, const __nv_bfloat16* q,
                      const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const __nv_bfloat16* dout, const float* lse,
                      const float* delta, __nv_bfloat16* dq, int Sq, int Sk,
                      int Hq, int Hk, int causal, float scale, float sl2,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      const Seg& seg) {
  static int allowed = 0;
  const int smem = kSeg ? (kDqSegInts + (Sk + kBK - 1) / kBK) * 4 : 0;
  if (kSeg) {
    const cudaError_t e =
        allow_dynamic_smem(flash_bwd_dq_kernel<D, kSeg>, smem, allowed);
    if (e != cudaSuccess) return e;
  }
  flash_bwd_dq_kernel<D, kSeg><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, Hq, Hk, causal, scale, sl2, qs,
      ks, vs, dos, seg);
  return cudaGetLastError();
}

template <int D, bool kSeg>
cudaError_t launch_dkv(dim3 grid, cudaStream_t s,
                       const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, const __nv_bfloat16* dout,
                       const float* lse, const float* delta,
                       __nv_bfloat16* dk, __nv_bfloat16* dv, int Sq, int Sk,
                       int Hq, int Hk, int causal, float scale, float sl2,
                       Strides qs, Strides ks, Strides vs, Strides dos,
                       const Seg& seg) {
  static int allowed = 48 * 1024;  // the default needs no opt-in
  const int smem = static_cast<int>(dkv_smem_bytes<D>()) +
                   (kSeg ? (kDkvSegInts + (Sq + kBQ - 1) / kBQ) * 4 : 0);
  const cudaError_t e =
      allow_dynamic_smem(flash_bwd_dkv_kernel<D, kSeg>, smem, allowed);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<D, kSeg><<<grid, kThreads, smem, s>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, Hq, Hk, causal, scale, sl2,
      qs, ks, vs, dos, seg);
  return cudaGetLastError();
}

bool bad_group(int Hq, int Hk) {
  return Hk <= 0 || Hq % Hk != 0 || kRows % (Hq / Hk) != 0;
}

// the segment pointers of the C entry points: all NULL (dense) or all
// given, with the range arrays the kernel reads
bool bad_seg(const Seg& seg, bool need_qrange) {
  if (!seg.qseg) return false;
  return !(seg.kseg && seg.qpos && seg.kpos && seg.krange &&
           (seg.qrange || !need_qrange));
}

}  // namespace

// q_seg, kv_seg, q_pos, kv_pos and kv_range are NULL on the dense branch;
// otherwise all five are given (flash_common.cuh: Seg)
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* q_seg,
    const void* kv_seg, const void* q_pos, const void* kv_pos,
    const void* kv_range, int B, int Sq, int Sk, int Hq, int Hk, int D,
    int causal, float scale, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dsb, long long dss,
    long long dsh, void* stream) {
  const Seg seg{static_cast<const int*>(q_seg),
                static_cast<const int*>(kv_seg),
                static_cast<const int*>(q_pos),
                static_cast<const int*>(kv_pos), nullptr,
                static_cast<const int2*>(kv_range)};
  if (bad_group(Hq, Hk) || bad_seg(seg, false))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sq <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const int bq = kRows / (Hq / Hk);
  dim3 grid((Sq + bq - 1) / bq, Hk, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* dd = static_cast<const __nv_bfloat16*>(dout);
  const auto* ll = static_cast<const float*>(lse);
  const auto* de = static_cast<const float*>(delta);
  auto* out = static_cast<__nv_bfloat16*>(dq);
  const float sl2 = scale * kLog2e;
  cudaError_t e;
  if (D == 128 && seg.qseg)
    e = launch_dq<128, true>(grid, s, qq, kk, vv, dd, ll, de, out, Sq, Sk,
                             Hq, Hk, causal, scale, sl2, qs, ks, vs, dos,
                             seg);
  else if (D == 128)
    e = launch_dq<128, false>(grid, s, qq, kk, vv, dd, ll, de, out, Sq, Sk,
                              Hq, Hk, causal, scale, sl2, qs, ks, vs, dos,
                              seg);
  else if (D == 64 && seg.qseg)
    e = launch_dq<64, true>(grid, s, qq, kk, vv, dd, ll, de, out, Sq, Sk,
                            Hq, Hk, causal, scale, sl2, qs, ks, vs, dos, seg);
  else if (D == 64)
    e = launch_dq<64, false>(grid, s, qq, kk, vv, dd, ll, de, out, Sq, Sk,
                             Hq, Hk, causal, scale, sl2, qs, ks, vs, dos,
                             seg);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}

// as flash_bwd_dq_bf16, with q_range (NULL on the dense branch) before
// kv_range
extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* q_seg, const void* kv_seg, const void* q_pos,
    const void* kv_pos, const void* q_range, const void* kv_range, int B,
    int Sq, int Sk, int Hq, int Hk, int D, int causal, float scale,
    long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dsb, long long dss, long long dsh,
    void* stream) {
  const Seg seg{static_cast<const int*>(q_seg),
                static_cast<const int*>(kv_seg),
                static_cast<const int*>(q_pos),
                static_cast<const int*>(kv_pos),
                static_cast<const int2*>(q_range),
                static_cast<const int2*>(kv_range)};
  if (bad_group(Hq, Hk) || bad_seg(seg, true))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Sk <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  dim3 grid((Sk + kBK - 1) / kBK, Hk, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dsb, dss, dsh};
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  const auto* dd = static_cast<const __nv_bfloat16*>(dout);
  const auto* ll = static_cast<const float*>(lse);
  const auto* de = static_cast<const float*>(delta);
  auto* gk = static_cast<__nv_bfloat16*>(dk);
  auto* gv = static_cast<__nv_bfloat16*>(dv);
  const float sl2 = scale * kLog2e;
  cudaError_t e;
  if (D == 128 && seg.qseg)
    e = launch_dkv<128, true>(grid, s, qq, kk, vv, dd, ll, de, gk, gv, Sq,
                              Sk, Hq, Hk, causal, scale, sl2, qs, ks, vs,
                              dos, seg);
  else if (D == 128)
    e = launch_dkv<128, false>(grid, s, qq, kk, vv, dd, ll, de, gk, gv, Sq,
                               Sk, Hq, Hk, causal, scale, sl2, qs, ks, vs,
                               dos, seg);
  else if (D == 64 && seg.qseg)
    e = launch_dkv<64, true>(grid, s, qq, kk, vv, dd, ll, de, gk, gv, Sq,
                             Sk, Hq, Hk, causal, scale, sl2, qs, ks, vs,
                             dos, seg);
  else if (D == 64)
    e = launch_dkv<64, false>(grid, s, qq, kk, vv, dd, ll, de, gk, gv, Sq,
                              Sk, Hq, Hk, causal, scale, sl2, qs, ks, vs,
                              dos, seg);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(e);
}
