// Flash attention on the CUDA cores, for float32 and fp16 operands (sm_90a).
//
// Replaces the Pallas TPU kernels `_fwd_kernel`, `_dq_kernel` and
// `_dkv_kernel` (paddle_tpu/kernels/pallas/flash_attention.py:281, :358,
// :408) for the operands the tensor-core kernels (flash_fwd.cu,
// flash_bwd.cu: bf16 only) do not take. The JAX package hands float32 to
// its Pallas kernels whole, and the products there keep float32's
// precision; here every product is a float32 fused multiply-add, so a
// float32 model's attention is float32 throughout. fp16 operands are
// widened to float32 on staging and the results rounded back once.
//
// Layout and semantics are those of the bf16 kernels: q [B, Sq, Hq, D],
// k/v [B, Sk, Hk, D] read through (batch, seq, head) strides in elements
// with a unit innermost stride; O, dQ, dK, dV contiguous in the operands'
// dtype; LSE and Delta float32 [B, Hq, Sq]. GQA: query head h reads kv
// head h / (Hq / Hk), any group. Masked logits are -1e30; a row that sees
// no key gives O = 0, LSE = +1e30 and zero gradients. Without segments
// causal masking is bottom-right aligned (query i sees keys j <= i + Sk -
// Sq); with segment ids (q_seg non-null, all four given) query i sees key
// j when the ids are equal and, if causal, q_pos[i] >= kv_pos[j]. P is
// rounded to the operands' dtype before P V and P^T dO, dS before dS K and
// dS^T Q, as the bf16 kernels round to bf16 (a no-op for float32).
//
// Which calls reach it: dQ and dK/dV above head dim 128, and nothing else.
// Up to 128 the backward runs on the tensor cores (flash_bwd.cu: fp16 on
// f16 wgmma, float32 as three bf16 pieces of every operand, six products a
// product, at 165 TFLOP/s of float32 work), and the forward runs there at
// every head dim (flash_fwd.cu: fp16 at 256 and above on the bf16 layouts'
// f16 forms, float32 as three pieces on 16-key stages at 256 and on the xl
// layout above), so
// `fwd_kernel` is on no route; a wrapper called directly still takes any
// head dim here, and chip_smoke.py times it beside the kernels that
// replaced it.
//
// What bounds it on this card: operations, on the CUDA cores' 67 TFLOP/s
// of float32 (TF32 on the tensor cores would drop 13 bits of every
// operand). Design -- simple first:
// - A CTA of 256 threads owns 64 query rows of one head (forward, dQ) or
//   64 keys of one kv head (dK/dV); 4 threads share a row, each holding 8
//   of a 32-wide tile of logits, so the softmax's row reductions are two
//   shuffles.
// - The head dim streams through shared memory 64 columns at a time
//   (rows padded to 68 floats: 16-byte aligned, float4 reads free of bank
//   conflicts), so any D runs at the same shared memory: the logits (and
//   dP) sum over the chunks, then the output's columns take the products.
// - A thread's output columns are 4 consecutive floats in each 16-wide
//   group of a 64-column chunk; a CTA owns W output columns (W 64, 128 or
//   256, the grid's z taking the rest: wider heads recompute the logits
//   once per W columns).
// - Causal tiles past a block's last visible key (or before a key block's
//   first query) are skipped on the dense branch; the segment branch
//   masks entry by entry.

#include "simt_common.cuh"

namespace {

using simt::from_f;
using simt::round_to;
using simt::to_f;

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows (keys for dK/dV) a CTA
constexpr int kTile = 32;   // keys (queries for dK/dV) a tile
constexpr int kChunk = 64;  // head-dim columns staged at once
constexpr int kPad = 68;    // floats a staged row
constexpr int kPStride = kTile + 1;
constexpr float kNeg = -1e30f;
constexpr float kBig = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;
};

struct Problem {
  int B, Sq, Sk, Hq, Hk, D, causal;
  float scale, sl2;  // scale, and scale * log2(e)
  Strides qs, ks, vs, dos;
  const int *qseg, *kseg, *qpos, *kpos;  // null on the dense branch
};

// rows [r0, r0 + NROWS) x columns [c0, c0 + kChunk) of a [B, S, H, D]
// operand at (b, h) -> dst [NROWS][kPad] floats, zero past S and D. Every
// load is issued before the first store: a store between two loads keeps
// the second waiting for the first (the compiler cannot move a global
// load above a shared store it cannot tell apart), a memory latency each.
template <int NROWS, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      Strides st, int b, int h, int r0,
                                      int S, int D, int c0) {
  constexpr int kIter = NROWS * kChunk / kThreads;
  float x[kIter];
  #pragma unroll
  for (int n = 0; n < kIter; ++n) {
    const int e = threadIdx.x + n * kThreads;
    const int row = r0 + e / kChunk;
    const int col = c0 + e % kChunk;
    x[n] = row < S && col < D
               ? to_f(src[b * st.b + row * st.s + h * st.h + col])
               : 0.f;
  }
  #pragma unroll
  for (int n = 0; n < kIter; ++n) {
    const int e = threadIdx.x + n * kThreads;
    dst[(e / kChunk) * kPad + e % kChunk] = x[n];
  }
}

// s[j] += a[row] . b[cg + 4 j] over one staged chunk
__device__ __forceinline__ void dot_chunk(float s[8], const float* a,
                                          const float* bm, int row, int cg) {
  #pragma unroll 4
  for (int d = 0; d < kChunk; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + row * kPad + d);
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 y =
          *reinterpret_cast<const float4*>(bm + (cg + 4 * j) * kPad + d);
      s[j] = fmaf(x.x, y.x, s[j]);
      s[j] = fmaf(x.y, y.y, s[j]);
      s[j] = fmaf(x.z, y.z, s[j]);
      s[j] = fmaf(x.w, y.w, s[j]);
    }
  }
}

// acc[e] += sum over the tile's kTile entries t of p[row][t] * m[t][col],
// col = cg 4 + 16 (e / 4) + e % 4 of the staged chunk
__device__ __forceinline__ void accumulate(float acc[16], const float* p,
                                           const float* m, int row, int cg) {
  #pragma unroll 4
  for (int t = 0; t < kTile; ++t) {
    const float w = p[row * kPStride + t];
    #pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 y =
          *reinterpret_cast<const float4*>(m + t * kPad + cg * 4 + 16 * jj);
      acc[4 * jj] = fmaf(w, y.x, acc[4 * jj]);
      acc[4 * jj + 1] = fmaf(w, y.y, acc[4 * jj + 1]);
      acc[4 * jj + 2] = fmaf(w, y.z, acc[4 * jj + 2]);
      acc[4 * jj + 3] = fmaf(w, y.w, acc[4 * jj + 3]);
    }
  }
}

// whether query i sees key j (both in range)
__device__ __forceinline__ bool visible(const Problem& p, int i, int j,
                                        int qs, int qp, int ks, int kp) {
  if (p.qseg != nullptr) return qs == ks && (!p.causal || qp >= kp);
  return !p.causal || j <= i + p.Sk - p.Sq;
}

// the segment ids and positions of keys [k0, k0 + kTile) -> sks, skp
__device__ __forceinline__ void stage_keys(const Problem& p, int b, int k0,
                                           int* sks, int* skp) {
  if (p.qseg == nullptr) return;
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int j = k0 + t;
    sks[t] = j < p.Sk ? p.kseg[b * p.Sk + j] : 0;
    skp[t] = j < p.Sk ? p.kpos[b * p.Sk + j] : 0;
  }
}

// the end of the keys a block of query rows [r0, r0 + kRows) can see
__device__ __forceinline__ int key_end(const Problem& p, int r0) {
  if (p.qseg != nullptr || !p.causal) return p.Sk;
  return max(0, min(p.Sk, r0 + kRows + p.Sk - p.Sq));
}

// Forward: grid (ceil(Sq / 64), B Hq, ceil(D / W)).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o,
           float* __restrict__ lse, Problem p) {
  constexpr int kCC = W / kChunk;
  __shared__ __align__(16) float sA[kRows * kPad];
  __shared__ __align__(16) float sB[kTile * kPad];
  __shared__ float sP[kRows * kPStride];
  __shared__ int sks[kTile], skp[kTile];
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hk);
  const int r0 = blockIdx.x * kRows;
  const int i = r0 + row;
  const int z0 = blockIdx.z * W;
  int qs = 0, qp = 0;
  if (p.qseg != nullptr && i < p.Sq) {
    qs = p.qseg[b * p.Sq + i];
    qp = p.qpos[b * p.Sq + i];
  }
  float m = kNeg, l = 0.f;
  float acc[kCC][16];
  #pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    #pragma unroll
    for (int e = 0; e < 16; ++e) acc[cc][e] = 0.f;

  const int kend = key_end(p, r0);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    float s[8] = {};
    for (int c0 = 0; c0 < p.D; c0 += kChunk) {
      __syncthreads();
      stage<kRows>(sA, q, p.qs, b, h, r0, p.Sq, p.D, c0);
      stage<kTile>(sB, k, p.ks, b, hk, k0, p.Sk, p.D, c0);
      if (c0 == 0) stage_keys(p, b, k0, sks, skp);
      __syncthreads();
      dot_chunk(s, sA, sB, row, cg);
    }
    float mx = m;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = cg + 4 * j;
      const bool ok = i < p.Sq && k0 + t < p.Sk &&
                      visible(p, i, k0 + t, qs, qp, sks[t], skp[t]);
      s[j] = ok ? s[j] * p.sl2 : kNeg;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = exp2f(m - mx);
    float rs = 0.f;
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float pj = s[j] == kNeg ? 0.f : exp2f(s[j] - mx);
      rs += pj;
      sP[row * kPStride + cg + 4 * j] = round_to<T>(pj);
    }
    l = l * alpha + rs;
    m = mx;
    #pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      #pragma unroll
      for (int e = 0; e < 16; ++e) acc[cc][e] *= alpha;
      const int c0 = z0 + cc * kChunk;
      if (c0 >= p.D) continue;  // uniform over the CTA
      __syncthreads();
      stage<kTile>(sB, v, p.vs, b, hk, k0, p.Sk, p.D, c0);
      __syncthreads();
      accumulate(acc[cc], sP, sB, row, cg);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (i >= p.Sq) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* orow = o + ((static_cast<long long>(b) * p.Sq + i) * p.Hq + h) * p.D;
  #pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    #pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = z0 + cc * kChunk + cg * 4 + 16 * (e >> 2) + (e & 3);
      if (col < p.D) orow[col] = from_f<T>(acc[cc][e] * inv);
    }
  if (blockIdx.z == 0 && cg == 0)
    lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + i] =
        l > 0.f ? (m + log2f(l)) * kLn2 : kBig;
}

// dQ: grid (ceil(Sq / 64), B Hq, ceil(D / W)). dQ = sum over keys of
// dS K, dS = P (dP - Delta) scale, dP = dO V^T, P = exp(S scale - LSE).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Problem p) {
  constexpr int kCC = W / kChunk;
  __shared__ __align__(16) float sA[kRows * kPad];
  __shared__ __align__(16) float sB[kTile * kPad];
  __shared__ float sP[kRows * kPStride];
  __shared__ int sks[kTile], skp[kTile];
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int b = blockIdx.y / p.Hq;
  const int h = blockIdx.y % p.Hq;
  const int hk = h / (p.Hq / p.Hk);
  const int r0 = blockIdx.x * kRows;
  const int i = r0 + row;
  const int z0 = blockIdx.z * W;
  int qs = 0, qp = 0;
  float lse2 = kBig, dl = 0.f;
  if (i < p.Sq) {
    const long long at = (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
    lse2 = lse[at] * kLog2e;
    dl = delta[at];
    if (p.qseg != nullptr) {
      qs = p.qseg[b * p.Sq + i];
      qp = p.qpos[b * p.Sq + i];
    }
  }
  float acc[kCC][16];
  #pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    #pragma unroll
    for (int e = 0; e < 16; ++e) acc[cc][e] = 0.f;

  const int kend = key_end(p, r0);
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    float s[8] = {}, dp[8] = {};
    for (int c0 = 0; c0 < p.D; c0 += kChunk) {
      __syncthreads();
      stage<kRows>(sA, q, p.qs, b, h, r0, p.Sq, p.D, c0);
      stage<kTile>(sB, k, p.ks, b, hk, k0, p.Sk, p.D, c0);
      if (c0 == 0) stage_keys(p, b, k0, sks, skp);
      __syncthreads();
      dot_chunk(s, sA, sB, row, cg);
    }
    for (int c0 = 0; c0 < p.D; c0 += kChunk) {
      __syncthreads();
      stage<kRows>(sA, dout, p.dos, b, h, r0, p.Sq, p.D, c0);
      stage<kTile>(sB, v, p.vs, b, hk, k0, p.Sk, p.D, c0);
      __syncthreads();
      dot_chunk(dp, sA, sB, row, cg);
    }
    #pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = cg + 4 * j;
      const bool ok = i < p.Sq && k0 + t < p.Sk &&
                      visible(p, i, k0 + t, qs, qp, sks[t], skp[t]);
      const float pj = ok ? exp2f(s[j] * p.sl2 - lse2) : 0.f;
      sP[row * kPStride + t] = round_to<T>(pj * (dp[j] - dl) * p.scale);
    }
    #pragma unroll
    for (int cc = 0; cc < kCC; ++cc) {
      const int c0 = z0 + cc * kChunk;
      if (c0 >= p.D) continue;
      __syncthreads();
      stage<kTile>(sB, k, p.ks, b, hk, k0, p.Sk, p.D, c0);
      __syncthreads();
      accumulate(acc[cc], sP, sB, row, cg);
    }
  }
  if (i >= p.Sq) return;
  T* drow = dq + ((static_cast<long long>(b) * p.Sq + i) * p.Hq + h) * p.D;
  #pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    #pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = z0 + cc * kChunk + cg * 4 + 16 * (e >> 2) + (e & 3);
      if (col < p.D) drow[col] = from_f<T>(acc[cc][e]);
    }
}

// dK/dV: grid (ceil(Sk / 64), B Hk, ceil(D / W)); each CTA sums over the
// G query heads of its kv head and every query tile. Thread row = key.
// dV = sum P^T dO, dK = sum dS^T Q.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, Problem p) {
  constexpr int kCC = W / kChunk;
  // sA: the CTA's 64 keys' K or V chunk, or (for the sums) the tile's dO
  // chunk in rows 0..31 and its Q chunk in rows 32..63; sB: the tile's Q
  // or dO chunk
  __shared__ __align__(16) float sA[kRows * kPad];
  __shared__ __align__(16) float sB[kTile * kPad];
  __shared__ float sP[kRows * kPStride];
  __shared__ float sS[kRows * kPStride];
  __shared__ float sl[kTile], sd[kTile];
  __shared__ int sqs[kTile], sqp[kTile];
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int cg = tid & 3;
  const int G = p.Hq / p.Hk;
  const int b = blockIdx.y / p.Hk;
  const int hk = blockIdx.y % p.Hk;
  const int j0 = blockIdx.x * kRows;
  const int j = j0 + row;  // this thread's key
  const int z0 = blockIdx.z * W;
  int ks = 0, kp = 0;
  if (p.qseg != nullptr && j < p.Sk) {
    ks = p.kseg[b * p.Sk + j];
    kp = p.kpos[b * p.Sk + j];
  }
  float accv[kCC][16], acck[kCC][16];
  #pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    #pragma unroll
    for (int e = 0; e < 16; ++e) accv[cc][e] = acck[cc][e] = 0.f;

  // the first query tile that can see the block's first key
  int qstart = 0;
  if (p.qseg == nullptr && p.causal)
    qstart = max(0, j0 - (p.Sk - p.Sq)) / kTile * kTile;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    for (int i0 = qstart; i0 < p.Sq; i0 += kTile) {
      float s[8] = {}, dp[8] = {};
      for (int c0 = 0; c0 < p.D; c0 += kChunk) {
        __syncthreads();
        stage<kRows>(sA, k, p.ks, b, hk, j0, p.Sk, p.D, c0);
        stage<kTile>(sB, q, p.qs, b, h, i0, p.Sq, p.D, c0);
        if (c0 == 0) {
          for (int t = tid; t < kTile; t += kThreads) {
            const int i = i0 + t;
            const bool in = i < p.Sq;
            const long long at =
                (static_cast<long long>(b) * p.Hq + h) * p.Sq + i;
            sl[t] = in ? lse[at] * kLog2e : kBig;
            sd[t] = in ? delta[at] : 0.f;
            if (p.qseg != nullptr) {
              sqs[t] = in ? p.qseg[b * p.Sq + i] : 0;
              sqp[t] = in ? p.qpos[b * p.Sq + i] : 0;
            }
          }
        }
        __syncthreads();
        dot_chunk(s, sA, sB, row, cg);
      }
      for (int c0 = 0; c0 < p.D; c0 += kChunk) {
        __syncthreads();
        stage<kRows>(sA, v, p.vs, b, hk, j0, p.Sk, p.D, c0);
        stage<kTile>(sB, dout, p.dos, b, h, i0, p.Sq, p.D, c0);
        __syncthreads();
        dot_chunk(dp, sA, sB, row, cg);
      }
      #pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int t = cg + 4 * jj;
        const int i = i0 + t;
        const bool ok =
            j < p.Sk && i < p.Sq &&
            visible(p, i, j, p.qseg ? sqs[t] : 0, p.qseg ? sqp[t] : 0, ks,
                    kp);
        const float pt = ok ? exp2f(s[jj] * p.sl2 - sl[t]) : 0.f;
        sP[row * kPStride + t] = round_to<T>(pt);
        sS[row * kPStride + t] = round_to<T>(pt * (dp[jj] - sd[t]) *
                                             p.scale);
      }
      #pragma unroll
      for (int cc = 0; cc < kCC; ++cc) {
        const int c0 = z0 + cc * kChunk;
        if (c0 >= p.D) continue;
        __syncthreads();
        stage<kTile>(sA, dout, p.dos, b, h, i0, p.Sq, p.D, c0);
        stage<kTile>(sA + kTile * kPad, q, p.qs, b, h, i0, p.Sq, p.D, c0);
        __syncthreads();
        accumulate(accv[cc], sP, sA, row, cg);
        accumulate(acck[cc], sS, sA + kTile * kPad, row, cg);
      }
    }
  }
  if (j >= p.Sk) return;
  const long long at = ((static_cast<long long>(b) * p.Sk + j) * p.Hk + hk) *
                       p.D;
  #pragma unroll
  for (int cc = 0; cc < kCC; ++cc)
    #pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int col = z0 + cc * kChunk + cg * 4 + 16 * (e >> 2) + (e & 3);
      if (col < p.D) {
        dk[at + col] = from_f<T>(acck[cc][e]);
        dv[at + col] = from_f<T>(accv[cc][e]);
      }
    }
}

// the output columns a CTA owns: the forward's and dQ's W (64, 128, 256),
// dK/dV's (two accumulators: 64 or 128)
inline int fwd_width(int D) { return D <= 64 ? 64 : D <= 128 ? 128 : 256; }
inline int dkv_width(int D) { return D <= 64 ? 64 : 128; }

Problem problem(int B, int Sq, int Sk, int Hq, int Hk, int D, int causal,
                float scale, const void* qseg, const void* kseg,
                const void* qpos, const void* kpos, const long long* st,
                int nst) {
  Problem p = {};
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hk = Hk;
  p.D = D;
  p.causal = causal;
  p.scale = scale;
  p.sl2 = scale * kLog2e;
  Strides* dst[4] = {&p.qs, &p.ks, &p.vs, &p.dos};
  for (int n = 0; n < nst; ++n) *dst[n] = Strides{st[3 * n], st[3 * n + 1],
                                                  st[3 * n + 2]};
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.qpos = static_cast<const int*>(qpos);
  p.kpos = static_cast<const int*>(kpos);
  return p;
}

bool valid(const Problem& p) {
  return p.B >= 0 && p.Sq >= 0 && p.Sk >= 0 && p.Hk > 0 && p.Hq > 0 &&
         p.Hq % p.Hk == 0 && p.D > 0 &&
         ((p.qseg == nullptr) == (p.kseg == nullptr)) &&
         ((p.qseg == nullptr) == (p.qpos == nullptr)) &&
         ((p.qseg == nullptr) == (p.kpos == nullptr));
}

int finish() { return static_cast<int>(cudaGetLastError()); }

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const Problem& p, cudaStream_t s) {
  const int W = fwd_width(p.D);
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.Hq, (p.D + W - 1) / W);
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<float*>(lse), p);
  };
  if (W == 64) args(fwd_kernel<T, 64>);
  else if (W == 128) args(fwd_kernel<T, 128>);
  else args(fwd_kernel<T, 256>);
  return finish();
}

template <typename T>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqo, const Problem& p,
       cudaStream_t s) {
  const int W = fwd_width(p.D);
  const dim3 grid((p.Sq + kRows - 1) / kRows, p.B * p.Hq, (p.D + W - 1) / W);
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dqo), p);
  };
  if (W == 64) args(dq_kernel<T, 64>);
  else if (W == 128) args(dq_kernel<T, 128>);
  else args(dq_kernel<T, 256>);
  return finish();
}

template <typename T>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dko, void* dvo,
        const Problem& p, cudaStream_t s) {
  const int W = dkv_width(p.D);
  const dim3 grid((p.Sk + kRows - 1) / kRows, p.B * p.Hk, (p.D + W - 1) / W);
  auto args = [&](auto kern) {
    kern<<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dko), static_cast<T*>(dvo), p);
  };
  if (W == 64) args(dkv_kernel<T, 64>);
  else args(dkv_kernel<T, 128>);
  return finish();
}

}  // namespace

// dtype: 0 float32, 1 float16. Strides: (batch, seq, head) of q, k, v
// (and dO for the backward), in elements. Segment pointers all null (the
// dense branch) or all given.
extern "C" int flash_simt_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* o, void* lse,
                              const void* q_seg, const void* kv_seg,
                              const void* q_pos, const void* kv_pos, int B,
                              int Sq, int Sk, int Hq, int Hk, int D,
                              int causal, float scale, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const Problem p = problem(B, Sq, Sk, Hq, Hk, D, causal, scale, q_seg,
                            kv_seg, q_pos, kv_pos, st, 3);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(q, k, v, o, lse, p, s);
  if (dtype == 1) return fwd<__half>(q, k, v, o, lse, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_simt_dq(int dtype, const void* q, const void* k,
                             const void* v, const void* dout,
                             const void* lse, const void* delta, void* dqo,
                             const void* q_seg, const void* kv_seg,
                             const void* q_pos, const void* kv_pos, int B,
                             int Sq, int Sk, int Hq, int Hk, int D,
                             int causal, float scale, long long qsb,
                             long long qss, long long qsh, long long ksb,
                             long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, long long dsb,
                             long long dss, long long dsh, void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dss, dsh};
  const Problem p = problem(B, Sq, Sk, Hq, Hk, D, causal, scale, q_seg,
                            kv_seg, q_pos, kv_pos, st, 4);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dq<float>(q, k, v, dout, lse, delta, dqo, p, s);
  if (dtype == 1) return dq<__half>(q, k, v, dout, lse, delta, dqo, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_simt_dkv(int dtype, const void* q, const void* k,
                              const void* v, const void* dout,
                              const void* lse, const void* delta, void* dko,
                              void* dvo, const void* q_seg,
                              const void* kv_seg, const void* q_pos,
                              const void* kv_pos, int B, int Sq, int Sk,
                              int Hq, int Hk, int D, int causal, float scale,
                              long long qsb, long long qss, long long qsh,
                              long long ksb, long long kss, long long ksh,
                              long long vsb, long long vss, long long vsh,
                              long long dsb, long long dss, long long dsh,
                              void* stream) {
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, dsb, dss, dsh};
  const Problem p = problem(B, Sq, Sk, Hq, Hk, D, causal, scale, q_seg,
                            kv_seg, q_pos, kv_pos, st, 4);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sk == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dkv<float>(q, k, v, dout, lse, delta, dko, dvo, p, s);
  if (dtype == 1)
    return dkv<__half>(q, k, v, dout, lse, delta, dko, dvo, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
