// Paged-decode attention on the CUDA cores, for every query dtype, head
// dim and GQA group (sm_90a).
//
// Replaces the Pallas TPU kernels `_decode_kernel` (float pools) and
// `_decode_kernel_q` (int8 pools) (paddle_tpu/kernels/pallas/
// paged_attention.py:133 and :156) for the operands the tensor-core
// kernels (paged_decode.cu, paged_decode_split.cu: bf16 queries, head dims
// 64 and 128, groups 1, 2, 4 and 8) do not take: float32 and fp16 models,
// head dims such as 80 or 256, groups such as 16. The JAX package's
// wrappers take all of these.
//
// One query token per slot attends that slot's pages of a shared pool:
// q [B, Hq, D] (float32, fp16 or bf16); k_pool/v_pool [NB, bs, Hk, D] of
// q's dtype, or int8 with k_scale/v_scale [NB, bs, Hk] f32; block_tables
// [B, MBPS] int32; seq_lens [B] int32; out [B, Hq, D] in q's dtype.
// Positions >= seq_len are masked; seq_len == 0 gives zeros. An int8 row
// is dequantized as T(f32(q8) * scale), as the JAX package's `_deq` casts
// to the query's dtype. Logits and sums in float32; P is rounded to T
// before P V, as the tensor-core kernels round it to bf16.
//
// What bounds it: bytes -- each live row is read once per query head
// (G times from L2). Design, simple first: a CTA of up to 4 warps per
// (slot, query head); each warp takes 32 keys at a time, stages their K
// rows as float32 in its own shared tile (rows padded by one float, so the
// lane-per-key dot products are free of bank conflicts), keeps an online
// softmax, then stages the V rows in the same tile and adds P V into its
// lane's columns (lane + 32 j). Staging looks each key's row up once (lane
// = key) and then reads rows column-parallel, a group of rows' loads in
// flight together. The warps' (m, l, O) merge in shared memory by their
// max.

#include "simt_common.cuh"

namespace {

using simt::from_f;
using simt::round_to;
using simt::to_f;

constexpr int kMaxWarps = 4;
constexpr int kKeys = 32;  // keys a warp stages at once
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// shared memory the warps' tiles may take together
constexpr int kTileBudget = 96 * 1024;

// the warps a CTA runs at head dim D: as many as fit kTileBudget, 1 to 4
inline int warps_for(int D) {
  const int per = kKeys * (D + 1) * 4;
  int w = kTileBudget / per;
  return w < 1 ? 1 : w > kMaxWarps ? kMaxWarps : w;
}

inline size_t smem_for(int D, int warps) {
  const size_t tiles = static_cast<size_t>(warps) * kKeys * (D + 1) * 4;
  const size_t partials = static_cast<size_t>(warps) * (D + 2) * 4;
  return static_cast<size_t>(D) * 4 + (tiles > partials ? tiles : partials);
}

// T: the query's (and output's) dtype; P: the pools' (T, or int8 with
// scales); NJ: columns a lane owns (D <= 32 NJ). Grid (B, Hq).
template <typename T, typename P, int NJ>
__global__ void __launch_bounds__(32 * kMaxWarps)
decode_simt_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                   const P* __restrict__ vp, const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens, T* __restrict__ out, int Hq,
                   int Hk, int D, int bs, int mbps, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int hk = h / (Hq / Hk);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  float* sq = smem;                                   // [D]
  float* tile = smem + D + warp * kKeys * (D + 1);    // [32][D + 1]
  const T* qrow = q + (static_cast<size_t>(b) * Hq + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) sq[d] = to_f(qrow[d]);
  __syncthreads();
  const int* trow = tables + static_cast<size_t>(b) * mbps;
  // a length past the table attends the whole table, as the plain version
  const int len = min(lens[b], mbps * bs);

  // one 32-key block's rows of `pool` into the warp's tile (row stride
  // `stride`), dequantized by `scale` for int8; zeros past len. Lane t
  // looks up key t's row and scale once; then every lane reads its
  // columns (lane + 32 j) of kGroup rows at a time, all of a group's loads
  // issued before its stores (a store between two loads keeps the second
  // waiting for the first: a memory latency an element).
  constexpr int kGroup = NJ <= 4 ? 8 : NJ <= 8 ? 4 : NJ <= 16 ? 2 : 1;
  auto stage = [&](const P* __restrict__ pool, const float* scale, int k0,
                   int stride) {
    const int key = k0 + lane;
    long long mine = -1;
    float mine_sc = 1.f;
    if (key < len) {
      mine = (static_cast<long long>(trow[key / bs]) * bs + key % bs) * Hk +
             hk;
      if (scale != nullptr) mine_sc = scale[mine];
    }
    for (int r0 = 0; r0 < kKeys; r0 += kGroup) {
      float x[kGroup][NJ];
      #pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const long long row = __shfl_sync(0xffffffffu, mine, r0 + g);
        #pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int c = lane + 32 * jn;
          x[g][jn] = row >= 0 && c < D ? to_f(pool[row * D + c]) : 0.f;
        }
      }
      #pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float sc = __shfl_sync(0xffffffffu, mine_sc, r0 + g);
        #pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
          const int c = lane + 32 * jn;
          if (c < D)
            tile[(r0 + g) * stride + c] =
                scale != nullptr ? round_to<T>(x[g][jn] * sc) : x[g][jn];
        }
      }
    }
    __syncwarp();
  };

  float m = kNeg, l = 0.f;
  float acc[NJ];
  #pragma unroll
  for (int jn = 0; jn < NJ; ++jn) acc[jn] = 0.f;
  for (int k0 = warp * kKeys; k0 < len; k0 += nw * kKeys) {
    stage(kp, ks, k0, D + 1);
    float s = 0.f;
    const float* krow = tile + lane * (D + 1);
    for (int d = 0; d < D; ++d) s = fmaf(sq[d], krow[d], s);
    s = k0 + lane < len ? s * scale_log2 : kNeg;
    float mx = fmaxf(m, s);
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float alpha = exp2f(m - mx);
    const float pk = s == kNeg ? 0.f : exp2f(s - mx);
    l = l * alpha + pk;
    m = mx;
    const float pr = round_to<T>(pk);
    __syncwarp();  // every lane is done with the K rows
    stage(vp, vs, k0, D);
    #pragma unroll
    for (int jn = 0; jn < NJ; ++jn) acc[jn] *= alpha;
    for (int t = 0; t < kKeys; ++t) {
      const float w = __shfl_sync(0xffffffffu, pr, t);
      #pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const int d = lane + 32 * jn;
        if (d < D) acc[jn] = fmaf(w, tile[t * D + d], acc[jn]);
      }
    }
    __syncwarp();  // the tile is refilled
  }
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, o);

  // the warps' partials, merged by their max
  __syncthreads();
  float* wm = smem + D;       // [nw]
  float* wl = wm + nw;        // [nw]
  float* wo = wl + nw;        // [nw][D]
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  #pragma unroll
  for (int jn = 0; jn < NJ; ++jn) {
    const int d = lane + 32 * jn;
    if (d < D) wo[warp * D + d] = acc[jn];
  }
  __syncthreads();
  float M = kNeg;
  for (int w = 0; w < nw; ++w) M = fmaxf(M, wm[w]);
  float L = 0.f;
  for (int w = 0; w < nw; ++w) L += wl[w] * exp2f(wm[w] - M);
  T* orow = out + (static_cast<size_t>(b) * Hq + h) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float O = 0.f;
    for (int w = 0; w < nw; ++w) O += wo[w * D + d] * exp2f(wm[w] - M);
    orow[d] = from_f<T>(L > 0.f ? O / L : 0.f);
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *t, *l;
  void* o;
  int B, Hq, Hk, D, bs, mbps;
  float sl2;
  cudaStream_t s;
};

template <typename T, typename P, int NJ>
int launch(const Args& a) {
  auto kern = decode_simt_kernel<T, P, NJ>;
  const int warps = warps_for(a.D);
  const size_t smem = smem_for(a.D, warps);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opened = 48 * 1024;  // dynamic shared memory allowed so far
  if (smem > opened) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opened = smem;
  }
  kern<<<dim3(a.B, a.Hq), 32 * warps, smem, a.s>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.t),
      static_cast<const int*>(a.l), static_cast<T*>(a.o), a.Hq, a.Hk, a.D,
      a.bs, a.mbps, a.sl2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int by_width(const Args& a) {
  const int nj = (a.D + 31) / 32;
  if (nj <= 2) return launch<T, P, 2>(a);
  if (nj <= 4) return launch<T, P, 4>(a);
  if (nj <= 8) return launch<T, P, 8>(a);
  if (nj <= 16) return launch<T, P, 16>(a);
  if (nj <= 32) return launch<T, P, 32>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int by_pool(bool quantized, const Args& a) {
  return quantized ? by_width<T, int8_t>(a) : by_width<T, T>(a);
}

}  // namespace

// dtype of q, out (and float pools): 0 float32, 1 float16, 2 bfloat16.
// quantized: int8 pools with k_scale/v_scale (else both null). D <= 1024.
extern "C" int paged_decode_simt(int dtype, int quantized, const void* q,
                                 const void* k_pool, const void* v_pool,
                                 const void* k_scale, const void* v_scale,
                                 const void* tables, const void* lens,
                                 void* out, int B, int Hq, int Hk, int D,
                                 int bs, int mbps, float scale,
                                 void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || D <= 0 || bs <= 0 || mbps < 0 ||
      (quantized != 0) != (k_scale != nullptr) ||
      (k_scale == nullptr) != (v_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || Hq == 0) return static_cast<int>(cudaSuccess);
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, tables,
               lens, out, B,      Hq,      Hk,      D,
               bs, mbps,  scale * kLog2e, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return by_pool<float>(quantized != 0, a);
  if (dtype == 1) return by_pool<__half>(quantized != 0, a);
  if (dtype == 2) return by_pool<__nv_bfloat16>(quantized != 0, a);
  return static_cast<int>(cudaErrorInvalidValue);
}
