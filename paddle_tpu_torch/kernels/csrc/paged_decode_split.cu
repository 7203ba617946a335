// Split-KV paged-decode attention for long tables, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel_chunked`
// (paddle_tpu/kernels/pallas/paged_attention.py:186), on bf16 pools
// (`quantized=False`) and on int8 pools with per-row scales
// (`quantized=True`). Same function as paged_decode.cu: q [B, Hq, D] bf16
// attends its slot's pages of k_pool/v_pool [NB, bs, Hk, D] (bf16, or int8
// with k_scale/v_scale [NB, bs, Hk] f32) through block_tables [B, MBPS]
// int32, masked at seq_lens [B] int32; out [B, Hq, D] bf16. An int8 row is
// dequantized as bf16(f32(q8) * scale) before the dot products.
//
// What bounds it on this card: bytes, as for every decode attention (each
// live KV row is read once for G dot products). A grid of one CTA per
// (slot, kv head) has B * Hk CTAs -- 64 at B = 8, Hk = 8, fewer than the
// 132 SMs -- so a long context leaves most of the card's memory bandwidth
// unused. The TPU kernel's chunking (several pages per
// sequential grid step) answers a different problem, per-step overhead on
// one core, and is not copied.
//
// Design (two kernels):
// - Split kernel, grid (B, Hk, nsplit). Each CTA takes a contiguous range
//   of `chunks_per_split` chunks of `chunk_pages` pages. The wrapper picks
//   nsplit so that B * Hk * nsplit >= 2 * 132 where the pages allow it.
//   Splits that start past seq_len exit at once. A chunk's live pages
//   (that head's rows of them, and for int8 pools the rows' scales, which
//   are strided by Hk and copied 4 bytes at a time) are staged into shared
//   memory with cp.async, double-buffered: the next chunk's loads are in
//   flight while the current one is consumed. `chunk_pages` is picked on
//   the host from the 227 KB shared-memory budget so that two CTAs share
//   an SM (an int8 page is about half a bf16 one, so int8 chunks hold
//   twice the pages); above 48 KB the kernel is opened up with
//   cudaFuncSetAttribute.
// - Within a CTA, row groups of D/8 threads read one KV row's 8-element
//   slices and keep an f32 online softmax each; they merge in shared
//   memory and the CTA writes its partial result in f32: acc
//   [B, Hk, nsplit, G, D] (unnormalized, relative to m) and m, l
//   [B, Hk, nsplit, G].
// - Merge kernel, grid (B, Hk), the same for both pool types: combines the
//   live splits by their max, O = sum(acc_s * 2^(m_s - M)) /
//   sum(l_s * 2^(m_s - M)); an empty slot gives zeros.

#include "paged_common.cuh"

namespace {

using paged::DecodeState;
using paged::kNeg;
using paged::kThreads;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes of one staging buffer: chunk_rows rows of K then of V (D elements
// of the pool's type each), then for int8 pools the rows' K scales and V
// scales (f32); rounded up to 16 so the second buffer stays aligned.
template <int D, bool Q>
__host__ __device__ constexpr size_t stage_bytes(int chunk_rows) {
  const size_t row = static_cast<size_t>(D) * (Q ? 1 : 2) + (Q ? 4 : 0);
  return (2 * static_cast<size_t>(chunk_rows) * row + 15) & ~size_t(15);
}

// Q: int8 pools with scales (k_scale/v_scale), else bf16 pools
template <int D, int G, bool Q>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const void* __restrict__ k_pool,
                          const void* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ lens,
                          float* __restrict__ acc_out,
                          float* __restrict__ m_out,
                          float* __restrict__ l_out, int Hk, int bs, int mbps,
                          int cpp, int per, int nsplit, float scale_log2) {
  using St = DecodeState<D, G>;
  constexpr int kRowBytes = D * (Q ? 1 : 2);  // one head's row of a pool
  constexpr int kVecs = kRowBytes / 16;       // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int Hq = Hk * G;
  // a length past the table attends the whole table, as the plain version
  const int len = min(lens[b], mbps * bs);
  const int chunk_rows = cpp * bs;
  const int live_pages = (len + bs - 1) / bs;
  const int live_chunks = (live_pages + cpp - 1) / cpp;
  const int c_begin = split * per;
  const int c_end = min(c_begin + per, live_chunks);
  if (c_begin >= c_end) return;  // past seq_len: the merge skips it

  const size_t buf_bytes = stage_bytes<D, Q>(chunk_rows);
  // stage s at smem_raw + s * buf_bytes: K rows, V rows, (Q) K and V scales
  const unsigned char* kp = static_cast<const unsigned char*>(k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(v_pool);
  const int row = threadIdx.x / St::kLanes;
  const int lane_c = threadIdx.x % St::kLanes;
  const int* trow = tables + static_cast<size_t>(b) * mbps;

  auto stage = [&](int chunk, int buf) {
    unsigned char* sK = smem_raw + buf * buf_bytes;
    unsigned char* sV = sK + static_cast<size_t>(chunk_rows) * kRowBytes;
    const int p0 = chunk * cpp;
    for (int idx = threadIdx.x; idx < chunk_rows * kVecs; idx += kThreads) {
      const int r = idx / kVecs;
      const int c16 = (idx % kVecs) * 16;
      const int page = p0 + r / bs;
      if (page < live_pages) {
        const int blk = __ldg(trow + page);
        const size_t src =
            ((static_cast<size_t>(blk) * bs + r % bs) * Hk + kvh) *
                kRowBytes + c16;
        cp_async16(sK + r * kRowBytes + c16, kp + src);
        cp_async16(sV + r * kRowBytes + c16, vp + src);
      }
    }
    if constexpr (Q) {
      float* sKs = reinterpret_cast<float*>(
          sV + static_cast<size_t>(chunk_rows) * kRowBytes);
      float* sVs = sKs + chunk_rows;
      for (int r = threadIdx.x; r < chunk_rows; r += kThreads) {
        const int page = p0 + r / bs;
        if (page < live_pages) {
          const int blk = __ldg(trow + page);
          const size_t src =
              (static_cast<size_t>(blk) * bs + r % bs) * Hk + kvh;
          cp_async4(sKs + r, k_scale + src);
          cp_async4(sVs + r, v_scale + src);
        }
      }
    }
    cp_async_commit();
  };

  St st;
  st.init(q, b, kvh, Hq, lane_c, scale_log2);
  stage(c_begin, 0);
  for (int c = c_begin; c < c_end; ++c) {
    const int buf = (c - c_begin) & 1;
    if (c + 1 < c_end) {
      stage(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* sK = smem_raw + buf * buf_bytes;
    const unsigned char* sV = sK + static_cast<size_t>(chunk_rows) * kRowBytes;
    const int key0 = c * chunk_rows;
    for (int r0 = 0; r0 < chunk_rows; r0 += St::kRowsInFlight) {
      const int r = r0 + row;
      const bool ok = r < chunk_rows && key0 + r < len;
      float kf[8] = {}, vf[8] = {};
      if (ok) {
        const int off = r * kRowBytes + lane_c * 8 * (Q ? 1 : 2);
        if constexpr (Q) {
          const float* sKs = reinterpret_cast<const float*>(
              sV + static_cast<size_t>(chunk_rows) * kRowBytes);
          const float* sVs = sKs + chunk_rows;
          paged::dequant8(*reinterpret_cast<const uint2*>(sK + off), sKs[r],
                          kf);
          paged::dequant8(*reinterpret_cast<const uint2*>(sV + off), sVs[r],
                          vf);
        } else {
          paged::unpack8(*reinterpret_cast<const uint4*>(sK + off), kf);
          paged::unpack8(*reinterpret_cast<const uint4*>(sV + off), vf);
        }
      }
      st.update(kf, vf, ok);
    }
    __syncthreads();  // this buffer is refilled two chunks later
  }

  const size_t part = (static_cast<size_t>(b) * Hk + kvh) * nsplit + split;
  float* acc = acc_out + part * G * D;
  float* mo = m_out + part * G;
  float* lo = l_out + part * G;
  st.merge(reinterpret_cast<float*>(smem_raw), row, lane_c,
           [&](int g, int d, float M, float L, float O) {
             acc[g * D + d] = O;
             if (d == 0) {
               mo[g] = M;
               lo[g] = L;
             }
           });
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const float* __restrict__ acc,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const int* __restrict__ lens,
                          __nv_bfloat16* __restrict__ out, int Hk, int nsplit,
                          int keys_per_split) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int Hq = Hk * G;
  const int len = lens[b];
  const int live = min(nsplit, (len + keys_per_split - 1) / keys_per_split);
  const size_t part0 = (static_cast<size_t>(b) * Hk + kvh) * nsplit;
  __nv_bfloat16* o = out + (static_cast<size_t>(b) * Hq + kvh * G) * D;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    const int d = idx % D;
    float M = kNeg;
    for (int s = 0; s < live; ++s) M = fmaxf(M, m[(part0 + s) * G + g]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < live; ++s) {
      const float w = exp2f(m[(part0 + s) * G + g] - M);
      L += l[(part0 + s) * G + g] * w;
      O += acc[((part0 + s) * G + g) * D + d] * w;
    }
    o[g * D + d] = __float2bfloat16(L > 0.f ? O / L : 0.f);
  }
}

struct SplitArgs {
  const void *q, *k, *v, *ks, *vs, *t, *lens;
  void *acc, *m, *l;
  int B, Hk, bs, mbps, cpp, per, nsplit;
  float sl2;
  cudaStream_t s;
};

template <int D, int G, bool Q>
int launch_split(const SplitArgs& a) {
  using St = DecodeState<D, G>;
  const size_t staging = 2 * stage_bytes<D, Q>(a.cpp * a.bs);
  const size_t merge = static_cast<size_t>(St::kSmemFloats) * sizeof(float);
  const size_t smem = staging > merge ? staging : merge;
  auto kern = paged_decode_split_kernel<D, G, Q>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(a.B, a.Hk, a.nsplit), kThreads, smem, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.t), static_cast<const int*>(a.lens),
      static_cast<float*>(a.acc), static_cast<float*>(a.m),
      static_cast<float*>(a.l), a.Hk, a.bs, a.mbps, a.cpp, a.per, a.nsplit,
      a.sl2);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int G>
int launch_merge(const void* acc, const void* m, const void* l,
                 const void* lens, void* out, int B, int Hk, int nsplit,
                 int kps, cudaStream_t s) {
  paged_decode_merge_kernel<D, G><<<dim3(B, Hk), kThreads, 0, s>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(lens),
      static_cast<__nv_bfloat16*>(out), Hk, nsplit, kps);
  return static_cast<int>(cudaGetLastError());
}

// dispatch a template over (D in {64, 128}) x (G in {1, 2, 4, 8})
#define PAGED_DISPATCH(D_, G_, CALL)                       \
  do {                                                     \
    if ((D_) == 128) {                                     \
      constexpr int kD = 128;                              \
      switch (G_) {                                        \
        case 1: { constexpr int kG = 1; return CALL; }     \
        case 2: { constexpr int kG = 2; return CALL; }     \
        case 4: { constexpr int kG = 4; return CALL; }     \
        case 8: { constexpr int kG = 8; return CALL; }     \
      }                                                    \
    } else if ((D_) == 64) {                               \
      constexpr int kD = 64;                               \
      switch (G_) {                                        \
        case 1: { constexpr int kG = 1; return CALL; }     \
        case 2: { constexpr int kG = 2; return CALL; }     \
        case 4: { constexpr int kG = 4; return CALL; }     \
        case 8: { constexpr int kG = 8; return CALL; }     \
      }                                                    \
    }                                                      \
    return static_cast<int>(cudaErrorInvalidValue);        \
  } while (0)

template <bool Q>
int split_entry(int Hq, int D, const SplitArgs& a) {
  if (a.Hk <= 0 || Hq % a.Hk != 0 || a.cpp <= 0 || a.per <= 0 ||
      a.nsplit <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return static_cast<int>(cudaSuccess);
  PAGED_DISPATCH(D, Hq / a.Hk, (launch_split<kD, kG, Q>(a)));
}

}  // namespace

extern "C" int paged_decode_split_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* lens, void* acc, void* m, void* l, int B,
    int Hq, int Hk, int D, int bs, int mbps, int chunk_pages,
    int chunks_per_split, int nsplit, float scale, void* stream) {
  const SplitArgs a{q,     k_pool, v_pool, nullptr, nullptr, tables,
                    lens,  acc,    m,      l,       B,       Hk,
                    bs,    mbps,   chunk_pages,     chunks_per_split,
                    nsplit, scale * paged::kLog2e,
                    static_cast<cudaStream_t>(stream)};
  return split_entry<false>(Hq, D, a);
}

extern "C" int paged_decode_split_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lens, void* acc, void* m, void* l, int B, int Hq, int Hk,
    int D, int bs, int mbps, int chunk_pages, int chunks_per_split,
    int nsplit, float scale, void* stream) {
  const SplitArgs a{q,     k_pool, v_pool, k_scale, v_scale, tables,
                    lens,  acc,    m,      l,       B,       Hk,
                    bs,    mbps,   chunk_pages,     chunks_per_split,
                    nsplit, scale * paged::kLog2e,
                    static_cast<cudaStream_t>(stream)};
  return split_entry<true>(Hq, D, a);
}

extern "C" int paged_decode_merge_bf16(const void* acc, const void* m,
                                       const void* l, const void* lens,
                                       void* out, int B, int Hq, int Hk,
                                       int D, int nsplit, int keys_per_split,
                                       void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || nsplit <= 0 || keys_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PAGED_DISPATCH(D, Hq / Hk,
                 (launch_merge<kD, kG>(acc, m, l, lens, out, B, Hk, nsplit,
                                       keys_per_split, s)));
}
