// Paged-decode attention, one CTA per (slot, kv head), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `_decode_kernel` (bf16 pools) and
// `_decode_kernel_q` (int8 pools) (paddle_tpu/kernels/pallas/
// paged_attention.py:133 and :156).
//
// One query token per slot attends that slot's pages of a shared pool:
// q [B, Hq, D] bf16; k_pool/v_pool [NB, bs, Hk, D] bf16, or int8 with
// k_scale/v_scale [NB, bs, Hk] f32 (one scale per row and kv head);
// block_tables [B, MBPS] int32; seq_lens [B] int32; out [B, Hq, D] bf16.
// Positions >= seq_len are masked; seq_len == 0 gives zeros. An int8 row
// is dequantized as bf16(f32(q8) * scale) before the dot products, as
// the JAX package's `_deq` casts to the query's dtype.
//
// What bounds it on this card: bytes. Each live KV row is read once and
// used for G = Hq/Hk dot products (a few flops per byte), far below the
// ~295 flops/byte where the tensor cores would become the limit. An int8
// row is half a bf16 row plus 4 bytes of scale.
//
// Design:
// - Grid (B, Hk). There is no scalar prefetch on a GPU: each CTA reads
//   its slot's seq_len and block ids itself and walks the live pages only,
//   so a short sequence costs only its own pages.
// - A page row is [Hk, D]; the CTA reads its head's slice (stride Hk*D)
//   as 16-byte (bf16) or 8-byte (int8) vectors, D/8 threads per row,
//   128/(D/8) rows in flight. The int8 row's two scales are strided by
//   Hk; every thread of the row group reads them (one cached line).
// - The G query rows of the kv head are folded into one CTA, so each KV
//   row is read once for the whole group and never expanded.
// - Each row group keeps an f32 online softmax; the groups merge through
//   shared memory at the end (paged_common.cuh).
// At B * Hk CTAs (64 at B = 8, Hk = 8) this fills under half of the 132
// SMs, so long tables go to the split kernel (paged_decode_split.cu); this
// one serves tables shorter than 16 pages.

#include "paged_common.cuh"

namespace {

using paged::DecodeState;
using paged::kThreads;

// Q: int8 pools with scales (k_scale/v_scale), else bf16 pools
template <int D, int G, bool Q>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const void* __restrict__ k_pool,
                    const void* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    __nv_bfloat16* __restrict__ out, int Hk, int bs, int mbps,
                    float scale_log2) {
  using St = DecodeState<D, G>;
  __shared__ float smem[St::kSmemFloats];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int Hq = Hk * G;
  const int row = threadIdx.x / St::kLanes;
  const int lane_c = threadIdx.x % St::kLanes;
  // a length past the table attends the whole table, as the plain version
  const int len = min(lens[b], mbps * bs);

  St st;
  st.init(q, b, kvh, Hq, lane_c, scale_log2);
  const int* trow = tables + static_cast<size_t>(b) * mbps;
  for (int t0 = 0; t0 < len; t0 += St::kRowsInFlight) {
    const int t = t0 + row;
    const bool ok = t < len;
    float kf[8] = {}, vf[8] = {};
    if (ok) {
      const int page = t / bs;
      const int blk = __ldg(trow + page);
      // (block, position, kv head) row of the pool
      const size_t r =
          (static_cast<size_t>(blk) * bs + (t - page * bs)) * Hk + kvh;
      const size_t off = r * D + lane_c * 8;
      if constexpr (Q) {
        const int8_t* kp = static_cast<const int8_t*>(k_pool);
        const int8_t* vp = static_cast<const int8_t*>(v_pool);
        paged::dequant8(__ldg(reinterpret_cast<const uint2*>(kp + off)),
                        __ldg(k_scale + r), kf);
        paged::dequant8(__ldg(reinterpret_cast<const uint2*>(vp + off)),
                        __ldg(v_scale + r), vf);
      } else {
        const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k_pool);
        const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(v_pool);
        paged::unpack8(__ldg(reinterpret_cast<const uint4*>(kp + off)), kf);
        paged::unpack8(__ldg(reinterpret_cast<const uint4*>(vp + off)), vf);
      }
    }
    st.update(kf, vf, ok);
  }

  __nv_bfloat16* o = out + (static_cast<size_t>(b) * Hq + kvh * G) * D;
  st.merge(smem, row, lane_c, [&](int g, int d, float, float L, float O) {
    o[g * D + d] = __float2bfloat16(L > 0.f ? O / L : 0.f);
  });
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *t, *l;
  void* o;
  int B, Hk, bs, mbps;
  float sl2;
  cudaStream_t s;
};

template <int D, int G, bool Q>
int launch(const Args& a) {
  paged_decode_kernel<D, G, Q><<<dim3(a.B, a.Hk), kThreads, 0, a.s>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.t), static_cast<const int*>(a.l),
      static_cast<__nv_bfloat16*>(a.o), a.Hk, a.bs, a.mbps, a.sl2);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q>
int dispatch(int Hq, int D, const Args& a) {
  if (a.Hk <= 0 || Hq % a.Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B <= 0) return static_cast<int>(cudaSuccess);
  const int G = Hq / a.Hk;
#define PAGED_G(D_)                                  \
  switch (G) {                                       \
    case 1: return launch<D_, 1, Q>(a);              \
    case 2: return launch<D_, 2, Q>(a);              \
    case 4: return launch<D_, 4, Q>(a);              \
    case 8: return launch<D_, 8, Q>(a);              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
  if (D == 128) PAGED_G(128)
  if (D == 64) PAGED_G(64)
#undef PAGED_G
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* tables,
                                 const void* lens, void* out, int B, int Hq,
                                 int Hk, int D, int bs, int mbps, float scale,
                                 void* stream) {
  const Args a{q,  k_pool, v_pool, nullptr, nullptr, tables,
               lens, out, B, Hk, bs, mbps, scale * paged::kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(Hq, D, a);
}

extern "C" int paged_decode_i8(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scale,
                               const void* v_scale, const void* tables,
                               const void* lens, void* out, int B, int Hq,
                               int Hk, int D, int bs, int mbps, float scale,
                               void* stream) {
  const Args a{q,  k_pool, v_pool, k_scale, v_scale, tables,
               lens, out, B, Hk, bs, mbps, scale * paged::kLog2e,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(Hq, D, a);
}
