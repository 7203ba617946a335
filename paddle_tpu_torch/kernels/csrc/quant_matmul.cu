// int8 weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_qmm_kernel`
// (paddle_tpu/kernels/pallas/quant_matmul.py:44), the forward of every
// converted (int8) linear layer.
//
// y [M, N] bf16 = x [M, K] bf16 . (w [N, K] int8 * s [N] f32)^T, summed in
// f32. w is PyTorch's Linear layout (K-contiguous); the TPU kernel takes
// [K, N].
//
// What bounds it on this card: at decode (M = 8 slot rows) bytes -- the
// int8 weight is read once and each byte feeds M multiply-adds, far under
// the ~295 flops/byte where the tensor cores would be the limit; at a long
// prefill (M ~ 1000) operations.
//
// Design:
// - int8 -> bf16 is exact (|q| <= 127 fits bf16's 8-bit significand), so
//   the products run on mma.sync m16n8k16 in bf16 on (q, x), summed in f32,
//   and s[n] multiplies each output channel's sum in the epilogue. That
//   equals the TPU kernel's order (w * s first, then the dot) up to f32
//   rounding.
// - The weight is the mma's A operand (16 output channels) and the tokens
//   its n8 operand, so decode's 8 rows fill one n-tile with no padding.
// - No shared-memory staging: per 64-wide k chunk each thread loads 16
//   contiguous bytes of two weight rows (channels gid, gid + 8) and 16
//   contiguous bf16 of each of its token rows straight into registers. A
//   dot product does not depend on the order of k, so the mma's k index
//   is permuted to match the loads: in step j (0..3) of a chunk, fragment
//   columns 2tig, 2tig+1 are k = 16tig + 4j + {0, 1} and columns 2tig+8,
//   2tig+9 are k = 16tig + 4j + {2, 3}, in A (weight bytes) and B (x
//   elements) alike. A K % 64 tail runs 16-wide chunks of the same form
//   (4 bytes per thread, j = 0).
// - Decode (M <= 8): a CTA of 8 warps owns 16 output channels and splits
//   K among its warps (interleaved chunks, 4 chunks' loads in flight per
//   thread); the 8 partial tiles are summed in shared memory in a fixed
//   order: deterministic, one launch, N/16 CTAs (256 at N = 4096).
// - Prefill (M > 8): a CTA of 4 warps owns 64 channels x 64 tokens, each
//   warp 16 channels x 8 n-tiles over all of K; the warps re-read the
//   token rows from L1.

#include "flash_common.cuh"

namespace {

using flash::mma_bf16;
using flash::pack_f32;

// bytes `byte` and `byte + 1` of `word`, as signed ints, to bf16x2 (exact)
__device__ __forceinline__ uint32_t i8x2(uint32_t word, int byte) {
  const float lo = static_cast<float>(static_cast<int8_t>(word >> (8 * byte)));
  const float hi =
      static_cast<float>(static_cast<int8_t>(word >> (8 * byte + 8)));
  return pack_f32(lo, hi);
}

// W consecutive 32-bit words from global memory (zeros when !ok)
template <int W>
__device__ __forceinline__ void ldg_words(uint32_t (&dst)[W],
                                          const void* src, bool ok) {
  if constexpr (W % 4 == 0) {
    #pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 v = ok ? __ldg(reinterpret_cast<const uint4*>(src) + i)
                         : make_uint4(0, 0, 0, 0);
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(src))
                       : make_uint2(0, 0);
    dst[0] = v.x;
    dst[1] = v.y;
  } else {
    static_assert(W == 1, "1, 2 or a multiple of 4 words");
    dst[0] = ok ? __ldg(reinterpret_cast<const unsigned*>(src)) : 0u;
  }
}

// One thread's share of a k chunk 16 * J wide: J words (4 bytes) of each of
// its two weight rows and 2 J words (4 bf16) of each of its NT token rows,
// all starting at the thread's offset in the chunk.
template <int J, int NT>
struct Chunk {
  uint32_t wa[J], wb[J];
  uint32_t x[NT][2 * J];

  __device__ __forceinline__ void load(const int8_t* ra, const int8_t* rb,
                                       bool oka, bool okb,
                                       const __nv_bfloat16* const* xr,
                                       const bool* okx, int k) {
    ldg_words<J>(wa, ra + k, oka);
    ldg_words<J>(wb, rb + k, okb);
    #pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      ldg_words<2 * J>(x[nt], xr[nt] + k, okx[nt]);
  }

  __device__ __forceinline__ void mma(float (&acc)[NT][4]) const {
    #pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint32_t a[4] = {i8x2(wa[j], 0), i8x2(wb[j], 0), i8x2(wa[j], 2),
                             i8x2(wb[j], 2)};
      #pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[nt], a, x[nt][2 * j], x[nt][2 * j + 1]);
    }
  }
};

// CTA: WN x WK warps; warp (wn, wk) computes 16 channels x 8 NT tokens
// over the k chunks wk, wk + WK, ...; U chunks are loaded before any is
// multiplied.
template <int NT, int WN, int WK, int U>
__global__ void __launch_bounds__(32 * WN * WK)
quant_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w, const float* __restrict__ s,
                    __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  constexpr int kTok = 8 * NT;
  constexpr int kCh = 16 * WN;
  __shared__ float red[WK > 1 ? WK * kCh * kTok : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wn = warp % WN;
  const int wk = warp / WN;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ca = blockIdx.x * kCh + 16 * wn + gid;  // channels ca, ca + 8
  const int m0 = blockIdx.y * kTok;
  const bool oka = ca < N;
  const bool okb = ca + 8 < N;
  const int8_t* ra = w + static_cast<size_t>(oka ? ca : 0) * K;
  const int8_t* rb = w + static_cast<size_t>(okb ? ca + 8 : 0) * K;
  const __nv_bfloat16* xr[NT];
  bool okx[NT];
  #pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = m0 + 8 * nt + gid;
    okx[nt] = m < M;
    xr[nt] = x + static_cast<size_t>(okx[nt] ? m : 0) * K;
  }

  float acc[NT][4] = {};
  const int nchunks = K / 64;
  for (int c = wk; c < nchunks; c += WK * U) {
    Chunk<4, NT> ch[U];
    #pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool live = c + u * WK < nchunks;
      ch[u].load(ra, rb, oka && live, okb && live, xr, okx,
                 (c + u * WK) * 64 + 16 * tig);
    }
    #pragma unroll
    for (int u = 0; u < U; ++u)
      if (c + u * WK < nchunks) ch[u].mma(acc);
  }
  for (int k0 = nchunks * 64 + 16 * wk; k0 < K; k0 += 16 * WK) {
    Chunk<1, NT> ch;
    ch.load(ra, rb, oka, okb, xr, okx, k0 + 4 * tig);
    ch.mma(acc);
  }

  // acc[nt]: c0, c1 at (channel ca, tokens m0 + 8nt + 2tig + {0, 1}),
  // c2, c3 at channel ca + 8
  if constexpr (WK == 1) {
    #pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      #pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = ca + 8 * (e >> 1);
        const int m = m0 + 8 * nt + 2 * tig + (e & 1);
        if (n < N && m < M)
          y[static_cast<size_t>(m) * N + n] =
              __float2bfloat16(acc[nt][e] * s[n]);
      }
  } else {
    // red[wk][channel in CTA][token in CTA]
    #pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      #pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(wk * kCh + 16 * wn + gid + 8 * (e >> 1)) * kTok + 8 * nt +
            2 * tig + (e & 1)] = acc[nt][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < kCh * kTok; idx += blockDim.x) {
      const int tok = idx / kCh;
      const int chl = idx % kCh;
      const int n = blockIdx.x * kCh + chl;
      const int m = m0 + tok;
      if (n >= N || m >= M) continue;
      float sum = 0.f;
      #pragma unroll
      for (int r = 0; r < WK; ++r) sum += red[(r * kCh + chl) * kTok + tok];
      y[static_cast<size_t>(m) * N + n] = __float2bfloat16(sum * s[n]);
    }
  }
}

template <int NT, int WN, int WK, int U>
int launch(const void* x, const void* w, const void* s, void* y, int M,
           int N, int K, cudaStream_t st) {
  const dim3 grid((N + 16 * WN - 1) / (16 * WN), (M + 8 * NT - 1) / (8 * NT));
  quant_matmul_kernel<NT, WN, WK, U><<<grid, 32 * WN * WK, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int quant_matmul_bf16(const void* x, const void* w, const void* s,
                                 void* y, int M, int N, int K, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<1, 1, 8, 4>(x, w, s, y, M, N, K, st);
  if ((M + 63) / 64 > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch<8, 4, 1, 1>(x, w, s, y, M, N, K, st);
}
