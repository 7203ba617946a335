// int8 weight matmul on the CUDA cores, for any activation dtype and any
// K (sm_90a).
//
// Replaces the Pallas TPU kernel `_qmm_kernel`
// (paddle_tpu/kernels/pallas/quant_matmul.py:44); written for the operands
// the tensor-core kernels (quant_matmul.cu) did not take then: float32 and
// fp16 activations, and any whose K is not a multiple of 16. The JAX
// package's wrapper takes any dtype and K and returns x's dtype. Those
// kernels now take every dtype and K (a ragged loader where an int8 row
// has no 16-byte stride), so this one is on no route; a direct call still
// takes anything, and chip_smoke.py times it beside them.
//
// y [M, N] = x [M, K] . (w [N, K] int8 * s [N] f32)^T in x's dtype: every
// product a float32 fused multiply-add, s[n] applied to each channel's sum,
// one rounding of y. That equals `quant_matmul_plain` (w * s first, then a
// float32 product) up to float32 rounding.
//
// Design, simple first: a CTA of 256 threads owns a 64 x 64 tile of y and
// walks K 32 at a time; x's and w's chunks are staged k-major as float32
// (int8 -> f32 is exact), rows padded to 68 floats, and each thread keeps a
// 4 x 4 block of sums fed by two float4 shared reads a k step. Edges past
// M, N and K are zero-filled.

#include "simt_common.cuh"

namespace {

using simt::from_f;
using simt::to_f;

constexpr int kThreads = 256;
constexpr int kTile = 64;  // rows of y (tokens) and columns (channels)
constexpr int kK = 32;     // k a chunk
constexpr int kPad = 68;

// grid (ceil(N / 64), ceil(M / 64))
template <typename T>
__global__ void __launch_bounds__(kThreads)
qmm_simt_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s, T* __restrict__ y, int M, int N,
                int K) {
  __shared__ __align__(16) float sx[kK * kPad];  // [k][m]
  __shared__ __align__(16) float sw[kK * kPad];  // [k][n]
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // channels 4 tx .. 4 tx + 3
  const int ty = tid >> 4;  // tokens 4 ty .. 4 ty + 3
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kK) {
    // every load of the chunk before the first store (a store between two
    // loads keeps the second waiting for the first)
    constexpr int kIter = kTile * kK / kThreads;
    float xv[kIter], wv[kIter];
    #pragma unroll
    for (int i = 0; i < kIter; ++i) {
      const int e = tid + i * kThreads;
      const int kk = k0 + e % kK;
      const int m = m0 + e / kK;
      const int n = n0 + e / kK;
      xv[i] = m < M && kk < K ? to_f(x[static_cast<size_t>(m) * K + kk])
                              : 0.f;
      wv[i] = n < N && kk < K ? to_f(w[static_cast<size_t>(n) * K + kk])
                              : 0.f;
    }
    __syncthreads();
    #pragma unroll
    for (int i = 0; i < kIter; ++i) {
      const int e = tid + i * kThreads;
      sx[(e % kK) * kPad + e / kK] = xv[i];
      sw[(e % kK) * kPad + e / kK] = wv[i];
    }
    __syncthreads();
    #pragma unroll 8
    for (int c = 0; c < kK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(sx + c * kPad +
                                                        4 * ty);
      const float4 bw = *reinterpret_cast<const float4*>(sw + c * kPad +
                                                         4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bw.x, bw.y, bw.z, bw.w};
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= M) continue;
    #pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n < N)
        y[static_cast<size_t>(m) * N + n] = from_f<T>(acc[i][j] * s[n]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* s, void* y, int M,
           int N, int K, cudaStream_t st) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  qmm_simt_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<T*>(y), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype of x and y: 0 float32, 1 float16, 2 bfloat16. x [M, K] and w
// [N, K] contiguous, s [N] float32, y [M, N].
extern "C" int quant_matmul_simt(int dtype, const void* x, const void* w,
                                 const void* s, void* y, int M, int N, int K,
                                 void* stream) {
  if (M < 0 || N < 0 || K < 0 || (M + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, s, y, M, N, K, st);
  if (dtype == 1) return launch<__half>(x, w, s, y, M, N, K, st);
  if (dtype == 2) return launch<__nv_bfloat16>(x, w, s, y, M, N, K, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
