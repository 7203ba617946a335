// Shared pieces of the split-KV paged-decode kernel (paged_decode_split.cu),
// for bf16 pools and for int8 pools with float32 per-row scales.
//
// Thread layout: a CTA of 128 threads is cut into row groups of
// kLanes = D/8 threads; each thread of a group owns 8 consecutive elements
// of the head dim, so one group reads one KV row (one head of a page row:
// [D] bf16 as 16-byte vectors, or [D] int8 as 8-byte vectors). The
// kRowsInFlight groups of a CTA take interleaved key rows, and each group
// keeps its own online-softmax state (m, l, acc) for the G query heads of
// its kv head. At the end the groups' states are merged through shared
// memory by their max -- the same merge the split kernel's second pass
// does across CTAs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// 8 int8 values of one row -> q * scale rounded to bf16, as the JAX
// package dequantizes (int8 -> f32 * scale -> the compute dtype) before
// the dot products
__device__ __forceinline__ void dequant8(const uint2& u, float scale,
                                         float f[8]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
  #pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __bfloat162float(
        __float2bfloat16(static_cast<float>(b[i]) * scale));
}

template <int D, int G>
struct DecodeState {
  static constexpr int kLanes = D / 8;                   // threads per row
  static constexpr int kRowsInFlight = kThreads / kLanes;
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "row group in one warp");

  float q[G][8];    // this thread's slice of the G query rows, pre-scaled
  float m[G];       // running max (exp2 domain)
  float l[G];       // running sum of unrounded p
  float acc[G][8];  // running sum of bf16(p) * v for this thread's slice

  // q [B, Hq, D]; query head of group g is kvh * G + g
  __device__ void init(const __nv_bfloat16* __restrict__ qp, int b, int kvh,
                       int Hq, int lane_c, float scale_log2) {
    #pragma unroll
    for (int g = 0; g < G; ++g) {
      const size_t idx =
          (static_cast<size_t>(b) * Hq + kvh * G + g) * D + lane_c * 8;
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(qp + idx), f);
      #pragma unroll
      for (int e = 0; e < 8; ++e) {
        q[g][e] = f[e] * scale_log2;
        acc[g][e] = 0.f;
      }
      m[g] = kNeg;
      l[g] = 0.f;
    }
  }

  // One key row, this thread's 8 elements of K and V as floats: every
  // thread of the warp must call this (the dot products reduce with warp
  // shuffles); `ok` false leaves the state as it is.
  __device__ void update(const float kf[8], const float vf[8], bool ok) {
    #pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
      #pragma unroll
      for (int e = 0; e < 8; ++e) s += q[g][e] * kf[e];
      #pragma unroll
      for (int o = kLanes / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (ok) {
        const float mn = fmaxf(m[g], s);
        const float alpha = exp2f(m[g] - mn);
        const float p = exp2f(s - mn);
        // P is cast to V's dtype before P V; the sum keeps the f32 value
        const float pr = __bfloat162float(__float2bfloat16(p));
        l[g] = l[g] * alpha + p;
        #pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = acc[g][e] * alpha + pr * vf[e];
        m[g] = mn;
      }
    }
  }

  // Merge the row groups of the CTA. `smem` holds at least
  // kSmemFloats floats. Afterwards thread t owns output elements
  // idx = t, t + 128, ... < G * D (g = idx / D, d = idx % D) and `emit`
  // is called with (g, d, M, L, O_unnormalized).
  static constexpr int kSmemFloats = kRowsInFlight * G * (D + 2);

  template <typename Emit>
  __device__ void merge(float* smem, int row, int lane_c, Emit emit) const {
    float* sM = smem;
    float* sL = sM + kRowsInFlight * G;
    float* sA = sL + kRowsInFlight * G;
    __syncthreads();  // smem may still be in use by the caller
    if (lane_c == 0) {
      #pragma unroll
      for (int g = 0; g < G; ++g) {
        sM[row * G + g] = m[g];
        sL[row * G + g] = l[g];
      }
    }
    #pragma unroll
    for (int g = 0; g < G; ++g)
      #pragma unroll
      for (int e = 0; e < 8; ++e)
        sA[(row * G + g) * D + lane_c * 8 + e] = acc[g][e];
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
      const int g = idx / D;
      const int d = idx % D;
      float M = kNeg;
      for (int r = 0; r < kRowsInFlight; ++r) M = fmaxf(M, sM[r * G + g]);
      float L = 0.f, O = 0.f;
      for (int r = 0; r < kRowsInFlight; ++r) {
        const float w = exp2f(sM[r * G + g] - M);
        L += sL[r * G + g] * w;
        O += sA[(r * G + g) * D + d] * w;
      }
      emit(g, d, M, L, O);
    }
  }
};

}  // namespace paged
