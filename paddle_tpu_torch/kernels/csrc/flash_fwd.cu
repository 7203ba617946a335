// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 softmax.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (paddle_tpu/kernels/pallas/flash_attention.py:281). Its LSE output is what
// the backward kernels (flash_bwd.cu) recompute P from.
//
// Computes O = softmax(Q K^T * scale + mask) V on the Paddle layout
// q [B, Sq, Hq, D], k/v [B, Sk, Hk, D] (bf16, read through their batch,
// sequence and head strides; the head dim is contiguous), writing
// O [B, Sq, Hq, D] bf16 and LSE [B, Hq, Sq] f32, both contiguous. Causal
// masking is bottom-right aligned (query i sees keys j <= i + Sk - Sq); a
// fully masked row gives O = 0 and LSE = +1e30. D is 64 or 128.
//
// What bounds it on this card: at prefill lengths (S in the hundreds to
// thousands) the work is the two matrix products, 4 * S^2/2 * D flops per
// head, so it is bound by tensor-core throughput, not by its bytes (q, k,
// v and o are read or written once, a few MB).
//
// Design:
// - One CTA of 4 warps owns 64 "folded" rows: the G query heads that
//   share one kv head, for 64/G consecutive query positions. K/V tiles are
//   loaded into shared memory once per group and serve all G heads -- the
//   GQA fold of the Pallas kernel, with KV never expanded.
// - A loop inside the CTA walks 64-key tiles; this replaces the TPU's
//   sequential `j` grid axis. Tiles above the causal diagonal are never
//   visited.
// - Both products run on the tensor cores with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); each warp keeps its 16 rows of O in registers. The
//   running max and sum are f32, in the exp2 domain. P is rounded to bf16
//   before P V, as the Pallas kernel casts P to V's dtype.
// - Ragged Sq and Sk are masked in the kernel (rows past Sq are not
//   written, keys past Sk are zero-filled and masked); nothing is padded
//   on the host.
// - Simple first: no cp.async pipelining, no wgmma/TMA yet.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int Hq, int Hk, int causal,
                 float scale_log2, Strides qs, Strides ks, Strides vs) {
  constexpr int kStride = D + 8;  // padded smem row: conflict-free reads
  constexpr int kKC = D / 16;     // k-chunks of the QK^T product
  constexpr int kDT = D / 8;      // n-tiles of the PV product
  constexpr int kNT = kBK / 8;    // n-tiles of the QK^T product
  __shared__ __align__(16) __nv_bfloat16 sK[kBK * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBK * kStride];

  const int G = Hq / Hk;
  const int bq = kRows / G;  // query positions per CTA
  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2;  // row within the 8-row half of the mma tile
  const int tig = lane & 3;   // column pair within the tile
  const int off = Sk - Sq;

  // the two rows this thread owns in the mma layout: gid and gid + 8
  int pos[2], head[2];
  bool live[2];
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    head[i] = kvh * G + r / bq;
    pos[i] = q0 + r % bq;
    live[i] = pos[i] < Sq;
  }

  // Q fragments for the whole head dim, straight from global memory
  uint32_t qf[kKC][4];
  #pragma unroll
  for (int kc = 0; kc < kKC; ++kc) {
    #pragma unroll
    for (int reg = 0; reg < 4; ++reg) {
      const int i = reg & 1;
      const int col = kc * 16 + tig * 2 + ((reg >> 1) << 3);
      uint32_t val = 0;
      if (live[i]) {
        val = *reinterpret_cast<const uint32_t*>(
            q + qs.at(b, pos[i], head[i]) + col);
      }
      qf[kc][reg] = val;
    }
  }

  float acc[kDT][4];
  #pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
    #pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};  // per-thread partial sums

  // keys this CTA can see: up to the diagonal of its last live row
  const int q_hi = min(q0 + bq, Sq) - 1;
  int kend = causal ? min(Sk, q_hi + off + 1) : Sk;
  if (kend < 0) kend = 0;

  for (int t0 = 0; t0 < kend; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed
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

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kNT][4];
    #pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      #pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
      const __nv_bfloat16* kp = sK + (nt * 8 + gid) * kStride + tig * 2;
      #pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kp + kc * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kp + kc * 16 + 8);
        mma_bf16(s[nt], qf[kc], b0, b1);
      }
    }

    // mask, online softmax (exp2 domain), P into s
    #pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
      #pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = t0 + nt * 8 + tig * 2 + j;
          const bool ok = key < Sk && (!causal || key <= pos[i] + off);
          const float x = ok ? s[nt][i * 2 + j] * scale_log2 : kNeg;
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
          const int key = t0 + nt * 8 + tig * 2 + j;
          const bool ok = key < Sk && (!causal || key <= pos[i] + off);
          const float p = ok ? exp2f(s[nt][i * 2 + j] - mx) : 0.f;
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

    // O += P V: the S accumulator layout of n-tiles 2kc and 2kc+1 is the
    // A-operand layout of k-chunk kc
    #pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const __nv_bfloat16* vp = sV + (kc * 16 + tig * 2) * kStride + gid;
      #pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const __nv_bfloat16* p = vp + dt * 8;
        const uint32_t b0 = pack_raw(p[0], p[kStride]);
        const uint32_t b1 = pack_raw(p[8 * kStride], p[9 * kStride]);
        mma_bf16(acc[dt], a, b0, b1);
      }
    }
  }

  // finalize: full row sums across the quad, normalize, write O and LSE
  #pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (!live[i]) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const size_t base =
        ((static_cast<size_t>(b) * Sq + pos[i]) * Hq + head[i]) * D;
    #pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<uint32_t*>(o + base + col) =
          pack_f32(acc[dt][i * 2] * inv, acc[dt][i * 2 + 1] * inv);
    }
    if (tig == 0) {
      lse[(static_cast<size_t>(b) * Hq + head[i]) * Sq + pos[i]] =
          l > 0.f ? (m_run[i] + log2f(l)) * kLn2 : kBig;
    }
  }
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Sk,
                              int Hq, int Hk, int D, int causal, float scale,
                              long long qsb, long long qss, long long qsh,
                              long long ksb, long long kss, long long ksh,
                              long long vsb, long long vss, long long vsh,
                              void* stream) {
  if (Hk <= 0 || Hq % Hk != 0 || kRows % (Hq / Hk) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bq = kRows / (Hq / Hk);
  dim3 grid((Sq + bq - 1) / bq, Hk, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float sl2 = scale * kLog2e;
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kk = static_cast<const __nv_bfloat16*>(k);
  const auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* oo = static_cast<__nv_bfloat16*>(o);
  auto* ll = static_cast<float*>(lse);
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (Sq <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  if (D == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(
        qq, kk, vv, oo, ll, Sq, Sk, Hq, Hk, causal, sl2, qs, ks, vs);
  } else if (D == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(
        qq, kk, vv, oo, ll, Sq, Sk, Hq, Hk, causal, sl2, qs, ks, vs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
