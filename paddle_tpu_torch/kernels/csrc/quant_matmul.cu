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
// the ~295 flops/byte where the tensor cores would be the limit. At
// prefill M is the padded prompt length (32 to 1008 on the serving path):
// at M 1008 operations (2 M N K flops, 0.12 ms for the gate/up shape at
// the bf16 peak), at M 112 still bytes (the 58.7 MB gate/up weight
// streams in 0.019 ms, the operations take 0.013).
//
// Both paths: int8 -> bf16 is exact (|q| <= 127 fits bf16's 8-bit
// significand), so the products run on the tensor cores in bf16 on
// (q, x), summed in f32, and s[n] multiplies each output channel's sum in
// the epilogue; one bf16 rounding of y. That equals the TPU kernel's order
// (w * s first, then the dot) up to f32 rounding.
//
// Decode (M <= 8), unchanged since its first version: mma.sync m16n8k16
// with the weight as the A operand (16 output channels) and the tokens as
// the n8 operand, no shared-memory staging. A dot product does not depend
// on the order of k, so the mma's k index is permuted to match contiguous
// loads: in step j (0..3) of a 64-wide chunk, fragment columns 2tig,
// 2tig+1 are k = 16tig + 4j + {0, 1} and columns 2tig+8, 2tig+9 are
// k = 16tig + 4j + {2, 3}, in A (weight bytes) and B (x elements) alike.
// A CTA of 8 warps owns 16 output channels and splits K among its warps
// (interleaved chunks, 4 chunks' loads in flight per thread, straight
// from global memory into registers; a K % 64 tail runs 16-wide chunks of
// the same form); the 8 partial tiles are summed in shared memory in a
// fixed order: deterministic, one launch, N/16 CTAs (256 at N = 4096).
//
// Prefill (M >= 9):
// - A CTA of four warpgroups owns 256 channels x 128 tokens; warpgroup g
//   computes channels 64 g .. 64 g + 63 x all 128 tokens with wgmma
//   m64n128k16 (64 f32 accumulators a thread). The large tile matters
//   most: every CTA re-reads its tokens from L2 for each channel tile and
//   its weights for each token tile, and with 128 x 128 tiles those
//   re-reads alone outlasted the products.
// - A 4-stage cp.async ring stages 64-wide k chunks: the token rows (eight
//   threads copy one 128-byte row, into wgmma's 128-byte-swizzled K-major
//   layout: the B operand, read from shared memory) and the int8 weight
//   rows (64 bytes, padded to 80 so that the fragment reads below are free
//   of bank conflicts). The weight crosses L2 as int8, half the bytes of
//   bf16.
// - The weight is wgmma's A operand from registers: each warp turns its 16
//   channel rows of a k step into the A fragment directly (two 4-byte
//   shared reads per row and one byte permutation pick k 2tig, 2tig + 1,
//   2tig + 8, 2tig + 9), converted exactly by byte permutation: a byte
//   (biased by 128) becomes the low mantissa byte of 2^23, one f32
//   subtract recovers q, one cvt packs two values; no int-to-float
//   conversions and no bf16 copy of the tile in shared memory.
// - As in CUTLASS's mixed-input mainloop, each k step is its own wgmma
//   commit group with up to three in flight, and a step's fragment is
//   rebuilt only after the product that last read it retired: the
//   conversion overlaps the products and ptxas keeps them asynchronous.
//   The first product starts the sums (scale-d = 0); zero-filling the
//   accumulators, or writing a fragment an in-flight product reads, makes
//   ptxas serialize every wgmma.
// - K is split where the tiles alone leave the SMs idle, into the whole
//   number of parts that brings the CTAs nearest one per SM (wrapper's
//   `prefill_plan`); split sums land in an f32 workspace and a second
//   kernel adds them in split order, scales and rounds once:
//   deterministic run to run.
// - The epilogue stages the f32 tile through shared memory so y's rows
//   (or the workspace's) are written coalesced.
// - Not yet: TMA with multicast across a cluster (would cut the L2
//   re-reads), a producer warp, a persistent grid.

#include "async_tiles.cuh"
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


// --- prefill path (M >= 9) -------------------------------------------------

namespace pf {

using tiles::sw128_offset;

constexpr int kTok = 128;      // tokens per CTA
constexpr int kCh = 256;       // output channels per CTA (64 per warpgroup)
constexpr int kBK = 64;        // k per staged chunk
constexpr int kKS = kBK / 16;  // wgmma k steps per chunk
constexpr int kStages = 4;     // ring depth
constexpr int kThreads = 512;  // four warpgroups
constexpr int kW8Stride = kBK + 16;  // bytes per staged int8 weight row
constexpr int kX = kTok * kBK * 2;   // bf16 token chunk (swizzled)
constexpr int kW8 = kCh * kW8Stride;  // int8 weight chunk
constexpr int kStage = kX + kW8;
constexpr int kOutStride = kCh + 4;  // floats per staged output row
constexpr int kOut = kTok * kOutStride * 4;  // the f32 output tile
constexpr int kSmem = kStages * kStage > kOut ? kStages * kStage : kOut;
static_assert(kStage % tiles::kAtomBytes == 0, "stages keep atoms aligned");

// four int8 (one word) -> two bf16x2, exactly: bytes 0, 1 into lo and
// bytes 2, 3 into hi. (q + 128) as the low byte of 2^23's f32 pattern is
// 2^23 + q + 128; subtracting 2^23 + 128 leaves q.
__device__ __forceinline__ void i8x4(uint32_t word, uint32_t& lo,
                                     uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  lo = pack_f32(f0 - kMagic, f1 - kMagic);
  hi = pack_f32(f2 - kMagic, f3 - kMagic);
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// CTA (blockIdx.x, blockIdx.y, blockIdx.z) = (token tile, channel tile,
// k split); the split covers chunks [z cps, (z + 1) cps), at least one.
// With ws == null it writes y = bf16(sum * s); else the f32 sums to
// ws[z][M][N]. Warpgroup g computes channels 64 g .. 64 g + 63 x all 128
// tokens (wgmma's M is the channel, N the token); warp w of the CTA owns
// channel rows 16 w .. 16 w + 15 of the A operand.
__global__ void __launch_bounds__(kThreads, 1)
qmm_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
                   int M, int N, int K, int cps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int crow = 16 * (tid >> 5);
  const int m0 = blockIdx.x * kTok;
  const int n0 = blockIdx.y * kCh;
  const int nck = (K + kBK - 1) / kBK;
  const int c0 = blockIdx.z * cps;
  const int nloc = min(nck, c0 + cps) - c0;

  // chunk c -> stage st: 128 token rows (128 bytes each, swizzled; eight
  // threads copy one row) and 256 int8 weight rows (64 bytes each, padded
  // to 80 so that the fragment reads are free of bank conflicts), in
  // 16-byte pieces; K % 16 == 0, so a piece is all in range or all out
  auto load = [&](int c, int st) {
    unsigned char* xs = smem + st * kStage;
    unsigned char* w8 = xs + kX;
    const int k0 = c * kBK;
    for (int i = tid; i < kTok * 8; i += kThreads) {
      const int r = i >> 3;
      const int p = i & 7;
      const int k = k0 + 8 * p;
      const bool ok = m0 + r < M && k < K;
      tiles::cp_async16(xs + sw128_offset(r, p),
                        ok ? x + static_cast<size_t>(m0 + r) * K + k : x, ok);
    }
    for (int i = tid; i < kCh * 4; i += kThreads) {
      const int r = i >> 2;
      const int q = i & 3;
      const int k = k0 + 16 * q;
      const bool ok = n0 + r < N && k < K;
      tiles::cp_async16(w8 + r * kW8Stride + 16 * q,
                        ok ? w + static_cast<size_t>(n0 + r) * K + k : w, ok);
    }
  };

  // the warp's A fragment (its 16 channel rows) for k step kk of the chunk
  // in stage st, converted exactly: k 2tig, 2tig + 1 of rows gid, gid + 8
  // in a0, a1 and k 2tig + 8, 2tig + 9 in a2, a3 -- two 4-byte reads per
  // row, one byte permutation picks the 4 bytes
  const uint32_t sel = (tig & 1) ? 0x7632u : 0x5410u;
  auto frag = [&](int st, int kk, uint32_t (&a)[4]) {
    const unsigned char* r0 = smem + st * kStage + kX +
                              (crow + gid) * kW8Stride + 4 * (tig >> 1) +
                              16 * kk;
    const unsigned char* r1 = r0 + 8 * kW8Stride;
    i8x4(__byte_perm(lds32(r0), lds32(r0 + 8), sel), a[0], a[2]);
    i8x4(__byte_perm(lds32(r1), lds32(r1 + 8), sel), a[1], a[3]);
  };

  // no zero fill: the first product overwrites (a non-wgmma write to the
  // accumulators would make ptxas serialize the products)
  float acc[kTok / 2];
  uint32_t a[kKS][4];  // one fragment per k step

  #pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nloc) load(c0 + st, st);
    tiles::cp_async_commit();
  }
  tiles::cp_async_wait<kStages - 2>();  // chunk 0 has landed
  tiles::fence_proxy_async();
  __syncthreads();
  frag(0, 0, a[0]);
  // As CUTLASS's mixed-input mainloop: one commit group per k step, up to
  // kKS - 1 of them in flight, so the fragment of step kk + 1 is rebuilt
  // only after the product that last read it (kKS steps back) retired.
  for (int i = 0; i < nloc; ++i) {
    const unsigned char* xs = smem + (i % kStages) * kStage;
    tiles::fence_regs(acc);
    #pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      tiles::wgmma_fence();
      tiles::wgmma_rs_n128(acc, a[kk], tiles::wgmma_desc_sw128(xs + 32 * kk),
                           i > 0 || kk > 0);
      tiles::wgmma_commit();
      tiles::wgmma_wait<kKS - 1>();
      if (kk + 1 < kKS) {
        frag(i % kStages, kk + 1, a[kk + 1]);
      } else if (i + 1 < nloc) {
        // chunk i - 1's products are retired here; once every warpgroup
        // is past this point its stage takes chunk i + kStages - 1
        tiles::cp_async_wait<kStages - 3>();  // chunk i + 1 has landed
        tiles::fence_proxy_async();
        __syncthreads();
        if (i + kStages - 1 < nloc)
          load(c0 + i + kStages - 1, (i + kStages - 1) % kStages);
        tiles::cp_async_commit();
        frag((i + 1) % kStages, 0, a[0]);
      }
    }
    tiles::fence_regs(acc);
  }
  tiles::wgmma_wait<0>();
  tiles::fence_regs(acc);
  tiles::cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the output tile in it

  // out[token][channel] f32. wgmma's accumulator: acc[4j + 2h + e] is
  // channel crow + gid + 8 h, token 8 j + 2 tig + e
  float* out = reinterpret_cast<float*>(smem);
  #pragma unroll
  for (int j = 0; j < kTok / 8; ++j)
    #pragma unroll
    for (int h = 0; h < 2; ++h)
      #pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(8 * j + 2 * tig + e) * kOutStride + crow + gid + 8 * h] =
            acc[4 * j + 2 * h + e];
  __syncthreads();
  const bool vec = N % 4 == 0;
  for (int i = tid; i < kTok * (kCh / 4); i += kThreads) {
    const int t = i / (kCh / 4);
    const int c = (i % (kCh / 4)) * 4;
    const int m = m0 + t;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(out + t * kOutStride + c);
    const float vals[4] = {v.x, v.y, v.z, v.w};
    if (ws == nullptr) {
      __nv_bfloat16* dst = y + static_cast<size_t>(m) * N + n;
      if (vec) {
        const float4 sc = *reinterpret_cast<const float4*>(s + n);
        uint2 pk;
        pk.x = pack_f32(v.x * sc.x, v.y * sc.y);
        pk.y = pack_f32(v.z * sc.z, v.w * sc.w);
        *reinterpret_cast<uint2*>(dst) = pk;
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e)
          dst[e] = __float2bfloat16(vals[e] * s[n + e]);
      }
    } else {
      float* dst = ws + (static_cast<size_t>(blockIdx.z) * M + m) * N + n;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e) dst[e] = vals[e];
      }
    }
  }
}

// y = bf16(s[n] * sum over splits of ws[split][m][n]), splits added in order
__global__ void qmm_reduce_kernel(const float* __restrict__ ws,
                                  const float* __restrict__ s,
                                  __nv_bfloat16* __restrict__ y, int M, int N,
                                  int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < splits; ++r) sum += ws[r * total + i];
    y[i] = __float2bfloat16(sum * s[i % N]);
  }
}

int launch(const void* x, const void* w, const void* s, void* y, void* ws,
           int M, int N, int K, int cps, cudaStream_t st) {
  static bool smem_ok = false;
  cudaError_t err = tiles::allow_smem(qmm_prefill_kernel, kSmem, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = ((K + kBK - 1) / kBK + cps - 1) / cps;
  const dim3 grid((M + kTok - 1) / kTok, (N + kCh - 1) / kCh, splits);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  qmm_prefill_kernel<<<grid, kThreads, kSmem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), part, M,
      N, K, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 8 ? total / 256 + 1 : 132 * 8);
  qmm_reduce_kernel<<<blocks, 256, 0, st>>>(
      part, static_cast<const float*>(s), static_cast<__nv_bfloat16*>(y), M,
      N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pf

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

// M <= 8: the decode kernel (cps and ws unused). M >= 9: the prefill
// kernel with `cps` 64-wide k chunks per split; with more than one split,
// ws holds splits x M x N floats.
extern "C" int quant_matmul_bf16(const void* x, const void* w, const void* s,
                                 void* y, void* ws, int M, int N, int K,
                                 int cps, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<1, 1, 8, 4>(x, w, s, y, M, N, K, st);
  const int nck = (K + pf::kBK - 1) / pf::kBK;
  if (cps <= 0 || (cps < nck && ws == nullptr) ||
      (N + pf::kCh - 1) / pf::kCh > 65535 || (nck + cps - 1) / cps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return pf::launch(x, w, s, y, ws, M, N, K, cps, st);
}
