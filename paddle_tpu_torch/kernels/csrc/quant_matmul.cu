// int8 weight matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_qmm_kernel`
// (paddle_tpu/kernels/pallas/quant_matmul.py:44), the forward of every
// converted (int8) linear layer.
//
// y [M, N] bf16 = x [M, K] bf16 . (w [N, K] int8 * s [N] f32)^T, summed in
// f32 (fp16 and float32 x likewise, y in x's dtype: at the end). w is
// PyTorch's Linear layout (K-contiguous); the TPU kernel takes [K, N].
//
// What bounds it on this card: at decode (M <= 8 slot rows) bytes -- the
// int8 weight is read once and each byte feeds M multiply-adds, far under
// the ~295 flops/byte where the tensor cores would be the limit (gate/up:
// 58.7 MB, 0.0176 ms at 3.35 TB/s). At prefill M is the padded prompt
// length (32 to 1008 on the serving path): at M 1008 operations (2 M N K
// flops, 0.12 ms for the gate/up shape at the bf16 peak), at M 112 still
// bytes (the weight streams in 0.019 ms, the operations take 0.013).
//
// Both paths: int8 -> bf16 is exact (|q| <= 128 fits bf16's 8-bit
// significand), so the products run on the tensor cores in bf16 on
// (q, x), summed in f32, and s[n] multiplies each output channel's sum in
// the epilogue; one bf16 rounding of y. That equals the TPU kernel's order
// (w * s first, then the dot) up to f32 rounding. The conversion
// (`i8x4`) is a byte permutation and one f32 subtract a value: a byte,
// biased by 128, becomes the low mantissa byte of 2^23's f32 pattern, and
// subtracting 2^23 + 128 leaves q; the f32 of any |q| <= 128 has at most
// 8 significant bits, so its upper half is its bf16 and one more byte
// permutation packs two of them. No int-to-float or float-to-bf16
// conversion instruction: those run on the SM's narrow conversion pipe.
//
// Decode (M <= 8). The first version (one 16-channel CTA a slice, every
// CTA re-reading all of x from L2, I2F conversion) reached 12-72 % of the
// bound. What holds a kernel of this size back on this card is the weight
// stream's depth and its start and end, not the products: a copy-only
// build of the ring below took most of the kernel's time at every shape
// (PERF.md).
// - A CTA of kW = 4 consumer warps owns 64 output channels (16 a warp)
//   and one producer warp. One lane of the producer fills a
//   kStages-deep ring with TMA (cp.async.bulk.tensor, 2-d tensor maps made
//   on the host, zeros past N, K and M): per 128-wide k stage one box of
//   64 weight rows x 128 bytes and two boxes of x's 8 rows x 64 k, all
//   with the 128-byte swizzle, completing on the stage's full barrier
//   (mbarrier with the byte count); consumer warps wait on it, multiply,
//   and arrive on the stage's empty barrier, which the producer waits on
//   before it refills the slot. No copy waits on a product and no warp
//   issues copies: earlier versions that copied with cp.async from every
//   thread (a CTA-wide barrier a stage, or a ring per warp) lost 10-30 %
//   to products holding up the next copies, one producer warp issuing
//   cp.async was 2-3x slower still.
// - x is staged with the weight, 2 KB a stage against 8 KB of weight:
//   a quarter of the weight's L2 traffic, no staging before the loop and
//   no shared memory that grows with K.
// - Launched as a programmatic dependent (PDL): a CTA starts, sets up its
//   barriers and the cluster while the kernel before it finishes, and
//   waits (`griddepcontrol.wait`) before its first global read; it lets
//   the next kernel launch once its last copy is issued. One layer's
//   seven launches in a CUDA graph overlap each launch with the last
//   one's tail. (Asking for the first weight stages before the wait
//   saved a little more, but would read a weight that the kernel before
//   might still be writing.)
// - Products: mma.sync m16n8k16, the weight as A (16 channels), the tokens
//   as the n8 operand. A dot product does not depend on the order of k, so
//   the mma's k index is permuted to match 16-byte reads: in step j (0..3)
//   of a 64-wide chunk, fragment columns 2tig, 2tig+1 are k = 16tig + 4j +
//   {0, 1} and columns 2tig+8, 2tig+9 are k = 16tig + 4j + {2, 3}, in A
//   (one 16-byte shared read a row: 4 steps) and in B (two 16-byte reads of
//   x's row: 4 steps) alike. mma row g reads weight row pi(g) (`row_of`)
//   so that the swizzled reads are free of bank conflicts. The products
//   need under a tenth of the tensor cores at the bound, so mma.sync,
//   which lets each warp multiply on its own, is kept; wgmma m64n8k16
//   would tie four warps to one k step and need x permuted in shared
//   memory; it was not built.
// - K is split over a thread-block cluster of S CTAs (S 1, 2, 4 or 8, one
//   launch through cudaLaunchKernelEx) so that the grid fills the card at
//   every shape: k/v (N 1024) runs 16 channel tiles x 8, q/o 64 x 4. For
//   the same bits at every S, K is cut into kGranules = 8 granules (a
//   multiple of 128 wide, fixed by K alone); each granule's sum starts
//   from zero, and the granules' sums meet in one fixed balanced binary
//   tree: rank r of S holds granules [8r/S, 8(r+1)/S) and sums its subtree,
//   the S subtree sums meet in the tree's top levels. Each warp stores its
//   subtree sum (one float4 a lane) into the shared memory of the rank
//   that owns its channels (rank w % S; distributed shared memory, remote
//   stores once every CTA of the cluster has started), one cluster barrier
//   later the owner adds the S sums, scales and rounds once. No workspace,
//   no second launch, no atomics: two calls and every S give the same
//   bits, and a CUDA graph can capture the call.
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
//   2tig + 8, 2tig + 9), converted exactly by `i8x4`; no bf16 copy of the
//   tile in shared memory.
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
//
// fp16 and float32 x: both paths are templated on x's type XT, the bf16
// instantiation being the code above.
// - fp16: the products in fp16 (`mma.sync` / `wgmma` `.f16`), the weight
//   converted by `i8x4_f16` (exact, below), y fp16.
// - float32: x as three bf16 pieces (split_bf16x3's rule: x0 + x1 + x2 ==
//   x) against the bf16 weight, which int8 makes exact: each weight
//   fragment meets the three pieces' fragments, x2 w and x1 w first and
//   x0 w last, summed in f32, each product exact in f32; one rounding of
//   y, which stays float32. What bounds it: three bf16 products for each
//   float32 product (330 TFLOP/s of float32 work) against the same weight
//   bytes. Prefill: a split pass (flash_bwd.cu `flash_split_bf16x3`, M x K
//   viewed as [1, M, 1, K]) writes the pieces [3, M, K] first, ~10 bytes
//   an element of x; a stage holds the three pieces' chunks (48 KiB) and
//   the int8 chunk (20 KiB), so the ring is three stages deep (204 KiB)
//   where bf16's is four. Decode: x is staged as float32 (four 32-wide
//   boxes a stage) and each lane splits what it reads into fragments: one
//   more launch a layer for a split pass would cost about as much as the
//   product itself at M <= 8.
//
// Any K (kRagged; until it, K % 16 != 0 ran on the CUDA cores,
// quant_matmul_simt.cu, 7.2x behind F.linear at M 300, K 4100 in fp16 on
// the H100): an int8 weight row of K bytes, and a 16-bit x row of 2 K, has
// no 16-byte stride there, which TMA (decode) and the 16-byte cp.async
// (prefill) need. The products do not care; only the loaders change.
// - w: each row's stage span is copied as the 16-byte-aligned span that
//   holds it (one 16-byte chunk more than the span), by 16-byte cp.async,
//   into a staged row 16 bytes longer than the aligned one (unswizzled at
//   decode: 144 bytes; prefill's padded 80-byte rows as they are), and the
//   fragment reads start at the row's offset in its span
//   (tiles::copy_spans, lds128_at / lds32_at: five or two 4-byte reads,
//   funnel-shifted). A first version copied each row at the widest
//   granule its stride allowed (4-byte cp.async at K 4100): on the H100
//   M 8 read 14x the aligned decode and M 300 3.3x, still 2.6x and 2.4x
//   with compile-time trip counts; the spans read 1.8x and 1.9x
//   (PERF.md).
// - x: its rows are copied at the widest granule their stride and base
//   allow (cp.async of 16, 8 or 4 bytes; 2 through registers) into
//   the same swizzled stages (wgmma and the decode's fragments read them
//   in place); float32 x at prefill is split with its pieces' K padded to
//   a multiple of 16, so its rows are aligned.
// - The ragged last k chunk is zero-filled in x; w's bytes past K there
//   are the next row's and meet those zeros. At decode the producer
//   warp's 32 lanes copy (TMA's one lane cannot) and each arrives on the
//   stage's full barrier when its copies land
//   (cp.async.mbarrier.arrive.noinc).
// No padded copy of w is made or kept: at K 4100, N 14336 that would be
// 58.8 MB written and read again, as much as the bound.

#include <cooperative_groups.h>

#include "async_tiles.cuh"
#include "flash_common.cuh"

namespace {

namespace cg = cooperative_groups;
using flash::mma_bf16;
using flash::pack_f32;

// four int8 (one word) -> two bf16x2, exactly: bytes 0, 1 into lo and
// bytes 2, 3 into hi. (q + 128) as the low byte of 2^23's f32 pattern is
// 2^23 + q + 128; subtracting 2^23 + 128 leaves q, whose f32 has its bf16
// in the upper half (at most 8 significant bits): one byte permutation
// packs two.
__device__ __forceinline__ void i8x4_bf16(uint32_t word, uint32_t& lo,
                                          uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  lo = __byte_perm(__float_as_uint(f0 - kMagic), __float_as_uint(f1 - kMagic),
                   0x7632);
  hi = __byte_perm(__float_as_uint(f2 - kMagic), __float_as_uint(f3 - kMagic),
                   0x7632);
}

// four int8 (one word) -> two fp16x2, exactly, laid out as i8x4_bf16's.
// The same bias trick on fp16's exponent: (q + 128) as the low byte of
// 1024's fp16 pattern (0x6400) is 1024 + q + 128, exact, since fp16's
// 10-bit mantissa spaces the values in [1024, 2048) one apart; one f16x2
// subtract of 1024 + 128 (0x6480) leaves q, exact again (|q| <= 128 fits
// fp16's 11-bit significand). Two byte permutations and one subtract a
// pair, no conversion instruction.
__device__ __forceinline__ void i8x4_f16(uint32_t word, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t u = word ^ 0x80808080u;
  const uint32_t l = __byte_perm(u, 0x64646464u, 0x4140);
  const uint32_t h = __byte_perm(u, 0x64646464u, 0x4342);
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(l), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(h), "r"(0x64806480u));
}

// the weight's conversion for products in T (bf16 or fp16): exact either
// way
template <typename T>
__device__ __forceinline__ void i8x4(uint32_t word, uint32_t& lo,
                                     uint32_t& hi) {
  if constexpr (flash::kIsHalf<T>)
    i8x4_f16(word, lo, hi);
  else
    i8x4_bf16(word, lo, hi);
}

// c (+)= A . B, mma.sync m16n8k16 in T (bf16 or fp16), f32 accumulate
template <typename T>
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (flash::kIsHalf<T>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// The element types of a path: XT the x it stages (bf16, fp16 or float32)
// and T the type its products take (fp16 for fp16 x, bf16 otherwise: a
// float32 x enters the products as three bf16 pieces, P = 3), YT that of y
// (x's own).
template <typename XT>
using ProdT = std::conditional_t<std::is_same<XT, __half>::value, __half,
                                 __nv_bfloat16>;
template <typename XT>
constexpr int kPiecesOf = std::is_same<XT, float>::value ? 3 : 1;

// y's element from its float32 value, rounded once
template <typename YT>
__device__ __forceinline__ YT to_y(float v) {
  if constexpr (std::is_same<YT, float>::value) return v;
  else if constexpr (std::is_same<YT, __half>::value) return __float2half_rn(v);
  else return __float2bfloat16(v);
}

// four consecutive y values from float32, one store of 8 (16-bit y) or 16
// bytes (float32 y); dst 8- or 16-byte aligned
template <typename YT>
__device__ __forceinline__ void store4(YT* dst, float a, float b, float c,
                                       float d) {
  if constexpr (std::is_same<YT, float>::value) {
    *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
  } else {
    uint2 pk;
    pk.x = flash::pack2<YT>(a, b);
    pk.y = flash::pack2<YT>(c, d);
    *reinterpret_cast<uint2*>(dst) = pk;
  }
}

// x's two float32 values (lo, hi) as three bf16x2 pieces, split_bf16x3's
// rule on both at once: one paired conversion (cvt.rn.bf16x2.f32) a piece
// and two exact subtracts, half the conversions of one value at a time
// (the conversion pipe is the decode kernel's narrowest at float32 x)
__device__ __forceinline__ void split_pair(float lo, float hi,
                                           uint32_t (&w)[3]) {
  #pragma unroll
  for (int p = 0; p < 3; ++p) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    w[p] = *reinterpret_cast<const uint32_t*>(&v);
    lo -= __low2float(v);
    hi -= __high2float(v);
  }
}

// --- decode path (M <= 8) --------------------------------------------------

namespace dec {

// mirrored by kernels/quant_matmul.py (DEC_*)
constexpr int kBK = 128;           // k (weight bytes a row) per ring stage
constexpr int kStages = 4;         // ring depth
constexpr int kGranules = 8;       // leaves of the fixed k tree
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kTok = 8;            // token rows of x staged (zeros past M)
constexpr int kWarpRows = 16 * kBK;  // one warp's 16 weight rows of a stage
constexpr int kW = 4;              // consumer warps a CTA (16 channels each)
constexpr int kCh = 16 * kW;       // output channels a CTA
constexpr int kBox = kTok * 128;   // one box of x: 8 rows of 128 bytes
constexpr int kRS = kBK + 16;      // a ragged weight row's staged span
static_assert(kBK == 128, "one 128-byte swizzle span a weight row");
// x's 8 rows over a stage's 128 k in boxes of 128 bytes a row (two boxes
// of 64 k for 16-bit x, four of 32 for float32 x), then 64 weight rows
// (ragged: each row's 16-byte-aligned span of 144 bytes, unswizzled)
__host__ __device__ constexpr int x_bytes(int elem) { return kTok * kBK * elem; }
__host__ __device__ constexpr int stage_bytes(int elem, bool ragged) {
  return x_bytes(elem) + kCh * (ragged ? kRS : kBK);
}

// k per granule: K / 8 rounded up to a whole number of stages
__host__ __device__ __forceinline__ int granule(int K) {
  return (K + kGranules * kBK - 1) / (kGranules * kBK) * kBK;
}

// dynamic shared memory: the ring, with S > 1 the owner slots (one float4
// a lane for each of the ceil(kW / S) warps a rank owns, from each of S
// ranks), and the ring's full and empty barriers
__host__ __device__ __forceinline__ size_t slot_bytes(int S) {
  return S > 1 ? static_cast<size_t>((kW + S - 1) / S) * S * 32 *
                     sizeof(float4)
               : 0;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int S, int elem,
                                                      bool ragged) {
  return static_cast<size_t>(kStages) * stage_bytes(elem, ragged) +
         slot_bytes(S) + 2 * kStages * sizeof(uint64_t);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// v[0] + ... + v[n - 1] for n in {1, 2, 4, 8} as the balanced binary tree:
// the subtree of n leaves of the one fixed 8-leaf tree
__device__ __forceinline__ float4 tree_sum(const float4 (&v)[kGranules],
                                           int n) {
  if (n == 1) return v[0];
  const float4 s01 = add4(v[0], v[1]);
  if (n == 2) return s01;
  const float4 s03 = add4(s01, add4(v[2], v[3]));
  if (n == 4) return s03;
  return add4(s03, add4(add4(v[4], v[5]), add4(v[6], v[7])));
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// the ring's full barrier completes when a stage's bytes have landed (the
// producer's one arrive with the byte count, then the copies' own), its
// empty barrier when the kW consumer warps have read the stage
using tiles::mbar_arrive;
using tiles::mbar_expect;
using tiles::mbar_init;
using tiles::mbar_wait;
using tiles::tma_2d;
using tiles::mbar_arrive_cp_async;
using tiles::sw128_offset;

// programmatic dependent launch: wait until the kernel before this one has
// finished and its writes are visible (at once when it was not launched as
// a dependent); let the kernel after this one start launching
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
// mma row g of a warp's 16-row tile (and g + 8) reads weight row pi(g): the
// 128-byte swizzle puts 16-byte piece p of row r at p ^ (r & 7), and rows
// pi(g), pi(g + 1) of one quarter of a warp then differ in bit 2 of (r & 7):
// their pieces 4 c .. 4 c + 3 land in different bank groups
__device__ __forceinline__ int row_of(int g) { return ((g & 1) << 2) | (g >> 1); }

// 1-d grid of (N / 64) x S CTAs, clusters of S along x: cluster = channel
// tile, rank = share of K. kW consumer warps (16 channels each) and one
// producer warp. `wmap` boxes 128 bytes x 64 rows of w, `xmap` 128 bytes
// x 8 rows of x (zeros past N, K and M), both with the 128-byte swizzle.
// XT is x's (and y's) type: bf16 and fp16 multiply as they are; a float32
// x is split into three bf16 pieces as each lane takes its fragments
// (every warp splits the 8 rows it reads: no pass before the kernel, whose
// launch would cost as much as the product at these sizes), and each
// weight fragment meets the three, small pieces first.
// kRagged (K % 16 != 0: a row of x or w has no 16-byte stride, which TMA
// needs) fills the ring with cp.async from all 32 lanes of the producer
// warp: x's rows in the same swizzled layout at the widest granule they
// allow (xg bytes: 16, 8 or 4 asynchronously, 2 through registers),
// each weight row's 16-byte-aligned span by 16-byte copies (copy_spans;
// the products read it from its offset), zeros past N, K and M; each lane
// arrives on the full barrier once its copies have landed.
template <typename XT, bool kRagged>
__global__ void __launch_bounds__(32 * (kW + 1), 4)
qmm_decode_kernel(const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap,
                  const XT* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, XT* __restrict__ y,
                  int M, int N, int K, int xg) {
  using T = ProdT<XT>;
  constexpr int P = kPiecesOf<XT>;
  constexpr int kX = x_bytes(sizeof(XT));
  constexpr int kStage = stage_bytes(sizeof(XT), kRagged);
  constexpr int kBoxK = 128 / sizeof(XT);  // k a box of x spans
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gk = granule(K);
  const int gpr = kGranules / S;   // granules of this rank
  const int spg = gk / kBK;        // stages a granule
  const int k0 = rank * gpr * gk;
  const int k1 = min(k0 + gpr * gk, K);
  const int nst = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
  const int c0 = (blockIdx.x / S) * kCh;  // the CTA's first channel
  float4* slots = reinterpret_cast<float4*>(smem + kStages * kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kStages * kStage + slot_bytes(S));
  uint64_t* empty = full + kStages;
  if (tid == 0) {
    #pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, kRagged ? 32 : 1);
      mbar_init(empty + i, kW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (S > 1) tiles::cluster_arrive();  // waited for before remote stores

  if (warp == kW) {
    // the producer (one lane): stage st -> slot st % kStages once the
    // consumers have read what it held: x's 8 rows over the stage's 128 k
    // (two boxes of 64), then the CTA's 64 weight rows of 128 bytes (one
    // box). A granule boundary never falls inside a stage, so a rank's
    // stages end at K or at the next rank's first k.
    if constexpr (kRagged) {
      grid_dependency_wait();  // every global read after the kernel before
      const bool sync = xg < 4;  // some copies through registers
      constexpr int es = sizeof(XT);
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
      const int8_t* wend = w + static_cast<size_t>(N) * K;
      for (int st = 0; st < nst; ++st) {
        const int slot = st % kStages;
        if (st >= kStages) mbar_wait(empty + slot, (st / kStages + 1) & 1);
        unsigned char* xs = smem + slot * kStage;
        const int kb = k0 + st * kBK;
        // x's 8 rows: byte `off` of a row's stage span lies in box off /
        // 128, chunk (off / 16) % 8 of the box's row, as TMA lays it
        tiles::copy_rows_by<kTok, kBK * es, 32>(
            xg, xs, xb + static_cast<size_t>(kb) * es,
            static_cast<long long>(K) * es, M, (K - kb) * es, lane,
            [](int r, int off) {
              return (off >> 7) * kBox + sw128_offset(r, (off >> 4) & 7) +
                     (off & 15);
            });
        tiles::copy_spans<kCh, kBK, kRS, 32>(xs + kX, w, c0, N - c0, K, kb,
                                             wend, lane);
        if (sync) {  // the register stores are in; the copies must land
          tiles::cp_async_commit();
          tiles::cp_async_wait<0>();
          mbar_arrive(full + slot);
        } else {
          mbar_arrive_cp_async(full + slot);
        }
      }
      launch_dependents();
    } else if (lane == 0) {
      grid_dependency_wait();  // every global read after the kernel before
      for (int st = 0; st < nst; ++st) {
        const int slot = st % kStages;
        if (st >= kStages) mbar_wait(empty + slot, (st / kStages + 1) & 1);
        unsigned char* xs = smem + slot * kStage;
        const int kb = k0 + st * kBK;
        mbar_expect(full + slot, kStage);
        #pragma unroll
        for (int bx = 0; bx < kX / kBox; ++bx)
          tma_2d(xs + bx * kBox, &xmap, kb + bx * kBoxK, 0, full + slot);
        tma_2d(xs + kX, &wmap, kb, c0, full + slot);
      }
      // every copy is issued: the next kernel may start launching
      launch_dependents();
    }
    __syncwarp();
    if (S > 1) {
      tiles::cluster_wait();
      cluster.sync();
    }
    return;
  }

  // the consumers. Fragment reads: weight rows pi(gid) and pi(gid) + 8 of
  // the warp's 16, piece 4 c + tig of 64-wide chunk c; x row gid of the
  // chunk's boxes, elements 16 tig .. 16 tig + 15 of the chunk (16-bit x:
  // pieces 2 tig and 2 tig + 1 of box c; float32 x: pieces 4 (tig % 2) ..
  // 4 (tig % 2) + 3 of box 2 c + tig / 2)
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n0 = c0 + 16 * warp;  // the warp's first channel
  const int wrow = row_of(gid);
  const bool live = n0 < N;
  // kRagged: rows n0 + wrow and + 8 from their offsets in their spans
  constexpr int kRow = kRagged ? kRS : kBK;  // bytes a staged weight row
  const int d0 = kRagged ? tiles::span_offset(
                               w, static_cast<long long>(n0 + wrow) * K)
                         : 0;
  const int d8 = kRagged ? tiles::span_offset(
                               w, static_cast<long long>(n0 + wrow + 8) * K)
                         : 0;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float4 leaf[kGranules];
  #pragma unroll
  for (int t = 0; t < kGranules; ++t) leaf[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  int g = 0;          // the granule stage st is in
  int g_end = spg;    // its first stage past it
  for (int st = 0; st < nst; ++st) {
    const int slot = st % kStages;
    mbar_wait(full + slot, (st / kStages) & 1);
    const unsigned char* xs = smem + slot * kStage;
    const unsigned char* ws = xs + kX + (16 * warp + wrow) * kRow;
    const unsigned char* xr = xs + gid * 128;
    if (live) {
      #pragma unroll
      for (int c = 0; c < kBK / 64; ++c) {
        uint4 wa, wb;
        if constexpr (kRagged) {
          wa = tiles::lds128_at(ws + d0 + 16 * (4 * c + tig));
          wb = tiles::lds128_at(ws + 8 * kRS + d8 + 16 * (4 * c + tig));
        } else {
          const int off = 16 * ((4 * c + tig) ^ wrow);
          wa = lds128(ws + off);
          wb = lds128(ws + 8 * kBK + off);
        }
        const unsigned char* xc = xr + c * (kX / 2);  // the chunk's boxes
        // xb[p][i]: piece p of x's k 16 tig + 2 i, + 1 of the chunk
        uint32_t xb[P][8];
        if constexpr (P == 1) {
          const uint4 x0 = lds128(xc + 16 * ((2 * tig) ^ gid));
          const uint4 x1 = lds128(xc + 16 * ((2 * tig + 1) ^ gid));
          const uint32_t w[8] = {x0.x, x0.y, x0.z, x0.w,
                                 x1.x, x1.y, x1.z, x1.w};
          #pragma unroll
          for (int i = 0; i < 8; ++i) xb[0][i] = w[i];
        } else {
          const unsigned char* xq = xc + (tig >> 1) * kBox;
          #pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float4 f = *reinterpret_cast<const float4*>(
                xq + 16 * ((4 * (tig & 1) + h) ^ gid));
            uint32_t lo[3], hi[3];
            split_pair(f.x, f.y, lo);
            split_pair(f.z, f.w, hi);
            #pragma unroll
            for (int p = 0; p < P; ++p) {
              xb[p][2 * h] = lo[p];
              xb[p][2 * h + 1] = hi[p];
            }
          }
        }
        const uint32_t ra[4] = {wa.x, wa.y, wa.z, wa.w};
        const uint32_t rb[4] = {wb.x, wb.y, wb.z, wb.w};
        #pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t a[4];
          i8x4<T>(ra[j], a[0], a[2]);
          i8x4<T>(rb[j], a[1], a[3]);
          #pragma unroll
          for (int p = P - 1; p >= 0; --p)
            mma16816<T>(acc, a, xb[p][2 * j], xb[p][2 * j + 1]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);  // the warp is done with it
    if (st + 1 == g_end || st + 1 == nst) {  // granule g ends
      #pragma unroll
      for (int t = 0; t < kGranules; ++t)
        if (t == g) leaf[t] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      ++g;
      g_end += spg;
    }
  }
  float4 v = tree_sum(leaf, gpr);
  grid_dependency_wait();  // s and y: after the kernel before this one

  if (S > 1) {
    // the subtree sum to the owner of these channels (rank warp % S), slot
    // [warp / S][rank][lane]; then the owner's warps add the S sums
    float4* remote = cluster.map_shared_rank(slots, warp % S);
    tiles::cluster_wait();  // every CTA of the cluster has started
    remote[((warp / S) * S + rank) * 32 + lane] = v;
    cluster.sync();  // every rank's sums have landed
    if (warp % S != rank) return;
    float4 part[kGranules];
    #pragma unroll
    for (int r = 0; r < kGranules; ++r)
      part[r] = r < S ? slots[((warp / S) * S + r) * 32 + lane]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    v = tree_sum(part, S);
  }

  // v: channel n0 + pi(gid) (x, y) and n0 + pi(gid) + 8 (z, w), tokens
  // 2 tig and 2 tig + 1
  const float vals[4] = {v.x, v.y, v.z, v.w};
  #pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = n0 + wrow + 8 * (e >> 1);
    const int m = 2 * tig + (e & 1);
    if (n < N && m < M)
      y[static_cast<size_t>(m) * N + n] = to_y<XT>(vals[e] * s[n]);
  }
}

using tiles::encode_tiled;

// a row-major [rows, cols] tensor of `elem`-byte values as 2-d boxes of
// box_cols x box_rows, 128-byte swizzle, zeros out of bounds
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* base, int rows, int cols, int box_cols,
                int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
            estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x's tensor-map element type
template <typename XT>
constexpr CUtensorMapDataType kXMapType =
    std::is_same<XT, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
    : std::is_same<XT, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

template <typename XT, bool kRagged>
int launch(const void* x, const void* w, const void* s, void* y, int M,
           int N, int K, int S, cudaStream_t st) {
  const size_t smem = smem_bytes(S, sizeof(XT), kRagged);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static size_t opened = 0;  // dynamic shared memory allowed so far
  if (smem > opened) {
    const cudaError_t e = cudaFuncSetAttribute(
        qmm_decode_kernel<XT, kRagged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opened = smem;
  }
  // TMA's tensor maps, or (kRagged) the copy granule of x's rows
  CUtensorMap wmap = {}, xmap = {};
  int xg = 16;
  if (kRagged) {
    xg = tiles::copy_granule_of(x, static_cast<long long>(K) * sizeof(XT));
  } else if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, N, K,
                         kBK, kCh) ||
             !tensor_map(&xmap, kXMapType<XT>, sizeof(XT), x, M, K,
                         128 / sizeof(XT), kTok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + kCh - 1) / kCh * S));
  cfg.blockDim = dim3(32 * (kW + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, qmm_decode_kernel<XT, kRagged>, wmap, xmap,
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<XT*>(y), M, N, K, xg);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dec

// --- prefill path (M >= 9) -------------------------------------------------

namespace pf {

using tiles::sw128_offset;

constexpr int kTok = 128;      // tokens per CTA
constexpr int kCh = 256;       // output channels per CTA (64 per warpgroup)
constexpr int kBK = 64;        // k per staged chunk
constexpr int kKS = kBK / 16;  // wgmma k steps per chunk
constexpr int kThreads = 512;  // four warpgroups
constexpr int kW8Stride = kBK + 16;  // bytes per staged int8 weight row
constexpr int kX = kTok * kBK * 2;   // a 16-bit token chunk (swizzled)
constexpr int kW8 = kCh * kW8Stride;  // int8 weight chunk
constexpr int kOutStride = kCh + 4;  // floats per staged output row
constexpr int kOut = kTok * kOutStride * 4;  // the f32 output tile

// A stage holds P token chunks (x's pieces: one for bf16 and fp16 x,
// three for float32 x) and the int8 weight chunk. Four stages of one piece
// (4 x 52 KiB) fit the 227 KiB a CTA may take; with three pieces a stage
// is 68 KiB, so the ring is three stages deep (204 KiB): two would leave a
// chunk's products waiting on the next chunk's copies.
template <int P>
struct Ring {
  static constexpr int kStages = P == 1 ? 4 : 3;
  static constexpr int kStage = P * kX + kW8;
  static constexpr int kSmem =
      kStages * kStage > kOut ? kStages * kStage : kOut;
  static_assert(kStage % tiles::kAtomBytes == 0, "stages keep atoms aligned");
  static_assert(kSmem <= 227 * 1024, "the ring fits a CTA");
};

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// CTA (blockIdx.x, blockIdx.y, blockIdx.z) = (token tile, channel tile,
// k split); the split covers chunks [z cps, (z + 1) cps), at least one.
// With ws == null it writes y = YT(sum * s); else the f32 sums to
// ws[z][M][N]. Warpgroup g computes channels 64 g .. 64 g + 63 x all 128
// tokens (wgmma's M is the channel, N the token); warp w of the CTA owns
// channel rows 16 w .. 16 w + 15 of the A operand. XT is x's type: x
// points at bf16 or fp16 [M, K], or for float32 x at its three bf16
// pieces [3, M, K] (flash_split_bf16x3), and each weight fragment then
// meets the three pieces' chunks, small pieces first, in one commit group
// a k step. kRagged (K % 16 != 0) stages the same chunks from rows with no
// 16-byte stride: x's rows ldx elements apart (float32 x's pieces padded
// to a multiple of 16 by the split pass, so ldx > K there), copied at the
// widest granule their stride and base allow (xg bytes), zero-filled past
// ldx; each of w's rows K bytes apart as its 16-byte-aligned span of 80
// bytes (copy_spans, in the 80-byte staged row), its fragments read from
// its offset there.
template <typename XT, bool kRagged>
__global__ void __launch_bounds__(kThreads, 1)
qmm_prefill_kernel(const ProdT<XT>* __restrict__ x,
                   const int8_t* __restrict__ w, const float* __restrict__ s,
                   XT* __restrict__ y, float* __restrict__ ws, int M, int N,
                   int K, int cps, int ldx, int xg) {
  using T = ProdT<XT>;
  constexpr int P = kPiecesOf<XT>;
  constexpr int kStages = Ring<P>::kStages;
  constexpr int kStage = Ring<P>::kStage;
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

  // chunk c -> stage st: each piece's 128 token rows (128 bytes each,
  // swizzled; eight threads copy one row) and 256 int8 weight rows (64
  // bytes each, padded to 80 so that the fragment reads are free of bank
  // conflicts), in 16-byte pieces; K % 16 == 0, so a piece is all in range
  // or all out
  auto load = [&](int c, int st) {
    unsigned char* xs = smem + st * kStage;
    unsigned char* w8 = xs + P * kX;
    const int k0 = c * kBK;
    if constexpr (kRagged) {
      const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
      #pragma unroll
      for (int p = 0; p < P; ++p)
        tiles::copy_rows_by<kTok, kBK * 2, kThreads>(
            xg, xs + p * kX,
            xb + ((static_cast<size_t>(p) * M + m0) * ldx + k0) * 2,
            2LL * ldx, M - m0, (ldx - k0) * 2, tid,
            [](int r, int off) {
              return sw128_offset(r, off >> 4) + (off & 15);
            });
      tiles::copy_spans<kCh, kBK, kW8Stride, kThreads>(
          w8, w, n0, N - n0, K, k0, w + static_cast<size_t>(N) * K, tid);
    } else {
      for (int i = tid; i < P * kTok * 8; i += kThreads) {
        const int p = P == 1 ? 0 : i / (kTok * 8);
        const int r = P == 1 ? i >> 3 : (i >> 3) % kTok;
        const int q = i & 7;
        const int k = k0 + 8 * q;
        const bool ok = m0 + r < M && k < K;
        const T* src = x + static_cast<size_t>(m0 + r) * K + k;
        if constexpr (P > 1) src += static_cast<size_t>(p) * M * K;
        tiles::cp_async16(xs + p * kX + sw128_offset(r, q), ok ? src : x,
                          ok);
      }
      for (int i = tid; i < kCh * 4; i += kThreads) {
        const int r = i >> 2;
        const int q = i & 3;
        const int k = k0 + 16 * q;
        const bool ok = n0 + r < N && k < K;
        tiles::cp_async16(w8 + r * kW8Stride + 16 * q,
                          ok ? w + static_cast<size_t>(n0 + r) * K + k : w,
                          ok);
      }
    }
  };

  // the warp's A fragment (its 16 channel rows) for k step kk of the chunk
  // in stage st, converted exactly: k 2tig, 2tig + 1 of rows gid, gid + 8
  // in a0, a1 and k 2tig + 8, 2tig + 9 in a2, a3 -- two 4-byte reads per
  // row, one byte permutation picks the 4 bytes
  const uint32_t sel = (tig & 1) ? 0x7632u : 0x5410u;
  // kRagged: rows n0 + crow + gid and + 8 from their offsets in their spans
  const int d0 = kRagged ? tiles::span_offset(
                               w, static_cast<long long>(n0 + crow + gid) * K)
                         : 0;
  const int d8 = kRagged ? tiles::span_offset(
                               w, static_cast<long long>(n0 + crow + gid + 8) *
                                      K)
                         : 0;
  auto frag = [&](int st, int kk, uint32_t (&a)[4]) {
    const unsigned char* r0 = smem + st * kStage + P * kX +
                              (crow + gid) * kW8Stride + 4 * (tig >> 1) +
                              16 * kk;
    const unsigned char* r1 = r0 + 8 * kW8Stride;
    if constexpr (kRagged) {
      r0 += d0;
      r1 += d8;
      i8x4<T>(__byte_perm(tiles::lds32_at(r0), tiles::lds32_at(r0 + 8), sel),
              a[0], a[2]);
      i8x4<T>(__byte_perm(tiles::lds32_at(r1), tiles::lds32_at(r1 + 8), sel),
              a[1], a[3]);
    } else {
      i8x4<T>(__byte_perm(lds32(r0), lds32(r0 + 8), sel), a[0], a[2]);
      i8x4<T>(__byte_perm(lds32(r1), lds32(r1 + 8), sel), a[1], a[3]);
    }
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
      #pragma unroll
      for (int p = P - 1; p >= 0; --p)
        flash::wgmma_rs_n128<T>(
            acc, a[kk], tiles::wgmma_desc_sw128(xs + p * kX + 32 * kk),
            i > 0 || kk > 0 || p < P - 1);
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
      XT* dst = y + static_cast<size_t>(m) * N + n;
      if (vec) {
        const float4 sc = *reinterpret_cast<const float4*>(s + n);
        store4(dst, v.x * sc.x, v.y * sc.y, v.z * sc.z, v.w * sc.w);
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e)
          dst[e] = to_y<XT>(vals[e] * s[n + e]);
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

// y = YT(s[n] * sum over splits of ws[split][m][n]), splits added in order
template <typename YT>
__global__ void qmm_reduce_kernel(const float* __restrict__ ws,
                                  const float* __restrict__ s,
                                  YT* __restrict__ y, int M, int N,
                                  int splits) {
  const size_t total = static_cast<size_t>(M) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float sum = 0.f;
    for (int r = 0; r < splits; ++r) sum += ws[r * total + i];
    y[i] = to_y<YT>(sum * s[i % N]);
  }
}

// ldx: x's row stride in elements (K, or float32 x's padded pieces'); with
// kRagged x's copy granule follows from it and x's base
template <typename XT, bool kRagged>
int launch(const void* x, const void* w, const void* s, void* y, void* ws,
           int M, int N, int K, int ldx, int cps, cudaStream_t st) {
  constexpr int kSmem = Ring<kPiecesOf<XT>>::kSmem;
  static bool smem_ok = false;
  cudaError_t err =
      tiles::allow_smem(qmm_prefill_kernel<XT, kRagged>, kSmem, smem_ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int xg = tiles::copy_granule_of(x, 2LL * ldx);
  const int splits = ((K + kBK - 1) / kBK + cps - 1) / cps;
  const dim3 grid((M + kTok - 1) / kTok, (N + kCh - 1) / kCh, splits);
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  qmm_prefill_kernel<XT, kRagged><<<grid, kThreads, kSmem, st>>>(
      static_cast<const ProdT<XT>*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<XT*>(y), part, M, N, K, cps,
      ldx, xg);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(M) * N;
  const int blocks = static_cast<int>(
      total / 256 + 1 < 132 * 8 ? total / 256 + 1 : 132 * 8);
  qmm_reduce_kernel<XT><<<blocks, 256, 0, st>>>(
      part, static_cast<const float*>(s), static_cast<XT*>(y), M, N, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pf

}  // namespace

namespace {

// the checks of the C entry points: the decode kernel (M <= 8) and the
// prefill kernel (M >= 9, `cps` chunks a split, a workspace when split);
// K a multiple of 16 unless `any_k` (the ragged loaders)
bool bad_decode(int M, int N, int K, int cluster, bool any_k = false) {
  return M < 0 || M > dec::kTok || N <= 0 || K <= 0 ||
         (K % 16 != 0 && !any_k) || cluster <= 0 ||
         cluster > dec::kMaxCluster || (cluster & (cluster - 1)) != 0;
}

bool bad_prefill(const void* ws, int M, int N, int K, int cps,
                 bool any_k = false) {
  if (M <= 8 || N <= 0 || K <= 0 || (K % 16 != 0 && !any_k)) return true;
  const int nck = (K + pf::kBK - 1) / pf::kBK;
  return cps <= 0 || (cps < nck && ws == nullptr) ||
         (N + pf::kCh - 1) / pf::kCh > 65535 || (nck + cps - 1) / cps > 65535;
}

}  // namespace

// M <= 8: y = x . (w * s)^T by the decode kernel, 64-channel CTAs in
// clusters of `cluster` (1, 2, 4 or 8) CTAs splitting K; one launch, no
// workspace.
extern "C" int quant_matmul_decode_bf16(const void* x, const void* w,
                                        const void* s, void* y, int M, int N,
                                        int K, int cluster, void* stream) {
  if (bad_decode(M, N, K, cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  return dec::launch<__nv_bfloat16, false>(x, w, s, y, M, N, K, cluster,
                                           static_cast<cudaStream_t>(stream));
}

// M >= 9: the prefill kernel with `cps` 64-wide k chunks per split; with
// more than one split, ws holds splits x M x N floats.
extern "C" int quant_matmul_bf16(const void* x, const void* w, const void* s,
                                 void* y, void* ws, int M, int N, int K,
                                 int cps, void* stream) {
  if (bad_prefill(ws, M, N, K, cps))
    return static_cast<int>(cudaErrorInvalidValue);
  return pf::launch<__nv_bfloat16, false>(x, w, s, y, ws, M, N, K, K, cps,
                                          static_cast<cudaStream_t>(stream));
}

// As quant_matmul_decode_bf16 for x of dtype 1 (fp16: y fp16, products in
// fp16) or 2 (float32: y float32, x split into three bf16 pieces inside the
// kernel).
extern "C" int quant_matmul_decode_tc(int dtype, const void* x,
                                      const void* w, const void* s, void* y,
                                      int M, int N, int K, int cluster,
                                      void* stream) {
  if (bad_decode(M, N, K, cluster) || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dec::launch<__half, false>(x, w, s, y, M, N, K, cluster, st)
             : dec::launch<float, false>(x, w, s, y, M, N, K, cluster, st);
}

// As quant_matmul_bf16 for dtype 1 (fp16 x and y) or 2 (x points at the
// three bf16 pieces [3, M, K] of a float32 x, contiguous; y float32).
extern "C" int quant_matmul_tc(int dtype, const void* x, const void* w,
                               const void* s, void* y, void* ws, int M,
                               int N, int K, int cps, void* stream) {
  if (bad_prefill(ws, M, N, K, cps) || (dtype != 1 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? pf::launch<__half, false>(x, w, s, y, ws, M, N, K, K, cps, st)
             : pf::launch<float, false>(x, w, s, y, ws, M, N, K, K, cps, st);
}

// Any K, for x of dtype 0 (bf16), 1 (fp16) or 2 (float32: x itself, split
// in the kernel): the decode kernel with the ragged loader (cp.async from
// the producer warp in place of TMA), as quant_matmul_decode_bf16.
extern "C" int quant_matmul_decode_unaligned(int dtype, const void* x,
                                             const void* w, const void* s,
                                             void* y, int M, int N, int K,
                                             int cluster, void* stream) {
  if (bad_decode(M, N, K, cluster, true) || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dec::launch<__nv_bfloat16, true>(x, w, s, y, M, N, K, cluster, st);
  return dtype == 1
             ? dec::launch<__half, true>(x, w, s, y, M, N, K, cluster, st)
             : dec::launch<float, true>(x, w, s, y, M, N, K, cluster, st);
}

// Any K: the prefill kernel with the ragged loader, as quant_matmul_bf16
// for dtype 0 (bf16 x and y) and quant_matmul_tc for 1 (fp16) and 2 (x
// points at float32 x's pieces [3, M, ldx], contiguous); ldx >= K is x's
// row stride in elements (K but for padded pieces).
extern "C" int quant_matmul_unaligned(int dtype, const void* x, const void* w,
                                      const void* s, void* y, void* ws, int M,
                                      int N, int K, int ldx, int cps,
                                      void* stream) {
  if (bad_prefill(ws, M, N, K, cps, true) || dtype < 0 || dtype > 2 ||
      ldx < K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pf::launch<__nv_bfloat16, true>(x, w, s, y, ws, M, N, K, ldx, cps,
                                           st);
  return dtype == 1
             ? pf::launch<__half, true>(x, w, s, y, ws, M, N, K, ldx, cps, st)
             : pf::launch<float, true>(x, w, s, y, ws, M, N, K, ldx, cps, st);
}
