"""PyTorch port: the CUDA kernels against their plain versions on the card.

Marked ``cuda``: these need an NVIDIA Hopper GPU and ``nvcc`` and skip
without them. On the card, run them with

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda --noconftest

(``--noconftest``: the suite's conftest imports JAX, which a GPU host
serving the port need not have.)

bf16 inputs. Flash forward: atol 3e-2 (a few bf16 ulps at |O| < 4: the
kernels round the unnormalized P to bf16, the plain versions the
normalized P) and, per (batch, position, head) row, max |kernel - plain|
/ max |plain| <= 2e-2 (two and a half ulps at the row's largest value;
|O| shrinks as the keys a row sees grow). Paged decode, int8 pools
included (both sides dequantize a row to the same bf16 values): atol
3e-2 and, per slot, max |kernel - plain| / max |plain| <= 2e-2 (the same
reasoning per slot). The backward kernels are compared
relatively, max |kernel - plain| / max |plain| <= 2e-2: dK and dV sum
over the whole sequence, and where P or dS sits at a bf16 rounding
boundary the two round differently. The segment branch of all three
(packed varlen sequences, segment ids) at the same tolerances, with exact
zeros where nothing is visible. The int8
weight matmul too, at 1e-2: it multiplies the scale after the f32 sum,
the plain version before, which moves the bf16 output by an ulp at most.

The CUDA cores' kernels (``flash_simt.cu``, ``paged_decode_simt.cuh``,
``quant_matmul_simt.cu``) take float32 and fp16 operands (decode and the
int8 matmul bf16 too): max |kernel - plain| / max |plain| (per row for
flash O, per slot for decode) within 1e-4 in float32 (the same float32
products summed in another order; 2e-4 for the flash gradients) and 5e-3
in fp16 (1e-2 for the gradients: both sides round P and dS to fp16, at
2^-11 of the value, at slightly different points); bf16 at the decode
limits above. B2 and B3 at D 64/128 in float32 (three bf16 pieces of
every operand, six products a product: ~2^-24 of each product dropped)
and fp16 (f16 wgmma) are held to the same float32 and fp16 gradient
limits; the split pass gives its plain version's bits.
"""

import functools

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import set_flags
from paddle_tpu_torch.kernels.flash_attention import (
    _SEG_NAMES, FULL, MASKED, SKIP, flash_attention_bwd_plain,
    flash_attention_plain, flash_bwd_cuda, flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda, flash_delta, flash_fwd_cuda, pair_classes,
    scaled_dot_product_attention, tile_bounds, varlen_segments)
from paddle_tpu_torch.kernels import paged_attention as _pa
from paddle_tpu_torch.kernels.paged_attention import (
    paged_decode_attention_chunked, paged_decode_attention_dense,
    paged_decode_attention_kernel, split_cluster_plan)
from paddle_tpu_torch.kernels import quant_matmul as _qm
from paddle_tpu_torch.kernels.quant_matmul import (
    DEC_CLUSTERS, SMEM_PER_BLOCK, decode_plan, decode_smem_bytes,
    quant_matmul, quant_matmul_plain)
from paddle_tpu_torch.quantization import _quantize_weight, quantize_rows

pytestmark = pytest.mark.cuda
ATOL = 3e-2
ROW_RTOL = 2e-2
DECODE_RTOL = 2e-2
BWD_RTOL = 2e-2
QMM_RTOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the plain versions compute in f32 on the card: keep TF32 out of it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev, dtype=torch.bfloat16)


def _row_rel_err(out, ref):
    """Per (batch, position, head) row: max |out - ref| / max |ref|; a row
    that sees no key (ref == 0) reads 0 only if out is 0 there too."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,fused", [
    (1, 64, 64, 4, 4, 64, True, False),
    (2, 100, 100, 8, 2, 128, True, False),
    (1, 37, 200, 8, 2, 128, True, False),
    (1, 37, 200, 8, 2, 128, False, False),
    (2, 200, 37, 4, 1, 64, True, False),
    (1, 1, 77, 32, 8, 128, True, False),
    # the kernel's tile edges: 64 folded rows (64/G positions), 64 keys
    (2, 1, 1, 8, 8, 64, True, False),
    (1, 127, 127, 8, 1, 128, True, False),
    (1, 128, 128, 32, 8, 128, True, False),
    (2, 129, 129, 16, 2, 64, True, False),
    (1, 1000, 1000, 32, 8, 128, True, False),
    (1, 1000, 1000, 16, 16, 64, False, False),
    (1, 129, 1000, 16, 2, 64, True, False),     # Sq < Sk, causal
    (1, 1000, 129, 8, 8, 128, True, False),     # Sq > Sk: fully masked rows
    (1, 128, 127, 32, 8, 128, False, False),
    (2, 127, 129, 8, 1, 64, True, False),
    # q/k/v as strided views of one [B, S, 3, H, D] projection
    (2, 300, 300, 4, 4, 64, True, True),
    (2, 129, 129, 2, 2, 128, True, True),
    # ViT-L/16's attention at a smaller batch: S 197 (5 live keys in the
    # last tile), G 1, non-causal
    (2, 197, 197, 16, 16, 64, False, False),
    # D 256 (the mma.sync kernel; Q read from shared memory each tile)
    (1, 2048, 2048, 16, 4, 256, True, False),
    (2, 197, 197, 8, 8, 256, False, False),
    (1, 37, 200, 8, 2, 256, True, False),
    (2, 200, 37, 4, 1, 256, True, False),       # fully masked rows
    (2, 129, 129, 2, 2, 256, True, True),
    # above 256 (the streamed kernel: one CTA a 128-column slice of O)
    (1, 2048, 2048, 16, 4, 384, True, False),
    (2, 197, 197, 8, 8, 512, False, False),
    (1, 37, 200, 8, 2, 512, True, False),
    (2, 200, 37, 4, 1, 384, True, False),       # fully masked rows
    (2, 129, 129, 2, 2, 640, True, True),
])
def test_flash_fwd_matches_plain(dev, B, Sq, Sk, Hq, Hk, D, causal, fused):
    if fused:
        q, k, v = _randn(dev, B, Sq, 3, Hq, D, seed=7).unbind(2)
    else:
        q = _randn(dev, B, Sq, Hq, D, seed=1)
        k = _randn(dev, B, Sk, Hk, D, seed=2)
        v = _randn(dev, B, Sk, Hk, D, seed=3)
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all())
    assert (o.float() - o_ref.float()).abs().max().item() <= ATOL
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    assert _row_rel_err(o, o_ref) <= ROW_RTOL
    if causal and Sq > Sk:  # rows that see no key: O 0, LSE +1e30
        assert o[:, :Sq - Sk].abs().max().item() == 0.0
        assert bool((lse[:, :, :Sq - Sk] == 1e30).all())


_SERVING_LENS = [0, 1, 16, 17, 100, 161, 239, 240]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("wrapper", [paged_decode_attention_kernel,
                                     paged_decode_attention_chunked])
@pytest.mark.parametrize("B,Hq,Hk,D,bs,mbps,lens", [
    (3, 8, 2, 128, 16, 8, [1, 100, 128]),
    (3, 8, 2, 128, 16, 8, [0, 17, 200]),   # a length past the table
    (2, 4, 4, 64, 16, 4, [30, 0]),
    (2, 32, 8, 128, 16, 20, [320, 33]),
    # the per-page kernel's cluster split (C = 4 at the serving shape):
    # 15 pages (not a multiple of C), empty beside full slots, slots with
    # fewer pages than C
    (8, 32, 8, 128, 16, 15, _SERVING_LENS),
    (3, 8, 2, 128, 8, 8, [1, 37, 64]),      # 8-row pages
    (3, 8, 2, 128, 8, 5, [0, 9, 77]),       # 8-row pages, past the table
    (3, 8, 2, 128, 32, 6, [31, 0, 192]),    # 32-row pages
    (2, 8, 8, 128, 16, 6, [50, 96]),        # G 1
    (2, 32, 4, 128, 16, 7, [100, 5]),       # G 8
    (3, 16, 2, 64, 16, 5, [70, 3, 80]),     # D 64
    (1, 8, 1, 64, 16, 3, [40]),             # one slot, C 2, G 8
    # a 128-page table: the per-page kernel's share streams through its
    # two-stage ring of chunks
    (8, 32, 8, 128, 16, 128, [1, 293, 585, 878, 1170, 1463, 1755, 2048]),
])
def test_paged_decode_matches_plain(dev, wrapper, quantized, B, Hq, Hk, D,
                                    bs, mbps, lens):
    rng = np.random.RandomState(0)
    kp = _randn(dev, B * mbps + 1, bs, Hk, D, seed=4)
    vp = _randn(dev, B * mbps + 1, bs, Hk, D, seed=5)
    q = _randn(dev, B, Hq, D, seed=6)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tbl = np.zeros((B, mbps), np.int32)
    for i in range(B):
        need = min(-(-lens[i] // bs), mbps)
        tbl[i, :need] = rng.permutation(np.arange(
            1 + i * mbps, 1 + (i + 1) * mbps))[:need]
    tbl = torch.as_tensor(tbl, device=dev)
    sl = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    count = "launches_q" if quantized else "launches"
    before = getattr(wrapper, count)
    out = wrapper(q, kp, vp, tbl, sl, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert getattr(wrapper, count) == before + 1
    assert bool(torch.isfinite(out.float()).all())
    for i, n in enumerate(lens):
        if n == 0:
            assert out[i].abs().max().item() == 0.0
        else:
            assert _rel_err(out[i], ref[i]) <= DECODE_RTOL, i
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_decode_replays_in_a_cuda_graph(dev, quantized):
    """The cluster launch captured in a CUDA graph: the capture counts one
    launch, and a replay after the query changes in place gives the plain
    version's answer for the new query."""
    B, Hq, Hk, D, bs, mbps = 8, 32, 8, 128, 16, 15
    rng = np.random.RandomState(1)
    kp = _randn(dev, B * mbps + 1, bs, Hk, D, seed=11)
    vp = _randn(dev, B * mbps + 1, bs, Hk, D, seed=12)
    q = _randn(dev, B, Hq, D, seed=13)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tbl = np.zeros((B, mbps), np.int32)
    for i, n in enumerate(_SERVING_LENS):
        tbl[i, :-(-n // bs)] = rng.permutation(np.arange(
            1 + i * mbps, 1 + (i + 1) * mbps))[:-(-n // bs)]
    tbl = torch.as_tensor(tbl, device=dev)
    sl = torch.as_tensor(np.asarray(_SERVING_LENS, np.int32), device=dev)
    wrapper = paged_decode_attention_kernel
    count = "launches_q" if quantized else "launches"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        wrapper(q, kp, vp, tbl, sl, **scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = getattr(wrapper, count)
    with torch.cuda.graph(graph):
        out = wrapper(q, kp, vp, tbl, sl, **scales)
    assert getattr(wrapper, count) == before + 1
    q.copy_(_randn(dev, B, Hq, D, seed=14))
    graph.replay()
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert getattr(wrapper, count) == before + 1
    assert out[0].abs().max().item() == 0.0
    for i in range(1, B):
        assert _rel_err(out[i], ref[i]) <= DECODE_RTOL, i
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


def test_paged_decode_rejects_an_int8_pool_without_scales(dev):
    kp = torch.zeros(3, 16, 2, 64, dtype=torch.int8, device=dev)
    q = _randn(dev, 1, 2, 64)
    tbl = torch.ones(1, 2, dtype=torch.int32, device=dev)
    sl = torch.full((1,), 5, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        paged_decode_attention_kernel(q, kp, kp, tbl, sl)
    with pytest.raises(ValueError, match="both"):
        paged_decode_attention_chunked(q, kp, kp, tbl, sl,
                                       k_scale=torch.ones(3, 16, 2,
                                                          device=dev))


def _decode_case(dev, B, Hq, Hk, D, bs, mbps, lens, quantized, seed):
    """Scattered-block pools, tables and lens; (q, kp, vp, tbl, sl,
    scales)."""
    rng = np.random.RandomState(seed)
    kp = _randn(dev, B * mbps + 1, bs, Hk, D, seed=seed + 1)
    vp = _randn(dev, B * mbps + 1, bs, Hk, D, seed=seed + 2)
    q = _randn(dev, B, Hq, D, seed=seed + 3)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tbl = np.zeros((B, mbps), np.int32)
    for i in range(B):
        need = min(-(-int(lens[i]) // bs), mbps)
        tbl[i, :need] = rng.permutation(np.arange(
            1 + i * mbps, 1 + (i + 1) * mbps))[:need]
    tbl = torch.as_tensor(tbl, device=dev)
    sl = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    return q, kp, vp, tbl, sl, scales


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("B,Hq,Hk,D,bs,mbps", [
    (5, 8, 8, 64, 8, 32),      # G 1, D 64, 8-row pages
    (5, 32, 4, 128, 16, 24),   # G 8, 16-row pages
    (5, 16, 4, 128, 32, 20),   # G 4, 32-row pages
])
def test_split_decode_matches_plain(dev, monkeypatch, quantized, cluster,
                                    B, Hq, Hk, D, bs, mbps):
    """The split route (B6, B6q) at every cluster size its plan can
    choose (forced): lens of 0, 1, a page boundary, the whole table and
    one in between; per-slot error, zeros for the empty slot, one launch
    a call, and the same bits from two calls."""
    monkeypatch.setattr(_pa, "split_cluster_plan", functools.partial(
        split_cluster_plan, cluster=cluster))
    lens = [0, 1, bs, mbps * bs, 3 * bs + 5]
    q, kp, vp, tbl, sl, scales = _decode_case(dev, B, Hq, Hk, D, bs, mbps,
                                              lens, quantized, seed=30)
    wrapper = paged_decode_attention_chunked
    count = "launches_q" if quantized else "launches"
    before = getattr(wrapper, count)
    out = wrapper(q, kp, vp, tbl, sl, **scales)
    again = wrapper(q, kp, vp, tbl, sl, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert getattr(wrapper, count) == before + 2
    assert torch.equal(out, again)
    assert bool(torch.isfinite(out.float()).all())
    assert out[0].abs().max().item() == 0.0
    for i in range(1, B):
        assert _rel_err(out[i], ref[i]) <= DECODE_RTOL, i
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


@pytest.mark.parametrize("quantized", [False, True])
def test_split_decode_replays_in_a_cuda_graph(dev, quantized):
    """The split route's one launch captured in a CUDA graph at engine A's
    shape (B 8, Hq 32, Hk 8, D 128, 128 16-row pages, lens 1..2048): the
    capture counts one launch, and a replay after the query changes in
    place gives the plain version's answer for the new query."""
    B, Hq, Hk, D, bs, mbps = 8, 32, 8, 128, 16, 128
    lens = np.linspace(1, 2048, 8).astype(np.int64)
    q, kp, vp, tbl, sl, scales = _decode_case(dev, B, Hq, Hk, D, bs, mbps,
                                              lens, quantized, seed=40)
    wrapper = paged_decode_attention_chunked
    count = "launches_q" if quantized else "launches"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        wrapper(q, kp, vp, tbl, sl, **scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = getattr(wrapper, count)
    with torch.cuda.graph(graph):
        out = wrapper(q, kp, vp, tbl, sl, **scales)
    assert getattr(wrapper, count) == before + 1
    q.copy_(_randn(dev, B, Hq, D, seed=44))
    graph.replay()
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert getattr(wrapper, count) == before + 1
    for i in range(B):
        assert _rel_err(out[i], ref[i]) <= DECODE_RTOL, i
    assert (out.float() - ref.float()).abs().max().item() <= ATOL


# the prefill kernel's tile edges (128 tokens x 256 channels, 64-wide k
# chunks, K split where the tiles alone leave SMs idle): N 72 and K 48 are
# tails of one partial tile and chunk; K 4144 ends in a partial chunk
_QMM_EDGES = [(M, N, K) for M in (9, 16, 112, 127, 128, 129, 1008)
              for N, K in ((72, 48), (72, 4096), (4096, 48), (4096, 4096),
                           (72, 14336), (4096, 14336))] + \
    [(200, 200, 4144), (257, 4100, 4144)]


# the decode kernel's edges (M <= 8; 16 W channels a CTA, 128-wide ring
# stages, K cut into 8 granules split over clusters of 1-8 CTAs): every
# token count, N 72, 200, 1000 (partial channel tiles), K 48 (one partial
# stage), 4144 (a partial stage and an empty rank at cluster 8)
_QMM_DECODE = [(M, N, K) for N in (72, 200, 1000, 1024, 4096, 14336)
               for K in (48, 4144, 4096, 14336) for M in range(1, 9)]


@functools.lru_cache(maxsize=1)
def _qmm_weight(N, K):
    """The quantized weight [N, K] of the matmul cases (kept for the next
    case of the same shape: the decode grid runs M fastest)."""
    w, s = _quantize_weight(_randn("cuda", N, K, seed=10) * 0.02, 0)
    return w, s.float()


@pytest.mark.parametrize("M,N,K", [
    (8, 4096, 4096), (1, 1024, 4096), (5, 200, 96), (3, 8, 32),
    (8, 4096, 14336), (1008, 14336, 4096), (32, 1024, 4096), (130, 128, 64),
    (17, 72, 48),
] + _QMM_EDGES + _QMM_DECODE)
def test_quant_matmul_matches_plain(dev, M, N, K):
    x = _randn(dev, M, K, seed=9)
    w, s = _qmm_weight(N, K)
    before = quant_matmul.launches
    out = quant_matmul(x, w, s)
    ref = quant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert _rel_err(out, ref) <= QMM_RTOL


def _force_decode_plan(monkeypatch, cluster):
    monkeypatch.setattr(_qm, "decode_plan", functools.partial(
        decode_plan, cluster=cluster))


@pytest.mark.parametrize("cluster", DEC_CLUSTERS)
def test_quant_matmul_decode_converts_every_int8_exactly(dev, monkeypatch,
                                                         cluster):
    """Every int8 value, -128 included, in every row and column of the
    weight, with x as unit rows (x[m] = e_k): y[m] = bf16(q[:, k] * s)
    exactly, for every k, at every cluster size."""
    N, K = 256, 512
    n = torch.arange(N, device=dev)[:, None]
    k = torch.arange(K, device=dev)[None, :]
    w = ((n + 7 * k) % 256 - 128).to(torch.int8).contiguous()
    s = _randn(dev, N, seed=11).abs().float() * 1e-2 + 1e-3
    _force_decode_plan(monkeypatch, cluster)
    eye = torch.eye(K, device=dev, dtype=torch.bfloat16)
    for k0 in range(0, K, 8):
        out = quant_matmul(eye[k0:k0 + 8].contiguous(), w, s)
        ref = (w[:, k0:k0 + 8].float().T * s).to(torch.bfloat16)
        assert torch.equal(out, ref), k0


@pytest.mark.parametrize("M,N,K", [(8, 4096, 4096), (3, 1000, 14336),
                                   (8, 1024, 4144), (1, 200, 48),
                                   (5, 14336, 4096)])
def test_quant_matmul_decode_bits_are_the_same_at_every_plan(dev,
                                                             monkeypatch,
                                                             M, N, K):
    """Every cluster size the plan can choose (forced): two calls give the
    same bits, and every size the same bits as every other (one fixed tree
    of sums over K)."""
    x = _randn(dev, M, K, seed=12)
    w, s = _qmm_weight(N, K)
    ref = quant_matmul_plain(x, w, s)
    outs = []
    for cluster in DEC_CLUSTERS:
        assert decode_smem_bytes(cluster) <= SMEM_PER_BLOCK
        _force_decode_plan(monkeypatch, cluster)
        out = quant_matmul(x, w, s)
        assert torch.equal(out, quant_matmul(x, w, s)), cluster
        outs.append(out)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert _rel_err(outs[0], ref) <= QMM_RTOL


def test_quant_matmul_decode_replays_in_a_cuda_graph(dev):
    """The decode kernel's one launch captured in a CUDA graph at q/o's
    shape (M 8, N 4096, K 4096; a cluster split of K): the capture counts
    one launch, and a replay after x changes in place gives the eager
    call's bits for the new x."""
    M, N, K = 8, 4096, 4096
    x = _randn(dev, M, K, seed=13)
    w, s = _qmm_weight(N, K)
    assert decode_plan(M, N, K) > 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        quant_matmul(x, w, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = quant_matmul.launches
    with torch.cuda.graph(graph):
        out = quant_matmul(x, w, s)
    assert quant_matmul.launches == before + 1
    x.copy_(_randn(dev, M, K, seed=14))
    graph.replay()
    eager = quant_matmul(x, w, s)
    ref = quant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert _rel_err(out, ref) <= QMM_RTOL


def test_quant_matmul_with_no_rows_launches_nothing(dev):
    w, s = _qmm_weight(1024, 4096)
    x = torch.empty(0, 4096, device=dev, dtype=torch.bfloat16)
    before = quant_matmul.launches
    assert quant_matmul(x, w, s).shape == (0, 1024)
    assert quant_matmul.launches == before


# the prefill kernel's outputs (M 112 and 1008 at Llama-3-8B's four layer
# shapes) on tools/torch_qmm_ab.py's fixed inputs, recorded from the first
# redesigned prefill kernel; the decode kernel's redesign shares its
# conversion and leaves these bits as they were
_PREFILL_DIGESTS = {
    "M112_N14336_K4096": "2f12e3704d96d1dd2ab6abf465584c16"
                         "af1af28150e196f41f18c1602a5aaf08",
    "M1008_N14336_K4096": "3e9c057be17c3c3c0dde7cefcea35089"
                          "50592d42bb68f4117afd965752c43415",
    "M112_N4096_K4096": "ff55142a65d676482acd8f0bbe90510e"
                        "8ef44294fc01dfae3a3e60608f594580",
    "M1008_N4096_K4096": "7694b3193be03579812234cec5c7eb0c"
                         "66d98ba6bfdfe4f3933c1e0ae0ab2571",
    "M112_N1024_K4096": "e290c07f0785ddf6d39835bfe4c431eb"
                        "c1a4e251e3fdda62f0a281ba38de57d1",
    "M1008_N1024_K4096": "4235bdc8e6afa01ff1579978dff94884"
                         "4f539fbc9946ca83c917528557e45368",
    "M112_N4096_K14336": "5744169404f31ab6b7d2be1ed85a5049"
                         "de3a6f1d4287c0d079b8e9b4e4eb50f6",
    "M1008_N4096_K14336": "ff0eda99620ddc1d71413abcc799c554"
                          "f016db30ce3a8963bb356dc17722884f",
}


def test_quant_matmul_prefill_outputs_are_bit_identical_to_the_recorded_ones(
        dev):
    """B7's prefill path gives, bit for bit, the outputs recorded above."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "tools" / "torch_qmm_ab.py"
    spec = importlib.util.spec_from_file_location("torch_qmm_ab", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.digests(_qm, which=("prefill",)) == {
        "prefill": _PREFILL_DIGESTS}


def test_quant_matmul_rejects_bad_inputs(dev):
    # K 40 itself is taken (the ragged loader); x's K must match w's
    x = _randn(dev, 4, 40)
    w = torch.zeros(16, 40, dtype=torch.int8, device=dev)
    s = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="must match"):
        quant_matmul(x, w[:, :32].contiguous(), s)
    with pytest.raises(ValueError, match="float32"):
        quant_matmul(x[:, :32].contiguous(), w[:, :32].contiguous(),
                     s.bfloat16())


def _rel_err(out, ref):
    ref = ref.float()
    return ((out.float() - ref).abs().max() /
            ref.abs().max().clamp_min(1e-6)).item()


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal", [
    (1, 64, 64, 4, 4, 64, True),
    (2, 100, 100, 8, 2, 128, True),
    (1, 37, 200, 8, 2, 128, True),     # Sq < Sk: bottom-right causal
    (1, 37, 200, 8, 2, 64, False),
    (2, 200, 37, 4, 1, 64, True),      # Sq > Sk: fully masked rows
    (1, 130, 130, 64, 1, 64, True),    # G = 64: one position per CTA
    # ragged ends (not multiples of 64 rows, 64 keys or 32-key halves)
    (1, 333, 333, 32, 8, 128, True),
    (2, 129, 161, 8, 8, 64, False),
    (1, 77, 1000, 8, 1, 128, True),    # Sq < Sk, G 8
    (1, 1000, 77, 8, 1, 64, True),     # Sq > Sk, G 8: masked rows
    (1, 1000, 333, 16, 4, 128, True),
    (1, 300, 300, 4, 4, 128, False),   # G 1, D 128
    (1, 500, 500, 64, 8, 64, True),    # G 8
    # S 2048 at G 4: the balanced dK/dV grid (Llama-3-8B's shape)
    (1, 2048, 2048, 32, 8, 128, True),
    (1, 2048, 2048, 16, 4, 64, True),
    # ViT-L/16's attention at a smaller batch
    (2, 197, 197, 16, 16, 64, False),
    # D 256 (two warpgroups: dK and dV from one CTA)
    (1, 2048, 2048, 16, 4, 256, True),
    (2, 197, 197, 8, 8, 256, False),
    (1, 37, 200, 8, 2, 256, True),
    (2, 200, 37, 4, 1, 256, True),
    (1, 333, 333, 32, 8, 256, True),
    (1, 100, 333, 8, 8, 256, False),   # G 1, Sk not a multiple of 64
    (2, 250, 250, 4, 4, 256, True),    # G 1, causal, ragged ends
    (1, 161, 161, 64, 1, 256, True),   # G 64: one position per CTA
    # above 256 (streamed: a CTA owns 128 columns of dQ, 64 of dK and dV)
    (1, 2048, 2048, 16, 4, 384, True),
    (1, 2048, 2048, 16, 4, 512, True),
    (2, 197, 197, 8, 8, 512, False),
    (1, 37, 200, 8, 2, 384, True),
    (2, 200, 37, 4, 1, 512, True),
    (1, 333, 333, 16, 8, 640, True),
])
def test_flash_bwd_matches_plain(dev, B, Sq, Sk, Hq, Hk, D, causal):
    q = _randn(dev, B, Sq, Hq, D, seed=1)
    k = _randn(dev, B, Sk, Hk, D, seed=2)
    v = _randn(dev, B, Sk, Hk, D, seed=3)
    do = _randn(dev, B, Sq, Hq, D, seed=4)
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    delta = flash_delta(o, do)
    before = (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_bwd_dq_cuda.launches, flash_bwd_dkv_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert bool(torch.isfinite(out.float()).all()), name
        assert _rel_err(out, ref) <= BWD_RTOL, name
    if causal and Sq > Sk:  # rows that see no key get exactly zero
        assert dq[:, :Sq - Sk].abs().max().item() == 0.0


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("seg", [False, True])
def test_flash_bwd_cluster_sizes_match_plain(dev, monkeypatch, cluster, seg):
    """B3 with its GQA group split over a cluster of 1, 2, 4 or 8 CTAs
    (``dkv_cluster`` picks 1 or 2; the kernel takes any power of two up to
    the portable 8) gives the plain gradients, dense and segment."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "dkv_cluster",
                        lambda B, Hk, G, Sk, D=128: cluster)
    if seg:
        q, k, v, do, causal, kw = _seg_inputs(dev, "long-g8-d64")
    else:
        q, k, v, do = _dense_inputs(dev, 1, 500, 16, 2, 128)
        causal, kw = True, {}
    dq, dk, dv = _bwd_calls(q, k, v, do, causal, kw)()
    o, lse = flash_fwd_cuda(q, k, v, causal, **kw)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, **kw)
    torch.cuda.synchronize()
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert _rel_err(out, ref) <= BWD_RTOL, name


@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("seg", [False, True])
def test_flash_bwd_256_cluster_sizes_match_plain(dev, monkeypatch, cluster,
                                                 seg):
    """B3 at D 256 (two warpgroups) with its GQA group split over a cluster
    of 1, 2 or 4 CTAs gives the plain gradients, dense and segment."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "dkv_cluster",
                        lambda B, Hk, G, Sk, D=128: cluster)
    if seg:
        q, k, v, do, causal, kw = _seg_inputs(dev, "ragged-g4-d256")
    else:
        q, k, v, do = _dense_inputs(dev, 1, 500, 16, 4, 256)
        causal, kw = True, {}
    dq, dk, dv = _bwd_calls(q, k, v, do, causal, kw)()
    o, lse = flash_fwd_cuda(q, k, v, causal, **kw)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, **kw)
    torch.cuda.synchronize()
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert _rel_err(out, ref) <= BWD_RTOL, name


def _bwd_calls(q, k, v, do, causal, kw):
    """B2 and B3 on the forward's O and LSE: a function of no arguments
    returning (dQ, dK, dV)."""
    o, lse = flash_fwd_cuda(q, k, v, causal, **kw)
    delta = flash_delta(o, do)

    def run():
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, **kw)
        return (dq,) + flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                          **kw)
    return run


def _dense_inputs(dev, B, S, Hq, Hk, D):
    return (_randn(dev, B, S, Hq, D, seed=1), _randn(dev, B, S, Hk, D, seed=2),
            _randn(dev, B, S, Hk, D, seed=3), _randn(dev, B, S, Hq, D, seed=4))


@pytest.mark.parametrize("case", ["dense-g4-d128", "dense-g1-d64",
                                  "ragged-g4-d128", "nonmono-g4-d128",
                                  "dense-g4-d256", "dense-g1-d256",
                                  "ragged-g4-d256", "dense-g4-d512",
                                  "ragged-g4-d512"])
def test_flash_bwd_is_deterministic(dev, case):
    """Two launches on the same inputs give the same bits: no atomics, and
    the cluster's partial sums meet in a fixed order (at D 256 and above
    the column slices of one tile sum nothing across CTAs)."""
    if case == "dense-g4-d128":
        q, k, v, do = _dense_inputs(dev, 1, 2048, 32, 8, 128)
        causal, kw = True, {}
    elif case == "dense-g1-d64":
        q, k, v, do = _dense_inputs(dev, 2, 1000, 16, 16, 64)
        causal, kw = True, {}
    elif case == "dense-g4-d256":
        q, k, v, do = _dense_inputs(dev, 1, 2048, 16, 4, 256)
        causal, kw = True, {}
    elif case == "dense-g1-d256":
        q, k, v, do = _dense_inputs(dev, 2, 333, 8, 8, 256)
        causal, kw = False, {}
    elif case == "dense-g4-d512":
        q, k, v, do = _dense_inputs(dev, 1, 1000, 16, 4, 512)
        causal, kw = True, {}
    else:
        q, k, v, do, causal, kw = _seg_inputs(dev, case)
    run = _bwd_calls(q, k, v, do, causal, kw)
    first = run()
    second = run()
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("case", ["dense-g4-d128", "dense-g1-d64",
                                  "long-g4-d128", "runs-g2-d64"])
def test_flash_bwd_replays_in_a_cuda_graph(dev, case):
    """B2 and B3 (the segment branch's tile bounds included) captured in a
    CUDA graph and replayed on new q and dO give the eager result."""
    if case.startswith("dense"):
        q, k, v, do = _dense_inputs(dev, *((1, 1000, 32, 8, 128)
                                          if "g4" in case else
                                          (2, 300, 4, 4, 64)))
        causal, kw = True, {}
    else:
        q, k, v, do, causal, kw = _seg_inputs(dev, case)
    o, lse = flash_fwd_cuda(q, k, v, causal, **kw)
    delta = flash_delta(o, do)
    call = lambda: (flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, **kw),
                    *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal,
                                        **kw))
    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = call()
    q.copy_(_randn(dev, *q.shape, seed=31))
    do.copy_(_randn(dev, *do.shape, seed=32))
    g.replay()
    eager = call()
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), outs, eager):
        assert torch.equal(a, b), name


def test_flash_autograd_on_strided_views_matches_plain_route(dev):
    """GPT's layout: q/k/v are views of one [b, s, 3, H, D] projection,
    read in place by the kernels; the kernel route's gradient of the fused
    projection agrees with the plain route's (FLAGS_flash_kernel=plain)."""
    b, s, h, d = 2, 300, 4, 64
    qkv = _randn(dev, b, s, 3, h, d, seed=7)
    do = _randn(dev, b, s, h, d, seed=8)
    grads = {}
    for mode in ("auto", "plain"):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            t = qkv.clone().requires_grad_()
            q, k, v = t.unbind(2)
            scaled_dot_product_attention(q, k, v, is_causal=True).backward(
                do)
            grads[mode] = t.grad
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
    torch.cuda.synchronize()
    assert _rel_err(grads["auto"], grads["plain"]) <= BWD_RTOL


@pytest.mark.parametrize("D,causal", [(80, False), (80, True),
                                      (40, False)])
def test_flash_autograd_pads_other_head_dims(dev, D, causal):
    """A head dim other than 64 or 128 (D 80 is ViT-H/14's): the kernel
    route pads it to the next of them and slices back; its output and
    gradients agree with the plain route's (FLAGS_flash_kernel=plain)."""
    b, s, hq, hk = 2, 197, 16, 16 if not causal else 4
    shapes = ((b, s, hq, D), (b, s, hk, D), (b, s, hk, D))
    do = _randn(dev, b, s, hq, D, seed=14)
    outs, grads = {}, {}
    for mode in ("auto", "plain"):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            ts = [_randn(dev, *sh, seed=11 + i).requires_grad_()
                  for i, sh in enumerate(shapes)]
            before = flash_fwd_cuda.launches
            out = scaled_dot_product_attention(*ts, is_causal=causal)
            out.backward(do)
            assert flash_fwd_cuda.launches - before == (mode == "auto")
            outs[mode], grads[mode] = out, [t.grad for t in ts]
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
    torch.cuda.synchronize()
    assert outs["auto"].shape == (b, s, hq, D)
    assert (outs["auto"].float() - outs["plain"].float()).abs().max() \
        .item() <= ATOL
    assert _row_rel_err(outs["auto"], outs["plain"]) <= ROW_RTOL
    for name, a, r in zip(("dq", "dk", "dv"), grads["auto"],
                          grads["plain"]):
        assert a.shape == r.shape, name
        assert _rel_err(a, r) <= BWD_RTOL, name


@pytest.mark.parametrize("D,causal", [(160, True), (192, False),
                                      (256, True)])
def test_flash_autograd_runs_head_dims_up_to_256(dev, D, causal):
    """Head dims 129-256 (Gemma's 256; the JAX package pads any D to a
    multiple of 128): the kernel route pads to 256 and slices back, runs
    B1-B3 once each, and agrees with the plain route."""
    b, s, hq, hk = 1, 300, 8, 2
    shapes = ((b, s, hq, D), (b, s, hk, D), (b, s, hk, D))
    do = _randn(dev, b, s, hq, D, seed=24)
    outs, grads = {}, {}
    for mode in ("auto", "plain"):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            ts = [_randn(dev, *sh, seed=21 + i).requires_grad_()
                  for i, sh in enumerate(shapes)]
            before = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                      flash_bwd_dkv_cuda.launches)
            out = scaled_dot_product_attention(*ts, is_causal=causal)
            out.backward(do)
            after = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                     flash_bwd_dkv_cuda.launches)
            want = 1 if mode == "auto" else 0
            assert [a - b_ for a, b_ in zip(after, before)] == [want] * 3
            outs[mode], grads[mode] = out, [t.grad for t in ts]
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
    torch.cuda.synchronize()
    assert outs["auto"].shape == (b, s, hq, D)
    assert (outs["auto"].float() - outs["plain"].float()).abs().max() \
        .item() <= ATOL
    assert _row_rel_err(outs["auto"], outs["plain"]) <= ROW_RTOL
    for name, a, r in zip(("dq", "dk", "dv"), grads["auto"],
                          grads["plain"]):
        assert a.shape == r.shape, name
        assert _rel_err(a, r) <= BWD_RTOL, name


@pytest.mark.parametrize("D,causal", [(288, True), (384, False),
                                      (512, True)])
def test_flash_autograd_refuses_head_dims_above_128(dev, D, causal):
    """Above 256 (the name is the rule before the kernels took every head
    dim): the kernel route pads D to the next multiple of 128 (288 to
    384), runs B1-B3 once each on CUDA tensors, and agrees with the plain
    route within the limits D 256 uses."""
    b, s, hq, hk = 1, 300, 8, 2
    shapes = ((b, s, hq, D), (b, s, hk, D), (b, s, hk, D))
    do = _randn(dev, b, s, hq, D, seed=34)
    outs, grads = {}, {}
    for mode in ("auto", "plain"):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            ts = [_randn(dev, *sh, seed=31 + i).requires_grad_()
                  for i, sh in enumerate(shapes)]
            before = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                      flash_bwd_dkv_cuda.launches)
            out = scaled_dot_product_attention(*ts, is_causal=causal)
            out.backward(do)
            after = (flash_fwd_cuda.launches, flash_bwd_dq_cuda.launches,
                     flash_bwd_dkv_cuda.launches)
            want = 1 if mode == "auto" else 0
            assert [a - b_ for a, b_ in zip(after, before)] == [want] * 3
            outs[mode], grads[mode] = out, [t.grad for t in ts]
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
    torch.cuda.synchronize()
    assert outs["auto"].shape == (b, s, hq, D)
    assert (outs["auto"].float() - outs["plain"].float()).abs().max() \
        .item() <= ATOL
    assert _row_rel_err(outs["auto"], outs["plain"]) <= ROW_RTOL
    for name, a, r in zip(("dq", "dk", "dv"), grads["auto"],
                          grads["plain"]):
        assert a.shape == r.shape, name
        assert _rel_err(a, r) <= BWD_RTOL, name


def _packed_seg(dev, cu_q, cu_k):
    """Segment ids and positions of packed sequences, [1, T] each."""
    cu = lambda c: torch.tensor(c, device=dev, dtype=torch.int32)
    return tuple(t[None] for t in varlen_segments(
        cu(cu_q), cu(cu_k), cu_q[-1], cu_k[-1], dev))


def _dense_seg(dev, B, S, orphan, run=24, ids=3, orphans=10):
    """Non-monotone ids (pos // run) % ids on both sides; with ``orphan``,
    query rows S//2 .. S//2 + orphans - 1 carry an id no key has."""
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    kseg = ((pos // run) % ids).expand(B, S).contiguous()
    qseg = kseg.clone()
    if orphan:
        qseg[:, S // 2:S // 2 + orphans] = 7
    p = pos.expand(B, S).contiguous()
    return qseg, kseg, p, p.clone()


# name: (B, Hq, Hk, D, causal, segments); "cu" cases are packed rows
_SEG_CASES = {
    # T 333, not a multiple of 64; 1-token sequences; boundaries in tiles
    "ragged-g4-d128": (1, 32, 8, 128, True, ("cu", [0, 1, 70, 71, 200, 333],
                                             None)),
    "ones-g1-d64": (1, 4, 4, 64, True, ("cu", [0, 1, 2, 3, 67, 131], None)),
    "g8-d128-full": (1, 16, 2, 128, False, ("cu", [0, 100, 130, 250], None)),
    # each sequence's last queries only: the bottom-right shift
    "cross-g4-d64": (1, 16, 4, 64, True, ("cu", [0, 10, 40, 41, 105],
                                          [0, 70, 100, 150, 214])),
    # sequence 1 has 30 queries and no key: rows with nothing to see
    "nokeys-g2-d64": (1, 8, 4, 64, True, ("cu", [0, 30, 60, 90],
                                          [0, 40, 40, 120])),
    "nonmono-g4-d128": (2, 16, 4, 128, True, ("dense", 200, True)),
    "nonmono-g1-d64": (2, 4, 4, 64, False, ("dense", 150, False)),
    # long sequences: pairs skipped by position inside a segment, full
    # (single-id, below the diagonal) and masked pairs
    "long-g4-d128": (1, 32, 8, 128, True, ("cu", [0, 300, 700, 701, 1100],
                                           None)),
    "long-g1-d64": (1, 4, 4, 64, False, ("cu", [0, 256, 257, 650], None)),
    "long-g8-d64": (1, 16, 2, 64, True, ("cu", [0, 3, 515, 900], None)),
    # runs of 128 tokens, ids (pos // 128) % 2, 40 orphan queries
    "runs-g2-d64": (2, 8, 4, 64, True, ("runs", 600, True)),
    "runs-g4-d128": (1, 16, 4, 128, False, ("runs", 450, False)),
    # D 256: the mma.sync kernels' segment branch
    "ragged-g4-d256": (1, 16, 4, 256, True, ("cu", [0, 1, 70, 71, 200, 333],
                                            None)),
    "cross-g4-d256": (1, 8, 2, 256, True, ("cu", [0, 10, 40, 41, 105],
                                           [0, 70, 100, 150, 214])),
    "nokeys-g2-d256": (1, 8, 4, 256, True, ("cu", [0, 30, 60, 90],
                                            [0, 40, 40, 120])),
    "runs-g2-d256": (2, 8, 4, 256, False, ("runs", 600, True)),
    # above 256: the streamed kernels' segment branch
    "ragged-g4-d512": (1, 16, 4, 512, True, ("cu", [0, 1, 70, 71, 200, 333],
                                            None)),
    "runs-g2-d384": (2, 8, 4, 384, False, ("runs", 600, True)),
}


def _seg_inputs(dev, name):
    B, Hq, Hk, D, causal, (kind, a, c) = _SEG_CASES[name]
    if kind == "cu":
        seg = _packed_seg(dev, a, c or a)
    elif kind == "runs":
        seg = _dense_seg(dev, B, a, c, run=128, ids=2, orphans=40)
    else:
        seg = _dense_seg(dev, B, a, c)
    Sq, Sk = seg[0].shape[1], seg[1].shape[1]
    q = _randn(dev, B, Sq, Hq, D, seed=11)
    k = _randn(dev, B, Sk, Hk, D, seed=12)
    v = _randn(dev, B, Sk, Hk, D, seed=13)
    do = _randn(dev, B, Sq, Hq, D, seed=14)
    kw = dict(zip(("q_segment_ids", "kv_segment_ids", "q_positions",
                   "kv_positions"), seg))
    return q, k, v, do, causal, kw


def _unseen(kw, causal):
    """Masks of query rows that see no key and keys no row sees."""
    qs, ks, qp, kp = (kw[n] for n in ("q_segment_ids", "kv_segment_ids",
                                      "q_positions", "kv_positions"))
    vis = qs[:, :, None] == ks[:, None, :]
    if causal:
        vis &= qp[:, :, None] >= kp[:, None, :]
    return ~vis.any(2), ~vis.any(1)


@pytest.mark.parametrize("name", sorted(_SEG_CASES))
def test_flash_segment_kernels_match_plain(dev, name):
    q, k, v, do, causal, kw = _seg_inputs(dev, name)
    before = (flash_fwd_cuda.seg_launches, flash_bwd_dq_cuda.seg_launches,
              flash_bwd_dkv_cuda.seg_launches, flash_fwd_cuda.launches)
    o, lse = flash_fwd_cuda(q, k, v, causal, scale=0.1, **kw)
    dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, do, causal, scale=0.1,
                                **kw)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, scale=0.1,
                                           return_lse=True, **kw)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale=0.1,
                                     **kw)
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.seg_launches, flash_bwd_dq_cuda.seg_launches,
            flash_bwd_dkv_cuda.seg_launches, flash_fwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1, before[2] + 1, before[3])
    assert bool(torch.isfinite(o.float()).all())
    assert (o.float() - o_ref.float()).abs().max().item() <= ATOL
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    assert _row_rel_err(o, o_ref) <= ROW_RTOL
    for gname, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert bool(torch.isfinite(out.float()).all()), gname
        assert _rel_err(out, ref) <= BWD_RTOL, gname
    rows, keys = _unseen(kw, causal)
    if rows.any():  # O 0, LSE +1e30, dQ 0
        r = rows[..., None, None].expand_as(o)
        assert o[r].abs().max().item() == 0.0
        assert dq[r].abs().max().item() == 0.0
        assert bool((lse.transpose(1, 2)[rows] == 1e30).all())
    if keys.any():  # dK = dV = 0
        c = keys[..., None, None].expand_as(dk)
        assert dk[c].abs().max().item() == 0.0
        assert dv[c].abs().max().item() == 0.0


@pytest.mark.parametrize("name", ["cross-g4-d64", "runs-g2-d64"])
def test_device_tile_bounds_match_tile_bounds(dev, monkeypatch, name):
    """The bounds the C entry points write on the card (B1 and B2: the kv
    side; B3: the q side, then the kv side) are ``tile_bounds``'."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    made, real = [], fa._bounds_workspace
    monkeypatch.setattr(fa, "_bounds_workspace",
                        lambda *a: made.append(real(*a)) or made[-1])
    q, k, v, do, causal, kw = _seg_inputs(dev, name)
    _bwd_calls(q, k, v, do, causal, kw)()
    torch.cuda.synchronize()
    qs, ks, qp, kp = (kw[n] for n in _SEG_NAMES)
    want = [tile_bounds(ks, kp), tile_bounds(ks, kp), tile_bounds(qs, qp),
            tile_bounds(ks, kp)]
    assert len(made) == 4
    for got, ref in zip(made, want):
        assert torch.equal(got, ref)


def test_segment_cases_reach_every_pair_class(dev):
    """The segment cases above reach skip, masked and full pairs in both
    B2's tiling (blocks of 64 / G positions) and B3's (64-row tiles)."""
    seen = {"dq": set(), "dkv": set()}
    for name in _SEG_CASES:
        _, Hq, Hk, _, causal, _ = _SEG_CASES[name]
        _, _, _, _, causal, kw = _seg_inputs(dev, name)
        qs, ks, qp, kp = (kw[n] for n in _SEG_NAMES)
        kb = tile_bounds(ks, kp)
        for kname, block in (("dq", 64 * Hk // Hq), ("dkv", 64)):
            cls = pair_classes(tile_bounds(qs, qp, block), kb, causal)
            seen[kname] |= set(cls.unique().tolist())
    assert seen == {"dq": {SKIP, MASKED, FULL}, "dkv": {SKIP, MASKED, FULL}}


def test_flash_segment_forward_replays_in_a_cuda_graph(dev):
    """The segment forward (its tile-bounds launch included) captured in
    a CUDA graph and replayed on new inputs gives the eager result."""
    q, k, v, _, causal, kw = _seg_inputs(dev, "ragged-g4-d128")
    flash_fwd_cuda(q, k, v, causal, **kw)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        o, lse = flash_fwd_cuda(q, k, v, causal, **kw)
    q.copy_(_randn(dev, *q.shape, seed=21))
    g.replay()
    o_eager, lse_eager = flash_fwd_cuda(q, k, v, causal, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o_eager) and torch.equal(lse, lse_eager)


def test_flash_segment_wrappers_reject_bad_ids(dev):
    q = _randn(dev, 1, 64, 4, 64)
    ids = torch.zeros(1, 64, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        flash_fwd_cuda(q, q, q, q_segment_ids=ids.long(), kv_segment_ids=ids,
                       q_positions=ids, kv_positions=ids)
    with pytest.raises(ValueError, match="segment branch takes all"):
        flash_fwd_cuda(q, q, q, q_segment_ids=ids)


# the segment forward's packed cases: kv sequences of 1, 70, 330, 0 and 97
# tokens, queries over all of each, 25 of them over the empty one (rows
# that see no key); Sq 523 and Sk 498 end inside a block and a tile, and
# the 330-token sequence's late blocks lie after its early tiles
_FWD_LENS_Q = [1, 70, 330, 25, 97]
_FWD_LENS_K = [1, 70, 330, 0, 97]


def _bf16_ulp(x):
    """One bf16 unit in the last place at each element of ``x``."""
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       torch.frexp(x.float().abs())[1] - 8)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128, 256, 384])
@pytest.mark.parametrize("Hq,Hk", [(8, 8), (16, 4), (16, 2)])
def test_flash_segment_forward_matches_plain(dev, Hq, Hk, D, causal):
    """B1-seg at G 1, 4 and 8, D 64, 128, 256 and 384, causal or not, on a
    packed row whose (query block, key tile) pairs reach every class at
    the forward's blocks of 64 / G positions: O and LSE against the plain
    version, O 0 and LSE +1e30 on rows that see no key, one launch a call,
    the same bits from two calls. Both O's are rounded to bf16, so an
    element may differ by ATOL or by one bf16 ulp of the reference where
    that is larger (|O| >= 4, which D 256's sharper logits reach)."""
    cu = lambda ls: np.concatenate([[0], np.cumsum(ls)]).tolist()
    seg = _packed_seg(dev, cu(_FWD_LENS_Q), cu(_FWD_LENS_K))
    kw = dict(zip(_SEG_NAMES, seg))
    cls = pair_classes(tile_bounds(seg[0], seg[2], 64 * Hk // Hq),
                       tile_bounds(seg[1], seg[3]), causal)
    assert set(cls.unique().tolist()) == {SKIP, MASKED, FULL}
    Sq, Sk = seg[0].shape[1], seg[1].shape[1]
    q = _randn(dev, 1, Sq, Hq, D, seed=51)
    k = _randn(dev, 1, Sk, Hk, D, seed=52)
    v = _randn(dev, 1, Sk, Hk, D, seed=53)
    before = (flash_fwd_cuda.seg_launches, flash_fwd_cuda.launches)
    o, lse = flash_fwd_cuda(q, k, v, causal, scale=0.1, **kw)
    o2, lse2 = flash_fwd_cuda(q, k, v, causal, scale=0.1, **kw)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, scale=0.1,
                                           return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.seg_launches, flash_fwd_cuda.launches) == \
        (before[0] + 2, before[1])
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert bool(torch.isfinite(o.float()).all())
    limit = torch.clamp(_bf16_ulp(o_ref), min=ATOL)
    assert bool(((o.float() - o_ref.float()).abs() <= limit).all())
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    assert _row_rel_err(o, o_ref) <= ROW_RTOL
    rows, _ = _unseen(kw, causal)
    assert bool(rows.any())
    r = rows[..., None, None].expand_as(o)
    assert o[r].abs().max().item() == 0.0
    assert bool((lse.transpose(1, 2)[rows] == 1e30).all())


# digests of the dense B1-B3 outputs (``tools/torch_flash_digest.py``,
# NVIDIA H100 80GB HBM3): B1's, and B2's and B3's at G 1, are those of the
# first kernels recorded, which the wgmma backward reproduces bit for bit;
# B3's at G 4 (B1_S200_Hq32_Hk8_D128) is the wgmma backward's, whose
# cluster of 2 CTAs sums the group's heads in another order
_DENSE_DIGESTS = {
    "B2_S300_Hq16_Hk16_D64": dict(
        flash_fwd="40838b7b7627c8b74d6b1118a8ca1544"
                  "ce10b930def3ee9da1a84445a976af54",
        flash_bwd_dq="39ae3c3fe76dfa272aeb9ca5606572f8"
                     "c21827bd73c24a2c677b940d3e790428",
        flash_bwd_dkv="766c9c1c33f4700d36ecaa65da1030cf"
                      "4a3ddd35ec000b0171dcce769384df12"),
    "B1_S200_Hq32_Hk8_D128": dict(
        flash_fwd="c01a0bf9752c84876b37b714d6ba8ef4"
                  "8535bb82dd31192fb731e9697fef9628",
        flash_bwd_dq="0ab54553205a9947bb0bde94ea7f5b5a"
                     "4739a9ce0c8771a8c2837ff7cae7553c",
        flash_bwd_dkv="74f4cd5d160ee099d4354f51176052c3"
                      "04cc0c0cb7ecde1de506bf587865acf0"),
}


def test_dense_flash_outputs_are_bit_identical_to_the_recorded_ones(dev):
    """B1-B3 give, bit for bit, the dense outputs recorded above."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "tools" / \
        "torch_flash_digest.py"
    spec = importlib.util.spec_from_file_location("torch_flash_digest",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from paddle_tpu_torch.kernels import flash_attention as fa
    assert tool.digests(fa) == _DENSE_DIGESTS


# digests of the segment kernels' outputs (``tools/torch_flash_digest.py``
# ``seg_digests``, NVIDIA H100 80GB HBM3): B1-seg's O and LSE, B2-seg's dQ
# and B3-seg's dK, dV, as the tree before the float32 and fp16 forward
# kernels gave them
_SEG_DIGESTS = dict(
    flash_fwd="c386e4ecc72cd8ca9d97a2a8cc4daf93"
              "28f9bb91aa1ff096382f19994676a0f5",
    flash_bwd_dq="686a92443e5906adf4c5d09391dd99f1"
                 "e68280c0934f44325dad5f59b9abd650",
    flash_bwd_dkv="851fbac636028bbfa1a3f7577336e1b1"
                  "4a76ed7adc1f584f7c37cc1a157037ac")


def test_segment_flash_outputs_are_bit_identical_to_the_recorded_ones(dev):
    """The bf16 segment kernels give, bit for bit, the outputs recorded
    above."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "tools" / \
        "torch_flash_digest.py"
    spec = importlib.util.spec_from_file_location("torch_flash_digest",
                                                  path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    from paddle_tpu_torch.kernels import flash_attention as fa
    assert tool.seg_digests(fa) == _SEG_DIGESTS


# -- fp8 training's product (amp.fp8): torch._scaled_mm, not a kernel of
# this repository, held against its plain version the same way. The two
# multiply the same fp8 operands and differ only in accumulation order:
# max |card - plain| / max |plain| <= 1e-3.
FP8_RTOL = 1e-3


def _fp8_operands(dev, m, n, k, seed=0):
    from paddle_tpu_torch.amp import fp8
    x = _randn(dev, m, k, seed=seed)
    w = _randn(dev, n, k, seed=seed + 1) * 0.02
    g = _randn(dev, m, n, seed=seed + 2)
    sx = fp8._amax(x) / fp8.E4M3_MAX
    sw = fp8._amax(w) / fp8.E4M3_MAX
    sg = fp8._grad_scale(g.float())
    return (fp8._quantize(x, sx, fp8.E4M3_MAX, torch.float8_e4m3fn),
            fp8._quantize(w, sw, fp8.E4M3_MAX, torch.float8_e4m3fn),
            fp8._quantize(g.float(), sg, fp8.E5M2_MAX, torch.float8_e5m2),
            sx, sw, sg)


@pytest.mark.parametrize("n,k", [(3072, 1024), (1024, 4096)])
def test_fp8_products_match_plain(dev, n, k):
    """The forward, dx and dW products of GPT-2 medium's linears (M 8192
    tokens) through ``fp8_gemm``'s card route, one launch each."""
    from paddle_tpu_torch.amp import fp8
    xq, wq, gq, sx, sw, sg = _fp8_operands(dev, 8192, n, k)
    products = {
        "fwd": (xq, wq.t(), sx, sw),
        "dx": (gq, fp8._transposed(wq).t(), sg, sw),
        "dw": (fp8._transposed(gq), fp8._transposed(xq).t(), sg, sx)}
    for name, args in products.items():
        before = fp8.fp8_gemm.launches
        out = fp8.fp8_gemm(*args)
        assert fp8.fp8_gemm.launches == before + 1
        ref = fp8.fp8_gemm_plain(*args)
        assert out.dtype == torch.float32 and out.shape == ref.shape
        err = ((out - ref).abs().max() / ref.abs().max()).item()
        assert err <= FP8_RTOL, (name, err)


def test_fp8_linear_on_the_card_launches_three_products(dev):
    """A bf16 FP8Linear forward + backward on the card: three products,
    bf16 grads, the output as the plain product of the same operands
    gives it; a shape ``_scaled_mm`` refuses raises (no fallback)."""
    from paddle_tpu_torch.amp import fp8
    lin = fp8.FP8Linear(1024, 3072, bias=True, device=dev,
                        dtype=torch.bfloat16, requires_grad=True)
    x = _randn(dev, 4, 256, 1024).requires_grad_()
    before = fp8.fp8_gemm.launches
    y = lin(x)
    y.float().square().mean().backward()
    assert fp8.fp8_gemm.launches == before + 3
    assert x.grad.dtype == lin.weight.grad.dtype == torch.bfloat16
    sx, sw = lin.fp8_scale_x, lin.fp8_scale_w
    ref = fp8.fp8_gemm_plain(
        fp8._quantize(x.detach().reshape(-1, 1024), sx, fp8.E4M3_MAX,
                      torch.float8_e4m3fn),
        fp8._quantize(lin.weight.detach(), sw, fp8.E4M3_MAX,
                      torch.float8_e4m3fn).t(), sx, sw)
    ref = ref.to(torch.bfloat16).reshape(4, 256, 3072) + lin.bias.detach()
    err = ((y.detach().float() - ref.float()).abs().max()
           / ref.float().abs().max()).item()
    assert err <= 1e-2  # one bf16 rounding of y apart
    bad = fp8.FP8Linear(24, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError):
        bad(_randn(dev, 8, 24))


# -- the routes above the kernel wrappers: shapes and dtypes the
# tensor-core kernels do not take go to a route decided before any launch,
# and counted: the CUDA cores' kernels (``simt``) or, for bf16 flash at a
# group not dividing 64, B1-B3 on expanded K and V
def _flash_route_counts():
    from paddle_tpu_torch.kernels.flash_attention import (BWD_ROUTE_COUNTS,
                                                          ROUTE_COUNTS)
    return dict(ROUTE_COUNTS), dict(BWD_ROUTE_COUNTS)


# the flash wrappers' counts: B1-B3 (bf16), the CUDA cores' three, the
# three-piece B2/B3 and the split pass (float32), B2/B3 in fp16, the
# three-piece B1 (float32; up to head dim 256) and B1 in fp16 up to 128,
# then above those: the three-piece B1 on the xl layout, fp16 B1 at 256 and
# above
def _flash_launches():
    from paddle_tpu_torch.kernels import flash_attention as fa
    return [f.launches + f.seg_launches for f in (
        fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda, fa.flash_bwd_dkv_cuda,
        fa.flash_simt_fwd_cuda, fa.flash_simt_dq_cuda,
        fa.flash_simt_dkv_cuda, fa.flash_bwd_dq_x3_cuda,
        fa.flash_bwd_dkv_x3_cuda)] + [
        fa.split_bf16x3_cuda.launches, fa.flash_bwd_dq_cuda.f16_launches,
        fa.flash_bwd_dkv_cuda.f16_launches,
        fa.flash_fwd_x3_cuda.launches + fa.flash_fwd_x3_cuda.seg_launches,
        fa.flash_fwd_cuda.f16_launches, fa.flash_fwd_x3_cuda.xl_launches,
        fa.flash_fwd_cuda.f16_256_launches, fa.flash_fwd_cuda.f16_xl_launches]


# launches of one forward + backward by the (forward, backward) routes, in
# _flash_launches' order: ``split`` splits q, k, v for the forward and q,
# k, v, dO again for the backward; above head dim 128 the forward stays on
# the tensor cores (float32 padded to 256: three splits and the three-piece
# B1; fp16 padded to 256: B1 at 256) and the backward takes the CUDA cores'
# pair
_ROUTE_LAUNCHES = {
    ("expanded", "expanded"): [1, 1, 1] + [0] * 13,
    ("split", "simt"): [0, 0, 0, 0, 1, 1, 0, 0, 3, 0, 0, 1] + [0] * 4,
    ("f16", "simt"): [0, 0, 0, 0, 1, 1] + [0] * 8 + [1, 0],
    ("split", "split"): [0, 0, 0, 0, 0, 0, 1, 1, 7, 0, 0, 1] + [0] * 4,
    ("f16", "f16"): [0] * 9 + [1, 1, 0, 1] + [0] * 3}


# the CUDA cores' kernels against the plain versions, both in float32 (the
# same products, summed in another order) or both rounding to fp16 at the
# same points (the kernels round the unnormalized P, the plain pair the
# normalized one): max |kernel - plain| / max |plain|, per row for O. The
# tensor-core B2/B3 in float32 (three bf16 pieces, six terms a product:
# ~2^-24 of each product dropped) and fp16 are held to the same limits.
SIMT_RTOL = {torch.float32: 1e-4, torch.float16: 5e-3,
             torch.bfloat16: DECODE_RTOL}
SIMT_BWD_RTOL = {torch.float32: 2e-4, torch.float16: 1e-2}


@pytest.mark.parametrize("dtype,Hq,Hk,D,causal,bwd", [
    (torch.float32, 32, 8, 64, True, "split"),
    (torch.float16, 32, 8, 64, True, "f16"),
    (torch.float32, 8, 8, 64, False, "split"),
    (torch.float32, 24, 8, 64, True, "split"),    # G 3 at float32
    (torch.float16, 24, 8, 80, False, "f16"),     # G 3, D 80 padded
    (torch.float32, 8, 2, 160, True, "simt"),     # above head dim 128
    (torch.float16, 8, 2, 160, False, "simt"),
    (torch.bfloat16, 24, 8, 64, True, "expanded"),    # G 3
    (torch.bfloat16, 24, 8, 64, False, "expanded"),
    (torch.bfloat16, 96, 8, 64, True, "expanded"),    # G 12
    (torch.bfloat16, 96, 8, 64, False, "expanded"),
    (torch.float32, 32, 4, 128, True, "split"),   # G 8, D 128
    (torch.float16, 16, 16, 128, True, "f16"),    # G 1
    (torch.float32, 96, 8, 48, False, "split"),   # G 12, D 48 padded
])
def test_flash_attention_routes_what_the_kernels_refuse(dev, dtype, Hq, Hk,
                                                        D, causal, bwd):
    """``FlashAttention`` in float32 and fp16 (forward on the tensor cores
    at every head dim, the backward up to head dim 128: float32 as three
    bf16 pieces, the forward after three split passes and the backward
    after four, fp16 on f16 wgmma; above 128 the backward on
    ``flash_simt.cu``) and at bf16 GQA groups 3 and 12 (B1-B3 once each on
    K and V expanded 3 times along the head axis, dK and dV summed over
    the copies), forward and backward: one count of the forward's route
    and one of the backward's, exactly the launches they imply, and the
    result against the plain pair on the same inputs."""
    b, s = 2, 300
    g = torch.Generator(device=dev).manual_seed(Hq + causal + D)
    mk = lambda h: torch.randn(b, s, h, D, generator=g, device=dev,
                               dtype=dtype)
    q, k, v, do = mk(Hq), mk(Hk), mk(Hk), mk(Hq)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd = bwd if bwd != "simt" else \
        "split" if dtype == torch.float32 else "f16"
    counts = _flash_route_counts()
    before = _flash_launches()
    out = scaled_dot_product_attention(*ts, is_causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    after = _flash_route_counts()
    for c0, c1, want in zip(counts, after, (fwd, bwd)):
        assert {n: c1[n] - c0[n] for n in c1} == \
            {n: int(n == want) for n in c1}
    assert [x - y for x, y in zip(_flash_launches(), before)] == \
        _ROUTE_LAUNCHES[fwd, bwd]
    o_ref, lse = flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True)
    refs = flash_attention_bwd_plain(q, k, v, o_ref, lse, do, causal=causal)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out.float()).all())
    if bwd != "expanded":
        assert _row_rel_err(out, o_ref) <= SIMT_RTOL[dtype]
        for name, t, ref in zip(("dq", "dk", "dv"), ts, refs):
            assert t.grad.dtype == dtype and t.grad.shape == ref.shape, name
            assert _rel_err(t.grad, ref) <= SIMT_BWD_RTOL[dtype], name
        return
    assert (out.float() - o_ref.float()).abs().max().item() <= ATOL
    assert _row_rel_err(out, o_ref) <= ROW_RTOL
    for name, t, ref in zip(("dq", "dk", "dv"), ts, refs):
        assert t.grad.dtype == dtype and t.grad.shape == ref.shape, name
        assert _rel_err(t.grad, ref) <= BWD_RTOL, name


# the tensor-core B2/B3 in float32 and fp16: (B, Sq, Sk, Hq, Hk, D, causal,
# segments)
_TC_CASES = [
    (2, 197, 197, 8, 2, 64, True, False),      # G 4, ragged last tiles
    (1, 300, 300, 24, 8, 80, True, False),     # G 3 (K, V expanded), D 80
    (1, 130, 260, 4, 4, 128, True, False),     # Sk > Sq, G 1
    (1, 260, 130, 4, 2, 128, True, False),     # Sq > Sk: rows see nothing
    (2, 200, 200, 8, 2, 128, False, False),
    (1, 1000, 1000, 32, 8, 128, True, False),  # Llama's heads, cluster 2
    (1, 256, 256, 8, 8, 64, True, True),
    (2, 300, 300, 8, 2, 128, False, True),
    (1, 300, 300, 24, 8, 80, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,seg", _TC_CASES)
def test_flash_bwd_float32_and_fp16_match_plain(dev, dtype, B, Sq, Sk, Hq,
                                                Hk, D, causal, seg):
    """``flash_attention`` forward + backward in float32 (B2/B3 on three
    bf16 pieces) and fp16 (B2/B3 on f16 wgmma), the head dim zero-padded
    to 64 or 128 and K, V expanded at G 3: dQ, dK, dV against the plain
    pair within SIMT_BWD_RTOL, exact zeros where a row sees no key."""
    from paddle_tpu_torch.kernels.flash_attention import (BWD_ROUTE_COUNTS,
                                                          flash_attention)
    g = torch.Generator(device=dev).manual_seed(D + Sq + Hq)
    mk = lambda n, h: torch.randn(B, n, h, D, generator=g, device=dev,
                                  dtype=dtype)
    q, k, v, do = mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, Hq)
    kw = dict(zip(_SEG_NAMES, _dense_seg(dev, B, Sq, True, run=40))) \
        if seg else {}
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    route = "split" if dtype == torch.float32 else "f16"
    before = BWD_ROUTE_COUNTS[route]
    flash_attention(*ts, causal=causal, **kw).backward(do)
    torch.cuda.synchronize()
    assert BWD_ROUTE_COUNTS[route] == before + 1
    o_ref, lse = flash_attention_plain(q, k, v, causal=causal,
                                       return_lse=True, **kw)
    refs = flash_attention_bwd_plain(q, k, v, o_ref, lse, do, causal, **kw)
    for name, t, ref in zip(("dq", "dk", "dv"), ts, refs):
        assert t.grad.dtype == dtype and t.grad.shape == ref.shape, name
        assert bool(torch.isfinite(t.grad.float()).all()), name
        assert _rel_err(t.grad, ref) <= SIMT_BWD_RTOL[dtype], name
    if Sq > Sk and causal:  # the first Sq - Sk rows see no key
        assert ts[0].grad[:, :Sq - Sk].abs().max().item() == 0.0


# B1 on the tensor cores in float32 and fp16: _TC_CASES and two at G 8
_FWD_TC_CASES = _TC_CASES + [
    (1, 300, 300, 32, 4, 128, True, False),
    (2, 150, 90, 16, 2, 64, False, False),
]


def _fwd_tc_check(dtype, q, k, v, causal, kw, o, lse):
    """O per row within SIMT_RTOL of the plain forward, LSE within 1e-3
    of it, +1e30 and O = 0 exactly where a row sees no key."""
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True, **kw)
    assert o.dtype == dtype and o.shape == q.shape
    assert bool(torch.isfinite(o.float()).all())
    assert _row_rel_err(o, o_ref) <= SIMT_RTOL[dtype]
    unseen = lse_ref >= 1e29
    assert torch.equal(lse >= 1e29, unseen)
    assert (lse - lse_ref)[~unseen].abs().max().item() <= 1e-3
    if bool(unseen.any()):
        assert o.float().permute(0, 2, 1, 3)[unseen].abs().max().item() == 0


def _fwd_tc_call(dtype, q, k, v, causal, kw):
    """``flash_attention`` forward alone (no gradient): one count of its
    route (``split`` or ``f16``) and the launches that route implies at
    q's head dim: float32's three split passes and one three-piece B1
    (``flash_fwd_tc_kernel`` up to 256, the xl kernel above), fp16's one
    B1 (up to 128, at 256 after padding, or above); returns (O, LSE)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        ROUTE_COUNTS, flash_attention, padded_head_dim)
    route = "split" if dtype == torch.float32 else "f16"
    dp = padded_head_dim(q.shape[-1])
    counts = dict(ROUTE_COUNTS)
    before = _flash_launches()
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert {n: ROUTE_COUNTS[n] - c for n, c in counts.items()} == \
        {n: int(n == route) for n in counts}
    want = [0] * 16
    if route == "split":
        want[8] = 3
        want[11 if dp <= 256 else 13] = 1
    else:
        want[12 if dp <= 128 else 14 if dp == 256 else 15] = 1
    assert [x - y for x, y in zip(_flash_launches(), before)] == want
    return o, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal,seg", _FWD_TC_CASES)
def test_flash_fwd_float32_and_fp16_match_plain(dev, dtype, B, Sq, Sk, Hq,
                                                Hk, D, causal, seg):
    """B1 on the tensor cores (``flash_fwd_tc_kernel``): float32 as three
    bf16 pieces (six terms a product, P split in registers), fp16 on f16
    wgmma, the head dim zero-padded to 64 or 128 and K, V expanded at G 3,
    dense and segment branch: O and LSE against the plain forward."""
    g = torch.Generator(device=dev).manual_seed(D + Sq + Hq + 1)
    mk = lambda n, h: torch.randn(B, n, h, D, generator=g, device=dev,
                                  dtype=dtype)
    q, k, v = mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk)
    kw = dict(zip(_SEG_NAMES, _dense_seg(dev, B, Sq, True, run=40))) \
        if seg else {}
    o, lse = _fwd_tc_call(dtype, q, k, v, causal, kw)
    _fwd_tc_check(dtype, q, k, v, causal, kw, o, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("name", ["ragged-g4-d128", "cross-g4-d64",
                                  "nokeys-g2-d64", "long-g8-d64",
                                  "runs-g2-d64", "nonmono-g4-d128"])
def test_flash_fwd_float32_and_fp16_segment_cases(dev, dtype, name):
    """The segment branch (kSeg) of B1 in float32 and fp16 on the packed
    and non-monotone cases of the bf16 kernels: ragged rows, 1-token
    sequences, queries with no key, long sequences (skipped, full and
    masked pairs)."""
    q, k, v, _, causal, kw = _seg_inputs(dev, name)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    o, lse = _fwd_tc_call(dtype, q, k, v, causal, kw)
    _fwd_tc_check(dtype, q, k, v, causal, kw, o, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_float32_and_fp16_read_strided_views(dev, dtype, D):
    """q, k and v as views of a fused [B, S, 3, H, D] projection (GPT's):
    the fp16 kernel and the float32 split pass read them through their
    strides, and the wrappers give what contiguous copies give, bit for
    bit."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_split_fwd_cuda)
    g = torch.Generator(device=dev).manual_seed(D + 3)
    qkv = torch.randn(2, 333, 3, 8, D, generator=g, device=dev, dtype=dtype)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    if dtype == torch.float16:
        call = lambda *t: flash_fwd_cuda(*t, True)
    else:
        call = lambda *t: flash_split_fwd_cuda(*t, True)
    o, lse = call(q, k, v)
    oc, lsec = call(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(o, oc) and torch.equal(lse, lsec)
    _fwd_tc_check(dtype, q, k, v, True, {}, o, lse)


def test_flash_fwd_float32_and_fp16_wrappers_refuse(dev):
    """fp16 B1 only at the kernel head dims (64, 128, 256, multiples of
    128 above) and one dtype for q, k, v; the three-piece B1 takes
    contiguous [3, B, S, H, D] bf16 pieces at D 64, 128, 256 or a multiple
    of 128 above."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_fwd_x3_cuda, split_bf16x3_cuda)
    h = torch.zeros(1, 64, 2, 192, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd_cuda(h, h, h, causal=True)
    h = h[..., :64].contiguous()
    with pytest.raises(ValueError, match="dtype"):
        flash_fwd_cuda(h, h.bfloat16(), h, causal=True)
    p = split_bf16x3_cuda(torch.zeros(1, 64, 2, 64, device=dev))
    with pytest.raises(ValueError, match="pieces"):
        flash_fwd_x3_cuda(p[:2], p, p, causal=True)
    with pytest.raises(ValueError, match="pieces"):
        flash_fwd_x3_cuda(p.transpose(3, 4), p, p, causal=True)
    wide = split_bf16x3_cuda(torch.zeros(1, 64, 2, 192, device=dev))
    with pytest.raises(ValueError, match="pieces"):
        flash_fwd_x3_cuda(wide, wide, wide, causal=True)


@pytest.mark.parametrize("D,dp", [(80, 128), (128, 128), (64, 64)])
def test_split_pass_matches_its_plain_version(dev, D, dp):
    """``split_bf16x3_cuda`` on a strided view (q of a fused [B, S, 3, H,
    D] projection) gives ``split_bf16x3_plain``'s bits, the head dim
    zero-padded; a non-unit innermost stride is refused."""
    from paddle_tpu_torch.kernels.flash_attention import (
        split_bf16x3_cuda, split_bf16x3_plain)
    g = torch.Generator(device=dev).manual_seed(D)
    qkv = torch.randn(2, 77, 3, 5, D, generator=g, device=dev) * 3.0
    x = qkv[:, :, 0]
    assert not x.is_contiguous()
    out = split_bf16x3_cuda(x, dp)
    assert out.shape == (3, 2, 77, 5, dp) and out.is_contiguous()
    assert torch.equal(out, split_bf16x3_plain(x, dp))
    rebuilt = out.double().sum(0)[..., :D]
    assert torch.equal(rebuilt, x.double())
    with pytest.raises(ValueError, match="innermost"):
        split_bf16x3_cuda(x.transpose(-1, -2).contiguous().transpose(-1, -2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_flash_bwd_float32_and_fp16_replay_in_a_cuda_graph(dev, dtype):
    """The float32 backward (four splits, B2 and B3 on the pieces) and
    the fp16 pair captured in a CUDA graph and replayed on new q and dO
    give the eager result; two eager calls give the same bits (no
    atomics; the 2-CTA cluster sums in a fixed order)."""
    from paddle_tpu_torch.kernels.flash_attention import flash_split_bwd_cuda
    B, S, Hq, Hk, D = 1, 1000, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(5)
    mk = lambda h: torch.randn(B, S, h, D, generator=g, device=dev,
                               dtype=dtype)
    q, k, v, do = mk(Hq), mk(Hk), mk(Hk), mk(Hq)
    o, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    if dtype == torch.float32:
        call = lambda: flash_split_bwd_cuda(q, k, v, o, lse, do, True)
    else:
        delta = flash_delta(o, do)
        call = lambda: (flash_bwd_dq_cuda(q, k, v, do, lse, delta, True),
                        *flash_bwd_dkv_cuda(q, k, v, do, lse, delta, True))
    first = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = call()
    q.copy_(torch.randn(q.shape, generator=g, device=dev, dtype=dtype))
    do.copy_(torch.randn(do.shape, generator=g, device=dev, dtype=dtype))
    graph.replay()
    eager = call()
    again = call()
    torch.cuda.synchronize()
    for name, a, b, c, d in zip(("dq", "dk", "dv"), outs, eager, again,
                                first):
        assert torch.equal(a, b), name
        assert torch.equal(b, c), name
        assert not torch.equal(b, d), name


def test_flash_bwd_float32_and_fp16_wrappers_refuse(dev):
    """fp16 only at D 64 and 128, one dtype for all four operands; the
    three-piece wrappers take contiguous [3, B, S, H, D] bf16 pieces."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_bwd_dq_x3_cuda, split_bf16x3_cuda)
    s = torch.zeros(1, 2, 64, device=dev)
    h = torch.zeros(1, 64, 2, 256, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="head_dim"):
        flash_bwd_dq_cuda(h, h, h, h, s, s, causal=True)
    h = h[..., :64]
    with pytest.raises(ValueError, match="dtype"):
        flash_bwd_dq_cuda(h, h.bfloat16(), h, h, s, s, causal=True)
    p = split_bf16x3_cuda(torch.zeros(1, 64, 2, 64, device=dev))
    with pytest.raises(ValueError, match="pieces"):
        flash_bwd_dq_x3_cuda(p[:2], p, p, p, s, s, causal=True)
    with pytest.raises(ValueError, match="pieces"):
        flash_bwd_dq_x3_cuda(p.transpose(3, 4), p, p, p, s, s, causal=True)


_SIMT_SHAPES = [
    (2, 197, 197, 8, 2, 64),     # ragged last tiles, G 4
    (1, 300, 300, 24, 8, 80),    # G 3, a head dim that is no chunk multiple
    (1, 130, 260, 4, 4, 128),    # Sk > Sq: bottom-right causal
    (1, 260, 130, 4, 2, 128),    # Sq > Sk: the first rows see no key
    (1, 64, 64, 2, 1, 256),
    (1, 100, 100, 2, 2, 320),    # two forward slices, three dK/dV slices
]


# the segment branch on the shapes whose queries and keys share positions
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,seg", [
    shape + (seg,) for shape in _SIMT_SHAPES for seg in (False, True)
    if not seg or shape[1] == shape[2]])
def test_flash_simt_matches_plain(dev, B, Sq, Sk, Hq, Hk, D, seg, dtype,
                                  causal):
    """``flash_simt.cu`` (forward, dQ, dK/dV) against the plain pair at the
    true head dim and group, dense and segment branch: O, LSE (+1e30 and
    O = 0 where a row sees nothing) and the three gradients."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_simt_bwd_cuda, flash_simt_fwd_cuda)
    g = torch.Generator(device=dev).manual_seed(D + Sq + Hq)
    mk = lambda s, h: torch.randn(B, s, h, D, generator=g, device=dev,
                                  dtype=dtype)
    q, k, v, do = mk(Sq, Hq), mk(Sk, Hk), mk(Sk, Hk), mk(Sq, Hq)
    kw = dict(zip(_SEG_NAMES, _dense_seg(dev, B, Sq, True, run=40))) \
        if seg else {}
    o, lse = flash_simt_fwd_cuda(q, k, v, causal, **kw)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and bool(torch.isfinite(o.float()).all())
    assert _row_rel_err(o, o_ref) <= SIMT_RTOL[dtype]
    unseen = lse_ref >= 1e29
    assert torch.equal(lse >= 1e29, unseen)
    assert (lse - lse_ref)[~unseen].abs().max().item() <= 1e-3
    if bool(unseen.any()):
        assert o.float().permute(0, 2, 1, 3)[unseen].abs().max().item() == 0
    dq, dk, dv = flash_simt_bwd_cuda(q, k, v, o_ref, lse_ref, do, causal,
                                     **kw)
    refs = flash_attention_bwd_plain(q, k, v, o_ref, lse_ref, do, causal,
                                     **kw)
    for name, t, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert t.dtype == dtype and t.shape == ref.shape, name
        assert _rel_err(t, ref) <= SIMT_BWD_RTOL[dtype], name


def test_flash_simt_rejects_what_it_does_not_take(dev):
    """bf16 belongs to the tensor-core kernels, mixed dtypes and a
    non-unit innermost stride to no kernel: the wrapper raises."""
    from paddle_tpu_torch.kernels.flash_attention import flash_simt_fwd_cuda
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="float32 or float16"):
        flash_simt_fwd_cuda(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="float32 or float16"):
        flash_simt_fwd_cuda(q, q.half(), q)
    with pytest.raises(ValueError, match="innermost"):
        flash_simt_fwd_cuda(q.transpose(-1, -2), q, q)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("Hq,Hk,D,dtype,mbps", [
    (16, 8, 256, torch.bfloat16, 8),      # D 256, G 2 (Gemma-2's widths)
    (16, 8, 256, torch.bfloat16, 32),
    (32, 8, 80, torch.bfloat16, 8),       # D 80
    (64, 4, 128, torch.bfloat16, 32),     # G 16
    (32, 8, 128, torch.float32, 8),       # a float32 model
    (32, 8, 128, torch.float32, 32),
    (32, 8, 128, torch.float16, 8),
    (24, 8, 64, torch.float32, 8),        # G 3
])
def test_paged_decode_routes_what_the_kernels_refuse(dev, quantized, Hq, Hk,
                                                     D, dtype, mbps):
    """``paged_decode_attention`` at shapes and dtypes B4-B6q do not take
    goes to ``paged_decode_simt.cuh`` (``simt`` in ``ROUTE_COUNTS``, one
    launch of it and none of B4-B6q), bf16 or int8 pools, against the
    dense version on the same inputs."""
    from paddle_tpu_torch.inference.paged import (ROUTE_COUNTS,
                                                  paged_decode_attention)
    lens = [0, 1, 17, 16 * mbps - 3]
    q, kp, vp, tbl, sl, scales = _decode_case(dev, 4, Hq, Hk, D, 16, mbps,
                                              lens, quantized, seed=D + Hq)
    q = q.to(dtype)
    if not quantized:
        kp, vp = kp.to(dtype), vp.to(dtype)
    wrappers = (paged_decode_attention_kernel, paged_decode_attention_chunked,
                _pa.paged_decode_attention_simt)
    counts = dict(ROUTE_COUNTS)
    launches = [(w.launches, w.launches_q) for w in wrappers]
    out = paged_decode_attention(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert {n: ROUTE_COUNTS[n] - counts[n] for n in ROUTE_COUNTS} == \
        {n: int(n == "simt") for n in ROUTE_COUNTS}
    moved = [(w.launches - a, w.launches_q - b_)
             for w, (a, b_) in zip(wrappers, launches)]
    assert moved == [(0, 0), (0, 0), (0, 1) if quantized else (1, 0)]
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    assert out[0].abs().max().item() == 0.0  # seq_len 0
    err = ((out.float() - ref.float()).abs().amax((1, 2)) /
           ref.float().abs().amax((1, 2)).clamp_min(1e-30))[1:]
    assert err.max().item() <= SIMT_RTOL[dtype]


def test_paged_decode_simt_rejects_what_it_does_not_take(dev):
    q = torch.randn(2, 8, 64, device=dev)
    kp = torch.randn(4, 16, 8, 64, device=dev)
    tbl = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    sl = torch.ones(2, dtype=torch.int32, device=dev)
    simt = _pa.paged_decode_attention_simt
    with pytest.raises(ValueError, match="k_pool"):
        simt(q, kp.half(), kp.half(), tbl, sl)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        simt(q.double(), kp.double(), kp.double(), tbl, sl)
    with pytest.raises(ValueError, match="both"):
        simt(q, kp, kp, tbl, sl, k_scale=torch.ones(4, 16, 8, device=dev))


# B7's wrappers by route (the ragged loader's launches apart), the CUDA
# cores' kernel, and the split pass's launches
def _qmm_launches():
    from paddle_tpu_torch.kernels.flash_attention import split_bf16x3_cuda
    return {"kernel": quant_matmul.launches,
            "f16": _qm.quant_matmul_f16.launches,
            "split": _qm.quant_matmul_x3.launches,
            "unaligned": quant_matmul.unaligned_launches,
            "f16_unaligned": _qm.quant_matmul_f16.unaligned_launches,
            "split_unaligned": _qm.quant_matmul_x3.unaligned_launches,
            "simt": _qm.quant_matmul_simt.launches,
            "split_pass": split_bf16x3_cuda.launches}


@pytest.mark.parametrize("dtype,K,route", [
    (torch.float32, 4096, "split"), (torch.float16, 4096, "f16"),
    (torch.bfloat16, 4100, "unaligned"),
    (torch.float32, 4100, "split_unaligned"),
    (torch.float16, 4100, "f16_unaligned")])
@pytest.mark.parametrize("M", [4, 100])
def test_int8_linear_routes_what_the_kernel_refuses(dev, dtype, K, route, M):
    """``ConvertedInt8Linear`` with a float32 or fp16 x at K 4096: the
    tensor-core kernels (``split``: float32 x as three bf16 pieces, split
    by a pass before the prefill kernel at M 100 and inside the decode
    kernel at M 4; ``f16``); with K 4100 (not a multiple of 16), whatever
    x: the same kernels through the ragged loader (``*unaligned``). One
    count of the route in ``quant_matmul.ROUTE_COUNTS``, one launch of
    its kernel and none of the others (``quant_matmul_simt`` none), in
    x's dtype, against ``quant_matmul_plain``; a bf16 x at K 4096 still
    launches B7's bf16 path."""
    from paddle_tpu_torch import quantization as TQ
    from paddle_tpu_torch.nn import Linear
    qat = lambda: TQ.QAT(TQ.QuantConfig(
        activation=None, weight=TQ.FakeQuanterWithAbsMaxObserver))
    holder = torch.nn.Sequential(Linear(K, 256, bias=False, device=dev))
    layer = qat().convert(qat().quantize(holder))[0]
    g = torch.Generator(device=dev).manual_seed(K + M)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    counts = dict(_qm.ROUTE_COUNTS)
    before = _qmm_launches()
    out = layer(x)
    torch.cuda.synchronize()
    assert {n: _qm.ROUTE_COUNTS[n] - counts[n] for n in counts} == \
        {n: int(n == route) for n in counts}
    want = {n: int(n == route) for n in before}
    want["split_pass"] = int(route.startswith("split") and M > 8)
    assert {n: c - before[n] for n, c in _qmm_launches().items()} == want
    assert out.dtype == dtype
    ref = quant_matmul_plain(x, layer.w_int8, layer.w_scales_f32)
    assert _rel_err(out, ref) <= SIMT_RTOL[dtype]
    if K % 16 == 0:
        before = _qmm_launches()
        layer(x.bfloat16())
        assert {n: c - before[n] for n, c in _qmm_launches().items()} == \
            {n: int(n == "kernel") for n in before}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("M", [1, 2, 8, 9, 300])
@pytest.mark.parametrize("N,K", [(300, 4096), (1024, 14336), (4100, 96)])
def test_quant_matmul_float32_and_fp16_match_plain(dev, dtype, M, N, K):
    """B7 for float32 x (three bf16 pieces, three products a weight
    fragment: ``quant_matmul_x3``) and fp16 x (f16 products:
    ``quant_matmul_f16``) at decode (M <= 8, split inside the kernel) and
    prefill (M >= 9, after the split pass), N ragged against the 64- and
    256-channel tiles, against ``quant_matmul_plain`` within float32's
    1e-4 and fp16's 5e-3; two calls give the same bits."""
    w, s = _qmm_weight(N, K)
    w, s = w.to(dev), s.to(dev)
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    fn = _qm.quant_matmul_x3 if dtype == torch.float32 else \
        _qm.quant_matmul_f16
    before = fn.launches
    out = fn(x, w, s)
    again = fn(x, w, s)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert out.dtype == dtype and out.shape == (M, N)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel_err(out, quant_matmul_plain(x, w, s)) <= SIMT_RTOL[dtype]
    assert torch.equal(out, again)


def test_quant_matmul_float32_and_fp16_refuse(dev):
    """The tensor-core wrappers take their own dtype, contiguous, any K
    (K 40 through the ragged loader); anything else raises, as does a
    K that does not match w's."""
    w = torch.zeros(16, 40, dtype=torch.int8, device=dev)
    s = torch.ones(16, device=dev)
    x = torch.randn(4, 40, device=dev)
    before = _qm.quant_matmul_x3.unaligned_launches
    assert torch.equal(_qm.quant_matmul_x3(x, w, s),
                       torch.zeros(4, 16, device=dev))
    assert _qm.quant_matmul_x3.unaligned_launches == before + 1
    with pytest.raises(ValueError, match="K must match"):
        _qm.quant_matmul_x3(x[:, :33].contiguous(), w, s)
    with pytest.raises(ValueError, match="float16"):
        _qm.quant_matmul_f16(x[:, :32].contiguous(), w[:, :32].contiguous(),
                             s)
    with pytest.raises(ValueError, match="contiguous"):
        _qm.quant_matmul_x3(torch.randn(32, 8, device=dev).T,
                            w[:, :32].contiguous(), s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("M,N,K", [(1, 64, 7), (4, 256, 4100),
                                   (100, 300, 4096), (130, 70, 33)])
def test_quant_matmul_simt_matches_plain(dev, dtype, M, N, K):
    """``quant_matmul_simt`` against ``quant_matmul_plain`` at edges past
    M, N and K (no multiple of 64 or 16 needed), in x's dtype."""
    w, s = _qmm_weight(N, K)
    x = torch.randn(M, K, device=dev).to(dtype)
    w, s = w.to(dev), s.to(dev)
    out = _qm.quant_matmul_simt(x, w, s)
    ref = quant_matmul_plain(x, w, s)
    assert out.dtype == dtype and out.shape == (M, N)
    assert _rel_err(out, ref) <= SIMT_RTOL[dtype]


# -- B7 at K % 16 != 0: the tensor-core kernels through the ragged loader
# (the widest copy granule the rows and bases allow, registers below 4
# bytes, the ragged last k chunk zero-filled)
_QMM_ANY_FN = {torch.bfloat16: "quant_matmul", torch.float16:
               "quant_matmul_f16", torch.float32: "quant_matmul_x3"}


def _qmm_any_operands(dev, dtype, M, N, K, w_offset=0, x_offset=0):
    """x [M, K] in ``dtype``, w int8 [N, K] and its scales, x and w placed
    ``x_offset`` elements and ``w_offset`` bytes into their buffers (so
    their bases lose their 16-byte alignment)."""
    w, s = _qmm_weight(N, K)
    wb = torch.empty(N * K + w_offset, dtype=torch.int8, device=dev)
    w_dev = wb[w_offset:].view(N, K)
    w_dev.copy_(w)
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    xb = torch.empty(M * K + x_offset, dtype=dtype, device=dev)
    x = xb[x_offset:].view(M, K)
    x.copy_(torch.randn(M, K, generator=g, device=dev).to(dtype))
    return x, w_dev, s.to(dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("M", [1, 8, 300])
@pytest.mark.parametrize("K", [1, 33, 4100, 4104])
def test_quant_matmul_any_k_matches_plain(dev, dtype, M, K):
    """B7's decode (M <= 8) and prefill (M 300) kernels at K not a multiple
    of 16, for bf16, fp16 and float32 x (float32's pieces split with K
    padded to a multiple of 16), N ragged against the 64- and 256-channel
    tiles: one ``unaligned_launches`` count a call, y against
    ``quant_matmul_plain`` within SIMT_RTOL, and two calls give the same
    bits."""
    N = 300
    x, w, s = _qmm_any_operands(dev, dtype, M, N, K)
    fn = getattr(_qm, _QMM_ANY_FN[dtype])
    before = (fn.launches, fn.unaligned_launches)
    out = fn(x, w, s)
    again = fn(x, w, s)
    torch.cuda.synchronize()
    assert (fn.launches, fn.unaligned_launches) == (before[0], before[1] + 2)
    assert out.dtype == dtype and out.shape == (M, N)
    assert bool(torch.isfinite(out.float()).all())
    assert _rel_err(out, quant_matmul_plain(x, w, s)) <= SIMT_RTOL[dtype]
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("M", [8, 300])
@pytest.mark.parametrize("w_offset,x_offset", [(1, 0), (4, 1), (2, 3)])
def test_quant_matmul_any_k_takes_unaligned_bases(dev, dtype, M, w_offset,
                                                  x_offset):
    """w and x whose bases are not 16-byte aligned (the granule drops to
    what they allow: bytes through registers at an odd w base), at K 4104
    and 4100: the same y as aligned copies of the same operands, bit for
    bit, within SIMT_RTOL of the plain version."""
    for K in (4104, 4100):
        x, w, s = _qmm_any_operands(dev, dtype, M, 200, K, w_offset,
                                    x_offset)
        fn = getattr(_qm, _QMM_ANY_FN[dtype])
        out = fn(x, w, s)
        ref = fn(x.clone(), w.clone(), s)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), K
        assert _rel_err(out, quant_matmul_plain(x, w, s)) <= SIMT_RTOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("M", [8, 300])
def test_quant_matmul_any_k_replays_in_a_cuda_graph(dev, dtype, M):
    """The ragged loader's decode and prefill (float32: with its split
    pass) captured in a CUDA graph and replayed on a new x give what a
    direct call gives on it, bit for bit."""
    x, w, s = _qmm_any_operands(dev, dtype, M, 1024, 4100)
    fn = getattr(_qm, _QMM_ANY_FN[dtype])
    fn(x, w, s)  # build and warm up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(x, w, s)
    x.copy_(torch.randn_like(x.float()).to(dtype))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, fn(x, w, s))


# -- float32 and fp16 B1 above head dim 128 on the tensor cores: fp16 on
# ``flash_fwd_256_kernel`` (D 129-256) and ``flash_fwd_xl_kernel`` (above),
# float32 as three bf16 pieces on ``flash_fwd_tc_kernel`` (16-key stages)
# at 256 and ``flash_fwd_xl_kernel`` above
@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [160, 256, 288, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_flash_fwd_float32_and_fp16_above_128_match_plain(dev, dtype, D,
                                                          causal, seg):
    """``flash_attention`` forward in float32 and fp16 above head dim 128
    (padded to ``padded_head_dim``), dense and segment branch, G 4 with
    ragged last tiles: one count of its route, the launches it implies,
    O per row and LSE against the plain forward at the true D."""
    B, S, Hq, Hk = 1, 333, 8, 2
    g = torch.Generator(device=dev).manual_seed(D + causal + 2 * seg)
    mk = lambda h: torch.randn(B, S, h, D, generator=g, device=dev,
                               dtype=dtype)
    q, k, v = mk(Hq), mk(Hk), mk(Hk)
    kw = dict(zip(_SEG_NAMES, _dense_seg(dev, B, S, True, run=40))) \
        if seg else {}
    o, lse = _fwd_tc_call(dtype, q, k, v, causal, kw)
    _fwd_tc_check(dtype, q, k, v, causal, kw, o, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("name", ["ragged-g4-d128", "cross-g4-d64",
                                  "nokeys-g2-d64", "runs-g2-d64"])
def test_flash_fwd_float32_and_fp16_above_128_segment_cases(dev, dtype,
                                                            name):
    """The segment cases of the bf16 kernels at head dim 200 (their
    inputs zero-padded: the same scores at the true D) in float32 and
    fp16: ragged rows, 1-token sequences, queries with no key."""
    q, k, v, _, causal, kw = _seg_inputs(dev, name)
    wide = lambda t: torch.nn.functional.pad(t, (0, 200 - t.shape[-1]))
    q, k, v = (wide(t).to(dtype) for t in (q, k, v))
    o, lse = _fwd_tc_call(dtype, q, k, v, causal, kw)
    _fwd_tc_check(dtype, q, k, v, causal, kw, o, lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("D", [160, 288])
def test_flash_fwd_above_128_replays_in_a_cuda_graph(dev, dtype, D):
    """The forward above head dim 128 (float32: three splits and B1 on
    pieces, the tc kernel at 256 or the xl kernel; fp16: B1 at 256 or the
    xl kernel) captured in a CUDA
    graph and replayed on new q give what a direct call gives, bit for
    bit."""
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    g = torch.Generator(device=dev).manual_seed(D)
    mk = lambda h: torch.randn(1, 300, h, D, generator=g, device=dev,
                               dtype=dtype)
    q, k, v = mk(16), mk(4), mk(4)
    call = lambda: flash_attention(q, k, v, causal=True, return_lse=True)
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, lse = call()
    q.copy_(torch.randn(q.shape, generator=g, device=dev, dtype=dtype))
    graph.replay()
    torch.cuda.synchronize()
    o2, lse2 = call()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_flash_attention_above_128_grads_through_the_simt_backward(dev):
    """Forward on the tensor cores, backward on ``flash_simt.cu`` above
    head dim 128: in float32 and fp16 at D 160, 256 and 288 the forward
    launches no ``flash_simt_fwd`` and the backward reads the sliced O and
    its LSE; the gradients are within SIMT_BWD_RTOL of the plain pair."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    for dtype in (torch.float32, torch.float16):
        for D in (160, 256, 288):
            g = torch.Generator(device=dev).manual_seed(D)
            mk = lambda h: torch.randn(1, 200, h, D, generator=g,
                                       device=dev, dtype=dtype)
            q, k, v, do = mk(8), mk(2), mk(2), mk(8)
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            fwd0 = fa.flash_simt_fwd_cuda.launches
            bwd0 = dict(fa.BWD_ROUTE_COUNTS)
            out = fa.scaled_dot_product_attention(*ts, is_causal=True)
            out.backward(do)
            torch.cuda.synchronize()
            assert fa.flash_simt_fwd_cuda.launches == fwd0
            assert {n: fa.BWD_ROUTE_COUNTS[n] - bwd0[n] for n in bwd0} == \
                {n: int(n == "simt") for n in bwd0}
            o_ref, lse = flash_attention_plain(q, k, v, causal=True,
                                               return_lse=True)
            refs = flash_attention_bwd_plain(q, k, v, o_ref, lse, do, True)
            assert _row_rel_err(out, o_ref) <= SIMT_RTOL[dtype]
            for t, ref in zip(ts, refs):
                assert _rel_err(t.grad, ref) <= SIMT_BWD_RTOL[dtype], \
                    (dtype, D)


# -- B1 at D 160-256 (``flash_fwd_256_kernel``, two warpgroups on wgmma)
# and B3 above D 256 (``flash_bwd_dkv_xl_kernel``, slices of up to 256
# columns), dense and segment branch, against the plain versions at the
# true D
def _wide_inputs(dev, S, Hq, Hk, D, seg, Sk=None, seed=60):
    Sk = Sk or S
    q = _randn(dev, 1, S, Hq, D, seed=seed)
    k = _randn(dev, 1, Sk, Hk, D, seed=seed + 1)
    v = _randn(dev, 1, Sk, Hk, D, seed=seed + 2)
    do = _randn(dev, 1, S, Hq, D, seed=seed + 3)
    kw = {}
    if seg:  # runs of 96 tokens, ids (pos // 96) % 3, 10 orphan queries
        kw = dict(zip(_SEG_NAMES, _dense_seg(dev, 1, S, True, run=96)))
    return q, k, v, do, kw


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [197, 2048])
@pytest.mark.parametrize("D", [160, 256])
@pytest.mark.parametrize("Hq,Hk", [(16, 4), (8, 8)])
def test_flash_fwd_256_matches_plain(dev, Hq, Hk, D, S, causal, seg):
    """B1 at D 160 (zero-padded to 256 as ``FlashAttention`` pads it) and
    256, G 4 and G 1 (whose two warpgroups hold 64 positions each), S 197
    (a ragged last tile) and 2048, dense and segment branch (with query
    rows whose id no key has): O per row within 2e-2 and elementwise
    within ATOL or one bf16 ulp where |O| >= 4, LSE within 2e-3, O 0 and
    LSE +1e30 on rows that see no key, one launch a call."""
    from paddle_tpu_torch.kernels.flash_attention import pad_head_dim
    q, k, v, _, kw = _wide_inputs(dev, S, Hq, Hk, D, seg)
    scale = 1.0 / np.sqrt(D)
    before = (flash_fwd_cuda.launches, flash_fwd_cuda.seg_launches)
    o, lse = flash_fwd_cuda(*(pad_head_dim(t, 256) for t in (q, k, v)),
                            causal, scale=scale, **kw)
    o = o[..., :D]
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, scale=scale,
                                           return_lse=True, **kw)
    torch.cuda.synchronize()
    assert (flash_fwd_cuda.launches, flash_fwd_cuda.seg_launches) == \
        (before[0] + (not seg), before[1] + seg)
    assert bool(torch.isfinite(o.float()).all())
    limit = torch.clamp(_bf16_ulp(o_ref), min=ATOL)
    assert bool(((o.float() - o_ref.float()).abs() <= limit).all())
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    assert _row_rel_err(o, o_ref) <= ROW_RTOL
    if seg:
        rows, _ = _unseen(kw, causal)
        assert bool(rows.any())
        r = rows[..., None, None].expand_as(o)
        assert o[r].abs().max().item() == 0.0
        assert bool((lse.transpose(1, 2)[rows] == 1e30).all())


@pytest.mark.parametrize("Hq,Hk", [(16, 4), (8, 8), (4, 4)])
def test_flash_fwd_256_rows_that_see_no_key(dev, Hq, Hk):
    """B1 at D 256, causal with Sq > Sk (bottom-right: the first Sq - Sk
    rows see no key, across both warpgroups of a CTA at G 1): O 0 and LSE
    +1e30 there, the plain version elsewhere."""
    q, k, v, _, _ = _wide_inputs(dev, 300, Hq, Hk, 256, False, Sk=130)
    o, lse = flash_fwd_cuda(q, k, v, True)
    o_ref, lse_ref = flash_attention_plain(q, k, v, True, return_lse=True)
    torch.cuda.synchronize()
    assert o[:, :170].abs().max().item() == 0.0
    assert bool((lse[:, :, :170] == 1e30).all())
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    assert _row_rel_err(o, o_ref) <= ROW_RTOL


@pytest.mark.parametrize("seg", [False, True])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [288, 384, 512, 640])
@pytest.mark.parametrize("Hq,Hk,S", [(16, 4, 2048), (8, 4, 333)])
def test_flash_bwd_dkv_xl_matches_plain(dev, Hq, Hk, S, D, causal, seg):
    """B3 above D 256 (D 288 zero-padded to 384; slices of 192 at D 384,
    256 at 512 and 640, the last of 640's half past D), dense and segment
    branch: dK and dV within 2e-2 of the plain version's largest value,
    exact zeros for keys no row sees, one launch a call."""
    from paddle_tpu_torch.kernels.flash_attention import (pad_head_dim,
                                                          padded_head_dim)
    q, k, v, do, kw = _wide_inputs(dev, S, Hq, Hk, D, seg, seed=70)
    dp = padded_head_dim(D)
    scale = 1.0 / np.sqrt(D)
    qp, kp, vp, dop = (pad_head_dim(t, dp) for t in (q, k, v, do))
    o, lse = flash_fwd_cuda(qp, kp, vp, causal, scale=scale, **kw)
    delta = flash_delta(o, dop)
    before = (flash_bwd_dkv_cuda.xl_launches, flash_bwd_dkv_cuda.launches,
              flash_bwd_dkv_cuda.seg_launches)
    dk, dv = flash_bwd_dkv_cuda(qp, kp, vp, dop, lse, delta, causal,
                                scale=scale, **kw)
    dk, dv = dk[..., :D], dv[..., :D]
    refs = flash_attention_bwd_plain(q, k, v, o[..., :D], lse, do, causal,
                                     scale=scale, **kw)[1:]
    torch.cuda.synchronize()
    assert (flash_bwd_dkv_cuda.xl_launches, flash_bwd_dkv_cuda.launches,
            flash_bwd_dkv_cuda.seg_launches) == \
        (before[0] + 1, before[1] + (not seg), before[2] + seg)
    for name, out, ref in zip(("dk", "dv"), (dk, dv), refs):
        assert bool(torch.isfinite(out.float()).all()), name
        assert _rel_err(out, ref) <= BWD_RTOL, name
    if seg:
        _, keys = _unseen(kw, causal)
        if keys.any():
            c = keys[..., None, None].expand_as(dk)
            assert dk[c].abs().max().item() == 0.0
            assert dv[c].abs().max().item() == 0.0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_256_reads_head_major_views(dev, causal):
    """B1 at D 256 reads K and V by TMA through their strides: q/k/v as
    [B, S, H, D] views of head-major [B, H, S, D] tensors (the head stride
    above the sequence stride) give the plain version's O and LSE."""
    B, S, Hq, Hk, D = 2, 333, 8, 2, 256
    q = _randn(dev, B, Hq, S, D, seed=81).transpose(1, 2)
    k = _randn(dev, B, Hk, S, D, seed=82).transpose(1, 2)
    v = _randn(dev, B, Hk, S, D, seed=83).transpose(1, 2)
    o, lse = flash_fwd_cuda(q, k, v, causal)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal, return_lse=True)
    torch.cuda.synchronize()
    assert (lse - lse_ref).abs().max().item() <= 2e-3
    assert _row_rel_err(o, o_ref) <= ROW_RTOL


# the CUDA cores' decode kernel (paged_decode_simt.cuh), redesigned: one
# cluster per (slot, kv head) with the group's heads in each CTA, the
# live pages split over the cluster; held to SIMT_RTOL per slot


def _simt_case(dev, B, Hq, Hk, D, bs, mbps, lens, dtype, quantized, seed):
    """Scattered-block pools of ``dtype`` (or int8 rows of the float32
    values, with their scales), tables and lens; (q, kp, vp, tbl, sl,
    scales)."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)
    kp, vp = mk(B * mbps + 1, bs, Hk, D), mk(B * mbps + 1, bs, Hk, D)
    q = mk(B, Hq, D).to(dtype)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    tbl = np.zeros((B, mbps), np.int32)
    for i in range(B):
        need = min(-(-int(lens[i]) // bs), mbps)
        tbl[i, :need] = rng.permutation(np.arange(
            1 + i * mbps, 1 + (i + 1) * mbps))[:need]
    return (q, kp, vp, torch.as_tensor(tbl, device=dev),
            torch.as_tensor(np.asarray(lens, np.int32), device=dev), scales)


def _simt_check(out, ref, lens, dtype):
    assert out.dtype == dtype and bool(torch.isfinite(out.float()).all())
    for i, n in enumerate(lens):
        if n == 0:
            assert out[i].abs().max().item() == 0.0
    err = ((out.float() - ref.float()).abs().flatten(1).amax(1) /
           ref.float().abs().flatten(1).amax(1).clamp_min(1e-30))
    err = err[[i for i, n in enumerate(lens) if n]]
    assert err.max().item() <= SIMT_RTOL[dtype]


def _simt_lens(bs, mbps):
    """0, 1, a page edge, the whole table, past it."""
    return [0, 1, bs * min(2, mbps), bs * mbps, bs * mbps + 5]


@pytest.mark.parametrize("mbps", [1, 9, 128])
@pytest.mark.parametrize("G", [1, 3, 16, 32])
@pytest.mark.parametrize("D", [64, 80, 128, 256, 1024])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_paged_decode_simt_matches_plain(dev, dtype, quantized, D, G, mbps):
    """``paged_decode_attention_simt`` against the plain version over
    query dtypes, pools (their dtype or int8), head dims, groups and
    tables of 1 to 128 16-row pages, lengths 0, 1, a page edge, the whole
    table and past it: per slot within SIMT_RTOL, zeros for the empty
    slot, one launch a call, the same bits from two calls."""
    bs, Hk = 16, 2
    lens = _simt_lens(bs, mbps)
    q, kp, vp, tbl, sl, scales = _simt_case(
        dev, len(lens), G * Hk, Hk, D, bs, mbps, lens, dtype, quantized,
        seed=D + G + mbps)
    simt = _pa.paged_decode_attention_simt
    count = "launches_q" if quantized else "launches"
    before = getattr(simt, count)
    out = simt(q, kp, vp, tbl, sl, **scales)
    again = simt(q, kp, vp, tbl, sl, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert getattr(simt, count) == before + 2
    assert torch.equal(out, again)
    _simt_check(out, ref, lens, dtype)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_paged_decode_simt_every_cluster_size(dev, monkeypatch, dtype,
                                              quantized, cluster):
    """Every cluster size ``simt_decode_plan`` may pick, forced, at engine
    A's heads (Hq 32, Hk 8, D 128) on 24-page tables and at D 80, G 3 on
    7-page ones: the ranks' shares (some empty) merge to the plain
    version's answer."""
    monkeypatch.setattr(_pa, "simt_decode_plan", functools.partial(
        _pa.simt_decode_plan, cluster=cluster))
    for Hq, Hk, D, mbps in ((32, 8, 128, 24), (12, 4, 80, 7)):
        lens = _simt_lens(16, mbps)
        q, kp, vp, tbl, sl, scales = _simt_case(
            dev, len(lens), Hq, Hk, D, 16, mbps, lens, dtype, quantized,
            seed=cluster + D)
        out = _pa.paged_decode_attention_simt(q, kp, vp, tbl, sl, **scales)
        ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
        torch.cuda.synchronize()
        _simt_check(out, ref, lens, dtype)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_paged_decode_simt_never_reads_dead_rows(dev, dtype, quantized):
    """NaN in the rows past seq_len of a slot's last live page and in
    every page no table holds (int8 pools: NaN scales and 127 rows) never
    reaches the output: it equals the plain version on the same pools
    with those rows zeroed."""
    bs, mbps = 16, 8
    lens = [0, 5, 37, 100, 128]
    for Hq, Hk, D in ((32, 8, 128), (12, 4, 72)):
        q, kp, vp, tbl, sl, scales = _simt_case(
            dev, len(lens), Hq, Hk, D, bs, mbps, lens, dtype, quantized,
            seed=D)
        clean = [kp.clone(), vp.clone(),
                 *(s.clone() for s in scales.values())]
        used = set(tbl.flatten().tolist())
        dead = [(int(tbl[i, n // bs]), n % bs) for i, n in enumerate(lens)
                if n % bs]
        unused = [x for x in range(kp.shape[0]) if x not in used]
        for t in (kp, vp, *scales.values()):
            bad = float("nan") if t.dtype.is_floating_point else 127
            for blk, pos in dead:
                t[blk, pos:] = bad
            t[unused] = bad
        for t in clean:
            for blk, pos in dead:
                t[blk, pos:] = 0
            t[unused] = 0
        out = _pa.paged_decode_attention_simt(q, kp, vp, tbl, sl, **scales)
        ref = paged_decode_attention_dense(
            q, clean[0], clean[1], tbl, sl,
            **dict(zip(scales, clean[2:])))
        torch.cuda.synchronize()
        _simt_check(out, ref, lens, dtype)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_paged_decode_simt_replays_in_a_cuda_graph(dev, dtype, quantized):
    """The cluster launch captured in a CUDA graph at engine A's shape
    (B 8, Hq 32, Hk 8, D 128, 128 16-row pages, lens 1..2048): the capture
    counts one launch, and a replay after the query changes in place gives
    the plain version's answer for the new query."""
    B, Hq, Hk, D, bs, mbps = 8, 32, 8, 128, 16, 128
    lens = np.linspace(1, 2048, 8).astype(np.int64)
    q, kp, vp, tbl, sl, scales = _simt_case(dev, B, Hq, Hk, D, bs, mbps,
                                            lens, dtype, quantized, seed=50)
    simt = _pa.paged_decode_attention_simt
    count = "launches_q" if quantized else "launches"
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        simt(q, kp, vp, tbl, sl, **scales)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = getattr(simt, count)
    with torch.cuda.graph(graph):
        out = simt(q, kp, vp, tbl, sl, **scales)
    assert getattr(simt, count) == before + 1
    q.copy_(torch.randn(B, Hq, D, device=dev).to(dtype))
    graph.replay()
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    assert getattr(simt, count) == before + 1
    _simt_check(out, ref, list(lens), dtype)
