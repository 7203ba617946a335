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
    x = _randn(dev, 4, 40)
    w = torch.zeros(16, 40, dtype=torch.int8, device=dev)
    s = torch.ones(16, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        quant_matmul(x, w, s)
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
    # D 256 (the mma.sync kernels: dK and dV from separate CTAs)
    (1, 2048, 2048, 16, 4, 256, True),
    (2, 197, 197, 8, 8, 256, False),
    (1, 37, 200, 8, 2, 256, True),
    (2, 200, 37, 4, 1, 256, True),
    (1, 333, 333, 32, 8, 256, True),
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
                                  "ragged-g4-d128", "nonmono-g4-d128"])
def test_flash_bwd_is_deterministic(dev, case):
    """Two launches on the same inputs give the same bits: no atomics, and
    the cluster's partial sums meet in a fixed order."""
    if case == "dense-g4-d128":
        q, k, v, do = _dense_inputs(dev, 1, 2048, 32, 8, 128)
        causal, kw = True, {}
    elif case == "dense-g1-d64":
        q, k, v, do = _dense_inputs(dev, 2, 1000, 16, 16, 64)
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


def test_flash_autograd_refuses_head_dims_above_128(dev):
    """Since D 256 was added the limit is 256: a CUDA tensor of a wider
    head raises on the kernel route (no plain fallback), naming it."""
    q = _randn(dev, 1, 64, 2, 288, seed=1)
    with pytest.raises(ValueError, match="above 256"):
        scaled_dot_product_attention(q, q, q)


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
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("Hq,Hk", [(8, 8), (16, 4), (16, 2)])
def test_flash_segment_forward_matches_plain(dev, Hq, Hk, D, causal):
    """B1-seg at G 1, 4 and 8, D 64, 128 and 256, causal or not, on a
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
