"""PyTorch port: plain paged-decode attention vs the JAX package's Pallas
kernels (interpret mode), and the port's decode routing on CPU tensors.

The plain version ``paged_decode_attention_dense`` is what the CUDA kernels
(``paged_decode.cu``, ``paged_decode_split.cu``) are held against on the
card. Tables hold scattered blocks; lens include 0, 1, an exact block
multiple and a full table. Float32, atol 1e-5. With int8 pools (K and V
quantized by the JAX package's ``quantize_rows``) against the Pallas
``_decode_kernel_q`` and the chunked kernel with ``quantized=True``, on
part of the JAX package's own parity matrix: atol 5e-5 (both dequantize
to the same float32 rows; the sums run in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import quantization as JQ
from paddle_tpu.kernels.pallas.paged_attention import (
    paged_decode_attention_chunked as pallas_chunked,
    paged_decode_attention_kernel as pallas_kernel)
from paddle_tpu_torch.inference.paged import (ROUTE_COUNTS, decode_route,
                                              paged_decode_attention)
from paddle_tpu_torch.kernels.paged_attention import (
    _SIMT_ACC, _SIMT_HEADS, _SPLIT_CTAS_PER_SM, SMEM_PER_BLOCK, _gather_kv,
    decode_cluster_plan, decode_cluster_shares, decode_smem_bytes,
    paged_decode_attention_chunked, paged_decode_attention_dense,
    paged_decode_attention_kernel, simt_decode_plan, simt_decode_schedule,
    simt_smem_bytes, split_cluster_plan, split_smem_bytes)

ATOL = 1e-5
INT8_ATOL = 5e-5
# per slot, max |split - dense| / max |dense| in bf16 (the GPU kernels'
# limit: P rounded to bf16 against each split's own max moves a slot by
# a few ulps)
DECODE_RTOL = 2e-2
# the same per slot in fp16 and bf16 against the Pallas kernels, which
# round P unnormalized, chunk by chunk, where the plain version rounds the
# normalized P (a few ulps of each: 2^-11 in fp16, 2^-8 in bf16)
HALF_RTOL = {torch.float16: 5e-3, torch.bfloat16: DECODE_RTOL}


def _case(B, HQ, HK, D, BS, MBPS, lens, seed=0):
    rng = np.random.RandomState(seed)
    NB = B * MBPS + 1
    kp = rng.randn(NB, BS, HK, D).astype(np.float32)
    vp = rng.randn(NB, BS, HK, D).astype(np.float32)
    q = rng.randn(B, HQ, D).astype(np.float32)
    tbl = np.zeros((B, MBPS), np.int32)
    for i in range(B):
        need = int(np.ceil(lens[i] / BS)) if lens[i] else 0
        tbl[i, :need] = rng.permutation(np.arange(
            1 + i * MBPS, 1 + i * MBPS + MBPS))[:need]  # scattered blocks
    return q, kp, vp, tbl, np.asarray(lens, np.int32)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


CASES = [
    # B, HQ, HK, D, BS, MBPS, lens
    (4, 8, 2, 64, 8, 4, [0, 1, 16, 32]),    # GQA 4: empty, one, multiple, full
    (3, 4, 4, 64, 8, 4, [9, 32, 0]),        # MHA
    (2, 8, 2, 64, 4, 16, [64, 37]),         # 16 pages: the split route
    # the shapes the simt route (the CUDA cores' kernel) serves
    (3, 16, 8, 256, 8, 4, [0, 1, 32]),      # D 256, G 2 (Gemma-2's widths)
    (2, 32, 8, 80, 8, 4, [9, 32]),          # D 80
    (2, 64, 4, 128, 4, 4, [16, 5]),         # G 16
    (3, 12, 4, 64, 8, 4, [0, 17, 32]),      # G 3
]


@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", CASES)
def test_plain_decode_matches_pallas_kernel(B, HQ, HK, D, BS, MBPS, lens):
    q, kp, vp, tbl, sl = _case(B, HQ, HK, D, BS, MBPS, lens)
    ref = pallas_kernel(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                        jnp.asarray(tbl), jnp.asarray(sl), interpret=True)
    out = paged_decode_attention_dense(*_torch(q, kp, vp, tbl, sl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0)


@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", CASES)
def test_plain_decode_matches_pallas_chunked(B, HQ, HK, D, BS, MBPS, lens):
    q, kp, vp, tbl, sl = _case(B, HQ, HK, D, BS, MBPS, lens, seed=1)
    ref = pallas_chunked(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                         jnp.asarray(tbl), jnp.asarray(sl), interpret=True,
                         chunk_pages=2)
    out = paged_decode_attention_dense(*_torch(q, kp, vp, tbl, sl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_wrappers_take_plain_version_on_cpu():
    args = _torch(*_case(2, 8, 2, 64, 8, 4, [5, 30]))
    ref = paged_decode_attention_dense(*args)
    n_page = paged_decode_attention_kernel.launches
    n_split = paged_decode_attention_chunked.launches
    assert torch.equal(paged_decode_attention_kernel(*args), ref)
    assert torch.equal(paged_decode_attention_chunked(*args), ref)
    assert paged_decode_attention_kernel.launches == n_page
    assert paged_decode_attention_chunked.launches == n_split


@pytest.mark.parametrize("mbps,mode,moved,on_cuda", [
    (4, "auto", "plain", "kernel"),
    (16, "auto", "plain", "split"),
    (16, "kernel", "plain", "split"),
    (4, "dense", "dense", "dense"),
])
def test_routing_on_cpu_moves_the_right_counter(mbps, mode, moved, on_cuda):
    """A CPU call moves one counter (``plain``; ``dense`` when forced);
    the same shapes on CUDA tensors would take ``on_cuda``."""
    q, kp, vp, tbl, sl = _case(2, 8, 2, 64, 4, mbps, [3, 4 * mbps])
    before = dict(ROUTE_COUNTS)
    out = paged_decode_attention(*_torch(q, kp, vp, tbl, sl),
                                 kernel_mode=mode)
    delta = {k: ROUTE_COUNTS[k] - before[k] for k in ROUTE_COUNTS}
    assert delta == {k: int(k == moved) for k in ROUTE_COUNTS}
    assert decode_route(mode, "cuda", True, mbps) == on_cuda
    ref = paged_decode_attention_dense(*_torch(q, kp, vp, tbl, sl))
    assert torch.equal(out, ref)


def test_routing_rejects_unknown_mode():
    with pytest.raises(ValueError, match="FLAGS_paged_kernel"):
        paged_decode_attention(*_torch(*_case(1, 4, 2, 64, 4, 4, [3])),
                               kernel_mode="pallas")


@pytest.mark.parametrize("quantized", [False, True])
def test_split_cluster_plan_at_engine_a_shape(quantized):
    # Llama-3-8B decode on engine A: B 8, Hk 8, G 4, a 128-page table; C
    # is the smallest size whose grid holds _SPLIT_CTAS_PER_SM CTAs per SM
    cluster = split_cluster_plan(8, 8, 4, 128, 128, quantized, 132)
    assert cluster in (1, 2, 4, 8, 16)
    assert 8 * 8 * cluster >= _SPLIT_CTAS_PER_SM * 132
    assert 8 * 8 * cluster // 2 < _SPLIT_CTAS_PER_SM * 132
    # a table too short to split stays one CTA per (slot, kv head)
    assert split_cluster_plan(8, 8, 4, 1, 128, quantized, 132) == 1


def _int8_case(B, HQ, HK, D, BS, MBPS, lens, seed=0):
    """The JAX parity matrix's scattered-pool case, K and V quantized."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * MBPS
    q = rng.standard_normal((B, HQ, D)).astype(np.float32)
    k = rng.standard_normal((NB, BS, HK, D)).astype(np.float32)
    v = rng.standard_normal((NB, BS, HK, D)).astype(np.float32)
    tables = np.zeros((B, MBPS), np.int32)
    perm = rng.permutation(np.arange(1, NB))
    for b in range(B):
        tables[b] = perm[b * MBPS:(b + 1) * MBPS]
    kq, ks = (np.asarray(a) for a in JQ.quantize_rows(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in JQ.quantize_rows(jnp.asarray(v)))
    return q, kq, vq, tables, np.asarray(lens, np.int32), ks, vs


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", [
    (3, 8, 2, 32, 8, 6, [0, 16, 47]),       # GQA 4, empty slot, boundary
    (2, 8, 1, 32, 8, 6, [8, 48]),           # MQA, boundary and full
])
def test_quantized_plain_decode_matches_pallas(B, HQ, HK, D, BS, MBPS, lens,
                                               chunked):
    q, kq, vq, tbl, sl, ks, vs = _int8_case(B, HQ, HK, D, BS, MBPS, lens)
    j = [jnp.asarray(a) for a in (q, kq, vq, tbl, sl)]
    if chunked:
        ref = pallas_chunked(*j, interpret=True, chunk_pages=2,
                             k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    else:
        ref = pallas_kernel(*j, interpret=True, k_scale=jnp.asarray(ks),
                            v_scale=jnp.asarray(vs))
    out = paged_decode_attention_dense(
        *(torch.from_numpy(np.array(a)) for a in (q, kq, vq, tbl, sl)),
        k_scale=torch.from_numpy(np.array(ks)),
        v_scale=torch.from_numpy(np.array(vs)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=INT8_ATOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_cluster_plan_fits_two_ctas_per_sm(quantized, cluster):
    """The size the split route picks leaves room for two CTAs on an SM
    (the block ids, the warps' stages and, on rank 0, the cluster's
    slots), whatever the grid asks for, and at engine A's shape for as
    many as the kernel's launch bounds ask (four, three for int8 pools); a
    forced size must fit one CTA, and one the kernel cannot launch is
    refused."""
    for b, d, g in ((8, 128, 4), (1, 128, 8), (1, 64, 8), (2, 128, 1)):
        for npages in (16, 128, 512):
            c = split_cluster_plan(b, 1, g, npages, d, quantized,
                                   132 * cluster)
            assert 2 * split_smem_bytes(npages, d, g, quantized, c) <= \
                SMEM_PER_BLOCK
            assert split_cluster_plan(b, 1, g, npages, d, quantized, 132,
                                      cluster=cluster) == cluster
            assert split_smem_bytes(npages, d, g, quantized, cluster) <= \
                SMEM_PER_BLOCK
    c = split_cluster_plan(8, 8, 4, 128, 128, quantized, 132)
    assert (3 if quantized else 4) * \
        split_smem_bytes(128, 128, 4, quantized, c) <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="cluster"):
        split_cluster_plan(8, 8, 4, 128, 128, quantized, 132, cluster=32)
    with pytest.raises(ValueError, match="shared memory"):
        split_cluster_plan(8, 8, 4, 1 << 16, 128, quantized, 132,
                           cluster=cluster)


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("quantized", [False, True])
def test_split_cluster_plan_covers_every_live_page(quantized, d, bs):
    """The split route's plan: C <= 16 and never more than the pages
    unless forced; every live page of every length, from 0 to past the
    table, goes to exactly one rank, in order, at most ceil(live / C) a
    rank (the kernel's share formula)."""
    for b, hk, g in ((8, 8, 4), (1, 1, 8), (3, 2, 1), (2, 8, 2)):
        for npages in (16, 17, 33, 64, 128):
            for forced in (None, 16):
                cluster = split_cluster_plan(b, hk, g, npages, d, quantized,
                                             132, cluster=forced)
                assert cluster in (1, 2, 4, 8, 16)
                assert forced or cluster <= npages
                for length in range(0, npages * bs + 2 * bs + 1, 7):
                    live = -(-min(length, npages * bs) // bs)
                    shares = decode_cluster_shares(length, bs, npages,
                                                   cluster)
                    assert len(shares) == cluster
                    pages = [p for p0, p1 in shares for p in range(p0, p1)]
                    assert pages == list(range(live))
                    assert all(p1 - p0 <= -(-live // cluster)
                               for p0, p1 in shares)


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_cluster_plan_covers_every_live_page(quantized, d, bs):
    """The per-page kernel's plan: C <= 8 and never more than the pages;
    the staged chunk (one stage, or each of two ring stages) fits in a
    block's shared memory; every live page of every length, from 0 to
    past the table, goes to exactly one rank, in order."""
    for b, hk, g in ((8, 8, 4), (1, 1, 8), (3, 2, 1), (64, 8, 4)):
        for npages in (1, 2, 3, 5, 7, 15, 16, 33, 128):
            cluster, cpp, stages = decode_cluster_plan(
                b, hk, g, npages, bs, d, quantized, num_sms=132)
            assert cluster in (1, 2, 4, 8) and cluster <= npages
            assert cpp >= 1 and stages in (1, 2)
            share = -(-npages // cluster)
            assert (stages == 1) == (cpp >= share)
            rows = -(-cpp * bs // 16) * 16
            assert decode_smem_bytes(rows, npages, d, g, quantized,
                                     stages, cluster) <= SMEM_PER_BLOCK // 2
            for length in range(0, npages * bs + 2 * bs + 1):
                live = -(-min(length, npages * bs) // bs)
                shares = decode_cluster_shares(length, bs, npages, cluster)
                assert len(shares) == cluster
                pages = [p for p0, p1 in shares for p in range(p0, p1)]
                assert pages == list(range(live))
                assert all(p1 - p0 <= share for p0, p1 in shares)


def test_decode_cluster_plan_at_the_serving_shape():
    # Llama-3-8B decode on engine B: B 8, Hk 8, G 4, 15 16-token pages;
    # C 4 puts 256 CTAs on 132 SMs, each share staged at once
    for quantized in (False, True):
        assert decode_cluster_plan(8, 8, 4, 15, 16, 128, quantized,
                                   132) == (4, 4, 1)
    # a 128-page table passed straight to the wrapper goes through the ring
    cluster, cpp, stages = decode_cluster_plan(8, 8, 4, 128, 16, 128, False,
                                               132)
    assert (cluster, stages) == (4, 2) and cpp < 32
    with pytest.raises(ValueError, match="shared memory"):
        decode_cluster_plan(1, 1, 4, 4, 1024, 128, False, 132)


def _split_merge(q, kp, vp, tbl, sl, cluster, k_scale=None, v_scale=None):
    """The plain version split along the kernel's cluster shares: each
    rank's (m, l, O) in f32 from its own pages, P cast to V's dtype
    against the rank's own max, then the ranks merged by their max."""
    b, hq, d = q.shape
    _, bs, hk, _ = kp.shape
    g = hq // hk
    npages = tbl.shape[1]
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(b, hk, g, d)
    for i in range(b):
        length = min(int(sl[i]), npages * bs)
        qi = q[i].reshape(hk, g, d).float()
        parts = []
        for p0, p1 in decode_cluster_shares(length, bs, npages, cluster):
            n = min(length, p1 * bs) - p0 * bs
            if n <= 0:
                continue
            idx = tbl[i, p0:p1].long()
            k = _gather_kv(kp, idx, k_scale, q.dtype).reshape(-1, hk, d)[:n]
            v = _gather_kv(vp, idx, v_scale, q.dtype).reshape(-1, hk, d)[:n]
            s = torch.einsum("ngd,tnd->ngt", qi, k.float()) * scale
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            o = torch.einsum("ngt,tnd->ngd", p.to(v.dtype).float(),
                             v.float())
            parts.append((m, p.sum(-1), o))
        if not parts:
            continue  # an empty slot gives zeros
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        l = sum(l * torch.exp(m - big) for m, l, _ in parts)
        o = sum(o * torch.exp(m - big)[..., None] for m, _, o in parts)
        out[i] = o / l[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("pools", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", [
    # the serving shape's lengths on 15 pages (not a multiple of C): empty
    # and full slots side by side, slots with fewer pages than C
    (8, 8, 2, 32, 16, 15, [0, 1, 16, 17, 100, 161, 239, 240]),
    (3, 4, 1, 32, 8, 7, [0, 56, 90]),    # a length past the table
    (2, 8, 8, 64, 32, 3, [5, 96]),       # G 1, 32-row pages
])
def test_cluster_split_merge_matches_dense(B, HQ, HK, D, BS, MBPS, lens,
                                           cluster, pools):
    q, kp, vp, tbl, sl = _torch(*_case(B, HQ, HK, D, BS, MBPS, lens))
    scales = {}
    if pools == "int8":
        kq, ks = (torch.from_numpy(np.array(a)) for a in
                  JQ.quantize_rows(jnp.asarray(kp.numpy())))
        vq, vs = (torch.from_numpy(np.array(a)) for a in
                  JQ.quantize_rows(jnp.asarray(vp.numpy())))
        kp, vp, scales = kq, vq, dict(k_scale=ks, v_scale=vs)
    if pools != "f32":
        q = q.bfloat16()
        if pools == "bf16":
            kp, vp = kp.bfloat16(), vp.bfloat16()
    out = _split_merge(q, kp, vp, tbl, sl, cluster, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0) and torch.all(ref[i] == 0)
            continue
        diff = (out[i].float() - ref[i].float()).abs().max()
        if pools == "f32":
            assert diff.item() <= ATOL, i
        else:
            assert (diff / ref[i].float().abs().max()).item() <= \
                DECODE_RTOL, i


@pytest.mark.parametrize("pools", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", [
    # long tables (the split route's): empty, one key, a page boundary,
    # the whole table, past it
    (5, 8, 2, 32, 16, 20, [0, 1, 16, 320, 333]),
    (3, 8, 8, 64, 8, 17, [9, 136, 70]),       # G 1, 8-row pages
])
def test_split_route_merge_matches_dense(B, HQ, HK, D, BS, MBPS, lens,
                                         cluster, pools):
    """The split route's clusters (up to 16 ranks) on long tables: the
    plain version split along the ranks' shares and merged in f32 matches
    the unsplit one, as for the per-page route."""
    test_cluster_split_merge_matches_dense(B, HQ, HK, D, BS, MBPS, lens,
                                           cluster, pools)


@pytest.mark.parametrize("D,Hq,Hk,q_dtype,int8,pages,route", [
    (128, 32, 8, torch.bfloat16, False, 8, "kernel"),
    (128, 32, 8, torch.bfloat16, False, 128, "split"),
    (64, 8, 8, torch.bfloat16, True, 8, "kernel"),
    (128, 32, 8, torch.bfloat16, True, 128, "split"),
    (256, 16, 8, torch.bfloat16, False, 8, "simt"),   # D 256, G 2
    (256, 16, 8, torch.bfloat16, True, 128, "simt"),
    (80, 32, 8, torch.bfloat16, False, 8, "simt"),    # D 80
    (128, 64, 4, torch.bfloat16, False, 128, "simt"),  # G 16
    (128, 64, 4, torch.bfloat16, True, 8, "simt"),
    (128, 32, 8, torch.float32, False, 8, "simt"),    # float32
    (128, 32, 8, torch.float32, True, 128, "simt"),
    (128, 32, 8, torch.float16, False, 8, "simt"),
])
def test_decode_route_sends_what_the_kernels_refuse_to_simt(
        D, Hq, Hk, q_dtype, int8, pages, route):
    """The decode route from dtypes and shapes alone: the kernels for bf16
    queries over bf16 (or int8, with scales) pools at D 64/128 and G 1, 2,
    4, 8; ``simt`` (the CUDA cores' kernel) for every other dtype, head
    dim or group on a CUDA tensor; the same tensors on the CPU take
    ``plain``."""
    from paddle_tpu_torch.kernels.paged_attention import decode_kernel_takes
    q = torch.empty(2, Hq, D, dtype=q_dtype)
    pool = torch.empty(4, 16, Hk, D,
                       dtype=torch.int8 if int8 else torch.bfloat16)
    scale = torch.empty(4, 16, Hk) if int8 else None
    takes = decode_kernel_takes(q, pool, pool, scale)
    assert takes == (route != "simt")
    assert decode_route("auto", "cuda", takes, pages) == route
    assert decode_route("kernel", "cuda", takes, pages) == route
    assert decode_route("auto", "cpu", takes, pages) == "plain"
    assert decode_route("dense", "cuda", takes, pages) == "dense"
    # an int8 pool without scales is not what the kernels take
    if int8:
        assert not decode_kernel_takes(q, pool, pool)


@pytest.mark.parametrize("quantized", [False, True])
def test_simt_wrapper_takes_plain_version_on_cpu(quantized):
    """``paged_decode_attention_simt`` (the CUDA cores' kernel for what
    B4-B6q do not take) on CPU tensors: the dense version, no launch
    counted, at a head dim (80) and group (3) no tensor-core kernel
    takes."""
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_simt)
    from paddle_tpu_torch.quantization import quantize_rows
    q, kp, vp, tbl, sl = _torch(*_case(2, 12, 4, 80, 4, 4, [0, 13]))
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    n = (paged_decode_attention_simt.launches,
         paged_decode_attention_simt.launches_q)
    out = paged_decode_attention_simt(q, kp, vp, tbl, sl, **scales)
    assert torch.equal(out, paged_decode_attention_dense(q, kp, vp, tbl, sl,
                                                         **scales))
    assert (paged_decode_attention_simt.launches,
            paged_decode_attention_simt.launches_q) == n


def _slot_rel(out, ref):
    """Per slot, max |out - ref| / max |ref| (0 where both are 0)."""
    diff = (out.float() - ref.float()).flatten(1).abs().amax(1)
    scale = ref.float().flatten(1).abs().amax(1)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


_SIMT_SHAPES = [
    # B, HQ, HK, D, BS, MBPS, lens: what the simt route serves
    (3, 16, 8, 256, 8, 4, [0, 1, 32]),      # D 256, G 2
    (2, 32, 8, 80, 8, 4, [9, 32]),          # D 80
    (2, 64, 4, 128, 4, 4, [16, 5]),         # G 16
    (3, 12, 4, 64, 8, 4, [0, 17, 33]),      # G 3, a length past the table
]


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", _SIMT_SHAPES)
def test_plain_decode_matches_pallas_in_half_dtypes(B, HQ, HK, D, BS, MBPS,
                                                    lens, dtype, quantized,
                                                    chunked):
    """The simt route's dtypes: fp16 and bf16 queries over pools of their
    dtype or int8 (``quantize_rows`` of the float32 rows), the plain
    version against the Pallas ``_decode_kernel`` / ``_decode_kernel_q``
    and the chunked kernel in interpret mode on the same values, per slot
    within HALF_RTOL; empty slots give zeros on both."""
    q, kp, vp, tbl, sl = _case(B, HQ, HK, D, BS, MBPS, lens, seed=2)
    jdt = jnp.float16 if dtype == torch.float16 else jnp.bfloat16
    scales = {}
    if quantized:
        kp, ks = (np.asarray(a) for a in JQ.quantize_rows(jnp.asarray(kp)))
        vp, vs = (np.asarray(a) for a in JQ.quantize_rows(jnp.asarray(vp)))
        scales = dict(k_scale=ks, v_scale=vs)
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
    else:
        jk, jv = jnp.asarray(kp, jdt), jnp.asarray(vp, jdt)
    jq = jnp.asarray(q, jdt)
    kw = {k: jnp.asarray(v) for k, v in scales.items()}
    if chunked:
        ref = pallas_chunked(jq, jk, jv, jnp.asarray(tbl), jnp.asarray(sl),
                             interpret=True, chunk_pages=2, **kw)
    else:
        ref = pallas_kernel(jq, jk, jv, jnp.asarray(tbl), jnp.asarray(sl),
                            interpret=True, **kw)
    tq = torch.from_numpy(q).to(dtype)
    tk = torch.from_numpy(np.array(kp))
    tv = torch.from_numpy(np.array(vp))
    if not quantized:
        tk, tv = tk.to(dtype), tv.to(dtype)
    out = paged_decode_attention_dense(
        tq, tk, tv, *_torch(tbl, sl),
        **{k: torch.from_numpy(np.array(v)) for k, v in scales.items()})
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert out.dtype == dtype
    assert _slot_rel(out, ref) <= HALF_RTOL[dtype]
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0) and torch.all(ref[i] == 0)


# the CUDA cores' decode plan at the widths the port may meet: pool
# element bytes (float32, fp16/bf16, int8 pools)
_SIMT_POOLS = [(4, False), (2, False), (4, True), (2, True)]


@pytest.mark.parametrize("elem,quantized", _SIMT_POOLS)
@pytest.mark.parametrize("d", [64, 72, 80, 128, 256, 512, 1024])
def test_simt_decode_plan_fits_a_cta(elem, quantized, d):
    """Every group 1-32 and table 1-128 pages: the plan fits one CTA's
    shared memory (and the layout the kernel derives, ``simt_smem_bytes``),
    covers the group exactly (``heads`` a CTA, the last split no empty),
    keeps a lane's accumulators and a CTA's heads within their limits,
    pads K rows so 16-byte reads are free of bank conflicts, and copies
    with a width that divides the row."""
    s = 1 if quantized else elem
    for g in (1, 2, 3, 4, 8, 16, 32):
        for npages in (1, 16, 128):
            p = simt_decode_plan(8, 8, g, npages, 16, d, elem, quantized,
                                 132)
            assert p.smem <= SMEM_PER_BLOCK
            assert p.smem == simt_smem_bytes(
                npages, d, elem, quantized, p.heads, p.rows, p.key_stride,
                p.value_stride, p.warps, p.stages, p.cluster)
            assert p.heads * p.group_splits >= g
            assert (p.group_splits - 1) * p.heads < g
            nj = max(2, 1 << (-(-d // 32) - 1).bit_length())
            heads_t = 1 << (p.heads - 1).bit_length()
            assert p.heads <= _SIMT_HEADS and heads_t * nj <= _SIMT_ACC
            assert p.rows * p.lanes_per_key == 32 and p.rows >= 4
            assert 1 <= p.warps <= 4 and 1 <= p.stages <= 3
            chunks = -(-d * s // 16)
            assert p.value_stride == 16 * chunks
            groups = p.key_stride // 16
            assert groups >= chunks and p.key_stride % 16 == 0
            if p.lanes_per_key < 8:
                assert groups % (2 * p.lanes_per_key) == p.lanes_per_key
            assert (d * s) % p.copy_width == 0
            assert p.copy_width == 16 or (d * s) % (2 * p.copy_width)
            assert p.cluster in (1, 2, 4, 8, 16)
            assert p.cluster <= max(npages, 1)


def test_simt_decode_plan_raises_where_nothing_fits():
    """A table whose block ids alone pass a CTA's shared memory, and a
    cluster size the kernel has not: refused before any launch."""
    with pytest.raises(ValueError, match="does not fit"):
        simt_decode_plan(1, 1, 4, 1 << 17, 16, 128, 4, False, 132)
    with pytest.raises(ValueError, match="cluster"):
        simt_decode_plan(8, 8, 4, 16, 16, 128, 4, False, 132, cluster=32)


@pytest.mark.parametrize("elem,quantized", [(4, False), (2, False),
                                            (4, True)])
def test_simt_decode_plan_at_engine_a_shape(elem, quantized):
    """Engine A's decode (B 8, Hk 8, G 4, 128-page tables of 16 rows, D
    128): at least one CTA per SM of the H100's 132, the group in one CTA,
    and a CTA that leaves room for the four an SM the grid puts there."""
    p = simt_decode_plan(8, 8, 4, 128, 16, 128, elem, quantized, 132)
    ctas = 8 * 8 * p.group_splits * p.cluster
    assert ctas >= 132 and p.group_splits == 1
    assert p.smem * min(-(-ctas // 132), 4) <= SMEM_PER_BLOCK


@pytest.mark.parametrize("cluster", [None, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("elem,quantized", [(4, False), (2, False),
                                            (4, True)])
def test_simt_decode_schedule_covers_every_live_row(elem, quantized, bs,
                                                    cluster):
    """The kernel's placement of a slot's rows (``simt_decode_schedule``):
    for every length from 0 to the whole table and one past it, each live
    row in exactly one block, blocks within ``rows``, each rank's rows
    within its pages of ``decode_cluster_shares``, and each warp's blocks
    cycling through its ring's stages in order."""
    for b, hk, g, npages, d in ((8, 8, 4, 16, 128), (8, 8, 4, 128, 128),
                                (2, 8, 2, 7, 256), (3, 4, 16, 33, 80)):
        p = simt_decode_plan(b, hk, g, npages, bs, d, elem, quantized, 132,
                             cluster=cluster)
        for length in list(range(0, npages * bs + 2)):
            live = min(length, npages * bs)
            sched = simt_decode_schedule(length, npages, bs, p)
            rows = [r for _, _, _, first, n in sched
                    for r in range(first, first + n)]
            assert sorted(rows) == list(range(live))
            shares = decode_cluster_shares(length, bs, npages, p.cluster)
            seen = {}
            for rank, warp, stage, first, n in sched:
                assert 0 < n <= p.rows and 0 <= warp < p.warps
                p0, p1 = shares[rank]
                assert p0 * bs <= first and first + n <= p1 * bs
                i = seen.get((rank, warp), 0)
                assert stage == i % p.stages
                seen[(rank, warp)] = i + 1


def _simt_merge(q, kp, vp, tbl, sl, plan, k_scale=None, v_scale=None):
    """The CUDA cores' decode kernel's arithmetic in float32, along its
    schedule: each (rank, warp) keeps an online softmax (m, l, O) per head
    over its blocks, P rounded to q's dtype against the running max; the
    warps merge by their max, then the ranks."""
    b, hq, d = q.shape
    _, bs, hk, _ = kp.shape
    g = hq // hk
    npages = tbl.shape[1]
    scale = 1.0 / np.sqrt(d)
    out = torch.zeros(b, hk, g, d)
    for i in range(b):
        idx = tbl[i].long()
        k = _gather_kv(kp, idx, k_scale, q.dtype).reshape(-1, hk, d).float()
        v = _gather_kv(vp, idx, v_scale, q.dtype).reshape(-1, hk, d).float()
        qi = q[i].reshape(hk, g, d).float()
        parts = {}
        for rank, warp, _, first, n in simt_decode_schedule(
                int(sl[i]), npages, bs, plan):
            s = torch.einsum("ngd,tnd->ngt", qi, k[first:first + n]) * scale
            m, l, o = parts.get((rank, warp), (
                torch.full((hk, g), -np.inf), torch.zeros(hk, g),
                torch.zeros(hk, g, d)))
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - mx)
            pr = torch.exp(s - mx[..., None])
            o = o * alpha[..., None] + torch.einsum(
                "ngt,tnd->ngd", pr.to(q.dtype).float(), v[first:first + n])
            parts[(rank, warp)] = (mx, l * alpha + pr.sum(-1), o)
        if not parts:
            continue
        for level in ("warps", "ranks"):
            groups = {}
            for key, part in parts.items():
                groups.setdefault(key[0] if level == "warps" else 0,
                                  []).append(part)
            parts = {}
            for key, ps in groups.items():
                big = torch.stack([m for m, _, _ in ps]).amax(0)
                w = [torch.exp(m - big) for m, _, _ in ps]
                parts[(key,)] = (big, sum(l * x for (_, l, _), x in
                                          zip(ps, w)),
                                 sum(o * x[..., None] for (_, _, o), x in
                                     zip(ps, w)))
        (_, l, o), = parts.values()
        out[i] = o / l[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


@pytest.mark.parametrize("cluster", [None, 1, 4, 16])
@pytest.mark.parametrize("pools", ["f32", "f16", "int8"])
@pytest.mark.parametrize("B,HQ,HK,D,BS,MBPS,lens", [
    (8, 8, 2, 32, 16, 15, [0, 1, 16, 17, 100, 161, 239, 240]),
    (3, 12, 4, 80, 8, 7, [0, 56, 90]),     # G 3, past the table
    (2, 16, 1, 64, 16, 9, [5, 144]),       # G 16 in two group splits
])
def test_simt_schedule_merge_matches_dense(B, HQ, HK, D, BS, MBPS, lens,
                                           pools, cluster):
    """The CUDA cores' kernel's split and merge, replayed in float32 along
    its plan's schedule (forced cluster sizes too), matches the plain
    version: float32 pools within ATOL, fp16 and int8 (dequantized to
    fp16) pools per slot within HALF_RTOL; empty slots give zeros."""
    q, kp, vp, tbl, sl = _torch(*_case(B, HQ, HK, D, BS, MBPS, lens))
    scales = {}
    if pools == "int8":
        kq, ks = (torch.from_numpy(np.array(a)) for a in
                  JQ.quantize_rows(jnp.asarray(kp.numpy())))
        vq, vs = (torch.from_numpy(np.array(a)) for a in
                  JQ.quantize_rows(jnp.asarray(vp.numpy())))
        kp, vp, scales = kq, vq, dict(k_scale=ks, v_scale=vs)
    if pools != "f32":
        q = q.half()
        if pools == "f16":
            kp, vp = kp.half(), vp.half()
    plan = simt_decode_plan(B, HK, HQ // HK, MBPS, BS, D, q.element_size(),
                            pools == "int8", 132, cluster=cluster)
    out = _simt_merge(q, kp, vp, tbl, sl, plan, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    for i, n in enumerate(lens):
        if n == 0:
            assert torch.all(out[i] == 0) and torch.all(ref[i] == 0)
    if pools == "f32":
        assert (out - ref).abs().max().item() <= ATOL
    else:
        assert _slot_rel(out, ref) <= HALF_RTOL[torch.float16]
