"""PyTorch port: ``paddle_tpu_torch.quantization`` and the int8 weight
matmul's plain version against the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages. Codes and
scales must be bitwise equal (weight scales are computed in the weight's
dtype, row scales in float32, both rounding half to even); outputs agree
within the stated tolerances (float32).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import quantization as JQ
from paddle_tpu.kernels.pallas.quant_matmul import (
    quant_matmul as pallas_quant_matmul)
from paddle_tpu.models import Llama as JaxLlama
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu_torch import Llama, LlamaConfig
from paddle_tpu_torch import quantization as TQ
from paddle_tpu_torch.convert import llama_int8_params_from_numpy
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.kernels import quant_matmul as _qm
from paddle_tpu_torch.kernels.quant_matmul import (
    CH_TILE, DEC_BK, DEC_CLUSTERS, DEC_GRANULES, DEC_MAX_M, DEC_CH,
    K_CHUNK, MIN_CHUNKS, SMEM_PER_BLOCK, SMS, TOK_TILE, decode_granule,
    decode_plan, decode_shares, decode_smem_bytes, prefill_plan, qmm_route,
    quant_matmul, quant_matmul_plain)
from paddle_tpu_torch.nn import Linear

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else \
        np.asarray(jnp.asarray(t).astype(jnp.float32))


def _qat(pkg):
    return pkg.QAT(pkg.QuantConfig(
        activation=None, weight=pkg.FakeQuanterWithAbsMaxObserver))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_primitives_bitwise(dtype):
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 64)).astype(np.float32) * \
        rng.uniform(1e-3, 30.0, (6, 5, 1)).astype(np.float32)
    x[2, 3] = 0.0  # an all-zero row: floor scale, zero codes
    xj, xt = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(_np(TQ.absmax_row_scales(xt)),
                                  _np(JQ.absmax_row_scales(xj)))
    qj, sj = JQ.quantize_rows(xj)
    qt, st = TQ.quantize_rows(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not qt[2, 3].any() and st[2, 3].item() == np.float32(1e-8)
    np.testing.assert_array_equal(_np(TQ.dequantize_rows(qt, st, tdt)),
                                  _np(JQ.dequantize_rows(qj, sj, jdt)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_bitwise(dtype):
    """The port's [out, in] weight against the JAX package's [in, out]:
    the same codes, and scales in the weight's dtype."""
    jdt, tdt = _DT[dtype]
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((256, 512)) * 0.02).astype(np.float32)
    w[:, 7] = 0.0  # an all-zero output channel: the 1e-9 floor
    qj, sj = JQ._quantize_weight(jnp.asarray(w).astype(jdt), channel_axis=1)
    qt, st = TQ._quantize_weight(
        torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt), channel_axis=0)
    assert st.dtype == tdt and qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy().T, np.asarray(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))


@pytest.mark.parametrize("m_shape,K,N", [((3, 5), 96, 200), ((1,), 32, 8),
                                         ((2, 130), 64, 128)])
def test_quant_matmul_plain_matches_pallas(m_shape, K, N):
    """The JAX package's own kernel test shapes; the port's weight is the
    transpose of the Pallas kernel's [K, N]."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((*m_shape, K)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (N,)).astype(np.float32)
    ref = pallas_quant_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                              interpret=True)
    out = quant_matmul_plain(torch.from_numpy(x),
                             torch.from_numpy(np.ascontiguousarray(w.T)),
                             torch.from_numpy(s))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-5)


def test_quant_matmul_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 32)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, (16,)).astype(np.float32))
    before = quant_matmul.launches
    assert torch.equal(quant_matmul(x, w, s), quant_matmul_plain(x, w, s))
    assert quant_matmul.launches == before


@pytest.mark.parametrize("n,k", [(14336, 4096), (4096, 4096), (1024, 4096),
                                 (4096, 14336)])
def test_prefill_plan_covers_k_and_fills_the_card(n, k):
    """Llama-3-8B's layer shapes at every padded prompt length: every
    split of K holds at least one chunk and all of them together cover K
    once; the CTAs come to about one wave of the card's SMs."""
    chunks = -(-k // K_CHUNK)
    for m in range(16, 1025, 16):
        cps, splits = prefill_plan(m, n, k)
        assert cps >= min(chunks, MIN_CHUNKS)
        assert (splits - 1) * cps < chunks <= splits * cps
        ctas = -(-m // TOK_TILE) * -(-n // CH_TILE) * splits
        assert ctas >= 0.7 * SMS, (m, cps, splits)
        assert splits == 1 or ctas < 1.5 * SMS, (m, cps, splits)


# Llama-3-8B's five decode shapes (N, K) and the decode kernel's edges:
# partial channel tiles (72, 200, 1000), K 48 (one partial stage), 4144 (a
# partial stage; at cluster 8 an empty rank)
_LLAMA_DECODE = [(14336, 4096), (4096, 4096), (1024, 4096), (4096, 14336),
                 (128256, 4096)]
_DECODE_EDGES = [(72, 48), (200, 4144), (1000, 14336), (1024, 4144)]


@pytest.mark.parametrize("n,k", _LLAMA_DECODE + _DECODE_EDGES)
def test_decode_plan_covers_channels_and_k_and_fits(n, k):
    """For every token count of the decode kernel: CTAs own 64 channels
    each and together cover N once; the cluster's K shares are
    contiguous, granule-aligned and cover K once; the cluster is a
    portable size; one CTA fits shared memory; at Llama-3-8B's shapes the
    CTAs come to about one wave of the card's SMs."""
    gk = decode_granule(k)
    # the least whole number of stages whose 8 granules hold K
    assert gk % DEC_BK == 0 and DEC_GRANULES * (gk - DEC_BK) < k <= \
        DEC_GRANULES * gk
    for m in range(1, DEC_MAX_M + 1):
        cluster = decode_plan(m, n, k)
        assert cluster in DEC_CLUSTERS
        assert cluster <= 8
        tiles = -(-n // DEC_CH)
        assert (tiles - 1) * DEC_CH < n <= tiles * DEC_CH
        shares = decode_shares(k, cluster)
        assert len(shares) == cluster and shares[0][0] == 0 and \
            shares[-1][1] == k
        for (a0, a1), (b0, _) in zip(shares, shares[1:]):
            assert a1 == b0 and a0 % gk == 0
        assert all(k0 < k1 for k0, k1 in shares)  # no idle rank
        assert decode_smem_bytes(cluster) <= SMEM_PER_BLOCK
        # four CTAs an SM (the kernel's launch bounds) fit its 228 KiB
        # with bf16 and fp16 x and with float32 x (4 bytes an element)
        assert 4 * decode_smem_bytes(cluster, 4) <= 228 * 1024
        if (n, k) in _LLAMA_DECODE:
            assert tiles * cluster >= 0.95 * SMS, (m, cluster)


# K not a multiple of 16 (the kernels' ragged loader): 1, odd, even, a
# multiple of 4 and of 8 past Llama's widths, and one past 14336
_RAGGED_K = (1, 33, 100, 4100, 4104, 14337)


@pytest.mark.parametrize("k", _RAGGED_K)
def test_plans_cover_ragged_k_once(k):
    """With K no multiple of 16 (nor of the plans' chunks), the k the
    kernels walk cover [0, K) exactly once: the prefill's splits by
    64-wide chunks, each split holding one at least (the ragged last chunk
    ends at K: zero-filled past it), at prompt lengths and layer widths of
    the serving path; the decode ranks by 128-wide stages from their
    share's start (a stage's copies stop at K only, so a stage may not
    reach into the next rank's share), at the planned cluster and at
    every forced one."""
    seen = np.zeros(k, np.int64)
    nck = -(-k // K_CHUNK)
    for m in (9, 112, 300, 1008):
        for n in (72, 1024, 14336):
            cps, splits = prefill_plan(m, n, k)
            seen[:] = 0
            for z in range(splits):
                c0, c1 = z * cps, min(nck, (z + 1) * cps)
                assert c1 > c0, (m, n, cps, splits)
                for c in range(c0, c1):
                    seen[c * K_CHUNK:min((c + 1) * K_CHUNK, k)] += 1
            assert (seen == 1).all(), (m, n)
    for n in (72, 1024, 14336):
        for cluster in {decode_plan(8, n, k), *DEC_CLUSTERS}:
            seen[:] = 0
            for k0, k1 in decode_shares(k, cluster):
                for st in range(-(-(k1 - k0) // DEC_BK) if k1 > k0 else 0):
                    a = k0 + st * DEC_BK
                    seen[a:min(a + DEC_BK, k)] += 1
            assert (seen == 1).all(), (n, cluster)


def test_decode_plan_forced_values():
    assert decode_plan(8, 4096, 4096, cluster=2) == 2
    # a forced cluster may leave ranks with no K (the kernel zero-fills)
    assert decode_plan(8, 72, 48, cluster=8) == 8
    assert decode_shares(48, 8)[1:] == [(48, 48)] * 7
    for bad in (0, 3, 16):
        with pytest.raises(ValueError):
            decode_plan(8, 4096, 4096, cluster=bad)


def _tree(parts):
    """The balanced binary tree of sums over 1, 2, 4 or 8 parts."""
    while len(parts) > 1:
        parts = [a + b for a, b in zip(parts[::2], parts[1::2])]
    return parts[0]


@pytest.mark.parametrize("n,k", [(72, 4144), (200, 48), (40, 14336)])
@pytest.mark.parametrize("cluster", DEC_CLUSTERS)
def test_decode_split_sum_matches_unsplit(n, k, cluster):
    """``quant_matmul_plain`` split along ``decode_shares`` (each rank's
    own sum over its K share, float32) and summed in rank order by the
    kernel's tree matches the unsplit plain version; each rank's share is
    the k range of the granules whose subtree it sums, so the ranks' sums
    meet in the top levels of the one tree over all granules."""
    rng = np.random.default_rng(k + n)
    x = torch.from_numpy(rng.standard_normal((DEC_MAX_M, k)).astype(
        np.float32))
    w = torch.from_numpy(rng.integers(-128, 128, (n, k), dtype=np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-3, n).astype(np.float32))
    q = w.float()
    part = lambda k0, k1: x[:, k0:k1] @ q[:, k0:k1].T
    split = _tree([part(k0, k1) for k0, k1 in decode_shares(k, cluster)])
    ref = quant_matmul_plain(x, w, s)
    # float32 sums of the same products in another order: within a few
    # ulps of the largest output (near-cancelling outputs carry that
    # absolute error too)
    np.testing.assert_allclose((split * s).numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    gk = decode_granule(k)
    per = DEC_GRANULES // cluster
    for r, share in enumerate(decode_shares(k, cluster)):
        assert share == (min(r * per * gk, k), min((r + 1) * per * gk, k))


def _jax_converted_linear(seed):
    paddle.seed(seed)
    src = jnn.Linear(24, 40)
    rng = np.random.default_rng(seed)
    src.bias.set_value(rng.standard_normal(40).astype(np.float32))
    qat = _qat(JQ)
    holder = jnn.Sequential(src)
    return qat.convert(qat.quantize(holder))[0]


@pytest.mark.parametrize("mode", ["auto", "dense"])
def test_converted_linear_from_jax_weights_matches_jax_dense(mode):
    """JAX's converted layer (dense route on the CPU) against the port's
    ConvertedInt8Linear holding its buffers, on both port routes."""
    jl = _jax_converted_linear(3)
    x = np.random.default_rng(4).standard_normal((5, 24)).astype(np.float32)
    ref = np.asarray(jl(paddle.to_tensor(x))._data)
    set_flags({"FLAGS_paged_kernel": mode})
    try:
        holder = torch.nn.Sequential(Linear(24, 40, bias=True,
                                            device="cpu"))
        tl = _qat(TQ).convert(_qat(TQ).quantize(holder))[0]
    finally:
        set_flags({"FLAGS_paged_kernel": "auto"})
    assert isinstance(tl, TQ.ConvertedInt8Linear) and tl.kernel_mode == mode
    tl.load_state_dict({
        "w_int8": torch.from_numpy(np.asarray(jl.w_int8._data).T.copy()),
        "w_scales": torch.from_numpy(np.array(jl.w_scales._data)),
        "bias": torch.from_numpy(np.array(jl.bias._data))})
    # the kernel's float32 scales follow the loaded ones, and stay float32
    # through a cast of the module
    assert torch.equal(tl.w_scales_f32, tl.w_scales)
    assert tl.to(torch.float64).w_scales_f32.dtype == torch.float32
    tl.float()
    out = tl(torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_fake_quanter_and_quanted_linear_two_training_calls():
    """Two training-mode calls: the moving-average scale, the fake-quant
    forward, and the straight-through gradient of the weight."""
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((24, 16)) * 0.1).astype(np.float32)  # [in, out]
    xs = [rng.standard_normal((4, 24)).astype(np.float32) * a
          for a in (1.0, 3.0)]
    paddle.seed(0)
    jsrc = jnn.Linear(24, 16, bias_attr=False)
    jsrc.weight.set_value(w)
    jq = JQ.QuantedLinear(jsrc, JQ.FakeQuanterWithAbsMaxObserver,
                          JQ.FakeQuanterWithAbsMaxObserver)
    tsrc = Linear(24, 16, device="cpu", requires_grad=True)
    with torch.no_grad():
        tsrc.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
    tq = TQ.QuantedLinear(tsrc, TQ.FakeQuanterWithAbsMaxObserver,
                          TQ.FakeQuanterWithAbsMaxObserver)
    tq.train()
    for x in xs:
        ref = np.asarray(jq(paddle.to_tensor(x))._data)
        out = tq(torch.from_numpy(x))
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
        for name in ("a_quanter", "w_quanter"):
            jf, tf = getattr(jq, name), getattr(tq, name)
            assert float(tf.scale) == float(jf.scale._data)
            assert tf.scales() == pytest.approx(jf.scales(), rel=1e-7)
    out.sum().backward()
    tq.eval()  # eval keeps the scales where training left them
    scales = [float(tq.a_quanter.scale), float(tq.w_quanter.scale)]
    x_fq = tq.a_quanter(torch.from_numpy(xs[1]))
    assert [float(tq.a_quanter.scale), float(tq.w_quanter.scale)] == scales
    # straight-through: d/dW of sum(x_fq @ W_fq.T) is x_fq summed over rows
    np.testing.assert_allclose(tsrc.weight.grad.numpy(),
                               x_fq.sum(0).expand(16, 24).numpy(),
                               atol=1e-5)


def test_qat_convert_tiny_llama_names_match_jax():
    paddle.seed(0)
    jm = JaxLlama(JaxConfig.tiny())
    jd = _qat(JQ).convert(_qat(JQ).quantize(jm))
    tm = Llama(LlamaConfig.tiny(), device="cpu")
    td = _qat(TQ).convert(_qat(TQ).quantize(tm))
    jnames = sorted(n for n, s in jd.named_sublayers()
                    if isinstance(s, JQ.ConvertedInt8Linear))
    tnames = sorted(n for n, s in td.named_modules()
                    if isinstance(s, TQ.ConvertedInt8Linear))
    assert len(tnames) == 15 and tnames == jnames
    # the copies were converted; the sources kept their float weights
    assert isinstance(tm.lm_head, Linear)
    named = {n: np.asarray(t._data) for n, t in
             [*jd.named_parameters(), *jd.named_buffers()]}
    state = llama_int8_params_from_numpy(named, JaxConfig.tiny())
    assert set(state) == set(td.state_dict())
    with pytest.raises(ValueError, match="missing"):
        llama_int8_params_from_numpy(
            {n: a for n, a in named.items() if "lm_head" not in n},
            JaxConfig.tiny())
    bad = dict(named)
    bad["layers.0.mlp.up_proj.w_scales"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        llama_int8_params_from_numpy(bad, JaxConfig.tiny())


@pytest.mark.parametrize("mode,device,dtype,K,route", [
    ("auto", "cuda", torch.bfloat16, 4096, "kernel"),
    ("kernel", "cuda", torch.bfloat16, 14336, "kernel"),
    ("auto", "cuda", torch.float32, 4096, "split"),
    ("auto", "cuda", torch.float16, 4096, "f16"),
    ("auto", "cuda", torch.float32, 14336, "split"),
    ("auto", "cuda", torch.bfloat16, 4100, "unaligned"),  # K % 16 != 0
    ("auto", "cuda", torch.float32, 4100, "split_unaligned"),
    ("auto", "cuda", torch.float16, 4100, "f16_unaligned"),
    ("auto", "cuda", torch.float64, 4096, "kernel"),     # refused there
    ("auto", "cpu", torch.float32, 4100, "cpu"),
    ("auto", "cpu", torch.bfloat16, 4096, "cpu"),
    ("dense", "cuda", torch.bfloat16, 4096, "dense"),
    ("dense", "cuda", torch.float32, 4100, "dense"),
])
def test_qmm_route_sends_what_the_kernel_refuses_to_simt(mode, device,
                                                         dtype, K, route):
    """An int8 layer's route from the mode, x's device and dtype and K
    alone: the tensor-core kernels take bf16 (``kernel``), fp16 (``f16``)
    and float32 x (``split``) with K a multiple of 16, and at any other K
    through their ragged loader (the ``*unaligned`` routes; the reference
    takes any K); any other dtype goes to the bf16 wrapper, which refuses
    it. The CUDA cores' ``quant_matmul_simt`` is on no route."""
    assert qmm_route(mode, device, dtype, K) == route


def test_converted_linear_counts_one_cpu_route_on_the_cpu():
    """On CPU tensors the layer takes the plain version, whatever x's
    dtype or K: one ``cpu`` count in ``ROUTE_COUNTS`` a call and no
    launch of either kernel."""
    holder = torch.nn.Sequential(Linear(20, 8, bias=False, device="cpu"))
    tl = _qat(TQ).convert(_qat(TQ).quantize(holder))[0]
    before = (dict(_qm.ROUTE_COUNTS), quant_matmul.launches,
              _qm.quant_matmul_simt.launches)
    x = torch.randn(3, 20)
    out = tl(x)
    assert {k: _qm.ROUTE_COUNTS[k] - before[0][k] for k in before[0]} == \
        {k: int(k == "cpu") for k in before[0]}
    assert (quant_matmul.launches, _qm.quant_matmul_simt.launches) == \
        before[1:]
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, quant_matmul_plain(x, tl.w_int8,
                                                       tl.w_scales_f32))


@pytest.mark.parametrize("dtype,K", [(torch.float32, 20), (torch.bfloat16, 20),
                                     (torch.float16, 32)])
def test_quant_matmul_simt_takes_plain_version_on_cpu(dtype, K):
    """``quant_matmul_simt`` (the CUDA cores' kernel for any x dtype and
    K) on CPU tensors: ``quant_matmul_plain`` in x's dtype, no launch
    counted."""
    w, s = TQ._quantize_weight(torch.randn(8, K), channel_axis=0)
    x = torch.randn(3, 2, K).to(dtype)
    n = _qm.quant_matmul_simt.launches
    out = _qm.quant_matmul_simt(x, w, s.float())
    assert out.dtype == dtype and out.shape == (3, 2, 8)
    assert torch.equal(out, quant_matmul_plain(x, w, s.float()))
    assert _qm.quant_matmul_simt.launches == n
