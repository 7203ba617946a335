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
boundary the two round differently. The int8
weight matmul too, at 1e-2: it multiplies the scale after the f32 sum,
the plain version before, which moves the bf16 output by an ulp at most.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import set_flags
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda, flash_delta, flash_fwd_cuda,
    scaled_dot_product_attention)
from paddle_tpu_torch.kernels.paged_attention import (
    paged_decode_attention_chunked, paged_decode_attention_dense,
    paged_decode_attention_kernel)
from paddle_tpu_torch.kernels.quant_matmul import (quant_matmul,
                                                   quant_matmul_plain)
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


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("wrapper", [paged_decode_attention_kernel,
                                     paged_decode_attention_chunked])
@pytest.mark.parametrize("B,Hq,Hk,D,mbps,lens", [
    (3, 8, 2, 128, 8, [1, 100, 128]),
    (3, 8, 2, 128, 8, [0, 17, 200]),   # a length past the table
    (2, 4, 4, 64, 4, [30, 0]),
    (2, 32, 8, 128, 20, [320, 33]),
])
def test_paged_decode_matches_plain(dev, wrapper, quantized, B, Hq, Hk, D,
                                    mbps, lens):
    bs = 16
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


# the prefill kernel's tile edges (128 tokens x 256 channels, 64-wide k
# chunks, K split where the tiles alone leave SMs idle): N 72 and K 48 are
# tails of one partial tile and chunk; K 4144 ends in a partial chunk
_QMM_EDGES = [(M, N, K) for M in (9, 16, 112, 127, 128, 129, 1008)
              for N, K in ((72, 48), (72, 4096), (4096, 48), (4096, 4096),
                           (72, 14336), (4096, 14336))] + \
    [(200, 200, 4144), (257, 4100, 4144)]


@pytest.mark.parametrize("M,N,K", [
    (8, 4096, 4096), (1, 1024, 4096), (5, 200, 96), (3, 8, 32),
    (8, 4096, 14336), (1008, 14336, 4096), (32, 1024, 4096), (130, 128, 64),
    (17, 72, 48),
] + _QMM_EDGES)
def test_quant_matmul_matches_plain(dev, M, N, K):
    x = _randn(dev, M, K, seed=9)
    w, s = _quantize_weight(_randn(dev, N, K, seed=10) * 0.02, 0)
    s = s.float()
    before = quant_matmul.launches
    out = quant_matmul(x, w, s)
    ref = quant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    assert _rel_err(out, ref) <= QMM_RTOL


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
