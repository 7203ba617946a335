"""PyTorch port: float32 flash backward as three bf16 pieces, on the CPU.

B2 and B3 (``csrc/flash_bwd.cu``) take a float32 operand x as three bf16
pieces b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x - b0 - b1) and keep,
of every product, the six terms whose pieces' indices sum to at most 2.
Here ``split_bf16x3_plain`` (the split pass's plain version) and
``_bwd_pieces`` below (the kernels' arithmetic in plain PyTorch) are
held against float32: the pieces rebuild x exactly, the
six-term backward matches the VJP of the Pallas kernels in interpret mode
within 1e-5 of the largest gradient, and one piece (plain bf16) misses by
more than the card's float32 gate (2e-4), so that gate tells the two
apart. The route map (``flash_bwd_route``, the forward's ``flash_route``)
is checked too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_attention import (
    flash_attention as pallas_flash)
from paddle_tpu_torch.kernels import flash_attention as fa

# the card's float32 gradient gate (chip_smoke.py SIMT_BWD_RTOL)
F32_BWD_RTOL = 2e-4
PIECES_RTOL = 1e-5


# the (A piece, B piece) terms of a product of two split operands, small
# ones first: the six whose indices sum to at most 2 at three pieces
# (``flash_common.cuh`` ``term_a``, ``term_b``), b0 b0 alone at one
_TERMS = {1: ((0, 0),),
          3: ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))}


def _pieces_einsum(eq, a, b, pieces):
    """``einsum(eq, a, b)`` as B2 and B3 compute it at ``pieces``: each
    operand split (``split_bf16x3_plain``; one piece is bf16), every kept
    term's product in float32, summed in ``_TERMS`` order."""
    ap, bp = fa.split_bf16x3_plain(a), fa.split_bf16x3_plain(b)
    out = None
    for i, j in _TERMS[pieces]:
        t = torch.einsum(eq, ap[i].float(), bp[j].float())
        out = t if out is None else out + t
    return out


def _bwd_pieces(q, k, v, o, lse, do, causal, pieces, **seg):
    """The float32 backward as B2 and B3 compute it at ``pieces``: every
    product (S, dP, dQ, dK, dV) of split operands, P and dS in float32
    and split before the products that take them (dK and dV sum over the
    G query heads of a group inside the products). Returns float32 (dQ,
    dK, dV)."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    scale = 1.0 / np.sqrt(D)
    segs = fa._segments(q, k, seg.get("q_segment_ids"), None, None, None)
    delta = (do * o).sum(-1).reshape(B, Sq, Hk, G).permute(0, 2, 3, 1)
    delta = delta[..., None]
    lse5 = lse.reshape(B, Hk, G, Sq)[..., None]
    qg = q.reshape(B, Sq, Hk, G, D)
    dog = do.reshape(B, Sq, Hk, G, D)
    prod = functools.partial(_pieces_einsum, pieces=pieces)
    valid = fa._row_mask(Sq, Sk, causal, q.device, segs, 0, Sq)
    s = prod("bsngd,btnd->bngst", qg, k) * scale
    p = torch.where(valid, torch.exp(s.masked_fill(~valid, -1e30) - lse5),
                    torch.zeros_like(s))
    dp = prod("bsngd,btnd->bngst", dog, v)
    ds = p * (dp - delta) * scale
    dq = prod("bngst,btnd->bsngd", ds, k).reshape(B, Sq, Hq, D)
    dk = prod("bngst,bsngd->btnd", ds, qg)
    dv = prod("bngst,bsngd->btnd", p, dog)
    return dq, dk, dv


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("scale", [1.0, 1e-20, 1e30, 3.7e-3])
def test_split_pieces_rebuild_float32(scale):
    """b0 + b1 + b2 equals x to within 2^-24 of |x| (exactly, here), each
    piece what the ones before leave, rounded to bf16."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((3, 50, 2, 66)) * scale)
                         .astype(np.float32))
    x[0, 0, 0, :4] = torch.tensor([0.0, 1.0, -3.0e-7, 65504.0])
    p = fa.split_bf16x3_plain(x)
    assert p.shape == (3,) + tuple(x.shape) and p.dtype == torch.bfloat16
    rebuilt = p[0].double() + p[1].double() + p[2].double()
    err = (rebuilt - x.double()).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all())
    assert torch.equal(p[0], x.to(torch.bfloat16))
    assert torch.equal(p[1], (x - p[0].float()).to(torch.bfloat16))


def test_split_pads_the_head_dim_with_zeros():
    x = torch.randn(2, 5, 3, 80)
    p = fa.split_bf16x3_plain(x, 128)
    assert p.shape == (3, 2, 5, 3, 128)
    assert torch.equal(p[..., 80:], torch.zeros_like(p[..., 80:]))
    assert torch.equal(p[..., :80], fa.split_bf16x3_plain(x))


@pytest.mark.parametrize("pieces,rtol", [(3, 1e-6), (1, 3e-3)])
def test_pieces_product_against_float64(pieces, rtol):
    """One product of split operands: six terms within 1e-6 of float64's,
    one piece (bf16) only within bf16's 3e-3."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 128)).astype(np.float32))
    got = _pieces_einsum("id,jd->ij", a, b, pieces)
    ref = a.double() @ b.double().T
    assert _rel(got, ref) <= rtol


CASES = ["causal", "full", "seg-causal", "seg"]


def _case(name, seed=5):
    """B 1, S 128, Hq 4, Hk 2, D 64 float32 from numpy, the segment cases
    with three segments whose boundaries lie inside 64-token tiles."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v, do = f(1, 128, 4, 64), f(1, 128, 2, 64), f(1, 128, 2, 64), \
        f(1, 128, 4, 64)
    kw = {}
    if name.startswith("seg"):
        ids = np.searchsorted([0, 37, 101, 128], np.arange(128),
                              side="right") - 1
        kw["q_segment_ids"] = ids[None].astype(np.int32)
    return q, k, v, do, name.endswith("causal"), kw


def _pallas_vjp(q, k, v, do, causal, kw):
    """O, LSE and (dQ, dK, dV) of the Pallas kernels in interpret mode."""
    jkw = {n: jnp.asarray(a) for n, a in kw.items()}
    (o, lse), vjp = jax.vjp(
        lambda a, b, c: pallas_flash(a, b, c, causal=causal,
                                     return_lse=True, **jkw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp((jnp.asarray(do), jnp.zeros_like(lse)))
    return np.asarray(o), np.asarray(lse), [np.asarray(r) for r in refs]


def _pieces(q, k, v, do, causal, kw, o, lse, pieces):
    t = lambda a: torch.from_numpy(np.array(a))
    return _bwd_pieces(t(q), t(k), t(v), t(o), t(lse), t(do), causal,
                       pieces, **{n: t(a) for n, a in kw.items()})


@pytest.mark.parametrize("name", CASES)
def test_six_term_backward_matches_pallas_vjp(name):
    """The kernels' float32 arithmetic (three pieces, six terms a
    product, P and dS split) gives the Pallas VJP's dQ, dK and dV within
    1e-5 of each gradient's largest entry."""
    q, k, v, do, causal, kw = _case(name)
    o, lse, refs = _pallas_vjp(q, k, v, do, causal, kw)
    got = _pieces(q, k, v, do, causal, kw, o, lse, 3)
    for n, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert g.dtype == torch.float32
        assert _rel(g.numpy(), r) <= PIECES_RTOL, n


@pytest.mark.parametrize("name", CASES)
def test_one_piece_backward_fails_the_float32_gate(name):
    """Plain bf16 products (one piece) miss the float32 gradients by more
    than the card's float32 gate: a kernel that dropped the small pieces
    would fail it."""
    q, k, v, do, causal, kw = _case(name)
    o, lse, refs = _pallas_vjp(q, k, v, do, causal, kw)
    got = _pieces(q, k, v, do, causal, kw, o, lse, 1)
    worst = max(_rel(g.numpy(), r) for g, r in zip(got, refs))
    assert worst > F32_BWD_RTOL


@pytest.mark.parametrize("device,dtype,Hq,Hk,D,mode,route,fwd", [
    ("cuda", torch.float32, 32, 8, 128, "auto", "split", "split"),
    ("cuda", torch.float32, 16, 16, 64, "auto", "split", "split"),
    ("cuda", torch.float32, 24, 8, 80, "auto", "split", "split"),  # G 3
    ("cuda", torch.float32, 32, 8, 1, "auto", "split", "split"),
    ("cuda", torch.float16, 32, 8, 128, "auto", "f16", "f16"),
    ("cuda", torch.float16, 96, 8, 64, "auto", "f16", "f16"),     # G 12
    ("cuda", torch.float32, 32, 8, 129, "auto", "simt", "split"),
    ("cuda", torch.float32, 16, 4, 256, "auto", "simt", "split"),
    ("cuda", torch.float16, 16, 4, 160, "auto", "simt", "f16"),
    ("cuda", torch.bfloat16, 32, 8, 128, "auto", "kernel", "kernel"),
    ("cuda", torch.bfloat16, 32, 8, 512, "auto", "kernel", "kernel"),
    ("cuda", torch.bfloat16, 24, 8, 64, "auto", "expanded", "expanded"),
    ("cuda", torch.float32, 32, 8, 128, "plain", "forced", "forced"),
    ("cpu", torch.float32, 32, 8, 128, "auto", "cpu", "cpu"),
    ("cpu", torch.float16, 32, 8, 64, "plain", "cpu", "cpu"),
])
def test_flash_bwd_route_maps_dtype_and_head_dim(device, dtype, Hq, Hk, D,
                                                 mode, route, fwd):
    """float32 and fp16 up to head dim 128 take the tensor-core B2/B3
    (``split``, ``f16``), above it the CUDA cores' kernels; their forward
    (``flash_route``) takes the tensor-core B1 at every head dim. Every
    other route is the forward's."""
    assert fa.flash_bwd_route(device, dtype, Hq, Hk, D, mode) == route
    assert fa.flash_route(device, dtype, Hq, Hk, D, mode) == fwd


def test_cpu_backward_counts_its_route_once():
    q = torch.randn(1, 9, 4, 64, requires_grad=True)
    k = torch.randn(1, 9, 2, 64, requires_grad=True)
    before = dict(fa.BWD_ROUTE_COUNTS)
    fa.scaled_dot_product_attention(q, k, k, is_causal=True).sum().backward()
    assert {n: fa.BWD_ROUTE_COUNTS[n] - before[n] for n in before} == \
        {n: int(n == "cpu") for n in before}


def test_piece_wrappers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 2, 64)
    p = fa.split_bf16x3_plain(x)
    s = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fa.split_bf16x3_cuda(x)
    with pytest.raises(ValueError, match="pieces"):
        fa.flash_bwd_dq_x3_cuda(p, p, p, p, s, s, causal=True)
    with pytest.raises(ValueError, match="pieces"):
        fa.flash_bwd_dkv_x3_cuda(p, p, p, p, s, s, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq_cuda(x.half(), x.half(), x.half(), x.half(), s, s)
