"""PyTorch port: float32 flash forward (B1) and float32 int8-weight matmul
(B7) on the tensor cores as three bf16 pieces, on the CPU.

``csrc/flash_fwd.cu`` ``flash_fwd_tc_kernel`` (P 3) takes float32 q, k, v
as three bf16 pieces each (``split_bf16x3_plain``'s rule) and keeps, of
S = Q K^T and of O += P V, the six terms whose pieces' indices sum to at
most 2; P stays float32 and is split in registers. ``csrc/quant_matmul.cu``
at float32 x multiplies each of x's three pieces by the int8 weight, which
is exact in bf16: three products, each exact in float32, summed, then the
scale. ``_fwd_pieces`` and ``_qmm_pieces`` below are that arithmetic in
plain PyTorch. They are held against the Pallas kernels in interpret mode,
inputs from numpy with a seed: the six-term forward within 1e-5 of each
row's largest |O| (O and LSE), the three-term product within 1e-6 of the
largest |y|. One piece (plain bf16) misses the card's float32 gate
(chip_smoke.py ``SIMT_RTOL["float32"]``, 1e-4) in both, so that gate
tells the two apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_attention import (
    flash_attention as pallas_flash)
from paddle_tpu.kernels.pallas.quant_matmul import (
    quant_matmul as pallas_qmm)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import quant_matmul as qm

# the card's float32 forward and int8-matmul gate (chip_smoke.py)
F32_RTOL = 1e-4
ROW_RTOL = 1e-5
QMM_RTOL = 1e-6

# the (A piece, B piece) terms of a product of two split operands, small
# ones first (``flash_common.cuh`` ``term_a``, ``term_b``)
_TERMS = {1: ((0, 0),),
          3: ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))}


def _prod(eq, a, b, pieces):
    ap, bp = fa.split_bf16x3_plain(a), fa.split_bf16x3_plain(b)
    out = None
    for i, j in _TERMS[pieces]:
        t = torch.einsum(eq, ap[i].float(), bp[j].float())
        out = t if out is None else out + t
    return out


def _fwd_pieces(q, k, v, causal, pieces, q_segment_ids=None, scale=None):
    """B1's float32 forward at ``pieces``: S of split q and k (times
    ``scale``, default 1 / sqrt(D)), the softmax in float32 (unnormalized
    P, its row sum l), P V of split P and split V, O = P V / l (0 where no
    key is visible), LSE = m + log l (+1e30 there). Returns float32 (O [B,
    Sq, Hq, D], LSE [B, Hq, Sq])."""
    B, Sq, Hq, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    G = Hq // Hk
    segs = fa._segments(q, k, q_segment_ids, None, None, None)
    qg = q.reshape(B, Sq, Hk, G, D)
    scale = 1.0 / np.sqrt(D) if scale is None else scale
    s = _prod("bsngd,btnd->bngst", qg, k, pieces) * scale
    valid = fa._row_mask(Sq, Sk, causal, q.device, segs, 0, Sq)
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    live = l > 0
    inv = torch.where(live, 1.0 / torch.where(live, l, torch.ones_like(l)),
                      torch.zeros_like(l))
    o = _prod("bngst,btnd->bsngd", p, v, pieces) * inv.permute(0, 3, 1, 2, 4)
    lse = torch.where(live, m + torch.log(torch.where(live, l,
                                                      torch.ones_like(l))),
                      torch.full_like(l, 1e30))
    return o.reshape(B, Sq, Hq, D), lse[..., 0].reshape(B, Hq, Sq)


def _row_rel(out, ref):
    """Per (batch, position, head) row: max |out - ref| / max |ref|; a row
    whose reference is 0 (no visible key) must be 0."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(out - ref).max(-1)
    scale = np.abs(ref).max(-1)
    assert not (diff[scale == 0] > 0).any()
    return (diff[scale > 0] / scale[scale > 0]).max()


# (B, Sq, Sk, Hq, Hk, D, causal, segments)
FWD_CASES = {
    "causal-g4-d64": (1, 96, 96, 8, 2, 64, True, False),
    "full-g1-d128": (2, 40, 40, 2, 2, 128, False, False),
    "causal-g3-d80": (1, 70, 70, 6, 2, 80, True, False),
    "sq-lt-sk-g4-d128": (1, 33, 100, 4, 1, 128, True, False),
    "sq-gt-sk-masked-rows": (1, 48, 20, 4, 4, 64, True, False),
    "full-sq-ne-sk-g3-d64": (1, 30, 75, 3, 1, 64, False, False),
    "seg-causal-g4-d64": (1, 128, 128, 4, 1, 64, True, True),
}


# head dims above 128, which the kernels run zero-padded to
# ``padded_head_dim`` (160 -> 256, 288 -> 384) on the three-piece B1
# (flash_fwd_tc_kernel at 256, flash_fwd_xl_kernel above)
WIDE_FWD_CASES = {
    "causal-g4-d160": (1, 96, 96, 8, 2, 160, True, False),
    "full-g2-d288": (1, 40, 72, 4, 2, 288, False, False),
    "seg-causal-g4-d160": (1, 128, 128, 4, 1, 160, True, True),
    "sq-lt-sk-g1-d288": (1, 33, 100, 2, 2, 288, True, False),
}


def _fwd_case(name, seed=11):
    B, Sq, Sk, Hq, Hk, D, causal, seg = {**FWD_CASES, **WIDE_FWD_CASES}[name]
    rng = np.random.default_rng(seed + Sq + D)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(B, Sq, Hq, D), f(B, Sk, Hk, D), f(B, Sk, Hk, D)
    kw = {}
    if seg:
        ids = np.searchsorted([0, 37, 101, Sq], np.arange(Sq),
                              side="right") - 1
        kw["q_segment_ids"] = np.tile(ids[None], (B, 1)).astype(np.int32)
    return q, k, v, causal, kw


def _fwd_both(name, pieces, dp=None):
    """(O, LSE) of the ``pieces`` arithmetic, with the head dim
    zero-padded to ``dp`` (at the true D's scale) and O sliced back as
    ``FlashAttention`` does, and the Pallas forward's on the same
    inputs."""
    q, k, v, causal, kw = _fwd_case(name)
    D = q.shape[-1]
    o_ref, lse_ref = pallas_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        return_lse=True, **{n: jnp.asarray(a) for n, a in kw.items()})
    o, lse = _fwd_pieces(*(fa.pad_head_dim(torch.from_numpy(a), dp or D)
                           for a in (q, k, v)), causal, pieces,
                         scale=1.0 / np.sqrt(D),
                         **{n: torch.from_numpy(a) for n, a in kw.items()})
    return o[..., :D], lse, np.asarray(o_ref), np.asarray(lse_ref)


@pytest.mark.parametrize("name", list(FWD_CASES))
def test_six_term_forward_matches_pallas(name):
    """The kernel's float32 arithmetic (three pieces, six terms a product,
    P split) gives the Pallas forward's O within 1e-5 of each row's
    largest entry and its LSE within 1e-5 relative; a fully masked row
    gives O = 0 and LSE = +1e30 on both sides."""
    o, lse, o_ref, lse_ref = _fwd_both(name, 3)
    assert o.dtype == torch.float32
    assert _row_rel(o.numpy(), o_ref) <= ROW_RTOL
    lse, lse_ref = lse.numpy().astype(np.float64), lse_ref.astype(np.float64)
    assert np.all(np.abs(lse - lse_ref) <= ROW_RTOL * np.maximum(
        1.0, np.abs(lse_ref)))
    if FWD_CASES[name][1] > FWD_CASES[name][2] and FWD_CASES[name][6]:
        dead = FWD_CASES[name][1] - FWD_CASES[name][2]  # rows before keys
        assert np.all(o.numpy()[:, :dead] == 0)
        assert np.all(lse[:, :, :dead] == np.float32(1e30))


@pytest.mark.parametrize("name", list(WIDE_FWD_CASES))
def test_six_term_forward_padded_above_128_matches_pallas(name):
    """Above head dim 128 (the three-piece B1: the tc kernel at 256, the
    xl kernel above): q, k and v zero-padded to ``padded_head_dim`` (160
    -> 256, 288 -> 384) before the split, S at the true D's scale, O
    sliced back to D: O within float32's
    gate (1e-4 of each row's largest entry) and LSE within 1e-4 relative
    of the Pallas forward, which pads D to a multiple of 128 itself."""
    D = WIDE_FWD_CASES[name][5]
    dp = fa.padded_head_dim(D)
    assert dp in (256, 384) and dp % 128 == 0
    o, lse, o_ref, lse_ref = _fwd_both(name, 3, dp)
    assert o.shape[-1] == D
    assert _row_rel(o.numpy(), o_ref) <= F32_RTOL
    lse, lse_ref = lse.numpy().astype(np.float64), lse_ref.astype(np.float64)
    assert np.all(np.abs(lse - lse_ref) <= F32_RTOL * np.maximum(
        1.0, np.abs(lse_ref)))
    # one piece (plain bf16) at the same padding misses the gate
    o1, _, _, _ = _fwd_both(name, 1, dp)
    assert _row_rel(o1.numpy(), o_ref) > F32_RTOL


@pytest.mark.parametrize("name", ["causal-g4-d64", "full-g1-d128",
                                  "causal-g3-d80"])
def test_one_piece_forward_fails_the_float32_gate(name):
    """Plain bf16 products (one piece) miss float32's O by more than the
    card's float32 gate: a kernel that dropped the small pieces would
    fail it."""
    o, _, o_ref, _ = _fwd_both(name, 1)
    assert _row_rel(o.numpy(), o_ref) > F32_RTOL


def _qmm_pieces(x, w_int8, w_scales, pieces):
    """B7's float32 product at ``pieces``: each piece of x times the int8
    weight (exact in bf16) in float32, small pieces first, then the
    scale. x [M, K] float32, w_int8 [N, K], w_scales [N]."""
    xp = fa.split_bf16x3_plain(x)
    w = w_int8.float()
    acc = None
    for p in reversed(range(pieces)):
        t = xp[p].float() @ w.T
        acc = t if acc is None else acc + t
    return acc * w_scales.float()[None, :]


def _qmm_case(M, N, K, seed=21):
    rng = np.random.default_rng(seed + M + K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    s = (rng.random(N).astype(np.float32) + 0.5) / 127
    ref = pallas_qmm(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(s),
                     interpret=True)
    return x, w, s, np.asarray(ref)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("M,N,K", [(1, 40, 64), (8, 72, 256),
                                   (9, 64, 128), (37, 100, 512)])
def test_three_term_int8_matmul_matches_pallas(M, N, K):
    """float32 x as three bf16 pieces against the int8 weight gives the
    Pallas kernel's y (x @ (w * s) in float32) within 1e-6 of its largest
    entry, at decode (M <= 8) and prefill sizes."""
    x, w, s, ref = _qmm_case(M, N, K)
    got = _qmm_pieces(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(s), 3)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert _rel(got.numpy(), ref) <= QMM_RTOL
    # the plain version the card holds the kernel to agrees as well
    plain = qm.quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(s))
    assert _rel(plain.numpy(), ref) <= QMM_RTOL


@pytest.mark.parametrize("M,N,K", [(8, 72, 33), (37, 100, 100),
                                   (9, 40, 4100), (1, 64, 4100)])
def test_int8_matmul_at_ragged_k_matches_pallas(M, N, K):
    """At K not a multiple of 16 (the ragged loaders' shapes: decode and
    prefill): the plain version the card holds the kernels to, and float32
    x's three-term product with x's pieces zero-padded to a multiple of
    16 (the split pass's padding; the kernels zero-fill w past K), both
    within 1e-6 of the largest |y| of the Pallas kernel, which takes K
    whole."""
    x, w, s, ref = _qmm_case(M, N, K)
    plain = qm.quant_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(s))
    assert _rel(plain.numpy(), ref) <= QMM_RTOL
    kp = -(-K // qm.K_ALIGN) * qm.K_ALIGN
    pad = lambda a: torch.nn.functional.pad(torch.from_numpy(a), (0, kp - K))
    got = _qmm_pieces(pad(x), pad(w), torch.from_numpy(s), 3)
    assert got.shape == (M, N) and _rel(got.numpy(), ref) <= QMM_RTOL


@pytest.mark.parametrize("M,N,K", [(8, 72, 256), (37, 100, 512)])
def test_one_piece_int8_matmul_fails_the_float32_gate(M, N, K):
    """x rounded to bf16 (one piece) misses float32's y by more than the
    card's float32 gate."""
    x, w, s, ref = _qmm_case(M, N, K)
    got = _qmm_pieces(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(s), 1)
    assert _rel(got.numpy(), ref) > F32_RTOL


@pytest.mark.parametrize("lo", [0, 7])
def test_fp16_weight_bias_trick_is_exact(lo):
    """The fp16 route's int8 -> fp16 conversion (``i8x4_f16``): byte
    q + 128 as the low byte of 1024's fp16 pattern is 1024 + q + 128,
    exact, and subtracting 1152 leaves q, for every q in [-128, 127]."""
    q = np.arange(-128, 128, dtype=np.int64)[lo:]
    bits = (0x6400 | (q + 128)).astype(np.uint16)
    h = bits.view(np.float16)
    assert np.array_equal(h.astype(np.float64), 1024.0 + q + 128)
    back = (h - np.float16(1152.0)).astype(np.float64)
    assert np.array_equal(back, q.astype(np.float64))


def test_routes_and_wrappers_refuse_cpu_pieces():
    """The three-piece forward wrapper takes pieces on the card only; the
    int8 wrappers give the plain version for CPU tensors, launching
    nothing."""
    p = fa.split_bf16x3_plain(torch.zeros(1, 4, 2, 64))
    with pytest.raises(ValueError, match="pieces"):
        fa.flash_fwd_x3_cuda(p, p, p, causal=True)
    x = torch.randn(3, 32)
    w = torch.randint(-127, 128, (8, 32), dtype=torch.int8)
    s = torch.rand(8)
    before = (qm.quant_matmul_x3.launches, qm.quant_matmul_f16.launches)
    assert torch.equal(qm.quant_matmul_x3(x, w, s),
                       qm.quant_matmul_plain(x, w, s))
    assert torch.equal(qm.quant_matmul_f16(x.half(), w, s),
                       qm.quant_matmul_plain(x.half(), w, s))
    assert (qm.quant_matmul_x3.launches,
            qm.quant_matmul_f16.launches) == before
