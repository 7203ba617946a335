"""PyTorch port: segment-id and packed varlen flash attention against the
JAX package.

The JAX side is ``paddle_tpu.kernels.pallas.flash_attention``'s
``flash_attention(q_segment_ids=...)`` and ``flash_attn_varlen`` in Pallas
interpret mode (the ``has_seg`` branch of ``_fwd_kernel``, ``_dq_kernel``
and ``_dkv_kernel``), and ``paddle_tpu.nn.functional``'s
``flash_attn_unpadded`` and ``flash_attn_varlen_qkvpacked``. The port side
runs on the CPU, so ``FlashAttention`` takes the plain pair
(``flash_attention_plain``, ``flash_attention_bwd_plain``): the math the
segment branch of the CUDA kernels is held against on the card. Inputs
come from numpy with a seed; float32, atol 1e-5, rtol 1e-5.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.pallas import flash_attention as pallas
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import functional as TF

TOL = dict(atol=1e-5, rtol=1e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _ids(kind, B, S):
    pos = np.arange(S)
    if kind == "monotone":      # three segments, boundaries inside tiles
        one = np.searchsorted([0, 37, 101, S], pos, side="right") - 1
    elif kind == "nonmonotone":  # ids repeat: 0 1 2 0 1 2 ...
        one = (pos // 24) % 3
    else:                        # ring attention's shape: one segment
        one = np.zeros(S, np.int64)
    return np.broadcast_to(one, (B, S)).astype(np.int32)


def _case(name):
    """(q, k, v, causal, kwargs) of one named segment case, B 2, D 64."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    B, S, D = 2, 128, 64
    Hq, Hk = {"g1": (2, 2)}.get(name.split("-")[0], (4, 1))
    q, k, v = _randn(rng, B, S, Hq, D), _randn(rng, B, S, Hk, D), \
        _randn(rng, B, S, Hk, D)
    causal = "causal" in name
    kw = {"q_segment_ids": _ids("nonmonotone" if "nonmono" in name
                                else "monotone", B, S)}
    if "ring" in name:
        # ids all 0, global positions: this shard's queries come 64 after
        # its keys (``distributed/ring_attention.py:100``)
        kw = {"q_segment_ids": _ids("ring", B, S),
              "q_positions": np.broadcast_to(np.arange(S) + 64, (B, S))
              .astype(np.int32),
              "kv_positions": np.broadcast_to(np.arange(S), (B, S))
              .astype(np.int32)}
    if "orphan" in name:
        # q id 5 appears on no key: those rows see nothing
        kv = kw["q_segment_ids"].copy()
        qs = kv.copy()
        qs[:, 40:50] = 5
        kw = {"q_segment_ids": qs, "kv_segment_ids": kv}
    if "scale" in name:
        kw["scale"] = 0.37
    return q, k, v, causal, kw


CASES = ["g1-causal-mono", "g4-causal-nonmono", "g4-mono", "g1-nonmono",
         "g4-causal-ring", "g4-causal-orphan", "g4-causal-mono-scale"]


def _pallas(q, k, v, causal, kw, **extra):
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    return pallas.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, **jkw,
                                  **extra)


def _torch_kw(kw):
    return {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
            for n, a in kw.items()}


@pytest.mark.parametrize("name", CASES)
def test_plain_segment_forward_matches_pallas(name):
    q, k, v, causal, kw = _case(name)
    o_ref, lse_ref = _pallas(q, k, v, causal, kw, return_lse=True)
    o, lse = fa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_lse=True, **_torch_kw(kw))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)
    if "orphan" in name:
        assert torch.all(o[:, 40:50] == 0)
        assert torch.all(lse.reshape(2, -1, 128)[:, :, 40:50] == 1e30)


@pytest.mark.parametrize("name", ["g1-causal-mono", "g4-causal-nonmono",
                                  "g4-causal-orphan", "g4-mono-scale"])
def test_segment_backward_matches_pallas_vjp(name):
    """``flash_attention`` on CPU tensors (``FlashAttention`` over the
    plain pair) against ``jax.vjp`` of the Pallas version, with cotangents
    on O and on LSE (the LSE cotangent folds into Delta, Pallas :726)."""
    q, k, v, causal, kw = _case(name)
    rng = np.random.default_rng(9)
    do = _randn(rng, *q.shape)
    dlse = _randn(rng, q.shape[0], q.shape[2], q.shape[1])
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    (o_ref, lse_ref), vjp = jax.vjp(
        lambda a, b, c: pallas.flash_attention(a, b, c, causal=causal,
                                               return_lse=True, **jkw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = fa.flash_attention(*ts, causal=causal, return_lse=True,
                                **_torch_kw(kw))
    torch.autograd.backward((o, lse), (torch.from_numpy(do),
                                       torch.from_numpy(dlse)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), **TOL)
    for n, t, r in zip(("dq", "dk", "dv"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL,
                                   err_msg=n)
    if "orphan" in name:  # rows that see no key get no gradient
        assert torch.all(ts[0].grad[:, 40:50] == 0)


def test_unseen_keys_and_rows_get_zero_gradients():
    """Keys whose id no query has, and queries whose id no key has: dK, dV
    and dQ are exactly 0 there, and nothing is NaN."""
    rng = np.random.default_rng(3)
    q, do = _randn(rng, 1, 96, 4, 64), _randn(rng, 1, 96, 4, 64)
    k, v = _randn(rng, 1, 96, 2, 64), _randn(rng, 1, 96, 2, 64)
    qs = np.zeros((1, 96), np.int32)
    ks = np.zeros((1, 96), np.int32)
    qs[:, 60:] = 1       # rows 60.. see no key
    ks[:, 20:30] = 2     # keys 20..29 are seen by no query
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=True,
                             q_segment_ids=torch.from_numpy(qs),
                             kv_segment_ids=torch.from_numpy(ks))
    out.backward(torch.from_numpy(do))
    dq, dk, dv = (t.grad for t in ts)
    assert torch.all(out[:, 60:] == 0) and torch.all(dq[:, 60:] == 0)
    assert torch.all(dk[:, 20:30] == 0) and torch.all(dv[:, 20:30] == 0)
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))
    assert dk[:, :20].abs().sum() > 0


def _packed(rng, tq, tk, hq=4, hk=2, d=64):
    return _randn(rng, tq, hq, d), _randn(rng, tk, hk, d), \
        _randn(rng, tk, hk, d)


VARLEN = {
    "three": ([0, 100, 130, 256], [0, 100, 130, 256]),
    # q holds each sequence's last tokens only: bottom-right shift
    "cross": ([0, 10, 40, 41, 105], [0, 70, 100, 150, 214]),
    "empty": ([0, 50, 50, 128], [0, 50, 50, 128]),
    # more q sequences than kv ones: the clamp of len_k decides
    "more_q": ([0, 30, 60, 90, 120], [0, 64, 128]),
}


@pytest.mark.parametrize("name,causal", [
    ("three", True), ("three", False), ("cross", True), ("empty", True),
    ("more_q", True)])
def test_flash_attn_varlen_matches_pallas(name, causal):
    cu_q, cu_k = (np.asarray(c, np.int32) for c in VARLEN[name])
    rng = np.random.default_rng(len(name))
    q, k, v = _packed(rng, int(cu_q[-1]), int(cu_k[-1]))
    ref = pallas.flash_attn_varlen(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(cu_q),
                                   jnp.asarray(cu_k), causal=causal)
    out = fa.flash_attn_varlen(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(cu_q),
                               torch.from_numpy(cu_k), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_varlen_does_not_leak_across_sequences():
    """Changing every key and value of sequence 1 leaves the outputs of
    sequences 0 and 2 bit for bit as they were."""
    cu = torch.tensor([0, 100, 130, 256])
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _packed(rng, 256, 256))
    out = fa.flash_attn_varlen(q, k, v, cu, cu, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[100:130] += 3.0
    v2[100:130] -= 5.0
    out2 = fa.flash_attn_varlen(q, k2, v2, cu, cu, causal=True)
    assert torch.equal(out[:100], out2[:100])
    assert torch.equal(out[130:], out2[130:])
    assert not torch.allclose(out[100:130], out2[100:130])


def test_varlen_segments_match_the_reference_derivation():
    """Ids and positions as Pallas :852-868 derives them, including tokens
    before cu[0] and past cu[-1] (JAX's gather wraps a negative index and
    clamps one out of range)."""
    cu_q = np.array([3, 10, 12], np.int32)
    cu_k = np.array([0, 5], np.int32)
    tq, tk = 15, 8
    jcu_q, jcu_k = jnp.asarray(cu_q), jnp.asarray(cu_k)
    pos_q, pos_k = jnp.arange(tq), jnp.arange(tk)
    seg_q = jnp.searchsorted(jcu_q, pos_q, side="right") - 1
    seg_k = jnp.searchsorted(jcu_k, pos_k, side="right") - 1
    len_q = jcu_q[seg_q + 1] - jcu_q[seg_q]
    len_k_q = jcu_k[jnp.minimum(seg_q + 1, 1)] - jcu_k[jnp.minimum(seg_q, 1)]
    want = (seg_q, seg_k, pos_q - jcu_q[seg_q] + (len_k_q - len_q),
            pos_k - jcu_k[seg_k])
    got = fa.varlen_segments(torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                             tq, tk, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("packed", [False, True])
def test_functional_unpadded_matches_paddle_tpu(packed):
    """``nn.functional.flash_attn_unpadded`` and
    ``flash_attn_varlen_qkvpacked`` against ``paddle_tpu.nn.functional``'s,
    causal, scale 0.2, dropout 0."""
    cu = np.array([0, 100, 130, 256], np.int32)
    rng = np.random.default_rng(6)
    qkv = _randn(rng, 256, 3, 4, 64)
    jcu = paddle.to_tensor(cu)
    tcu = torch.from_numpy(cu)
    if packed:
        ref, none = JF.flash_attn_varlen_qkvpacked(
            paddle.to_tensor(qkv), jcu, jcu, 130, 130, 0.2, causal=True)
        out, tnone = TF.flash_attn_varlen_qkvpacked(
            torch.from_numpy(qkv), tcu, tcu, 130, 130, 0.2, causal=True)
    else:
        q, k, v = (np.ascontiguousarray(qkv[:, i]) for i in range(3))
        ref, none = JF.flash_attn_unpadded(
            *(paddle.to_tensor(a) for a in (q, k, v)), jcu, jcu, 130, 130,
            0.2, causal=True)
        out, tnone = TF.flash_attn_unpadded(
            *(torch.from_numpy(a) for a in (q, k, v)), tcu, tcu, 130, 130,
            0.2, causal=True)
    assert none is None and tnone is None
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_functional_flash_attention_returns_out_and_none():
    rng = np.random.default_rng(8)
    q, k, v = (_randn(rng, 2, 40, 4, 64) for _ in range(3))
    ref, none = JF.flash_attention(*(paddle.to_tensor(a) for a in (q, k, v)),
                                   causal=True)
    out, tnone = TF.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                    causal=True)
    assert none is None and tnone is None
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_unpadded_dropout_drops_output_entries():
    """Dropout > 0: the identity when ``training=False``; in training it
    zeroes entries of the output and scales the rest by 1/(1-p), the mask
    drawn from the generator (the same seed, the same output)."""
    cu = torch.tensor([0, 20, 64])
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(a) for a in _packed(rng, 64, 64))
    args = (q, k, v, cu, cu, 44, 44, 0.125)
    base, _ = TF.flash_attn_unpadded(*args, causal=True)
    off, _ = TF.flash_attn_unpadded(*args, dropout=0.5, causal=True,
                                    training=False)
    assert torch.equal(off, base)
    runs = [TF.flash_attn_unpadded(
        *args, dropout=0.5, causal=True,
        generator=torch.Generator().manual_seed(11))[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    kept = runs[0] != 0
    assert 0.3 < kept.float().mean().item() < 0.7
    torch.testing.assert_close(runs[0][kept], base[kept] * 2.0)


def test_segment_wrappers_refuse_cpu_and_partial_segments():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd_cuda(q, q, q, q_segment_ids=ids, kv_segment_ids=ids,
                          q_positions=ids, kv_positions=ids)
    with pytest.raises(ValueError, match="segment branch takes all"):
        fa._check_seg("flash_fwd", q, q, (ids, None, None, None))

