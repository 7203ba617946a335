"""PyTorch port: plain flash forward vs the JAX package's Pallas kernel.

The JAX side is ``paddle_tpu.kernels.pallas.flash_attention.flash_attention``
in Pallas interpret mode (its CPU route), the port side is
``flash_attention_plain`` — the math the CUDA kernel
(``paddle_tpu_torch/kernels/csrc/flash_fwd.cu``) is held against on the
card. Inputs come from numpy with a seed; float32, atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.pallas.flash_attention import (
    flash_attention as pallas_flash)
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_plain, flash_fwd_cuda, scaled_dot_product_attention)

ATOL = 1e-5


def _inputs(B, Sq, Sk, Hq, Hk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hk, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal", [
    (1, 16, 16, 4, 4, 32, True),     # G = 1
    (2, 20, 20, 8, 2, 32, True),     # G = 4, Sq not a tile multiple
    (2, 20, 20, 8, 2, 32, False),
    (1, 13, 40, 8, 2, 32, True),     # Sq < Sk: bottom-right causal
    (1, 13, 40, 4, 4, 32, False),
    (1, 24, 10, 4, 2, 32, True),     # Sq > Sk: fully masked top rows
])
def test_plain_flash_matches_pallas(B, Sq, Sk, Hq, Hk, D, causal):
    q, k, v = _inputs(B, Sq, Sk, Hq, Hk, D)
    o_ref, lse_ref = pallas_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  return_lse=True)
    o, lse = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL,
                               rtol=1e-6)


def test_fully_masked_rows_give_zero_and_big_lse():
    q, k, v = _inputs(1, 6, 2, 2, 1, 16)
    o, lse = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   return_lse=True)
    # off = Sk - Sq = -4: query rows 0..3 see no key
    assert torch.all(o[:, :4] == 0)
    assert torch.all(lse[:, :, :4] == 1e30)
    assert torch.all(lse[:, :, 4:] < 1e29)


def test_sdpa_takes_plain_route_on_cpu():
    q, k, v = _inputs(1, 9, 9, 4, 2, 16)
    before = flash_fwd_cuda.launches
    out = scaled_dot_product_attention(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), is_causal=True)
    ref = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True)
    assert torch.equal(out, ref)
    assert flash_fwd_cuda.launches == before


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
               for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, k, v, causal=True)


@pytest.mark.parametrize("D,causal", [(256, True), (256, False),
                                      (160, True), (288, True),
                                      (384, False), (512, True)])
def test_plain_pair_at_wide_head_dims_matches_pallas(D, causal):
    """Head dims above 128: the kernels run 160 and 256 at 256 (Gemma's
    256), and above 256 at the next multiple of 128 (288 at 384; 384 and
    512 as they are). The plain pair the kernels are held to on the card,
    forward and backward through ``FlashAttention`` on CPU tensors,
    against the Pallas kernels in interpret mode (which pad D to a
    multiple of 128)."""
    import jax
    rng = np.random.default_rng(D + causal)
    q, k, v, do = (rng.standard_normal((1, 24, h, D)).astype(np.float32)
                   for h in (4, 2, 2, 4))
    o_ref, vjp = jax.vjp(
        lambda q_, k_, v_: pallas_flash(q_, k_, v_, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = scaled_dot_product_attention(*ts, is_causal=causal)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_ref),
                               atol=ATOL)
    for name, t, r in zip(("dq", "dk", "dv"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=ATOL, err_msg=name)


def test_plain_pair_with_segments_at_head_dim_384_matches_pallas():
    """The segment branch above head dim 256 (``has_seg`` in Pallas): D
    384, G 2, causal, three packed sequences with boundaries inside the
    rows and a caller's scale; O, LSE and the gradients of q, k, v
    through ``flash_attention`` on CPU tensors (the plain pair) against
    the Pallas kernels in interpret mode."""
    import jax
    from paddle_tpu_torch.kernels.flash_attention import flash_attention
    D, S = 384, 40
    rng = np.random.default_rng(384)
    q, k, v, do = (rng.standard_normal((1, S, h, D)).astype(np.float32)
                   for h in (4, 2, 2, 4))
    ids = (np.searchsorted([0, 7, 23, S], np.arange(S), side="right") - 1
           ).astype(np.int32)[None]
    (o_ref, lse_ref), vjp = jax.vjp(
        lambda q_, k_, v_: pallas_flash(q_, k_, v_, causal=True, scale=0.05,
                                        q_segment_ids=jnp.asarray(ids),
                                        return_lse=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp((jnp.asarray(do), jnp.zeros_like(lse_ref)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = flash_attention(*ts, causal=True, scale=0.05,
                               q_segment_ids=torch.from_numpy(ids),
                               return_lse=True)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_ref),
                               atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_ref),
                               atol=ATOL, rtol=1e-6)
    for name, t, r in zip(("dq", "dk", "dv"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   atol=ATOL, err_msg=name)


def test_padded_head_dim_maps_up_to_256_and_raises_above():
    """The kernels' head dims: 64, 128 and 256 up to 256, and above 256 the
    next multiple of 128, as the Pallas kernel pads D. Since the kernels
    took every multiple of 128 above 256 no D raises (the name is the
    earlier rule's)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        kernel_head_dim, padded_head_dim)
    dims = (1, 64, 65, 128, 129, 192, 256, 257, 288, 384, 385, 512, 640)
    assert [padded_head_dim(d) for d in dims] == \
        [64, 64, 128, 128, 256, 256, 256, 384, 384, 384, 512, 512, 640]
    assert all(kernel_head_dim(padded_head_dim(d)) for d in range(1, 1100))
    assert [kernel_head_dim(d) for d in (64, 96, 256, 288, 384, 512)] == \
        [True, False, True, False, True, True]
    # the plain route computes any head dim
    q = torch.randn(1, 5, 2, 288)
    assert flash_attention_plain(q, q, q, causal=True).shape == q.shape


@pytest.mark.parametrize("device,dtype,Hq,Hk,D,mode,route", [
    ("cuda", torch.bfloat16, 32, 8, 128, "auto", "kernel"),     # G 4
    ("cuda", torch.bfloat16, 16, 16, 64, "auto", "kernel"),     # G 1
    ("cuda", torch.bfloat16, 64, 1, 128, "auto", "kernel"),     # G 64
    ("cuda", torch.bfloat16, 24, 8, 128, "auto", "expanded"),   # G 3
    ("cuda", torch.bfloat16, 96, 8, 64, "auto", "expanded"),    # G 12
    ("cuda", torch.bfloat16, 128, 1, 128, "auto", "expanded"),  # G 128
    ("cuda", torch.float32, 32, 8, 128, "auto", "split"),
    ("cuda", torch.float16, 32, 8, 128, "auto", "f16"),
    ("cuda", torch.float32, 24, 8, 80, "auto", "split"),       # G 3
    ("cuda", torch.float16, 96, 8, 64, "auto", "f16"),         # G 12
    ("cuda", torch.float32, 32, 8, 160, "auto", "split"),      # D > 128
    ("cuda", torch.float16, 16, 4, 160, "auto", "f16"),
    ("cuda", torch.float64, 32, 8, 128, "auto", "kernel"),     # refused there
    ("cuda", torch.bfloat16, 32, 8, 128, "plain", "forced"),
    ("cuda", torch.float32, 32, 8, 128, " Plain ", "forced"),
    ("cpu", torch.bfloat16, 32, 8, 128, "auto", "cpu"),
    ("cpu", torch.float32, 24, 8, 160, "plain", "cpu"),
])
def test_flash_route_maps_dtype_and_group_to_a_route(device, dtype, Hq, Hk,
                                                     D, mode, route):
    """``FlashAttention``'s forward route from the device, dtype, group,
    head dim and ``FLAGS_flash_kernel`` alone: bf16 takes the tensor-core
    kernels (K and V expanded where G does not divide 64), float32 and
    fp16 the tensor-core kernels at every head dim (``split``, ``f16``)
    and any group; any other dtype goes to the bf16 kernels' wrapper,
    which refuses it."""
    from paddle_tpu_torch.kernels.flash_attention import flash_route
    assert flash_route(device, dtype, Hq, Hk, D, mode) == route
    with pytest.raises(ValueError, match="FLAGS_flash_kernel"):
        flash_route(device, dtype, Hq, Hk, D, "bogus")


def test_expand_factor_is_the_least_that_leaves_a_divisor_of_64():
    from paddle_tpu_torch.kernels.flash_attention import expand_factor
    groups = (1, 2, 3, 4, 5, 6, 8, 12, 24, 64, 96, 128)
    assert [expand_factor(g) for g in groups] == \
        [1, 1, 3, 1, 5, 3, 1, 3, 3, 1, 3, 2]


@pytest.mark.parametrize("Hq", [24, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_expanded_route_arithmetic_matches_pallas(Hq, causal):
    """The ``expanded`` route's arithmetic (G 3 and G 12 over Hk 8, D 64,
    S 128): K and V expanded ``expand_factor(G)`` times, the plain pair on
    the expanded heads, the copies' dK and dV summed in float32
    (``reduce_expanded``): O, dQ, dK and dV against the Pallas kernels in
    interpret mode from the same numpy inputs, at this file's atol."""
    import jax
    from paddle_tpu_torch.kernels.flash_attention import (
        expand_factor, expand_kv, flash_attention_bwd_plain,
        reduce_expanded)
    Hk, D, S = 8, 64, 128
    rng = np.random.default_rng(Hq + causal)
    q, k, v, do = (rng.standard_normal((1, S, h, D)).astype(np.float32)
                   for h in (Hq, Hk, Hk, Hq))
    o_ref, vjp = jax.vjp(
        lambda q_, k_, v_: pallas_flash(q_, k_, v_, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(do))
    r = expand_factor(Hq // Hk)
    assert r == 3
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    kx, vx = expand_kv(kt, r), expand_kv(vt, r)
    assert kx.shape == (1, S, Hk * r, D)
    o, lse = flash_attention_plain(qt, kx, vx, causal=causal,
                                   return_lse=True)
    dq, dkx, dvx = flash_attention_bwd_plain(qt, kx, vx, o, lse, dot,
                                             causal=causal)
    dk = reduce_expanded(dkx, r, kt.dtype)
    dv = reduce_expanded(dvx, r, vt.dtype)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    for name, g, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert g.shape == ref.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=ATOL,
                                   err_msg=name)
