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
                                      (160, True)])
def test_plain_pair_at_wide_head_dims_matches_pallas(D, causal):
    """Head dims the kernels run at 256 (Gemma's 256; 160 pads to it):
    the plain pair the D-256 kernels are held to on the card, forward and
    backward through ``FlashAttention`` on CPU tensors, against the Pallas
    kernels in interpret mode (which pad D to a multiple of 128)."""
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


def test_padded_head_dim_maps_up_to_256_and_raises_above():
    from paddle_tpu_torch.kernels.flash_attention import padded_head_dim
    assert [padded_head_dim(d) for d in (64, 65, 128, 129, 192, 256)] == \
        [64, 128, 128, 256, 256, 256]
    for d in (257, 512):
        with pytest.raises(ValueError, match="above 256"):
            padded_head_dim(d)
    # the plain route still computes any head dim
    q = torch.randn(1, 5, 2, 288)
    assert flash_attention_plain(q, q, q, causal=True).shape == q.shape
