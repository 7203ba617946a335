"""PyTorch port: the flash-attention backward against the Pallas VJP.

The JAX side is the VJP of ``paddle_tpu.kernels.pallas.flash_attention.
flash_attention`` (the forward, ``_dq_kernel`` and ``_dkv_kernel`` in
Pallas interpret mode); the port side is ``FlashAttention`` on CPU tensors,
which runs ``flash_attention_plain`` and ``flash_attention_bwd_plain``: the
math the CUDA kernels (``csrc/flash_bwd.cu``) are held against on the card.
Inputs and the output cotangent come from numpy with a seed; float32, dQ,
dK and dV at atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.pallas.flash_attention import (
    flash_attention as pallas_flash)
from paddle_tpu_torch.core import set_flags
from paddle_tpu_torch.kernels import flash_attention as fa

ATOL = 1e-5


def _inputs(B, Sq, Sk, Hq, Hk, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, Sq, Hq, D), f(B, Sk, Hk, D), f(B, Sk, Hk, D), \
        f(B, Sq, Hq, D)


def _port_grads(q, k, v, do, causal):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.scaled_dot_product_attention(*ts, is_causal=causal)
    out.backward(torch.from_numpy(do))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hk,D,causal", [
    (1, 16, 16, 4, 4, 32, True),     # G = 1
    (2, 20, 20, 8, 2, 32, True),     # G = 4, Sq not a tile multiple
    (2, 20, 20, 8, 2, 32, False),
    (1, 13, 40, 8, 2, 32, True),     # Sq < Sk: bottom-right causal
    (1, 24, 10, 4, 2, 32, True),     # Sq > Sk: top rows see no key
])
def test_plain_backward_matches_pallas_vjp(B, Sq, Sk, Hq, Hk, D, causal):
    q, k, v, do = _inputs(B, Sq, Sk, Hq, Hk, D)
    o_ref, vjp = jax.vjp(
        lambda q_, k_, v_: pallas_flash(q_, k_, v_, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(do))
    out, grads = _port_grads(q, k, v, do, causal)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(o_ref),
                               atol=ATOL)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   err_msg=name)


def test_fully_masked_rows_get_zero_grads_and_no_nan():
    """Parity trap 8 (second half): causal Sq > Sk, rows 0..13 see no key
    (O = 0, LSE = +1e30); their dQ is exactly 0 and nothing is NaN. The
    first half, the P/dS/dO casts, shows only in bf16: the cuda-marked
    tests and ``chip_smoke.py`` hold the kernels against the plain pair
    there."""
    q, k, v, do = _inputs(1, 24, 10, 4, 2, 32, seed=1)
    out, (dq, dk, dv) = _port_grads(q, k, v, do, causal=True)
    assert torch.all(out[:, :14] == 0)
    assert torch.all(dq[:, :14] == 0)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()


def test_cpu_route_runs_the_functions_backward(monkeypatch):
    """The plain forward is not differentiated by autograd: the graph holds
    one FlashAttention node and its backward calls the plain backward."""
    calls = []
    real = fa.flash_attention_bwd_plain

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_bwd_plain", counted)
    q, k, v, do = _inputs(1, 9, 9, 4, 2, 16)
    before = (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
              fa.flash_bwd_dkv_cuda.launches)
    out, _ = _port_grads(q, k, v, do, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert out.grad_fn.next_functions[0][0] is not None  # q's leaf
    assert calls == [1]
    assert (fa.flash_fwd_cuda.launches, fa.flash_bwd_dq_cuda.launches,
            fa.flash_bwd_dkv_cuda.launches) == before


def test_non_contiguous_views_and_dropout_on_output():
    """Parity trap 9: q/k/v as views of one fused [b, s, 3, H, D]
    projection (GPT's layout) give the same grads as contiguous copies;
    dropout drops entries of the output with the generator's mask."""
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 12, 3, 4, 16)).astype(np.float32)
    do = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    t = torch.from_numpy(qkv).requires_grad_()
    q, k, v = t.unbind(2)
    assert not q.is_contiguous()
    fa.scaled_dot_product_attention(q, k, v, is_causal=True).backward(
        torch.from_numpy(do))
    _, grads = _port_grads(*(np.ascontiguousarray(qkv[:, :, i])
                             for i in range(3)), do, True)
    np.testing.assert_allclose(t.grad.numpy(),
                               torch.stack(grads, 2).numpy(), atol=ATOL)
    g = torch.Generator().manual_seed(0)
    ref = fa.scaled_dot_product_attention(q, k, v, is_causal=True)
    out = fa.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          dropout_p=0.5, generator=g)
    kept = out != 0
    assert 0.3 < kept.float().mean().item() < 0.7
    torch.testing.assert_close(out[kept], ref[kept] * 2.0)


def test_route_switch_is_read_at_call_time():
    q = torch.zeros(1, 4, 2, 64)
    before = dict(fa.ROUTE_COUNTS)
    fa.scaled_dot_product_attention(q, q, q, is_causal=True)
    # CPU tensors take the plain pair
    assert {k: fa.ROUTE_COUNTS[k] - before[k] for k in before} == \
        {k: int(k == "cpu") for k in before}
    set_flags({"FLAGS_flash_kernel": "bogus"})
    try:
        with pytest.raises(ValueError, match="FLAGS_flash_kernel"):
            fa.scaled_dot_product_attention(q, q, q, is_causal=True)
    finally:
        set_flags({"FLAGS_flash_kernel": "auto"})


def test_backward_wrappers_refuse_cpu_tensors():
    z = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    s = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq_cuda(z, z, z, z, s, s, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv_cuda(z, z, z, z, s, s, causal=True)
