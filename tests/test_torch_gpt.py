"""PyTorch port: GPT modules, the fused LM-head cross entropy and the whole
tiny GPT's gradients against the JAX package on the CPU.

Inputs come from numpy with a seed and go to both packages; parameters are
moved from the JAX model through ``convert.gpt_params_from_numpy``. In the
gradient tests the JAX side's attention reaches the Pallas flash kernels
(forward, dQ, dK/dV) in interpret mode through ``PADDLE_FLASH_FORCE=pallas``.
Float32, atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.functional.fused_ce import (
    fused_linear_cross_entropy as jax_fused_ce)
from paddle_tpu_torch.convert import (gpt_expected_shapes,
                                      gpt_params_from_numpy)
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.nn import fused_linear_cross_entropy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.fused_ce import chunk_plan

ATOL = 1e-5


def _named(layer):
    return {n: np.asarray(p._data) for n, p in layer.named_parameters()}


def _is_linear_weight(name):
    return name.endswith(".weight") and name.split(".")[-2] in (
        "qkv_proj", "out_proj", "fc_in", "fc_out", "lm_head")


def _port_of(jax_layer, port_layer):
    """Copy a JAX layer's parameters into the port's counterpart (Linear
    weights transposed, as ``convert`` does)."""
    state = {n: torch.from_numpy(np.array(a.T if _is_linear_weight(n)
                                          else a))
             for n, a in _named(jax_layer).items()}
    port_layer.load_state_dict(state, strict=True)
    return port_layer


@pytest.fixture(scope="module")
def cfg():
    return jgpt.GPTConfig.tiny()


def _port_cfg(**kw):
    c = tgpt.GPTConfig.tiny()
    for k, v in kw.items():
        setattr(c, k, v)
    return c


def test_layer_norm_and_tanh_gelu():
    """Parity trap 6: LayerNorm uses the biased variance, in f32; GPT's
    GELU is the tanh form."""
    rng = np.random.default_rng(0)
    x = (3.0 + rng.standard_normal((3, 7, 64))).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    b = rng.standard_normal((64,)).astype(np.float32)
    ref = JF.layer_norm(paddle.to_tensor(x), 64, paddle.to_tensor(w),
                        paddle.to_tensor(b), 1e-5)
    out = TF.layer_norm(torch.from_numpy(x), 64, torch.from_numpy(w),
                        torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    assert TF.layer_norm(torch.from_numpy(x).bfloat16(), 64).dtype == \
        torch.bfloat16
    for approx in (True, False):
        ref = JF.gelu(paddle.to_tensor(x - 3.0), approximate=approx)
        out = TF.gelu(torch.from_numpy(x - 3.0), approximate=approx)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)
    # the two forms differ by more than the tolerance: the test tells them
    # apart
    xt = torch.linspace(-4, 4, 101)
    assert (TF.gelu(xt, True) - TF.gelu(xt, False)).abs().max() > 1e-4


def test_mlp_and_block_forward(cfg, monkeypatch):
    """The block's attention takes the JAX package's XLA route here (the
    flash forward is held against the Pallas kernel in
    ``test_torch_flash_attention.py``); the gradient tests below take the
    Pallas route."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "xla")
    paddle.seed(1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    jm = jgpt.GPTMLP(cfg)
    tm = _port_of(jm, tgpt.GPTMLP(_port_cfg(), device="cpu",
                                  dtype=torch.float32))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               jm(paddle.to_tensor(x)).numpy(), atol=ATOL)
    jb = jgpt.GPTBlock(cfg)
    for p in jb.parameters():  # non-trivial biases and norm weights
        p._rebind(jnp.asarray(rng.standard_normal(p.shape).astype(
            np.float32) * 0.1 + (1.0 if p.ndim == 1 else 0.0)))
    tb = _port_of(jb, tgpt.GPTBlock(_port_cfg(), device="cpu",
                                    dtype=torch.float32))
    np.testing.assert_allclose(tb(torch.from_numpy(x)).detach().numpy(),
                               jb(paddle.to_tensor(x)).numpy(), atol=ATOL)


@pytest.mark.parametrize("V,transpose", [(307, True), (307, False),
                                         (8307, True)])
def test_fused_cross_entropy_matches(V, transpose):
    """V 307: one chunk (C 1, R 0); V 8307: C 1 plus an R 115 remainder.
    Loss, dx and dW; two labels are ignore_index. Parity trap 5 (second
    half): the mean runs over non-ignored labels, divisor at least 1."""
    K, C, R = chunk_plan(V)
    assert (C, R) == ((1, 0) if V == 307 else (1, 115))
    rng = np.random.default_rng(V)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    w = (rng.standard_normal((V, 32) if transpose else (32, V)) * 0.2
         ).astype(np.float32)
    lbl = rng.integers(0, V, (3, 5)).astype(np.int64)
    lbl[0, 1] = lbl[2, 4] = -100
    lbl[1, 0] = V - 1  # the last column (the remainder's last one)
    jx, jw = paddle.to_tensor(x), paddle.to_tensor(w)
    jx.stop_gradient = jw.stop_gradient = False
    jl = jax_fused_ce(jx, jw, paddle.to_tensor(lbl),
                      transpose_weight=transpose)
    jl.backward()
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl = fused_linear_cross_entropy(tx, tw, torch.from_numpy(lbl),
                                    transpose_weight=transpose)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), atol=ATOL)
    # every label ignored: the mean's divisor is at least 1, loss 0
    none = fused_linear_cross_entropy(tx, tw, torch.full((3, 5), -100),
                                      transpose_weight=transpose)
    assert none.item() == 0.0


@pytest.fixture(scope="module")
def jax_gpts(cfg):
    """The tiny JAX GPT (fused and dense head share one set of
    parameters) and the same parameters as numpy."""
    paddle.seed(0)
    m = jgpt.GPT(cfg)
    return m, _named(m)


def test_conversion_maps_every_name(cfg, jax_gpts):
    _, named = jax_gpts
    state = gpt_params_from_numpy(named, cfg)
    port = tgpt.GPT(_port_cfg(), device="cpu")
    port_params = dict(port.named_parameters())
    assert set(state) == set(named) == set(port_params)
    for n, t in state.items():
        assert tuple(t.shape) == tuple(port_params[n].shape) == \
            gpt_expected_shapes(cfg)[n]
        want = named[n].T if _is_linear_weight(n) else named[n]
        np.testing.assert_array_equal(t.numpy(), want)
    port.load_state_dict(state, strict=True)
    with pytest.raises(ValueError, match="missing"):
        gpt_params_from_numpy(
            {n: a for n, a in named.items() if n != "ln_f.bias"}, cfg)
    with pytest.raises(ValueError, match="unexpected"):
        gpt_params_from_numpy(dict(named, extra=np.zeros(1)), cfg)
    bad = dict(named)
    bad["h.0.attn.qkv_proj.weight"] = bad["h.0.attn.qkv_proj.weight"].T
    with pytest.raises(ValueError, match="shape"):
        gpt_params_from_numpy(bad, cfg)


@pytest.mark.parametrize("fused", [True, False])
def test_tiny_gpt_gradients_match(cfg, jax_gpts, monkeypatch, fused):
    """One ``loss.backward()`` on both sides from the same parameters and
    ids [2, 40]: the loss and every parameter's gradient. Parity trap 5:
    the fused loss slices the hidden states, not the logits; trap 7: the
    tied wte gets gradient from the lookup and the head."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, named = jax_gpts
    jm.config.fused_head_ce = fused
    try:
        ids = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(
            np.int64)
        jm.clear_gradients()
        jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        jl.backward()
        jgrads = {n: np.asarray(p.grad._data)
                  for n, p in jm.named_parameters()}
    finally:
        jm.config.fused_head_ce = True
    port = tgpt.GPT(_port_cfg(fused_head_ce=fused), device="cpu")
    port.load_state_dict(gpt_params_from_numpy(named, cfg))
    tl = port.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-6)
    for n, p in port.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if _is_linear_weight(n) else g,
                                   jgrads[n], atol=ATOL, err_msg=n)


def test_config_sizes_and_unported_options():
    c = tgpt.GPTConfig.gpt2_medium()
    assert (c.hidden_size, c.num_layers, c.num_heads, c.intermediate_size,
            c.vocab_size) == (1024, 24, 16, 4096, 50304)
    m = tgpt.GPT(tgpt.GPTConfig.tiny(), device="cpu")
    n = sum(p.numel() for p in m.parameters())
    assert m.num_params() == n - 64 * 64
    assert m.flops_per_token(40) == 6 * m.num_params() + 12 * 2 * 64 * 40
    assert all(p.requires_grad for p in m.parameters())
    # use_fp8 is ported: the block linears become FP8Linear
    from paddle_tpu_torch.amp.fp8 import FP8Linear
    f8 = tgpt.GPT(_port_cfg(use_fp8=True), device="cpu")
    assert isinstance(f8.h[0].attn.qkv_proj, FP8Linear)
    with pytest.raises(NotImplementedError):
        tgpt.GPT.tp_placement_rules(None)
