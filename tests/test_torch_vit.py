"""PyTorch port: the ViT slice against the JAX package on the CPU.

A tiny ViT (image 32, patch 8: S = 17 tokens, not a multiple of the
kernels' 64-row tiles; hidden 64, 2 layers, 4 heads, 10 classes) is built
by the JAX package from a seed and moved into the port through
``convert.vit_params_from_numpy``. Its logits, loss and every parameter's
gradient must match, with the JAX side's attention through the Pallas
flash kernels in interpret mode (``PADDLE_FLASH_FORCE=pallas``), and
three ``TrainStep``s of AdamW with global-norm clip must give the same
losses. Also the flash head-dim padding (the kernel route's rule for a
head dim other than 64 or 128) through the plain pair, and the masked
SDPA route's counter. Float32, atol 1e-5.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.vision.models import vit as jvit
from paddle_tpu_torch import AdamW, TrainStep
from paddle_tpu_torch.convert import (vit_expected_shapes,
                                      vit_params_from_numpy)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.vision import models as tvm
from paddle_tpu_torch.vision.models import vit as tvit

ATOL = 1e-5
TINY = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
            num_heads=4, num_classes=10)


def _is_linear_weight(name):
    return name == "heads.weight" or name.endswith(
        ("_proj.weight", "mlp.0.weight", "mlp.3.weight")) and \
        not name.startswith("conv_proj")


@pytest.fixture(scope="module")
def jax_vit():
    paddle.seed(0)
    m = jvit.VisionTransformer(jvit.ViTConfig(**TINY))
    return m, {n: np.asarray(p._data) for n, p in m.named_parameters()}


def _batch(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 3, 32, 32)).astype(np.float32),
            rng.integers(0, 10, (b,)).astype(np.int64))


def _port(named, dtype=None):
    m = tvit.VisionTransformer(tvit.ViTConfig(**TINY), device="cpu",
                               dtype=dtype)
    m.load_state_dict(vit_params_from_numpy(named, m.config, dtype=dtype),
                      strict=True)
    return m


def test_conversion_maps_every_name(jax_vit):
    """Every name maps; Linear weights are transposed, ``conv_proj.weight``
    (a 4-d kernel whose name also ends in ``_proj.weight``), the class
    token and the positions are copied as they are; a missing, extra or
    mis-shaped name raises."""
    _, named = jax_vit
    cfg = tvit.ViTConfig(**TINY)
    state = vit_params_from_numpy(named, cfg)
    port = tvit.VisionTransformer(cfg, device="cpu")
    params = dict(port.named_parameters())
    assert set(state) == set(named) == set(params) == \
        set(vit_expected_shapes(cfg))
    for n, t in state.items():
        assert tuple(t.shape) == tuple(params[n].shape) == \
            vit_expected_shapes(cfg)[n]
        want = named[n].T if _is_linear_weight(n) else named[n]
        np.testing.assert_array_equal(t.numpy(), want, err_msg=n)
    assert state["conv_proj.weight"].shape == (64, 3, 8, 8)
    np.testing.assert_array_equal(state["conv_proj.weight"].numpy(),
                                  named["conv_proj.weight"])
    assert tuple(state["pos_embedding"].shape) == (1, 17, 64)
    assert "encoder.1.mlp.3.bias" in state
    with pytest.raises(ValueError, match="missing"):
        vit_params_from_numpy({n: a for n, a in named.items()
                               if n != "ln.bias"}, cfg)
    with pytest.raises(ValueError, match="unexpected"):
        vit_params_from_numpy(dict(named, extra=np.zeros(1)), cfg)
    bad = dict(named)
    bad["encoder.0.mlp.0.weight"] = bad["encoder.0.mlp.0.weight"].T
    with pytest.raises(ValueError, match="shape"):
        vit_params_from_numpy(bad, cfg)
    bad = dict(named)
    bad["conv_proj.weight"] = bad["conv_proj.weight"].transpose(1, 0, 2, 3)
    with pytest.raises(ValueError, match="shape"):
        vit_params_from_numpy(bad, cfg)


def test_tiny_vit_logits_loss_and_gradients_match(jax_vit, monkeypatch):
    """One ``loss.backward()`` on both sides from the same parameters and
    batch [3, 3, 32, 32]: logits, loss and every parameter's gradient."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, named = jax_vit
    x, y = _batch(1)
    jm.clear_gradients()
    jlogits = jm(paddle.to_tensor(x)).numpy()
    jl = jm.loss(paddle.to_tensor(x), paddle.to_tensor(y))
    jl.backward()
    jgrads = {n: np.asarray(p.grad._data) for n, p in jm.named_parameters()}
    jm.clear_gradients()

    port = _port(named)
    before = fa.sdpa_masked_plain.calls
    logits = port(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), jlogits, atol=ATOL)
    tl = port.loss(torch.from_numpy(x), torch.from_numpy(y))
    tl.backward()
    assert fa.sdpa_masked_plain.calls == before
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-6)
    assert set(jgrads) == {n for n, _ in port.named_parameters()}
    for n, p in port.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if _is_linear_weight(n) else g,
                                   jgrads[n], atol=ATOL, err_msg=n)


def test_tiny_vit_trained_three_steps_matches_jax_train_step(monkeypatch):
    """AdamW 1e-3 with ``ClipGradByGlobalNorm(1.0)`` through ``TrainStep``
    on both sides, three steps on one batch: each step's loss within 1e-5
    relative, and falling."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    paddle.seed(4)
    jm = jvit.VisionTransformer(jvit.ViTConfig(**TINY))
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    x, y = _batch(5, b=4)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    jstep = paddle.jit.TrainStep(jm, jo, lambda m, a, b: m.loss(a, b))
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for _ in range(3)]

    tm = _port(named)
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, to, lambda m, a, b: m.loss(a, b))
    tl = [tstep(torch.from_numpy(x), torch.from_numpy(y)).item()
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[2] < tl[0]


def test_vit_presets_and_sizes():
    """ViT-L/16 has 304,326,632 parameters (counted on the meta device);
    the presets pass the model's arguments on and the rest to the
    config; the block's GELU is the exact form."""
    m = tvm.vit_l_16(num_classes=1000, device="meta")
    assert sum(p.numel() for p in m.parameters()) == 304_326_632
    assert (m.config.hidden_size, m.config.num_layers,
            m.config.num_heads) == (1024, 24, 16)
    h = tvm.vit_h_14(device="meta", dtype=torch.bfloat16)
    assert h.config.patch_size == 14 and h.conv_proj.weight.dtype == \
        torch.bfloat16
    assert h.config.hidden_size // h.config.num_heads == 80
    b = tvm.vit_b_16(num_classes=10, image_size=32, device="cpu")
    assert b.config.num_layers == 12 and b.heads.weight.shape == (10, 768)
    assert b.encoder[0].mlp[1].approximate is False
    assert all(p.requires_grad for p in b.parameters())
    assert b.class_token.abs().sum().item() == 0.0
    assert b.pos_embedding.abs().max().item() <= 0.04


def test_vit_builds_from_its_generator():
    """The same generator seed gives the same weights; another, others."""
    def build(seed):
        return tvit.VisionTransformer(
            tvit.ViTConfig(**TINY), device="cpu",
            generator=torch.Generator().manual_seed(seed))
    a, b, c = build(0), build(0), build(1)
    for (n, p), q, r in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(p, q), n
        if p.abs().sum() > 0 and "ln" not in n:
            assert not torch.equal(p, r), n


@pytest.mark.parametrize("D,causal", [(80, False), (40, True), (100, False),
                                      (16, False)])
def test_head_dim_padding_keeps_the_results(D, causal):
    """The kernel route's rule for D not in (64, 128): zero-pad q, k, v and
    dO to ``padded_head_dim(D)``, keep the scale of the true D, slice O,
    dQ, dK, dV back. Through the plain pair (which the kernels are held
    to): the padded run equals the unpadded one, LSE included."""
    dp = fa.padded_head_dim(D)
    assert dp == (64 if D <= 64 else 128)
    rng = np.random.default_rng(D)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 70, h, D)).astype(np.float32)) for h in (4, 2, 2, 4))
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    qp, kp, vp, dop = (fa.pad_head_dim(t, dp) for t in (q, k, v, do))
    assert qp.shape[-1] == dp and torch.equal(qp[..., :D], q)
    op, lsep = fa.flash_attention_plain(qp, kp, vp, causal=causal,
                                        scale=scale, return_lse=True)
    assert op[..., D:].abs().max().item() == 0.0
    torch.testing.assert_close(op[..., :D], o, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(lsep, lse, atol=ATOL, rtol=1e-5)
    gp = fa.flash_attention_bwd_plain(qp, kp, vp, op, lsep, dop,
                                      causal=causal, scale=scale)
    for a, b in zip(gp, grads):
        torch.testing.assert_close(a[..., :D], b, atol=ATOL, rtol=1e-5)
    # the wrong scale (the padded D's) would not pass
    wrong = fa.flash_attention_plain(qp, kp, vp, causal=causal)
    assert (wrong[..., :D] - o).abs().max().item() > 1e-3


def test_head_dim_above_128_raises():
    """Head dims 129-256 run at the kernels' 256 since D 256 was added;
    above 256 the kernel route raises."""
    assert fa.pad_head_dim(torch.ones(2, 64), 64).shape == (2, 64)
    assert [fa.padded_head_dim(d) for d in (1, 64, 65, 128, 129, 160, 256)] \
        == [64, 64, 128, 128, 256, 256, 256]
    with pytest.raises(ValueError, match="above 256"):
        fa.padded_head_dim(257)


def test_masked_route_counts_and_the_flash_route_does_not():
    q = torch.randn(1, 9, 2, 16, generator=torch.Generator().manual_seed(0))
    before = fa.sdpa_masked_plain.calls
    out = fa.scaled_dot_product_attention(q, q, q)
    assert fa.sdpa_masked_plain.calls == before
    masked = fa.scaled_dot_product_attention(
        q, q, q, attn_mask=torch.ones(9, 9, dtype=torch.bool))
    assert fa.sdpa_masked_plain.calls == before + 1
    torch.testing.assert_close(masked, out, atol=ATOL, rtol=1e-5)
    # GQA and causal on the masked route equal the flash route's
    k = q[:, :, :1]
    causal = fa.scaled_dot_product_attention(q, k, k, is_causal=True)
    torch.testing.assert_close(fa.sdpa_masked_plain(
        q, k, k, torch.zeros(9, 9), causal=True), causal, atol=ATOL,
        rtol=1e-5)
