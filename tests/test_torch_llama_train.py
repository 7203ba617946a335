"""PyTorch port: Llama training against the JAX package on the CPU.

``LlamaConfig.tiny()`` in float32, parameters moved from the JAX model
through ``convert.llama_params_from_numpy``, ids from numpy with a seed.
The JAX side's attention reaches the Pallas flash kernels (forward, dQ,
dK/dV) in interpret mode through ``PADDLE_FLASH_FORCE=pallas``. The loss,
fused and unfused, tied and untied, within 1e-5; every gradient within
1e-4 of the largest |gradient| of its tensor; three ``TrainStep`` steps
of AdamW (1e-3, global-norm clip 1.0): every parameter tensor within
1e-5 relative in norm (||port - jax|| / ||jax||), and its change from the
initial weights within 1e-4 relative in norm. Not elementwise: where a
gradient is near Adam's epsilon its first step differs by ~1e-3 of the
learning rate between the two float32 sums (~1e-6 absolute here).
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import AdamW, TrainStep
from paddle_tpu_torch.convert import llama_params_from_numpy
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import ClipGradByGlobalNorm

ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-5
UPDATE_RTOL = 1e-4


def _named(layer):
    return {n: np.asarray(p._data) for n, p in layer.named_parameters()}


def _is_linear(name):
    return name == "lm_head.weight" or name.endswith("_proj.weight")


def _jax_model(tied, seed=0):
    cfg = jllama.LlamaConfig.tiny()
    cfg.tie_word_embeddings = tied
    paddle.seed(seed)
    return jllama.Llama(cfg), cfg


def _port(cfg, named, fused=True):
    pcfg = tllama.LlamaConfig(**{f.name: getattr(cfg, f.name) for f in
                                 dataclasses.fields(tllama.LlamaConfig)})
    pcfg.fused_head_ce = fused
    port = tllama.Llama(pcfg, device="cpu", requires_grad=True)
    port.load_state_dict(llama_params_from_numpy(named, cfg))
    return port


def _ids(seed=5, b=2, s=24):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int64)


@pytest.fixture(scope="module", params=[False, True], ids=["untied",
                                                           "tied"])
def models(request):
    jm, cfg = _jax_model(request.param)
    return jm, cfg, _named(jm)


@pytest.mark.parametrize("fused", [True, False])
def test_loss_and_every_gradient_match(models, monkeypatch, fused):
    """One ``loss.backward()`` from the same parameters and ids: the loss
    (fused head CE or ``cross_entropy`` on the logits; the tied head's
    weight is the embedding, which then gets gradient from the lookup and
    the head) and every parameter's gradient."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, cfg, named = models
    ids = _ids()
    jm.config.fused_head_ce = fused
    try:
        jm.clear_gradients()
        jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        jl.backward()
        jgrads = {n: np.asarray(p.grad._data)
                  for n, p in jm.named_parameters()}
    finally:
        jm.config.fused_head_ce = True
    port = _port(cfg, named, fused)
    tl = port.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), atol=ATOL)
    assert set(dict(port.named_parameters())) == set(jgrads)
    for n, p in port.named_parameters():
        g = p.grad.numpy()
        g = g.T if _is_linear(n) else g
        ref = jgrads[n]
        err = np.abs(g - ref).max() / max(np.abs(ref).max(), 1e-12)
        assert err <= GRAD_RTOL, (n, err)


def test_three_train_steps_match_jax_train_step(monkeypatch):
    """AdamW 1e-3 with global-norm clip 1.0 through both ``TrainStep``s
    (``lambda m, ids: m.loss(ids, ids)``, as examples/hybrid_llama.py
    trains) for three steps on one batch: the losses, then every
    parameter."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, cfg = _jax_model(False, seed=1)
    named = _named(jm)
    ids = _ids(seed=6)
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    jstep = paddle.jit.TrainStep(jm, jo, lambda m, x: m.loss(x, x))
    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(3)]

    port = _port(cfg, named)
    to = AdamW(learning_rate=1e-3, parameters=port.parameters(),
               grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(port, to, lambda m, x: m.loss(x, x))
    tl = [tstep(torch.from_numpy(ids)).item() for _ in range(3)]
    np.testing.assert_allclose(tl, jl, atol=ATOL)
    assert tl[2] < tl[0]
    jafter = _named(jm)
    for n, p in port.named_parameters():
        a = p.detach().numpy()
        a = a.T if _is_linear(n) else a
        ref, init = jafter[n], named[n]
        err = np.linalg.norm(a - ref) / np.linalg.norm(ref)
        assert err <= PARAM_RTOL, (n, err)
        moved = np.linalg.norm(ref - init)
        assert moved > 0, n
        err = np.linalg.norm((a - init) - (ref - init)) / moved
        assert err <= UPDATE_RTOL, (n, err)


def test_flops_per_token_and_num_params(models):
    jm, cfg, named = models
    port = _port(cfg, named)
    assert port.num_params() == jm.num_params()
    for s in (1, 24, 2048):
        assert port.flops_per_token(s) == jm.flops_per_token(s)


def test_config_presets_match():
    for name in ("llama3_70b", "llama3_8b", "llama2_7b", "tiny"):
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        for f in dataclasses.fields(tllama.LlamaConfig):
            assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    c = tllama.LlamaConfig.llama3_70b()
    assert (c.hidden_size, c.num_layers, c.num_heads, c.num_kv_heads,
            c.intermediate_size) == (8192, 80, 64, 8, 28672)
    assert tllama.LlamaConfig().fused_head_ce


def test_conversion_keeps_every_name_with_fused_head_ce():
    """``fused_head_ce`` adds no parameter: the converter maps every name
    with it on or off."""
    jm, cfg = _jax_model(False)
    named = _named(jm)
    for fused in (True, False):
        cfg.fused_head_ce = fused
        state = llama_params_from_numpy(named, cfg)
        assert set(state) == set(named)
