"""PyTorch port: ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``)
against the JAX package on the CPU.

The scaler cases mirror the JAX package's ``tests/test_amp.py`` on a
Linear(4, 4) with the same weights and inputs on both sides: weights at
atol 1e-6 after each step, the scaler's ``state_dict`` equal, and the same
errors. ``auto_cast`` (O1) and ``decorate`` (O2) run the tiny GPT from the
same float32 parameters: the ops of the lists cast as they do there
(products and attention in bf16, norms and the loss in float32), and the
losses agree within bf16's rounding, rtol 1e-2, as bf16 rounds at other
places in the two frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import GPT, GPTConfig, amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import gpt_params_from_numpy
from paddle_tpu_torch.nn import LayerNorm, Linear
from paddle_tpu_torch.nn import functional as TF

ATOL = 1e-6
BF16_RTOL = 1e-2


def _pair(scalers, seed=0):
    """Linear(4, 4) + SGD(0.1) on both sides, same weights, with the grads
    of sum(model(x)) (scaled by each side's scaler when given)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    x = rng.standard_normal((2, 4)).astype(np.float32)
    jm = jnn.Linear(4, 4)
    jm.weight._rebind(jnp.asarray(w))
    jm.bias._rebind(jnp.asarray(b))
    tm = Linear(4, 4, bias=True, device="cpu", requires_grad=True)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w.T))
        tm.bias.copy_(torch.from_numpy(b))
    jo = jopt.SGD(learning_rate=0.1, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.1, parameters=tm.parameters())
    jl = jm(paddle.to_tensor(x)).sum()
    tl = tm(torch.from_numpy(x)).sum()
    if scalers is not None:
        jl, tl = scalers[0].scale(jl), scalers[1].scale(tl)
    jl.backward()
    tl.backward()
    return (jm, jo), (tm, to)


def _same(jside, tside):
    (jm, _), (tm, _) = jside, tside
    np.testing.assert_allclose(tm.weight.detach().numpy().T,
                               np.asarray(jm.weight.numpy()), atol=ATOL)
    np.testing.assert_allclose(tm.bias.detach().numpy(),
                               np.asarray(jm.bias.numpy()), atol=ATOL)


def _scalers(**kw):
    return jamp.GradScaler(**kw), amp.GradScaler(**kw)


def test_unscale_then_step_unscales_once():
    sc = _scalers(init_loss_scaling=1024.0)
    j, t = _pair(sc)
    for s, (m, o) in zip(sc, (j, t)):
        s.unscale_(o)
        s.step(o)  # must not unscale again
        s.update()
    _same(j, t)
    assert sc[1].state_dict() == sc[0].state_dict()


def test_one_unscale_gives_the_unscaled_gradient():
    """The gradient after ``unscale_`` equals the one of the unscaled
    loss, and the step is lr times it (JAX package's first case)."""
    sc = _scalers(init_loss_scaling=1024.0)
    j, t = _pair(sc)
    _, (tm, _) = _pair(None)
    sc[1].unscale_(t[1])
    torch.testing.assert_close(t[0].weight.grad, tm.weight.grad)
    w_before = t[0].weight.detach().clone()
    sc[1].step(t[1])
    torch.testing.assert_close(t[0].weight.detach(),
                               w_before - 0.1 * tm.weight.grad)


def test_double_unscale_raises():
    sc = _scalers(init_loss_scaling=8.0)
    j, t = _pair(sc)
    for s, (_, o) in zip(sc, (j, t)):
        s.unscale_(o)
        with pytest.raises(RuntimeError, match="already been called"):
            s.unscale_(o)


def test_unscale_after_step_raises_and_update_resets():
    sc = _scalers(init_loss_scaling=8.0)
    j, t = _pair(sc)
    for s, (_, o) in zip(sc, (j, t)):
        s.step(o)
        with pytest.raises(RuntimeError, match="after step"):
            s.unscale_(o)
        with pytest.raises(RuntimeError, match="already been called"):
            s.step(o)
        s.update()
    j2, t2 = _pair(sc, seed=1)
    for s, (_, o) in zip(sc, (j2, t2)):
        s.unscale_(o)
        s.step(o)
        s.update()
    _same(j2, t2)
    assert sc[1].state_dict() == sc[0].state_dict()


def test_inf_grad_skips_step_and_decreases_scale():
    sc = _scalers(init_loss_scaling=1024.0, decr_every_n_nan_or_inf=1,
                  decr_ratio=0.5)
    j, t = _pair(sc)
    w_before = t[0].weight.detach().clone()
    j[0].weight.grad._rebind(j[0].weight.grad._data * np.inf)
    with torch.no_grad():
        t[0].weight.grad.mul_(float("inf"))
    for s, (_, o) in zip(sc, (j, t)):
        s.step(o)
        s.update()
    assert torch.equal(t[0].weight.detach(), w_before)
    _same(j, t)
    assert float(sc[1].get_loss_scaling()) == 512.0
    assert sc[1].state_dict() == sc[0].state_dict()


def test_scale_increases_after_good_steps():
    sc = _scalers(init_loss_scaling=4.0, incr_every_n_steps=2,
                  incr_ratio=2.0)
    for seed in range(3):
        j, t = _pair(sc, seed)
        for s, (_, o) in zip(sc, (j, t)):
            s.step(o)
            s.update()
        _same(j, t)
        assert sc[1].state_dict() == sc[0].state_dict()
    assert float(sc[1].get_loss_scaling()) == 8.0
    assert sc[1].state_dict()["good_steps"] == 1


def test_disabled_scaler_passthrough():
    sc = _scalers(enable=False)
    j, t = _pair(None)
    for s, (_, o) in zip(sc, (j, t)):
        s.step(o)
    _same(j, t)
    x = torch.tensor(2.0)
    assert sc[1].scale(x) is x and not sc[1].is_enable()
    assert not sc[1].is_use_dynamic_loss_scaling()


def test_multi_optimizer_found_inf_isolation():
    """Each optimizer's step acts on its own inf verdict; any inf shrinks
    the scale once."""
    sc = _scalers(init_loss_scaling=64.0, decr_every_n_nan_or_inf=1,
                  decr_ratio=0.5)
    j1, t1 = _pair(sc, 0)
    j2, t2 = _pair(sc, 1)
    w1 = t1[0].weight.detach().clone()
    w2 = t2[0].weight.detach().clone()
    j1[0].weight.grad._rebind(j1[0].weight.grad._data * np.inf)
    with torch.no_grad():
        t1[0].weight.grad.mul_(float("inf"))
    for s, (_, o1), (_, o2) in zip(sc, (j1, t1), (j2, t2)):
        s.unscale_(o1)
        s.unscale_(o2)
        s.step(o1)
        s.step(o2)
        s.update()
    assert torch.equal(t1[0].weight.detach(), w1)   # skipped
    assert not torch.equal(t2[0].weight.detach(), w2)  # stepped
    _same(j1, t1)
    _same(j2, t2)
    assert float(sc[1].get_loss_scaling()) == 32.0
    assert sc[1].state_dict() == sc[0].state_dict()
    restored = amp.GradScaler()
    restored.load_state_dict(sc[1].state_dict())
    assert restored.state_dict()["scale"] == 32.0


def test_o1_lists_cast_by_op_name():
    """White-list ops run in the AMP dtype, black-list ops in float32,
    custom lists move an op; off, one attribute read and nothing casts."""
    x = torch.randn(3, 8)
    w = torch.randn(4, 8)
    assert TF.linear(x, w).dtype == torch.float32
    with amp.auto_cast():
        assert TF.linear(x, w).dtype == torch.bfloat16
        assert TF.matmul(x, w, transpose_y=True).dtype == torch.bfloat16
        assert TF.layer_norm(x.bfloat16(), 8).dtype == torch.float32
        assert TF.rms_norm(x.bfloat16()).dtype == torch.float32
        assert TF.softmax(x.bfloat16()).dtype == torch.float32
        assert TF.gelu(x).dtype == torch.float32  # in neither list
        with amp.auto_cast(custom_black_list={"linear"}, dtype="float16"):
            assert TF.linear(x.half(), w.half()).dtype == torch.float32
            assert TF.matmul(x, w.t()).dtype == torch.float16
    assert not amp.amp_state().enabled
    assert amp.autocast is amp.auto_cast and amp.amp_guard is amp.auto_cast
    assert amp.amp_decorate is amp.decorate
    assert amp.is_bfloat16_supported() and amp.is_float16_supported()
    assert amp.AmpScaler is amp.GradScaler
    assert amp.OptimizerState.UNSCALED == jamp.OptimizerState.UNSCALED
    assert amp.white_list == jamp.white_list
    assert amp.black_list == jamp.black_list


def _gpt_pair():
    cfg = jgpt.GPTConfig.tiny()
    paddle.seed(0)
    jm = jgpt.GPT(cfg)
    named = {n: np.asarray(p._data) for n, p in jm.named_parameters()}
    tm = GPT(GPTConfig.tiny(), device="cpu")
    tm.load_state_dict(gpt_params_from_numpy(named, cfg))
    ids = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(
        np.int64)
    return jm, tm, ids


def test_auto_cast_o1_tiny_gpt_loss(monkeypatch):
    """O1 on a float32 model: the block linears and attention in bf16, the
    norms and the loss in float32; the loss equals the JAX package's."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, tm, ids = _gpt_pair()
    seen = {}

    def record(key):
        def hook(module, args, out):
            seen.setdefault(key, out.dtype)
        return hook

    tm.h[0].attn.qkv_proj.register_forward_hook(record("qkv"))
    tm.h[0].ln_1.register_forward_hook(record("ln"))
    with jamp.auto_cast():
        jl = float(jm.loss(paddle.to_tensor(ids),
                           paddle.to_tensor(ids)).numpy())
    with amp.auto_cast():
        tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
    tl.backward()
    assert seen == {"qkv": torch.bfloat16, "ln": torch.float32}
    assert tl.dtype == torch.float32
    assert all(p.grad.dtype == torch.float32 for p in tm.parameters())
    np.testing.assert_allclose(tl.item(), jl, rtol=BF16_RTOL)
    plain = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids)).item()
    assert plain != tl.item()  # the casts took effect


def test_decorate_o2_grad_scaler_tiny_gpt(monkeypatch):
    """O2: every floating parameter in bf16 except LayerNorm's (the same
    Parameter objects), float32 masters on; three steps of
    auto_cast + GradScaler + AdamW against the JAX package's: losses and
    the scaler's state."""
    monkeypatch.setenv("PADDLE_FLASH_FORCE", "pallas")
    jm, tm, ids = _gpt_pair()
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    to = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                    multi_precision=False)
    params = dict(tm.named_parameters())
    jm, jo = jamp.decorate(models=jm, optimizers=jo, level="O2")
    tm2, to2 = amp.decorate(models=tm, optimizers=to, level="O2")
    assert tm2 is tm and to2 is to and to._multi_precision
    jdt = {n: str(p._data.dtype) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        assert p is params[n]
        ln = isinstance(tm.get_submodule(n.rsplit(".", 1)[0]), LayerNorm)
        assert p.dtype == (torch.float32 if ln else torch.bfloat16), n
        assert str(p.dtype).split(".")[-1] == jdt[n], n
    jsc, tsc = jamp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=2), \
        amp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=2)
    jls, tls = [], []
    for _ in range(3):
        with jamp.auto_cast(level="O2"):
            jl = jm.loss(paddle.to_tensor(ids), paddle.to_tensor(ids))
        jsc.scale(jl).backward()
        jsc.step(jo)
        jsc.update()
        jo.clear_grad()
        jls.append(float(jl.numpy()))
        with amp.auto_cast(level="O2"):
            tl = tm.loss(torch.from_numpy(ids), torch.from_numpy(ids))
        tsc.scale(tl).backward()
        tsc.step(to)
        tsc.update()
        to.clear_grad()
        tls.append(tl.item())
    np.testing.assert_allclose(tls, jls, rtol=BF16_RTOL)
    assert tls[2] < tls[0]
    assert tsc.state_dict() == jsc.state_dict()
    assert tsc.state_dict()["scale"] == 2048.0
    assert all(st["master"] is not None for p, st in
               zip(tm.parameters(), to._state.values())
               if p.dtype == torch.bfloat16)
